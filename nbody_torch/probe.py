"""Device-side probes of the main paths, for a machine with a CUDA GPU.

    python -m nbody_torch.probe trace [-n N] [-d DIM] [--steps K] [--algorithm A]
                                      [--precision float|double]
        Builds an N-body galaxy (default 2^20, 3-D, float32; double takes
        the trees' list paths), runs one untimed step of algorithm A
        (default all-pairs; or octree, bvh) through the engine, then K
        steps (default 3) under torch.profiler. Prints
        the kernel table, the wall time of the K steps, the summed device
        kernel time, the device idle share 1 - kernel time / wall, the
        peak device memory of the K steps, and the host synchronisations
        of one more step (CUDA's sync debug mode).

    python -m nbody_torch.probe knobs {oct|bvh} OUT SPEC [SPEC ...] [--n N]
                                      [--device cuda|cpu]
        The port of scripts/probe_oct_knobs.py and probe_bvh_knobs.py: per
        SPEC, one N-body galaxy (default 1,000,000, float32, theta 0.5),
        evolved first by 52 engine steps where the SPEC asks, runs the
        scripts' step (sort, the fast path's force with the SPEC's knobs,
        un-permute, leapfrog): one untimed step, then 3 timed with CUDA
        events (the host clock with --device cpu). Appends one JSON line
        per SPEC to OUT and prints it: probe, spec, n, sec (seconds per
        step), the scripts' info keys (subdiag's widths, pbdiag's float
        sums) and descend_*, the device, and the kernel launches of the 4
        steps. Every SPEC of results/r4 and results/r5's knob_*.jsonl runs. SPEC is the scripts' grammar,
        octree tile,s_block,window_tiles,ablate|none,dim,evolved and BVH
        tile,s_target,window_tiles,ablate|none,evolved[,dim], several
        ablate tokens joined by dots. Runs on the GPU unless --device cpu;
        an error ends the run with a non-zero exit.

    python -m nbody_torch.probe entries OUT [--n N] [--e E] [--device cuda|cpu]
        The port of scripts/probe_entries_kernel.py (nbody_torch/probes/
        entries_kernel.py): the table-driven entries kernel on n bodies
        (default 2^20; the script's 1,000,000 does not split into its
        tiles) and E entries (default 393,216) in the modes (S, real | pad
        | half_real); one JSON line per mode with the script's keys (probe,
        S, mode, E, sec, us_per_entry, pairs_per_s) and n, device, kernel,
        launches.

    python -m nbody_torch.probe entry-overhead OUT [MODE] [S] [T] [--e E]
                                               [--dim D] [--device cuda|cpu]
        The port of scripts/probe_entry_overhead.py (probes/
        entry_overhead.py): MODE all (default) or a comma-separated list of
        ideal, sepmj, sel, when, switch, prod, prod_noskip, prod_packed,
        prod_packed_noskip; S 1024, T 128, E 8192, dim 3 by default. The
        entov_equiv lines, then one entov line per mode.

    python -m nbody_torch.probe dma-pipeline OUT [MODE] [--math 0|1] [--e E]
                                             [--s S] [--dim D] [--device cuda|cpu]
        The port of scripts/probe_dma_pipeline.py (probes/dma_pipeline.py):
        MODE all (default), blockspec, manual2 or manual4; E 8192, S 1024,
        dim 3 by default; --math 0 is the script's PROBE_MATH=0 control.
        The dmapipe_equiv lines, then one dmapipe line per mode.
        These three append to OUT, run on the GPU unless --device cpu (the
        kernels' plain twins), and end non-zero on an error.

    python -m nbody_torch.probe entries-plan OUT [--n N] [--dims 3,2] [--device cuda|cpu]
        The entries kernel's plan at other part counts (probes/
        entries_plan.py): the entries call that one f32 octree and one BVH
        force evaluation make on an N-body galaxy (default 2^20), timed on
        plans of one part a tile, ntiles parts, and 1/4 to 4 times the
        default target, and the plan alone; one JSON line per (tree, dim),
        appended to OUT. A one-off design sweep; on the CPU the wrapper
        runs its twin, which takes no plan.

    python -m nbody_torch.probe split-parts OUT [--n N] [--dims 3,2] [--device cuda|cpu]
        The list kernel and the two windows on other part counts
        (probes/split_parts.py): the interval window call of one f32
        octree force evaluation, the node-mask window call of one f32 BVH
        force evaluation and the list call of one f64 octree and BVH
        list-path evaluation on an N-body galaxy (default 2^20), timed at
        P = 1, 2, 4, 8 and the default; the list on the CLI's work (the
        fallback's tiles skipped) and on every tile's heads; one JSON line
        per (kernel, tree, dim), appended to OUT. A one-off design sweep.

    python -m nbody_torch.probe sass OUT.txt
        Compiles each nbody_torch/csrc/*.cu to a cubin with the build's
        nvcc flags and -Xptxas -v, writes `cuobjdump -sass` of them to
        OUT.txt, and prints one JSON line per kernel (also written to
        OUT.txt.json): its registers and spill bytes, its hot loop, the
        innermost loop with the most MUFU operations: instructions, MUFU,
        FP32, FP64 and shared-load instructions in it, and the
        instructions a pair, counting two MUFU operations a pair (a root
        and a reciprocal, as every chain of csrc/ but the fast variants'
        far branches takes); where the kernel has one, its far loop (far_*:
        the innermost loop whose MUFU operations are all rsqrt, the fast
        variants' far branches, counted at one MUFU a pair); and its
        global loads by width over the whole function (LDG.E.128 a 16-byte
        load), what the sum passes are judged by.

    python -m nbody_torch.probe accuracy [n] [steps] [--dims 2,3] [--algos bvh,octree]
                                         [--evolved] [--no-ap-oracle] [--legs L]
                                         [--force-error] [--out FILE.json]
                                         [--reference SRC] [--device cuda|cpu]
        The port of scripts/accuracy_study.py (probes/accuracy.py; n 16,384
        and 25 steps by default): the float32 fast paths (leg fp32fast) and
        the float64 list paths (f64group) of both trees against each other
        and the float64 all-pairs oracle on the galaxy at theta 0.5, as
        final-position L1s of `steps` steps or, with --force-error, as one
        force evaluation's relative L1 and per-body relative errors (p50,
        p99, max) against the float64 all-pairs kernel. The script's JSON
        lines, the list in --out (default accuracy_torch.json) and its
        markdown table; the --evolved pre-roll cache and the force dumps
        beside --out. The reference binary's legs need --reference, the
        reference's src/main.cpp, and g++; else stderr says why they are
        skipped.

    python -m nbody_torch.probe acc-growth [n] [steps] [--dim 3] [--algos bvh,octree]
                                           [--out FILE.jsonl] [--device cuda|cpu]
        The port of scripts/probe_acc_growth.py (probes/accuracy.py; n
        131,072, 10 steps by default): the float64 and float32 legs stepped
        in lockstep; per step {algo, dim, n, step, pos_l1, acc_l1}, printed
        and appended to --out (default acc_growth.jsonl).

    python -m nbody_torch.probe nasa [--csv FILE | --synthetic N] [--external CSV]
                                     [--steps 25] [--workdir DIR] [--reference SRC]
                                     [--device cuda|cpu]
        The port of scripts/nasa.py (probes/nasa.py): the asteroid CSV (or N
        synthetic main-belt bodies from seed 7, default 2,000) converted to
        the state format, the octree and all-pairs runs of nbody_torch.cli
        at -d 3 --precision double --theta 0.6 --csv-detailed --save pos
        under --workdir (default nasa_work), and the L1 of their final
        positions, printed as check_state.py prints it.

    python -m nbody_torch.probe mesh-scaling [--n 32768] [--steps 3] [--out FILE.md]
                                             [--device cuda|cpu]
        The port of scripts/probe_mesh_scaling.py (probes/mesh_scaling.py):
        per shard count S in 1, 2, 4, 8 one group of S ranks times the ring,
        the replicated BVH and octree steps, the partitioned octree (also
        S/2 x 2 from S = 4, and at n * S / 8 bodies); one JSON line per S
        with the script's keys and the backend, the ranks a card and the
        launches; the script's table in --out. Ranks that share a card give
        no scaling figure.
        These four run on the GPU unless --device cpu (the kernels' plain
        twins) and end non-zero on an error.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import time
import warnings


def trace(n: int, dim: int, steps: int, algorithm: str, precision: str = "float",
          table: bool = True) -> dict:
    """Profile `steps` steps (see the module docstring); prints the kernel
    table (unless table=False) and the summary line, and returns the
    summary: wall and device kernel seconds, the idle share, the kernels
    launched, the peak GiB, the host syncs of one step, and each kernel's
    device seconds by name (device_s_by_kernel)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nbody_torch.config import precision_dtype
    from nbody_torch.models import build_model
    from nbody_torch.sim.engines import EngineOptions, get_engine

    dev = torch.device("cuda", 0)
    cfg, s = build_model("galaxy", n, dim, precision_dtype(precision), device=dev)
    step = get_engine(algorithm).make_step(cfg, EngineOptions(), dev)
    s, _ = step(s, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(1, steps + 1):
            s, _ = step(s, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if table:
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e6
    by_kernel = {}
    for e in events:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time / 1e6
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more step with CUDA's sync debug mode on: every operation that
    # makes the host wait for the device warns once per call
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s, _ = step(s, steps + 1)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    print(f"{algorithm}, {n} bodies, {dim}-D {np.dtype(cfg.dtype).name}, {steps} steps: "
          f"wall {wall:.4f} s, device "
          f"kernel time {busy:.4f} s, idle share {1 - busy / wall:.4f}, {len(events)} kernels, "
          f"peak memory {peak:.2f} GiB; host synchronisations in one step: {len(syncs)} {syncs}")
    return {"algorithm": algorithm, "n": n, "dim": dim, "precision": precision, "steps": steps,
            "wall_s": wall, "device_s": busy, "idle_share": 1 - busy / wall,
            "kernels": len(events), "peak_gib": peak, "host_syncs": len(syncs),
            "device_s_by_kernel": by_kernel}


# the info keys the knob scripts log (probe_oct_knobs.py:104-115,
# probe_bvh_knobs.py:108-115), where the path reports them: integers, and
# the octree's pbdiag sums as floats
KNOB_KEYS = {"oct": ("entries", "fallback_tiles", "open_cells", "near_width_sum",
                     "near_unique_blocks", "near_width_cell_tile",
                     "near_width_cell_subtile_xnsub", "window_span_sum", "window_capacity",
                     "far_heap_nonempty"),
             "bvh": ("entries", "fallback_tiles", "res_width_sum", "res_pairs",
                     "res_unique_blocks")}
KNOB_FLOATS = ("pb_width_box", "pb_width_com", "pb_width_tile")


def knob_step(tree: str, spec: str, cfg):
    """The knob scripts' step for one SPEC on cfg's galaxy: sort, the fast
    path's force with the SPEC's tile, S (s_block or s_target), window and
    ablate tokens, un-permute, leapfrog: step(state) -> (state, info).
    theta is 0.5, as in the scripts."""
    import dataclasses

    from nbody_torch.ops.integrator import leapfrog_step
    from nbody_torch.ops.permutation import unpermute_rows

    parts = spec.split(",")
    tile, width, wt, ablate = int(parts[0]), int(parts[1]), int(parts[2]), parts[3]
    ablate = "" if ablate == "none" else ablate.replace(".", ",")
    theta, G, eps = 0.5, cfg.G, cfg.eps
    if tree == "oct":
        from nbody_torch.ops.octree import max_depth, morton_sort, robust_quant_box
        from nbody_torch.ops.octree_group import compute_force_grouped_fast

        depth = max_depth(cfg.n, cfg.dim)

        def force(s):
            lo_r, hi_r = robust_quant_box(s.x)
            ms, xs, ks, perm = morton_sort(s.m, s.x, lo_r, hi_r, depth)
            a, info = compute_force_grouped_fast(ms, xs, ks, depth, theta, G, eps, tile=tile,
                                                 s_block=width, window_tiles=wt, ablate=ablate,
                                                 box=(lo_r, hi_r))
            return a, perm, info
    else:
        from nbody_torch.ops.bvh import build_tree
        from nbody_torch.ops.bvh_group import compute_force_grouped_windowed
        from nbody_torch.ops.geometry import aabb_of_points
        from nbody_torch.ops.hilbert import hilbert_sort_perm

        def force(s):
            perm = hilbert_sort_perm(s.x, *aabb_of_points(s.x, eps), true_curve=True)
            m, x = s.m[perm], s.x[perm]
            a, info = compute_force_grouped_windowed(build_tree(m, x, eps), m, x, theta, G, eps,
                                                     tile=tile, s_target=width, window_tiles=wt,
                                                     ablate=ablate)
            return a, perm, info

    def step(s):
        a, perm, info = force(s)
        return leapfrog_step(dataclasses.replace(s, a=unpermute_rows(a, perm)), cfg.dt), info

    return step


def parse_knob_spec(tree: str, spec: str) -> tuple[int, int]:
    """(dim, evolved) of a SPEC: the octree's fields 5 and 6; the BVH's
    field 5, and its optional sixth the dim (default 3)."""
    parts = spec.split(",")
    if tree == "oct":
        if len(parts) != 6:
            raise ValueError(f"octree SPEC is tile,s_block,window_tiles,ablate|none,dim,evolved: "
                             f"{spec!r}")
        return int(parts[4]), int(parts[5])
    if len(parts) not in (5, 6):
        raise ValueError(f"BVH SPEC is tile,s_target,window_tiles,ablate|none,evolved[,dim]: "
                         f"{spec!r}")
    return (int(parts[5]) if len(parts) == 6 else 3), int(parts[4])


def knobs(tree: str, out: str, specs: list[str], n: int, device: str) -> None:
    import numpy as np
    import torch

    from nbody_torch.cli import resolve_device
    from nbody_torch.models import build_model
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.probes import log
    from nbody_torch.sim.engines import EngineOptions, get_engine

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    for spec in specs:
        dim, evolved = parse_knob_spec(tree, spec)
        cfg, state = build_model("galaxy", n, dim, np.float32, device=dev)
        step = knob_step(tree, spec, cfg)
        if evolved:  # the scripts' 4 x 13 engine steps
            engine_step = get_engine("octree" if tree == "oct" else "bvh").make_step(
                cfg, EngineOptions(), dev)
            for k in range(52):
                state, _ = engine_step(state, k)
        ca.reset_launch_counts()
        cg.reset_launch_counts()
        state, info = step(state)  # untimed
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(3):
                state, _ = step(state)
            end.record()
            torch.cuda.synchronize(dev)
            sec = start.elapsed_time(end) / 3e3
        else:
            t0 = time.perf_counter()
            for _ in range(3):
                state, _ = step(state)
            sec = (time.perf_counter() - t0) / 3
        # descend__dbg (the dbg token) holds tensors, not a counter
        keys = [k for k in info if k in KNOB_KEYS[tree] or (
            k.startswith(("res_pass_", "descend_")) and k != "descend__dbg")]
        launches = {k: v for k, v in {**ca.launch_counts, **cg.launch_counts}.items() if v}
        log(out, {"probe": f"{tree}knobs", "spec": spec, "n": n, "sec": sec,
                  **{k: int(info[k]) for k in keys},
                  **{k: float(info[k]) for k in KNOB_FLOATS if k in info},
                  "device": name, "launches": launches})
        del state, step


def _modes(arg: str, known: tuple[str, ...]) -> list[str]:
    modes = list(known) if arg == "all" else arg.split(",")
    bad = [m for m in modes if m not in known]
    if bad:
        raise ValueError(f"unknown modes {bad}: expected all or some of {', '.join(known)}")
    return modes


def entry_probe(args) -> None:
    """entries, entry-overhead or dma-pipeline (nbody_torch/probes/)."""
    from nbody_torch.cli import resolve_device

    if args.cmd == "entries":
        from nbody_torch.probes import entries_kernel

        entries_kernel.run(args.out, args.n, args.e, resolve_device(args.device))
    elif args.cmd == "entry-overhead":
        from nbody_torch.probes import entry_overhead

        modes = _modes(args.mode, entry_overhead.MODES)
        entry_overhead.run(args.out, modes, args.S, args.T, args.e, args.dim,
                           resolve_device(args.device))
    else:
        from nbody_torch.probes import dma_pipeline

        modes = _modes(args.mode, dma_pipeline.MODES)
        dma_pipeline.run(args.out, modes, args.e, args.s, args.dim, bool(args.math),
                         resolve_device(args.device))


def script_port(args) -> None:
    """accuracy, acc-growth, nasa or mesh-scaling (nbody_torch/probes/)."""
    from nbody_torch.cli import resolve_device

    dev = resolve_device(args.device)
    if args.cmd == "accuracy":
        from nbody_torch.probes import accuracy

        accuracy.study(args.n, args.steps, [int(d) for d in args.dims.split(",")],
                       args.algos.split(","), dev, evolved=args.evolved,
                       force_error=args.force_error, ap_oracle=not args.no_ap_oracle,
                       legs=args.legs.split(","), out=args.out, ref_src=args.reference)
    elif args.cmd == "acc-growth":
        from nbody_torch.probes import accuracy

        accuracy.growth(args.n, args.steps, args.dim, args.algos.split(","), args.out, dev)
    elif args.cmd == "nasa":
        from nbody_torch.probes import nasa

        nasa.run(args.csv, args.synthetic, args.external, args.steps, args.workdir, dev.type,
                 args.reference)
    else:
        from nbody_torch.probes import mesh_scaling

        mesh_scaling.run(args.n, args.steps, args.out, dev)


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
SASS_TARGET = re.compile(r"(0x[0-9a-f]+|\.L_x_\d+)")
FP32_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP")
FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")


def sass_loops(text: str) -> dict[str, dict]:
    """function -> its hot loop, from `cuobjdump -sass` text: the
    innermost loop (a backward branch's range that holds no other loop
    with MUFU) with the most MUFU operations, ties to the shorter one;
    {} counts for a function with no such loop."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = chunk.split("\n", 1)
        insts, labels = [], {}
        for line in body.splitlines():
            lab = SASS_LABEL.match(line)
            if lab:
                labels[lab.group(1)] = len(insts)
                continue
            ins = SASS_LINE.search(line)
            if ins:
                insts.append((int(ins.group(1), 16), ins.group(3), ins.group(4)))
        index = {addr: k for k, (addr, _, _) in enumerate(insts)}
        loops = []
        for k, (_, op, args) in enumerate(insts):
            target = SASS_TARGET.search(args) if op.startswith("BRA") else None
            if target is None:
                continue
            t = target.group(1)
            first = labels.get(t) if t.startswith(".L") else index.get(int(t, 16))
            if first is not None and first <= k:
                loops.append((first, k))

        def count(lo, hi, ops):
            return sum(1 for _, op, _ in insts[lo:hi + 1] if op.split(".")[0] in ops)

        def mufu(lo, hi):
            return sum(1 for _, op, _ in insts[lo:hi + 1] if op.startswith("MUFU"))

        inner = [(lo, hi) for lo, hi in loops if mufu(lo, hi) and not any(
            (a, b) != (lo, hi) and lo <= a and b <= hi and mufu(a, b) for a, b in loops)]
        if not inner:
            out[name.strip()] = {}
            continue
        lo, hi = max(inner, key=lambda r: (mufu(*r), -(r[1] - r[0])))
        n, mu = hi - lo + 1, mufu(lo, hi)
        row = {"loop_instructions": n, "mufu": mu,
               "fp32": count(lo, hi, FP32_OPS), "fp64": count(lo, hi, FP64_OPS),
               "lds": count(lo, hi, ("LDS",)),
               "instructions_per_pair": n * 2 / mu}
        # a far loop: rsqrt only (the fast variants' far branches, one MUFU a pair)
        far = [(lo, hi) for lo, hi in inner
               if mufu(lo, hi) == sum(1 for _, op, _ in insts[lo:hi + 1] if op == "MUFU.RSQ")]
        if far:
            lo, hi = max(far, key=lambda r: (mufu(*r), -(r[1] - r[0])))
            n, mu = hi - lo + 1, mufu(lo, hi)
            row.update(far_loop_instructions=n, far_mufu=mu, far_fp32=count(lo, hi, FP32_OPS),
                       far_instructions_per_pair=n / mu)
        out[name.strip()] = row
    return out


def sass_global_loads(text: str) -> dict[str, dict]:
    """function -> its global loads in `cuobjdump -sass` text, counted by
    opcode with its modifiers (LDG.E.128 is one 16-byte load), over the
    whole function: what a kernel without a MUFU loop (the sum passes) is
    judged by."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = chunk.split("\n", 1)
        loads = {}
        for line in body.splitlines():
            ins = SASS_LINE.search(line)
            if ins and ins.group(3).startswith("LDG"):
                loads[ins.group(3)] = loads.get(ins.group(3), 0) + 1
        out[name.strip()] = loads
    return out


def sass_slow_paths(text: str) -> dict[str, int]:
    """function -> its CALL and FCHK instructions in `cuobjdump -sass`
    text: the IEEE division's and root's slow paths (nvcc's -prec-div and
    -prec-sqrt); the chain's approximations take none."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = chunk.split("\n", 1)
        out[name.strip()] = sum(1 for line in body.splitlines()
                                if (ins := SASS_LINE.search(line))
                                and ins.group(3).split(".")[0] in ("CALL", "FCHK"))
    return out


def ptxas_usage(text: str) -> dict[str, dict]:
    """function -> {registers, spill_stores, spill_loads} from nvcc
    -Xptxas -v output."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
    return usage


def sass_of(src) -> tuple[str, list[dict]]:
    """nvcc -cubin of one source with the build's flags and -Xptxas -v,
    then cuobjdump -sass: (the compiler's log and the SASS text, one row a
    kernel: its demangled name, registers, spills, hot loop (sass_loops),
    global loads and slow-path instructions)."""
    from nbody_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    nvcc = _build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(nvcc), "cu++filt")
    cubin = _build.BUILD_DIR / f"probe.{src.stem}.cubin"
    log = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", str(cubin), str(src)],
                         check=True, capture_output=True, text=True)
    text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    usage = ptxas_usage(log.stdout + log.stderr)
    loads = sass_global_loads(text)
    slow = sass_slow_paths(text)
    rows = []
    for name, loop in sass_loops(text).items():
        demangled = (subprocess.run([filt, name], capture_output=True, text=True).stdout
                     .strip() if os.access(filt, os.X_OK) else name)
        rows.append({"source": src.name, "kernel": demangled or name, **usage.get(name, {}),
                     **loop, "global_loads": loads.get(name, {}),
                     "slow_path_instructions": slow.get(name, 0)})
    return log.stdout + log.stderr + text, rows


def sass(out: str) -> None:
    from nbody_torch import _build

    rows = []
    with open(out, "w") as f:
        for src in _build.sources():
            text, src_rows = sass_of(src)
            f.write(text)
            rows += src_rows
    with open(out + ".json", "w") as f:
        for row in rows:
            print(json.dumps(row))
            f.write(json.dumps(row) + "\n")
    print(f"wrote {out} and {out}.json")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nbody_torch.probe")
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace", help="profile K steps; print the idle share")
    t.add_argument("-n", type=int, default=1 << 20)
    t.add_argument("--algorithm", choices=("all-pairs", "octree", "bvh"), default="all-pairs")
    t.add_argument("-d", "--dim", type=int, default=3)
    t.add_argument("--steps", type=int, default=3)
    t.add_argument("--precision", choices=("float", "double"), default="float")
    k = sub.add_parser("knobs", help="the knob scripts' step per SPEC; one JSON line each")
    k.add_argument("tree", choices=("oct", "bvh"))
    k.add_argument("out")
    k.add_argument("specs", nargs="+", metavar="SPEC")
    k.add_argument("--n", type=int, default=1_000_000)
    k.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    en = sub.add_parser("entries", help="the table-driven entries kernel's cost model")
    en.add_argument("out")
    en.add_argument("--n", type=int, default=1 << 20)
    en.add_argument("--e", type=int, default=393_216)
    eo = sub.add_parser("entry-overhead", help="the entry kernel's overhead ladder")
    eo.add_argument("out")
    eo.add_argument("mode", nargs="?", default="all")
    eo.add_argument("S", nargs="?", type=int, default=1024)
    eo.add_argument("T", nargs="?", type=int, default=128)
    eo.add_argument("--e", type=int, default=8192)
    eo.add_argument("--dim", type=int, choices=(2, 3), default=3)
    dp = sub.add_parser("dma-pipeline", help="synchronous block copies against a copy ring")
    dp.add_argument("out")
    dp.add_argument("mode", nargs="?", default="all")
    dp.add_argument("--math", type=int, choices=(0, 1), default=1)
    dp.add_argument("--e", type=int, default=8192)
    dp.add_argument("--s", type=int, default=1024)
    dp.add_argument("--dim", type=int, choices=(2, 3), default=3)
    ep = sub.add_parser("entries-plan", help="the entries call on plans of other part counts")
    ep.add_argument("out")
    ep.add_argument("--n", type=int, default=1 << 20)
    ep.add_argument("--dims", default="3,2")
    sp = sub.add_parser("split-parts", help="the list and window kernels on other part counts")
    sp.add_argument("out")
    sp.add_argument("--n", type=int, default=1 << 20)
    sp.add_argument("--dims", default="3,2")
    for p in (en, eo, dp, ep, sp):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ac = sub.add_parser("accuracy", help="the fp32 fast paths' and f64 list paths' error")
    ac.add_argument("n", nargs="?", type=int, default=16384)
    ac.add_argument("steps", nargs="?", type=int, default=25)
    ac.add_argument("--dims", default="2,3")
    ac.add_argument("--algos", default="bvh,octree", help="engine subset (e.g. re-run one row)")
    ac.add_argument("--evolved", action="store_true",
                    help="pre-roll 50 fp32 fast octree steps first, the legs' common start")
    ac.add_argument("--no-ap-oracle", action="store_true",
                    help="skip the f64 all-pairs trajectory; normalise by the f64 leg")
    ac.add_argument("--legs", default="fp32fast,f64group", help="force-error legs subset")
    ac.add_argument("--force-error", action="store_true",
                    help="one force evaluation against the f64 all-pairs kernel, no trajectory")
    ac.add_argument("--out", default="accuracy_torch.json")
    ac.add_argument("--reference", help="the reference's src/main.cpp, for its legs")
    ag = sub.add_parser("acc-growth", help="fp32 against f64, stepped in lockstep")
    ag.add_argument("n", nargs="?", type=int, default=131072)
    ag.add_argument("steps", nargs="?", type=int, default=10)
    ag.add_argument("--dim", type=int, choices=(2, 3), default=3)
    ag.add_argument("--algos", default="bvh,octree")
    ag.add_argument("--out", default="acc_growth.jsonl")
    na = sub.add_parser("nasa", help="the asteroid validation pipeline")
    na.add_argument("--csv", help="real SBDB CSV (TimThuering schema)")
    na.add_argument("--synthetic", type=int, default=0,
                    help="generate a synthetic belt of N bodies instead")
    na.add_argument("--external", help="external simulator lastState.csv to compare")
    na.add_argument("--steps", type=int, default=25)
    na.add_argument("--workdir", default="nasa_work")
    na.add_argument("--reference", help="the reference's src/main.cpp, for its run")
    ms = sub.add_parser("mesh-scaling", help="the --mesh layouts' times by shard count")
    ms.add_argument("--n", type=int, default=32768)
    ms.add_argument("--steps", type=int, default=3)
    ms.add_argument("--out", default=None)
    for p in (ac, ag, na, ms):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    s = sub.add_parser("sass", help="write the kernels' SASS to a file")
    s.add_argument("out")
    args = parser.parse_args(argv)
    if args.cmd == "trace":
        trace(args.n, args.dim, args.steps, args.algorithm, args.precision)
    elif args.cmd == "knobs":
        knobs(args.tree, args.out, args.specs, args.n, args.device)
    elif args.cmd in ("entries", "entry-overhead", "dma-pipeline"):
        entry_probe(args)
    elif args.cmd == "entries-plan":
        from nbody_torch.cli import resolve_device
        from nbody_torch.probes import entries_plan

        entries_plan.run(args.out, args.n, tuple(int(d) for d in args.dims.split(",")),
                         resolve_device(args.device))
    elif args.cmd == "split-parts":
        from nbody_torch.cli import resolve_device
        from nbody_torch.probes import split_parts

        split_parts.run(args.out, args.n, tuple(int(d) for d in args.dims.split(",")),
                        resolve_device(args.device))
    elif args.cmd in ("accuracy", "acc-growth", "nasa", "mesh-scaling"):
        script_port(args)
    else:
        sass(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
