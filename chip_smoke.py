#!/usr/bin/env python3
"""GPU smoke check of the nbody_torch port. Run from the repo root on a
machine with one NVIDIA Hopper GPU (H100):

    python3 chip_smoke.py

Phases, each printed on its own lines:
  1. the card (nvidia-smi name and power limit) and the CUDA kernels'
     build from nbody_torch/csrc/;
  2. the all-pairs kernels against their plain torch twins on the card,
     on the same inputs: n = 65,536 in float32 and float64, 2-D and 3-D,
     both softenings, a ragged n and a rectangular block; then both
     kernels at the main path's shape, N = 2^20 3-D float32, timed beside
     the twin;
  3. the all-pairs main path at full size through the CLI: 2^20 galaxy
     bodies in 3-D, and a small run whose final state must match the CPU's;
  4. energies and saving: a 65,536-body 2-D galaxy with --csv-detailed
     --save all, checked through energy.bin and positions.bin;
  5. the octree fast path (the CLI's default algorithm):
     a. one octree force evaluation of a 2^20-body galaxy, in 3-D and in
        2-D, whose far, window and entries kernel calls are recorded; each
        kernel is then run again on its recorded inputs and timed beside
        its plain twin;
     b. the CLI at full size, -n 1048576 -s 12 --algorithm octree in 3-D
        and in 2-D;
     c. the 3-D force of (a) against the sqrt3 all-pairs kernel on the
        same sorted bodies (sanity bounds on the relative error);
     d. a 17,000-body 3-D evaluation on the card and through the CPU
        twins: equal counters, forces within 1e-5 of sum |a|.
The kernels' launch counts are set to 0 just before each CLI run that
drives a main path and read just after it: the all-pairs force kernel's
from the 2^20 run of phase 3, the potential kernel's from the run of
phase 4 (the 2^20 --csv-total run computes no energies), the octree
kernels' from the 3-D run of phase 5b (the 2-D run's counts and the
fallback launches of the all-pairs kernel are reported beside them).
Launches made to compare a kernel with its twin, and those of the small
runs, do not count.

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a GPU, or if any phase
fails, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
# Per-row tolerance of a kernel against its twin, as a fraction of the row's
# sum of |term|: both sum the same terms in different orders, so they
# differ by a few ulps of that sum, times ~sqrt of the terms per partial sum.
TOL = {"float32": 1e-5, "float64": 1e-12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def scaled(got, ref, scale):
    """(max |got - ref| / scale, max |got - ref|) once the card is done;
    fails on a non-finite kernel output."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    err = ((got - ref).abs() / scale.clamp_min(torch.finfo(scale.dtype).tiny)).max().item()
    return err, (got - ref).abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU.",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from nbody_torch import _build, cli
    from nbody_torch.ops import cuda_allpairs as ca

    dev = torch.device("cuda", 0)

    # -- phase 1: card and build -------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({'already built' if cached else 'nvcc ' + ' '.join(_build.NVCC_FLAGS)}) "
          f"-> {_build.library_path().name}")

    # -- phase 2: kernels vs plain twins -----------------------------------
    rng = np.random.default_rng(SEED)

    def bodies(n, dim, dtype):
        m = torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dtype, device=dev)
        x = torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=dtype, device=dev)
        return m, x

    def report(label, dtype, err):
        tol = TOL[str(dtype).split(".")[-1]]
        print(f"[2] {label}: max |kernel - plain| / sum|term| = {err:.3e} (limit {tol:g})")
        check(err <= tol, f"{label}: scaled error {err:.3e} above {tol:g}")

    n = 65536
    for dtype in (torch.float32, torch.float64):
        for dim in (2, 3):
            m, x = bodies(n, dim, dtype)
            for soft in ("poly", "sqrt3"):
                got = ca.allpairs_block_cuda(x, m, x, eps_of(dtype), soft)
                ref = ca.allpairs_block_torch(x, m, x, eps_of(dtype), soft)
                scale = ca.allpairs_block_abs_torch(x, m, x, eps_of(dtype), soft)
                report(f"block {soft} {dim}-D {dtype} n={n}", dtype,
                       scaled(got, ref, scale)[0])
            got = ca.potential_rowsums_cuda(m, x, eps_of(dtype))
            ref = ca.potential_rowsums_torch(m, x, eps_of(dtype))
            report(f"potential {dim}-D {dtype} n={n}", dtype, scaled(got, ref, ref.abs())[0])
    # ragged edges: n not a multiple of the 256-row block, and ni != nj
    for dtype in (torch.float32, torch.float64):
        mj, xj = bodies(n + 37, 3, dtype)
        xi = xj[:4099].contiguous()
        got = ca.allpairs_block_cuda(xi, mj, xj, eps_of(dtype), "poly")
        ref = ca.allpairs_block_torch(xi, mj, xj, eps_of(dtype), "poly")
        scale = ca.allpairs_block_abs_torch(xi, mj, xj, eps_of(dtype), "poly")
        report(f"block poly 3-D {dtype} ni=4099 nj={n + 37}", dtype, scaled(got, ref, scale)[0])
        G = 6.674e-11
        got = ca.allpairs_accel_cuda(mj, xj, G, eps_of(dtype))
        ref = G * ca.allpairs_block_torch(xj, mj, xj, eps_of(dtype))
        scale = G * ca.allpairs_block_abs_torch(xj, mj, xj, eps_of(dtype))
        report(f"accel (G={G}) 3-D {dtype} n={n + 37}", dtype, scaled(got, ref, scale)[0])
        got = ca.potential_rowsums_cuda(mj, xj, eps_of(dtype))
        ref = ca.potential_rowsums_torch(mj, xj, eps_of(dtype))
        report(f"potential 3-D {dtype} n={n + 37}", dtype, scaled(got, ref, ref.abs())[0])

    # the main path's shape: N = 2^20, 3-D, float32
    big = 1 << 20
    m, x = bodies(big, 3, torch.float32)
    eps = eps_of(torch.float32)
    kernels = {}
    for name, kern, plain, scale_fn in (
        ("allpairs_block_kernel",
         lambda: ca.allpairs_accel_cuda(m, x, 1.0, eps),
         lambda: ca.allpairs_block_torch(x, m, x, eps),
         lambda: ca.allpairs_block_abs_torch(x, m, x, eps)),
        ("potential_rowsums_kernel",
         lambda: ca.potential_rowsums_cuda(m, x, eps),
         lambda: ca.potential_rowsums_torch(m, x, eps),
         None),
    ):
        got = kern()  # warm-up launch
        ms = event_ms(kern, reps=3)
        plain_ms, ref = event_ms(plain, reps=1, keep=True)
        scale = ref.abs() if scale_fn is None else scale_fn()
        err, abs_err = scaled(got, ref, scale)
        report(f"{name} at N=2^20 3-D float32 (kernel {ms:.1f} ms, plain {plain_ms:.1f} ms)",
               torch.float32, err)
        kernels[name] = {"max_abs_err": abs_err, "max_scaled_err": err,
                         "scaled_err_limit": TOL["float32"], "ms": ms, "plain_ms": plain_ms}
        del got, ref, scale
    del m, x
    torch.cuda.empty_cache()

    # -- phase 3: the main path at full size -------------------------------
    ca.reset_launch_counts()
    argv = ["-n", str(big), "-s", "12", "-d", "3", "--algorithm", "all-pairs",
            "--workload", "galaxy", "--device", "cuda", "--csv-total"]
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    phase3_launches = dict(ca.launch_counts)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 2, f"CLI run failed: rc={rc}, output {lines!r}")
    check(lines[0] == "algorithm,dim,precision,nsteps,nbodies,total [s]", f"header {lines[0]!r}")
    fields = lines[1].split(",")
    check(fields[:5] == ["all-pairs", "3", "32", "2", str(big)], f"CSV row {lines[1]!r}")
    total = float(fields[5])
    force_launches = phase3_launches["allpairs_block_kernel"]
    check(force_launches >= 12, f"force kernel launched {force_launches} times, expected >= 12")
    per_step = total / 2
    rate = big * (big - 1) * 2 / total if total > 0 else float("inf")
    print(f"[3] python -m nbody_torch.cli {' '.join(argv)}")
    print(f"[3]   {lines[1]}  ->  {per_step:.3f} s/step, {rate:.4e} interactions/s "
          f"(N(N-1)*nsteps/total); wall {wall:.1f} s with model build and warmup; "
          f"force kernel launches {force_launches}")

    # small input: the same path on the card and on the CPU (plain twins)
    with tempfile.TemporaryDirectory() as tmp:
        finals = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"final_{device}.bin")
            cli.main(["-n", "2048", "-s", "12", "-d", "3", "--algorithm", "all-pairs",
                      "--workload", "galaxy", "--precision", "double", "--device", device,
                      "--csv-total", "--save-state", path], out=io.StringIO())
            finals[device] = read_state(path)
    gpu, cpu = finals["cuda"], finals["cpu"]
    check(gpu.shape == (2048, 7) and bool(np.isfinite(gpu).all()), "final state malformed")
    # per column (m, x, v): float32 files of float64 states that agree to
    # ~1e-15 differ by at most one float32 ulp of the column's largest value
    diff = float((np.abs(gpu - cpu).max(axis=0) / np.abs(cpu).max(axis=0)).max())
    print(f"[3] 2048-body 3-D galaxy, 12 steps in float64: final state on the card vs "
          f"the CPU twins, max over columns of max |diff| / max |value| = {diff:.3e} "
          f"(limit 1e-6)")
    check(diff <= 1e-6, "card and CPU final states differ")

    # -- phase 4: energies and saving ----------------------------------------
    n4 = 65536
    with tempfile.TemporaryDirectory() as tmp:
        here = os.getcwd()
        os.chdir(tmp)
        try:
            out = io.StringIO()
            ca.reset_launch_counts()
            cli.main(["-n", str(n4), "-s", "3", "-d", "2", "--algorithm", "all-pairs",
                      "--workload", "galaxy", "--device", "cuda", "--csv-detailed",
                      "--save", "all"], out=out)
            phase4_launches = dict(ca.launch_counts)
            energy = Path("energy.bin").read_bytes()
            positions = Path("positions.bin").read_bytes()
        finally:
            os.chdir(here)
    row = out.getvalue().strip().splitlines()[-1].split(",")
    check(row[:5] == ["all-pairs", "2", "32", "3", str(n4)] and len(row) == 8,
          f"detailed CSV row {row!r}")
    pe_launches = phase4_launches["potential_rowsums_kernel"]
    check(pe_launches >= 4, f"potential kernel launched {pe_launches} times, expected >= 4")
    check(struct.unpack("<II", energy[:8]) == (3, 4), "energy.bin header")
    e = np.frombuffer(energy[8:], np.float32).reshape(-1, 2)
    check(e.shape == (4, 2) and bool(np.isfinite(e).all()), f"energy records {e!r}")
    check(struct.unpack("<IIII", positions[:16]) == (n4, 3, 4, 2)
          and len(positions) == 16 + 4 * n4 * 2 * 4, "positions.bin header or length")
    tot = e.sum(axis=1).astype(np.float64)
    drift = abs(tot[-1] - tot[0]) / abs(tot[0])
    print(f"[4] {n4}-body 2-D galaxy, 3 steps, --csv-detailed --save all: "
          f"{','.join(row)}; E0 = {tot[0]:.6e}, E3 = {tot[-1]:.6e}, "
          f"relative drift {drift:.3e} (limit 1e-3); potential kernel launches {pe_launches}")
    check(drift <= 1e-3, "energy drift too large")

    octree_kernels, fallback_launches = octree_phases(dev, big)

    entries = []
    for name, replaces, launches, run in (
        ("allpairs_block_kernel", "nbody_tpu/ops/pallas_allpairs.py:113", phase3_launches,
         f"phase 3: {big}-body 3-D all-pairs --csv-total"),
        ("potential_rowsums_kernel", "nbody_tpu/ops/pallas_allpairs.py:255", phase4_launches,
         f"phase 4: {n4}-body 2-D all-pairs --csv-detailed --save all"),
    ):
        check(launches[name] > 0, f"{name} was not launched on the main path")
        entries.append({"name": name, "route": "cuda", "source": "nbody_torch/csrc/allpairs.cu",
                        "replaces": replaces, "launches": launches[name], "launches_in": run,
                        **kernels[name], "n": big, "dim": 3, "dtype": "float32"})
    entries[0]["also_replaces"] = "nbody_tpu/ops/pallas_allpairs.py:181"
    entries[0]["octree_fallback_launches"] = fallback_launches
    print(json.dumps({"kernels": entries + octree_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


OCTREE_KERNELS = {  # name -> (wrapper in ops.cuda_group_eval, twin, Pallas function replaced)
    "masked_eval_bits_kernel": ("masked_eval_bits_cuda", "masked_eval_bits_torch",
                                "nbody_tpu/ops/pallas_group_eval.py:310"),
    "window_eval_interval_kernel": ("window_eval_interval_cuda", "window_eval_interval_torch",
                                    "nbody_tpu/ops/pallas_group_eval.py:502"),
    "entries_lohi_kernel": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch",
                            "nbody_tpu/ops/pallas_group_eval.py:963"),
}


def octree_phases(dev, big: int):
    """Phase 5: the octree fast path at 2^20. Returns the JSON entries of
    its three kernels and the all-pairs kernel's fallback launches in the
    CLI runs, by dimension."""
    import torch

    from nbody_torch import cli
    from nbody_torch.models import build_model
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.ops import octree
    from nbody_torch.ops import octree_group as og

    eps = eps_of(torch.float32)
    measured = {name: {} for name in OCTREE_KERNELS}

    # -- (a) one real evaluation per dimension, its kernel inputs recorded
    for dim in (3, 2):
        cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
        depth = octree.max_depth(big, dim)
        lo, hi = octree.robust_quant_box(state.x)
        ms, xs, ks, _ = octree.morton_sort(state.m, state.x, lo, hi, depth)
        del state
        recorded = {}

        def recorder(name, fn):
            def call(*args):
                recorded[name] = args
                return fn(*args)
            return call

        wrappers = {name: getattr(og, attr) for name, (attr, _, _) in OCTREE_KERNELS.items()}
        for name, (attr, _, _) in OCTREE_KERNELS.items():
            setattr(og, attr, recorder(name, wrappers[name]))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            a, info = og.compute_force_grouped_fast(ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for name, (attr, _, _) in OCTREE_KERNELS.items():
                setattr(og, attr, wrappers[name])
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        counters = {k: int(v) for k, v in info.items()}
        print(f"[5a] {big}-body {dim}-D galaxy, one octree force evaluation: {wall:.3f} s wall "
              f"(first call), peak memory above its inputs {peak:.2f} GiB; {counters}")
        check(bool(torch.isfinite(a).all()), "octree force is not finite")
        check(set(recorded) == set(OCTREE_KERNELS), f"kernels called: {sorted(recorded)}")
        for name, (attr, twin_attr, _) in OCTREE_KERNELS.items():
            args = recorded[name]
            kern, twin = getattr(cg, attr), getattr(cg, twin_attr)
            got = kern(*args)  # warm-up launch
            kms = event_ms(lambda: kern(*args), reps=5)
            plain_ms, ref = event_ms(lambda: twin(*args), reps=1, keep=True)
            scale = twin(*args, absolute=True)
            err, abs_err = scaled(got, ref, scale)
            # both against the twin in float64 on the same inputs
            ref64 = twin(*(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
                           else a for a in args))
            err64 = [scaled(v, ref64, scale)[0] for v in (got, ref)]
            print(f"[5a] {name} at the {dim}-D 2^20 shapes: kernel {kms:.3f} ms, plain {plain_ms:.1f} "
                  f"ms; max |kernel - plain| / sum|term| = {err:.3e} (limit 1e-5); against float64: "
                  f"kernel {err64[0]:.3e}, plain {err64[1]:.3e}")
            check(err <= 1e-5, f"{name} {dim}-D: scaled error {err:.3e} above 1e-5")
            measured[name][dim] = {"ms": kms, "plain_ms": plain_ms, "max_abs_err": abs_err,
                                   "max_scaled_err": err, "max_scaled_err_vs_float64": err64[0]}
            del got, ref, ref64, scale
        del recorded
        if dim == 3:
            # -- (c) the 3-D force against the exact sqrt3 sum on the same bodies
            ref = cfg.G * ca.allpairs_block_cuda(xs, ms, xs, eps, "sqrt3")
            rel = ((a - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).double()
            med, p99 = (torch.quantile(rel, q).item() for q in (0.5, 0.99))
            print(f"[5c] {big}-body 3-D octree vs sqrt3 all-pairs, per-body relative error: "
                  f"median {med:.3e}, p99 {p99:.3e}, max {rel.max().item():.3e} "
                  f"(limits: median 1e-3, p99 1e-2)")
            check(med <= 1e-3 and p99 <= 1e-2, "octree force far from the direct sum")
            del ref, rel
        del a, ms, xs, ks
        torch.cuda.empty_cache()

    # -- (b) the CLI at full size; counts from 0 just before each run ------
    launches = {}
    for dim in (3, 2):
        ca.reset_launch_counts()
        cg.reset_launch_counts()
        argv = ["-n", str(big), "-s", "12", "-d", str(dim), "--algorithm", "octree",
                "--workload", "galaxy", "--device", "cuda", "--csv-total"]
        out = io.StringIO()
        t0 = time.perf_counter()
        rc = cli.main(argv, out=out)
        wall = time.perf_counter() - t0
        launches[dim] = {**cg.launch_counts, "allpairs_block_kernel": ca.launch_counts[
            "allpairs_block_kernel"]}
        lines = out.getvalue().strip().splitlines()
        check(rc == 0 and len(lines) == 2 and lines[0] == "algorithm,dim,precision,nsteps,nbodies,"
              "total [s]", f"octree CLI run failed: rc={rc}, output {lines!r}")
        fields = lines[1].split(",")
        check(fields[:5] == ["octree", str(dim), "32", "2", str(big)], f"CSV row {lines[1]!r}")
        print(f"[5b] python -m nbody_torch.cli {' '.join(argv)}")
        print(f"[5b]   {lines[1]}  ->  {float(fields[5]) / 2:.3f} s/step; wall {wall:.1f} s with "
              f"model build and warmup; launches {launches[dim]}")
        for name in OCTREE_KERNELS:
            check(launches[dim][name] > 0, f"{name} was not launched in the {dim}-D octree run")

    # -- (d) 17,000 bodies, 3-D: the card against the CPU twins -------------
    rng = np.random.default_rng(11)
    n, dim = 17000, 3
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    m = rng.uniform(0.1, 1, n).astype(np.float32)
    depth = octree.max_depth(n, dim)
    runs = []
    for device in (dev, torch.device("cpu")):
        lo, hi = octree.robust_quant_box(torch.tensor(x, device=device))
        ms, xs, ks, _ = octree.morton_sort(torch.tensor(m, device=device),
                                           torch.tensor(x, device=device), lo, hi, depth)
        a, info = og.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, eps)
        runs.append((a.cpu(), {k: int(v) for k, v in info.items()}))
    (ga, ginfo), (pa, pinfo) = runs
    rel = ((ga - pa).abs().sum() / pa.abs().sum()).item()
    print(f"[5d] {n}-body 3-D clusters, card vs CPU twins: sum|diff| / sum|a| = {rel:.3e} "
          f"(limit 1e-5); counters {'equal' if ginfo == pinfo else 'DIFFER'}: {ginfo}")
    check(ginfo == pinfo, f"counters differ: card {ginfo}, CPU {pinfo}")
    check(rel <= 1e-5, "card and CPU octree forces differ")

    entries = []
    for name, (_, _, replaces) in OCTREE_KERNELS.items():
        entries.append({"name": name, "route": "cuda", "source": "nbody_torch/csrc/group_eval.cu",
                        "replaces": replaces, "launches": launches[3][name],
                        "launches_in": f"phase 5b: {big}-body 3-D octree --csv-total",
                        **measured[name][3], "n": big, "dim": 3, "dtype": "float32",
                        "launches_2d": launches[2][name], "2d": measured[name][2]})
    return entries, {dim: launches[dim]["allpairs_block_kernel"] for dim in (3, 2)}


def eps_of(dtype) -> float:
    import torch

    return float(torch.finfo(dtype).eps)


def event_ms(fn, reps: int, keep: bool = False):
    """Mean milliseconds of `reps` calls of fn, timed with CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    return (ms, out) if keep else ms


def read_state(path: str) -> np.ndarray:
    """The loadable state format (nbody_torch.io.saving): (n, 1 + 2*dim) float32."""
    with open(path, "rb") as f:
        n, dim = struct.unpack("<II", f.read(8))
        f.read(8)
        return np.frombuffer(f.read(), np.float32).reshape(n, 1 + 2 * dim)


if __name__ == "__main__":
    sys.exit(main())
