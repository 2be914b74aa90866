"""Time the tree kernels, the sum passes, the small BVH runs and the all-pairs
variants of the nbody_torch found under ROOT, for comparing two checkouts on
one card:

    python nbody_torch/probes/compare_trees.py ROOT [OUT] [--allpairs-only | --walks-only]

Run it as a file (not with -m), once per checkout, in turns (parent,
change, change, parent) on one card: it imports nbody_torch
from ROOT, so an older checkout is timed with its own kernels and
wrappers. Prints one JSON line (appended to OUT too, if given):

  interval_{3,2}d_ms   window_eval_interval_cuda on the call that one f32
                       octree force evaluation of a 2^20-body galaxy makes
                       (recorded from it), CUDA events over 10 calls;
  far_sqrt3_{3,2}d_ms  masked_eval_bits_cuda on the same evaluation's call,
                       on the device alone (the calls queued behind a
                       sleep kernel);
  far_poly_{3,2}d_ms   the same on the call of one f32 BVH force evaluation
                       of a 2^20-body galaxy;
  densemask_{sqrt3,poly}_{3,2}d_ms  masked_eval_cuda on the call of one such
                       octree (sqrt3) or BVH (poly) evaluation with
                       ablate="densemask", on the device alone;
  shared_{farcompact,desc1,desc2}_{3,2}d_ms  group_shared_masked_eval_cuda on
                       the call of one such octree evaluation with that
                       ablate token, on the device alone;
  *_zero_ms, *_light_ms, *_heavy_share  for those octree calls (sqrt3):
                       the same call with every weight zero (the weights'
                       stream and the blocks' fixed work alone), and with
                       the weights of its heaviest 5% of tiles (by nonzero
                       weights) zeroed, and those tiles' share of the
                       nonzero weights;
  dense_{3,2}d_ms      window_eval_dense_cuda on a synthetic 2^20 window:
                       that BVH evaluation's node-mask window call, its
                       slots broadcast over their S bodies as a float mask,
                       CUDA events over 3 calls;
  dense_n16_{3,2}d_ms  window_eval_dense_cuda on the call of a 16-body BVH
                       evaluation (theta 0) on the device alone (the call
                       and any second pass), *_call_ms back to back,
                       *_host_ms the host's time to enqueue one call;
  small_{n10,n16}_s_per_step  -n 10 -s 1010 --algorithm bvh --theta 0 and
                       -n 16 -s 1010 --algorithm bvh through the CLI with
                       --csv-total: the total over 1,000 timed steps;
  parts_sum_*_ms       parts_sum_cuda on random partial rows of 2,048 tiles
                       of 512 rows, 4 parts a tile: float32 in 3-D and 2-D
                       with every part written, float64 in 3-D with none (the
                       f64 octree list path's 3-D case); on the device alone;
  *_call_ms            the same calls back to back (their host cost shows);
  *_torch_sum_ms       torch.sum over the same parts, on the device alone;
  entries_sum_{3,2}d_ms entries_sum_cuda on the float32 parts, 4 a tile;
  allpairs_{newton,fast,mxu,mxu_fast}_ms  one 2^20 3-D float32 evaluation
                       by kernel_bench's call of each kernel (newton, fast,
                       mxu, mxu-fast) on its inputs Hilbert-sorted (bench.py's
                       all-pairs bodies), CUDA events over 3 calls;
  decide_{fast,mxu,mxu_fast}_ms  where ROOT has ops/cuda_variant_decide, its
                       decision (tile statistics and table) for the same
                       bodies and each variant's tiles, over 10 calls.
  walk_{bvh,octree}_{3d,3d_f64,2d}_ms  ops.bvh.compute_force and
                       ops.octree.compute_force (the per-body walks, the
                       octree's with its pack) on a 2^20-body galaxy's tree
                       (3-D float32, 3-D float64, 2-D float32), CUDA events
                       over 3 calls; where ROOT has octree_records_cuda,
                       pack_octree_*_ms the pack alone, over 10 calls.
--allpairs-only runs the all-pairs keys alone, --walks-only the walks'.
"""

import importlib
import json
import sys
import time

import numpy as np
import torch

N, NTILES, P, TB = 1 << 20, 2048, 4, 512
REPS = 20


def events_ms(fn, reps: int) -> float:
    """Mean ms of `reps` calls back to back after one warm-up (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = REPS) -> float:
    """Mean host ms to enqueue one of `reps` calls, after one warm-up and
    a sync (few enough calls that the launch queue never fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_ms(fn, reps: int = REPS, sleep_us: float = 500.0) -> float:
    """Mean device ms of `reps` calls queued behind a sleep kernel of
    sleep_us a call that outlasts their enqueueing (checked), after one
    warm-up."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(int(1.98e9 * sleep_us * 1e-6 * reps))
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError(f"enqueueing took {host_ms:.3f} ms, longer than the sleep")
    return ev[1].elapsed_time(ev[2]) / reps


def recorded(module, names, run) -> dict:
    """name -> the positional args of module.<name>'s last call while run()
    ran."""
    seen, saved = {}, {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            seen[name] = args
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        run()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    return seen


# the octree's ablate tokens timed, each the wrapper it calls and its key
OCTREE_TOKENS = {"densemask": ("masked_eval_cuda", "densemask_sqrt3"),
                 "farcompact": ("group_shared_masked_eval_cuda", "shared_farcompact"),
                 "desc1": ("group_shared_masked_eval_cuda", "shared_desc1"),
                 "desc2": ("group_shared_masked_eval_cuda", "shared_desc2")}


def weight_variants(args) -> tuple:
    """A weighted far-field call's args (mask 4th) with every weight zero,
    and with the weights of its heaviest 5% of tiles zeroed; and those
    tiles' share of the nonzero weights."""
    mask = args[3]
    kept = (mask != 0).sum(1).double()
    heavy = kept >= torch.quantile(kept, 0.95)
    light = mask.masked_fill(heavy[:, None], 0)
    return ((*args[:3], torch.zeros_like(mask), *args[4:]), (*args[:3], light, *args[4:]),
            (kept[heavy].sum() / kept.sum()).item())


def octree_calls(dim: int, dev: torch.device, build_model, octree, og) -> dict:
    """The interval window's and the far field's call args of one f32
    octree evaluation of a 2^20-body galaxy, and under each token of
    OCTREE_TOKENS its wrapper's call args of one evaluation of the same
    bodies with that ablate token."""
    cfg, state = build_model("galaxy", N, dim, np.float32, device=dev)
    depth = octree.max_depth(N, dim)
    lo, hi = octree.robust_quant_box(state.x)
    ms, xs, ks, _ = octree.morton_sort(state.m, state.x, lo, hi, depth)

    def run(ablate=""):
        og.compute_force_grouped_fast(ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps, ablate=ablate)
    calls = recorded(og, ["window_eval_interval_cuda", "masked_eval_bits_cuda"], run)
    for token, (name, _) in OCTREE_TOKENS.items():
        calls[token] = recorded(og, [name], lambda: run(token))[name]
    return calls


def bvh_calls(n: int, dim: int, theta, dev: torch.device, build_model, bvh, bg,
              densemask: bool = False) -> dict:
    """The far field's and the window's call args of one f32 BVH evaluation
    of an n-body galaxy (theta None: the model's), and with densemask the
    dense-mask far field's call args of one evaluation of the same tree
    with ablate="densemask" under "densemask"."""
    cfg, state = build_model("galaxy", n, dim, np.float32, device=dev)
    state = bvh.hilbert_sort(state, cfg.eps)
    tree = bvh.build_tree(state.m, state.x, cfg.eps)

    def run(ablate=""):
        bg.compute_force_grouped_windowed(tree, state.m, state.x,
                                          cfg.theta if theta is None else theta, cfg.G, cfg.eps,
                                          ablate=ablate)
    names = ["masked_eval_bits_cuda", "window_eval_nodemask_cuda", "window_eval_dense_cuda"]
    calls = recorded(bg, names, run)
    if densemask:
        calls["densemask"] = recorded(bg, ["masked_eval_cuda"],
                                      lambda: run("densemask"))["masked_eval_cuda"]
    return calls


SMALL_RUNS = {"n10": ["-n", "10", "-s", "1010", "--algorithm", "bvh", "--theta", "0"],
              "n16": ["-n", "16", "-s", "1010", "--algorithm", "bvh"]}


def small_run_step(cli, argv) -> float:
    """s/step of a small CLI run on the card: the --csv-total total over
    its timed steps."""
    import io

    out = io.StringIO()
    if cli.main([*argv, "--device", "cuda", "--csv-total"], out=out) != 0:
        raise RuntimeError(f"{' '.join(argv)} failed: {out.getvalue()}")
    fields = out.getvalue().strip().splitlines()[1].split(",")
    return float(fields[5]) / int(fields[3])


def allpairs_row(dev: torch.device) -> dict:
    """The all-pairs keys: kernel_bench's calls at 2^20 3-D on its inputs,
    Hilbert-sorted, and the decision alone where the checkout has one."""
    kb = importlib.import_module("nbody_torch.kernel_bench")
    aabb_of_points = importlib.import_module("nbody_torch.ops.geometry").aabb_of_points
    hilbert_sort_perm = importlib.import_module("nbody_torch.ops.hilbert").hilbert_sort_perm
    eps = float(np.finfo(np.float32).eps)
    m, x = (torch.tensor(a, device=dev) for a in kb.inputs(N, 3))
    perm = hilbert_sort_perm(x, *aabb_of_points(x, eps))
    m, x = m[perm].contiguous(), x[perm].contiguous()
    row = {}
    for kernel in ("newton", "fast", "mxu", "mxu-fast"):
        accel = kb.accel_fn(kernel, eps)
        row[f"allpairs_{kernel.replace('-', '_')}_ms"] = events_ms(lambda: accel(m, x), 3)
    try:
        vd = importlib.import_module("nbody_torch.ops.cuda_variant_decide")
    except ImportError:
        return row
    near_coef = float(np.float32(1e5 * eps))
    fast_thresh = float((eps / 1e-6) ** (2.0 / 3.0))  # cuda_allpairs.far_threshold
    for mode, thresh in (("fast", fast_thresh), ("mxu", 0.0), ("mxu-fast", 1e-2)):
        row[f"decide_{mode.replace('-', '_')}_ms"] = events_ms(
            lambda: vd.decide_cuda(x, mode, N, 512, 1024, near_coef, thresh), 10)
    return row


WALK_CONFIGS = (("3d", 3, np.float32), ("3d_f64", 3, np.float64), ("2d", 2, np.float32))


def walk_row(dev: torch.device, build_model) -> dict:
    """The walk keys: each tree's compute_force on a 2^20-body galaxy."""
    bvh, octree, tw = (importlib.import_module(f"nbody_torch.ops.{name}")
                       for name in ("bvh", "octree", "cuda_tree_walk"))
    scalar_bounds = importlib.import_module("nbody_torch.ops.geometry").scalar_bounds
    row = {}
    for key, dim, dtype in WALK_CONFIGS:
        cfg, state = build_model("galaxy", N, dim, dtype, device=dev)
        th, G, eps = cfg.theta, cfg.G, cfg.eps
        st = bvh.hilbert_sort(state, eps)
        tree = bvh.build_tree(st.m, st.x, eps)
        lo, hi = scalar_bounds(state.x)
        levels, _, ms, xs = octree.build_octree(state.m, state.x, lo, hi,
                                                octree.max_depth(N, dim))
        calls = {"bvh": (tw.BVH_WALK, lambda: bvh.compute_force(tree, st.m, st.x, th, G, eps)),
                 "octree": (tw.OCTREE_WALK,
                            lambda: octree.compute_force(levels, ms, xs, hi - lo, th, G, eps))}
        for walk, (name, call) in calls.items():
            row[f"walk_{walk}_{key}_ms"] = events_ms(call, 3)
        if hasattr(tw, "octree_records_cuda"):
            row[f"pack_octree_{key}_ms"] = events_ms(
                lambda: tw.octree_records_cuda(levels, ms, xs), 10)
        del state, st, tree, levels, ms, xs, calls
        torch.cuda.empty_cache()
    return row


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("compare_trees needs a CUDA GPU")
    allpairs_only, walks_only = "--allpairs-only" in argv, "--walks-only" in argv
    argv = [a for a in argv if a not in ("--allpairs-only", "--walks-only")]
    root = argv[0] if argv else "."
    sys.path.insert(0, root)  # the checkout's nbody_torch, not this file's
    build_model = importlib.import_module("nbody_torch.models").build_model
    cg, octree, og = (importlib.import_module(f"nbody_torch.ops.{name}")
                      for name in ("cuda_group_eval", "octree", "octree_group"))
    dev = torch.device("cuda", 0)
    row = {"root": root, "module": cg.__file__, "device": torch.cuda.get_device_name(0)}
    row.update(walk_row(dev, build_model) if walks_only else allpairs_row(dev))
    trees = not (allpairs_only or walks_only)
    bvh, bg, cli = (importlib.import_module(f"nbody_torch.{name}")
                    for name in ("ops.bvh", "ops.bvh_group", "cli"))
    for dim in (3, 2) if trees else ():
        calls = octree_calls(dim, dev, build_model, octree, og)
        args = calls["window_eval_interval_cuda"]
        row[f"interval_{dim}d_ms"] = events_ms(lambda: cg.window_eval_interval_cuda(*args), 10)
        args = calls["masked_eval_bits_cuda"]
        row[f"far_sqrt3_{dim}d_ms"] = device_ms(lambda: cg.masked_eval_bits_cuda(*args))
        for token, (name, key) in OCTREE_TOKENS.items():
            args, fn = calls[token], getattr(cg, name)
            row[f"{key}_{dim}d_ms"] = device_ms(lambda: fn(*args))
            zero, light, row[f"{key}_{dim}d_heavy_share"] = weight_variants(args)
            row[f"{key}_{dim}d_zero_ms"] = device_ms(lambda: fn(*zero))
            row[f"{key}_{dim}d_light_ms"] = device_ms(lambda: fn(*light))
            del zero, light
        del calls, args
        torch.cuda.empty_cache()
        calls = bvh_calls(N, dim, None, dev, build_model, bvh, bg, densemask=True)
        args = calls["masked_eval_bits_cuda"]
        row[f"far_poly_{dim}d_ms"] = device_ms(lambda: cg.masked_eval_bits_cuda(*args))
        args = calls["densemask"]
        row[f"densemask_poly_{dim}d_ms"] = device_ms(lambda: cg.masked_eval_cuda(*args))
        xi, mj, xj, w0, in_win, eps, wt, S, softening = calls["window_eval_nodemask_cuda"]
        mask = in_win.to(torch.float32).repeat_interleave(S, dim=1).contiguous()
        args = (xi, mj, xj, w0, mask, eps, wt, softening)
        row[f"dense_{dim}d_ms"] = events_ms(lambda: cg.window_eval_dense_cuda(*args), 3)
        del calls, args, mask, xi, mj, xj, w0, in_win
        torch.cuda.empty_cache()
        args = bvh_calls(16, dim, 0.0, dev, build_model, bvh, bg)["window_eval_dense_cuda"]
        row[f"dense_n16_{dim}d_ms"] = device_ms(lambda: cg.window_eval_dense_cuda(*args))
        row[f"dense_n16_{dim}d_call_ms"] = events_ms(lambda: cg.window_eval_dense_cuda(*args),
                                                     REPS)
        row[f"dense_n16_{dim}d_host_ms"] = host_ms(lambda: cg.window_eval_dense_cuda(*args), 200)
    for key, run in SMALL_RUNS.items() if trees else ():
        row[f"small_{key}_s_per_step"] = small_run_step(cli, run)
    for dim, dtype, written in ((3, torch.float32, P), (2, torch.float32, P),
                                (3, torch.float64, 0)) if trees else ():
        parts = torch.rand((NTILES * P, TB, dim), dtype=dtype, device=dev)
        nparts = torch.full((NTILES,), written, dtype=torch.int32, device=dev)
        key = f"parts_sum_{str(dtype).removeprefix('torch.')}_{dim}d_{written}parts"
        row[f"{key}_ms"] = device_ms(lambda: cg.parts_sum_cuda(parts, nparts, P))
        row[f"{key}_call_ms"] = events_ms(lambda: cg.parts_sum_cuda(parts, nparts, P), REPS)
        view = parts.view(NTILES, P, TB * dim)
        row[f"{key}_torch_sum_ms"] = device_ms(lambda: torch.sum(view, 1))
        if dtype == torch.float32:
            start = torch.arange(0, NTILES * P + 1, P, dtype=torch.int32, device=dev)
            row[f"entries_sum_{dim}d_ms"] = device_ms(lambda: cg.entries_sum_cuda(parts, start))
        del parts
    line = json.dumps(row)
    print(line)
    if len(argv) > 1:
        with open(argv[1], "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
