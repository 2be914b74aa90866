"""Time the octree's interval window and the sum passes of the nbody_torch
found under ROOT, for comparing two checkouts on one card:

    python nbody_torch/probes/compare_trees.py ROOT [OUT]

Run it as a file (not with -m), once per checkout, in turns (parent,
change, change, parent) on one card: it imports nbody_torch
from ROOT, so an older checkout is timed with its own kernels and
wrappers. Prints one JSON line (appended to OUT too, if given):

  interval_{3,2}d_ms   window_eval_interval_cuda on the call that one f32
                       octree force evaluation of a 2^20-body galaxy makes
                       (recorded from it), CUDA events over 10 calls;
  parts_sum_*_ms       parts_sum_cuda on random partial rows of 2,048 tiles
                       of 512 rows, 4 parts a tile: float32 in 3-D and 2-D
                       with every part written, float64 in 3-D with none (the
                       f64 octree list path's 3-D case); on the device alone,
                       the calls queued behind a sleep kernel;
  *_call_ms            the same calls back to back (their host cost shows);
  *_torch_sum_ms       torch.sum over the same parts, on the device alone;
  entries_sum_{3,2}d_ms entries_sum_cuda on the float32 parts, 4 a tile.
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


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device ms of `reps` calls queued behind a sleep kernel that
    outlasts their enqueueing (checked), after one warm-up."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(int(1.98e9 * 500e-6 * reps))
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


def interval_call(dim: int, dev: torch.device, build_model, octree, og) -> tuple:
    """The args of the interval window call of one f32 octree evaluation."""
    cfg, state = build_model("galaxy", N, dim, np.float32, device=dev)
    depth = octree.max_depth(N, dim)
    lo, hi = octree.robust_quant_box(state.x)
    ms, xs, ks, _ = octree.morton_sort(state.m, state.x, lo, hi, depth)
    seen, wrapper = {}, og.window_eval_interval_cuda

    def record(*args, **kwargs):
        seen["args"] = args
        return wrapper(*args, **kwargs)

    og.window_eval_interval_cuda = record
    try:
        og.compute_force_grouped_fast(ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps)
    finally:
        og.window_eval_interval_cuda = wrapper
    return seen["args"]


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("compare_trees needs a CUDA GPU")
    root = argv[0] if argv else "."
    sys.path.insert(0, root)  # the checkout's nbody_torch, not this file's
    build_model = importlib.import_module("nbody_torch.models").build_model
    cg, octree, og = (importlib.import_module(f"nbody_torch.ops.{name}")
                      for name in ("cuda_group_eval", "octree", "octree_group"))
    dev = torch.device("cuda", 0)
    row = {"root": root, "module": cg.__file__, "device": torch.cuda.get_device_name(0)}
    for dim in (3, 2):
        args = interval_call(dim, dev, build_model, octree, og)
        row[f"interval_{dim}d_ms"] = events_ms(lambda: cg.window_eval_interval_cuda(*args), 10)
        del args
        torch.cuda.empty_cache()
    for dim, dtype, written in ((3, torch.float32, P), (2, torch.float32, P),
                                (3, torch.float64, 0)):
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
