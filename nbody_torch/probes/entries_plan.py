"""The entries kernel's plan at other part counts (python -m nbody_torch.probe
entries-plan): a one-off design sweep, not a port of a TPU script.

One force evaluation of each f32 fast path (the octree's near field,
sqrt3; the BVH's residual, poly) on an n-body galaxy records the call of
entries_lohi_eval_cuda that the path makes. That call is then timed again
on plans of other targets: one part a tile (parts=1, the grid of one
block a tile), one part a tile on average (ntiles), and a quarter, a
half, 1, 2 and 4 times plan_target's default. It also times the plan
alone (entries_plan on the recorded inputs). Each (tree, dim) gives one
JSON line: probe, tree, dim, n, the default target, ms by target, plan_ms,
the device and the launches.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nbody_torch.models import build_model
from nbody_torch.ops import bvh, octree
from nbody_torch.ops import bvh_group as bg
from nbody_torch.ops import cuda_group_eval as cg
from nbody_torch.ops import octree_group as og
from nbody_torch.probes import device_name, log

REPS = 3


def timed_ms(fn, dev: torch.device, reps: int = REPS) -> float:
    """Mean milliseconds of `reps` calls of fn after one untimed call: CUDA
    events on a GPU, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def recorded_call(tree: str, n: int, dim: int, dev: torch.device) -> tuple:
    """The positional args of the entries call that one fast-path force
    evaluation of tree `tree` makes on an n-body galaxy."""
    cfg, state = build_model("galaxy", n, dim, np.float32, device=dev)
    module = og if tree == "octree" else bg
    seen = []
    wrapper = module.entries_lohi_eval_cuda

    def keep(*args, **kwargs):
        seen.append(args)
        return wrapper(*args, **kwargs)

    module.entries_lohi_eval_cuda = keep
    try:
        if tree == "octree":
            depth = octree.max_depth(n, dim)
            lo, hi = octree.robust_quant_box(state.x)
            ms, xs, ks, _ = octree.morton_sort(state.m, state.x, lo, hi, depth)
            og.compute_force_grouped_fast(ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps)
        else:
            state = bvh.hilbert_sort(state, cfg.eps)
            t = bvh.build_tree(state.m, state.x, cfg.eps)
            bg.compute_force_grouped_windowed(t, state.m, state.x, cfg.theta, cfg.G, cfg.eps)
    finally:
        module.entries_lohi_eval_cuda = wrapper
    if len(seen) != 1:
        raise RuntimeError(f"the {tree} evaluation made {len(seen)} entries calls, not 1")
    return seen[0]


def run(out: str, n: int, dims: tuple[int, ...], dev: torch.device) -> None:
    """Sweep both trees in each dimension; one JSON line each."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    for tree in ("octree", "bvh"):
        for dim in dims:
            args = recorded_call(tree, n, dim, dev)
            ents, lohis, n_real, S, ntiles = args[3], args[4], args[5], args[6], args[7]
            target = cg.plan_target(ents.shape[0], S, ntiles, sms)
            targets = sorted({1, ntiles, max(1, target // 4), max(1, target // 2), target,
                              2 * target, 4 * target})
            cg.reset_launch_counts()
            ms = {p: timed_ms(lambda p=p: cg.entries_lohi_eval_cuda(*args, parts=p), dev)
                  for p in targets}
            _, start, stop = cg.lohi_ranges(ents, lohis, S)
            nj = args[1].shape[0]
            start, stop = start.clamp_max(nj), stop.clamp_max(nj)
            plan_ms = timed_ms(lambda: cg.entries_plan(ents, start, stop, n_real, ntiles, target),
                               dev)
            log(out, {"probe": "entries_plan", "tree": tree, "dim": dim, "n": n,
                      "softening": args[9], "ntiles": ntiles, "default_target": target,
                      "ms_by_target": ms, "plan_ms": plan_ms, "reps": REPS,
                      "device": device_name(dev),
                      "launches": {k: v for k, v in cg.launch_counts.items() if v}})
            del args
            if dev.type == "cuda":
                torch.cuda.empty_cache()
