"""The list kernel and the two windows on other part counts (python -m
nbody_torch.probe split-parts): a one-off design sweep, not a port of a TPU
script.

The three kernels split each tile's work in the kernel into at most P parts
a tile, P from shapes alone (cuda_group_eval.split_parts). One force
evaluation of the f32 octree fast path records its interval window call,
one of the f32 BVH fast path its node-mask window call, and one f64
list-path evaluation of each tree records its list kernel call and the
heads before the fallback's tiles were zeroed (live_heads). Each call is
then timed at P = 1, 2, 4, 8 and the default: the windows as recorded; the
list on the CLI's work (the recorded heads) and on every tile's heads
(nbody_tpu's work). One JSON line per (kernel, tree, dim): probe, kernel,
tree, dim, n, the default P, ms by P (the list's by work), the live tiles,
the device and the launches.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.models import build_model
from nbody_torch.ops import bvh, octree
from nbody_torch.ops import bvh_group as bg
from nbody_torch.ops import cuda_allpairs as ca
from nbody_torch.ops import cuda_group_eval as cg
from nbody_torch.ops import octree_group as og
from nbody_torch.ops.geometry import scalar_bounds
from nbody_torch.probes import device_name, log
from nbody_torch.probes.entries_plan import timed_ms

PARTS = (1, 2, 4, 8)


def _recorded(module, names, run) -> dict:
    """name -> the positional args of its last call while run() ran."""
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


def interval_call(n: int, dim: int, dev: torch.device) -> tuple:
    """The window_eval_interval_cuda args of one f32 octree force evaluation."""
    cfg, state = build_model("galaxy", n, dim, np.float32, device=dev)
    depth = octree.max_depth(n, dim)
    lo, hi = octree.robust_quant_box(state.x)
    ms, xs, ks, _ = octree.morton_sort(state.m, state.x, lo, hi, depth)
    return _recorded(og, ["window_eval_interval_cuda"], lambda: og.compute_force_grouped_fast(
        ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps))["window_eval_interval_cuda"]


def window_call(n: int, dim: int, dev: torch.device) -> tuple:
    """The window_eval_nodemask_cuda args of one f32 BVH force evaluation."""
    cfg, state = build_model("galaxy", n, dim, np.float32, device=dev)
    state = bvh.hilbert_sort(state, cfg.eps)
    tree = bvh.build_tree(state.m, state.x, cfg.eps)
    return _recorded(bg, ["window_eval_nodemask_cuda"], lambda: bg.compute_force_grouped_windowed(
        tree, state.m, state.x, cfg.theta, cfg.G, cfg.eps))["window_eval_nodemask_cuda"]


def list_call(tree: str, n: int, dim: int, dev: torch.device) -> tuple[tuple, tuple]:
    """The group_eval_cuda args of one f64 list-path evaluation, and its
    heads with every tile live (live_heads' inputs)."""
    cfg, state = build_model("galaxy", n, dim, np.float64, device=dev)
    if tree == "octree":
        lo, hi = scalar_bounds(state.x)
        levels, _, m, x = octree.build_octree(state.m, state.x, lo, hi, octree.max_depth(n, dim))
        module, args = og, (levels, m, x, hi - lo)
    else:
        st = bvh.hilbert_sort(state, cfg.eps)
        module, args = bg, (bvh.build_tree(st.m, st.x, cfg.eps), st.m, st.x)
    seen = _recorded(module, ["group_eval_cuda", "live_heads"], lambda: module.compute_force_grouped(
        *args, cfg.theta, cfg.G, cfg.eps))
    ncnt, lcnt, _ = seen["live_heads"]
    return seen["group_eval_cuda"], (ncnt.to(torch.int32), lcnt.to(torch.int32))


def run(out: str, n: int, dims: tuple[int, ...], dev: torch.device) -> None:
    """Sweep the windows (octree interval, BVH node-mask) and the list
    (both trees) in each dimension."""
    sms = ca.sm_count_of(dev.index) if dev.type == "cuda" else 132
    for dim in dims:
        for tree, kernel, call, wt_arg in (
                ("octree", "window_eval_interval_kernel<sqrt3>", cg.window_eval_interval_cuda, 7),
                ("bvh", "window_eval_nodemask_kernel<poly>", cg.window_eval_nodemask_cuda, 6)):
            args = (interval_call if tree == "octree" else window_call)(n, dim, dev)
            w0, tb = args[3], args[0].shape[0] // args[3].shape[0]
            default = cg.split_parts(w0.shape[0], args[wt_arg] * tb, sms)
            cg.reset_launch_counts()
            ms = {p: timed_ms(lambda p=p: call(*args, parts=p), dev)
                  for p in sorted({*PARTS, default})}
            log(out, {"probe": "split_parts", "kernel": kernel, "tree": tree, "dim": dim, "n": n,
                      "default_parts": default, "ms_by_parts": ms, "device": device_name(dev),
                      "launches": {k: v for k, v in cg.launch_counts.items() if v}})
            del args
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        for tree in ("octree", "bvh"):
            args, every = list_call(tree, n, dim, dev)
            xi, mj = args[0], args[1]
            ntiles = mj.shape[0]
            cg.reset_launch_counts()
            ms = {}
            default = cg.split_parts(ntiles, mj.shape[1], sms)
            for work, heads in (("cli", args[6:8]), ("all_live", every)):
                ms[work] = {p: timed_ms(lambda p=p, heads=heads: cg.group_eval_cuda(
                                *args[:6], *heads, parts=p), dev)
                            for p in sorted({*PARTS, default})}
            log(out, {"probe": "split_parts", "kernel": f"group_eval_kernel<float64, {args[4]}>",
                      "tree": tree, "dim": dim, "n": n, "default_parts": default,
                      "ms_by_parts": ms, "live_tiles": int(((args[6] + args[7]) > 0).sum()),
                      "ntiles": ntiles, "device": device_name(dev),
                      "launches": {k: v for k, v in cg.launch_counts.items() if v}})
            del args, every
            if dev.type == "cuda":
                torch.cuda.empty_cache()
