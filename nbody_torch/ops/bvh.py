"""Hilbert-sorted implicit BVH (the port of nbody_tpu.ops.bvh).

The reference's tree (src/bvh.h) is already level-synchronous and
pointer-free:
  * the bodies are sorted along a Hilbert curve (ops.hilbert);
  * the tree is a complete binary heap over the sorted bodies, with
    nleafs = bit_ceil(n) (bvh.h:151); level l fills heap slots
    [2^l - 1, 2^(l+1) - 1), and node l's children are 2l+1 and 2l+2;
  * the deepest stored level pairs the bodies two by two (bvh.h:177-207),
    and zero mass marks a dead padding node (bvh.h:186);
  * the refit is one whole-level pass per level (bvh.h:210-243).

The force comes from ops.bvh_group.compute_force_grouped_windowed (the
group traversal's fast path, float32), or from its list path,
ops.bvh_group.compute_force_grouped (float64 runs, and --kernel torch).
The sort physically reorders the body arrays every step and they stay
reordered, as in the reference: the body order is user-visible. The
per-body walk is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from nbody_torch.ops.geometry import aabb_of_points
from nbody_torch.ops.hilbert import hilbert_keys, quantize
from nbody_torch.ops.permutation import sort_rows_by_key
from nbody_torch.state import SystemState


def _bit_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _weighted_sum(ml: torch.Tensor, xl: torch.Tensor, mr: torch.Tensor,
                  xr: torch.Tensor) -> torch.Tensor:
    return ml[:, None] * xl + mr[:, None] * xr


@dataclasses.dataclass
class BVHTree:
    """Flat heap-ordered node arrays (sized 2^nlevels - 1)."""
    mm: torch.Tensor  # (nnodes,)     node masses (0 = dead)
    mx: torch.Tensor  # (nnodes, dim) node centres of mass
    bw: torch.Tensor  # (nnodes,)     node widths (largest box side)
    nlevels: int      # levels excluding the leaf (body) level


def build_tree(m: torch.Tensor, x: torch.Tensor, eps: float) -> BVHTree:
    """Level-synchronous refit over Hilbert-sorted bodies (bvh.h:174-244),
    in nbody_tpu's arithmetic (bvh.py:58-126)."""
    n, dim = x.shape
    dtype, dev = x.dtype, x.device
    nleafs = _bit_ceil(max(n, 2))
    nlevels = nleafs.bit_length() - 1
    last_level = nlevels - 1
    tol = torch.full((), 10.0 * eps, dtype=dtype, device=dev)
    zero = x.new_zeros(())
    one = x.new_ones(())

    # deepest stored level: one node per body pair (bvh.h:177-207)
    bl = torch.arange(1 << last_level, device=dev) * 2
    br = bl + 1
    has_l, has_r = bl < n, br < n
    xlb, xrb = x[bl.clamp(0, n - 1)], x[br.clamp(0, n - 1)]
    mlb = torch.where(has_l, m[bl.clamp(0, n - 1)], zero)
    mrb = torch.where(has_r, m[br.clamp(0, n - 1)], zero)
    mass = mlb + mrb
    com_pair = _weighted_sum(mlb, xlb, mrb, xrb) / torch.where(mass == 0, one, mass)[:, None]
    com = torch.where(has_r[:, None], com_pair, xlb)  # a one-body node sits on its body
    com = torch.where(has_l[:, None], com, zero)
    bmin = torch.where(has_r[:, None], torch.minimum(xlb, xrb) - tol, xlb - tol)
    bmax = torch.where(has_r[:, None], torch.maximum(xlb, xrb) + tol, xlb + tol)
    width = torch.where(has_l, (bmax - bmin).amax(1), zero)
    mass = torch.where(has_l, mass, zero)
    levels = [(mass, com, width, bmin, bmax)]

    # upward merge, one pass per level (bvh.h:210-243)
    for _ in range(last_level):
        cm, cx, cw, cbmin, cbmax = levels[0]
        ml, mr = cm[0::2], cm[1::2]
        dead_l, dead_r = ml == 0, mr == 0
        mass = ml + mr
        com_pair = _weighted_sum(ml, cx[0::2], mr, cx[1::2]) / torch.where(mass == 0, one,
                                                                          mass)[:, None]
        com = torch.where(dead_r[:, None], cx[0::2], com_pair)
        com = torch.where(dead_l[:, None], zero, com)
        bmin = torch.where(dead_r[:, None], cbmin[0::2], torch.minimum(cbmin[0::2], cbmin[1::2]))
        bmax = torch.where(dead_r[:, None], cbmax[0::2], torch.maximum(cbmax[0::2], cbmax[1::2]))
        width = torch.where(dead_r, cw[0::2], (bmax - bmin).amax(1))
        width = torch.where(dead_l, zero, width)
        mass = torch.where(dead_l, zero, mass)
        levels.insert(0, (mass, com, width, bmin, bmax))

    return BVHTree(mm=torch.cat([lv[0] for lv in levels]),
                   mx=torch.cat([lv[1] for lv in levels]),
                   bw=torch.cat([lv[2] for lv in levels]), nlevels=nlevels)


def hilbert_order(state: SystemState, xmin: torch.Tensor, xmax: torch.Tensor) -> SystemState:
    """The state's rows in Hilbert order over the box [xmin, xmax]: the
    reference's quirk curve, a stable sort."""
    keys = hilbert_keys(quantize(state.x, xmin, xmax - xmin))
    return SystemState(*sort_rows_by_key(keys, state.m, state.x, state.v, state.a, state.ao))


def hilbert_sort(state: SystemState, eps: float) -> SystemState:
    """The resort of bvh_step_force (bvh.py:243-257): Hilbert order over
    the box of the bodies and the origin."""
    return hilbert_order(state, *aabb_of_points(state.x, eps))


def bvh_step_force(state: SystemState, theta: float, G: float, eps: float,
                   group_tile: int = 512, window_tiles: int = 32, list_path: bool = False,
                   use_cuda: bool = True):
    """One BVH force evaluation (bvh.py:214-283): bbox -> Hilbert sort ->
    refit -> grouped windowed force, or with list_path the grouped list
    force (bvh.py:259-278), through the CUDA kernels' wrappers or, where
    not use_cuda, their plain twins. Returns the PERMUTED state with `a`
    filled, and aux with the device scalars "overflow" and "root_mass"
    (the root monopole's mass, bvh.h:377)."""
    from nbody_torch.ops.bvh_group import compute_force_grouped, compute_force_grouped_windowed

    state = hilbert_sort(state, eps)
    tree = build_tree(state.m, state.x, eps)
    if list_path:
        a, info = compute_force_grouped(tree, state.m, state.x, theta, G, eps, tile=group_tile,
                                        use_cuda=use_cuda)
    else:
        a, info = compute_force_grouped_windowed(tree, state.m, state.x, theta, G, eps,
                                                 tile=group_tile, window_tiles=window_tiles)
    aux = {"overflow": info["node_overflow"], "root_mass": tree.mm[0]}
    return dataclasses.replace(state, a=a), aux
