"""Replicated trees, row-sharded evaluation (the port of
nbody_tpu.parallel.tree_sharded).

Every rank sorts all bodies and builds the whole tree (replicated: the
tree is O(n) while the evaluation is the O(n log n) part), then evaluates
only its own contiguous rows [r * nrows, (r + 1) * nrows) of the sorted
bodies through the group paths' row-range mode; the ranks' rows are
gathered into every rank and the overflow counts summed
(tree_sharded.py:1-33). Each rank's group path makes its own host reads
on its own rows, and no collective sits among them, so ranks whose tiles
branch differently cannot deadlock.

The bodies are padded to npad = round_up(n, world * tile) with zero-mass
copies of the last sorted body (_pad_bodies, :60-67): no box grows and no
force changes. The paths follow the port's tree engines: float32 with the
kernels takes the fast path, float64 or --kernel torch the list path
(nbody_tpu's _use_pallas_eval makes the same split).

Scaling ceiling, as nbody_tpu states it: only the evaluation is 1/world a
rank. The sort and the build run on every rank over all n bodies, every
rank holds all of them, and each step gathers all n accelerations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops.bvh import build_tree, hilbert_sort
from nbody_torch.ops.bvh_group import compute_force_grouped as bvh_grouped
from nbody_torch.ops.bvh_group import compute_force_grouped_windowed
from nbody_torch.ops.geometry import scalar_bounds
from nbody_torch.ops.integrator import leapfrog_step
from nbody_torch.ops.octree import (build_octree, max_depth, morton_sort, robust_quant_box,
                                    tree_size_from_keys)
from nbody_torch.ops.octree_group import compute_force_grouped as octree_grouped
from nbody_torch.ops.octree_group import compute_force_grouped_fast
from nbody_torch.ops.permutation import unpermute_rows
from nbody_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum
from nbody_torch.state import SystemState


def pad_bodies(m: torch.Tensor, x: torch.Tensor, npad: int):
    """m, x with npad - n zero-mass copies of the last body appended."""
    n = x.shape[0]
    if npad == n:
        return m, x
    return (torch.cat([m, m.new_zeros(npad - n)]),
            torch.cat([x, x[-1:].expand(npad - n, x.shape[1])]))


def sharded_rows(n: int, mesh: Mesh, tile: int) -> tuple[int, int, int]:
    """(npad, row_start, nrows): the padded body count and this rank's rows."""
    step = mesh.world * tile
    npad = -(-n // step) * step
    return (npad, *mesh.rows(npad))


def _bvh_force(tree, m, x, cfg: SimConfig, mesh: Mesh, tile: int, list_path: bool,
               use_cuda: bool):
    """This rank's rows of the BVH force over the padded bodies (m, x),
    gathered, and the info of its own rows."""
    _, r0, nrows = sharded_rows(x.shape[0], mesh, tile)
    if list_path:
        a_loc, info = bvh_grouped(tree, m, x, cfg.theta, cfg.G, cfg.eps, tile=tile,
                                  use_cuda=use_cuda, row_start=r0, nrows=nrows)
    else:
        a_loc, info = compute_force_grouped_windowed(tree, m, x, cfg.theta, cfg.G, cfg.eps,
                                                     tile=tile, row_start=r0, nrows=nrows)
    return all_gather_rows(mesh, a_loc), info


def make_sharded_bvh_force(cfg: SimConfig, mesh: Mesh, tile: int = 512, list_path: bool = False,
                           use_cuda: bool = True) -> Callable:
    """accel(m, x) over Hilbert-sorted bodies (make_sharded_bvh_force,
    :70-115): the replicated build, this rank's rows evaluated, all n rows
    returned on every rank."""

    def accel(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        mp, xp = pad_bodies(m, x, sharded_rows(n, mesh, tile)[0])
        a_all, _ = _bvh_force(build_tree(mp, xp, cfg.eps), mp, xp, cfg, mesh, tile, list_path,
                              use_cuda)
        return a_all[:n]

    return accel


def make_sharded_bvh_step(cfg: SimConfig, mesh: Mesh, tile: int = 512, list_path: bool = False,
                          use_cuda: bool = True) -> Callable:
    """The --mesh BVH step (make_sharded_bvh_step, :118-182): Hilbert sort
    of the whole state, the sharded force, the leapfrog. Like nbody_tpu's
    it re-sorts every step and takes the default window and refinement:
    --sort-every, --traversal, --refine-levels and --window-tiles do not
    reach it. Returns (state, k) -> (state, aux) with aux's "overflow" (the
    ranks' sum) and "root_mass" (the padded tree's root)."""

    def step(state: SystemState, k: int):
        state = hilbert_sort(state, cfg.eps)
        n = state.n
        mp, xp = pad_bodies(state.m, state.x, sharded_rows(n, mesh, tile)[0])
        tree = build_tree(mp, xp, cfg.eps)
        a_all, info = _bvh_force(tree, mp, xp, cfg, mesh, tile, list_path, use_cuda)
        over = all_reduce_sum(mesh, info["node_overflow"].to(torch.int32))
        state = dataclasses.replace(state, a=a_all[:n])
        return leapfrog_step(state, cfg.dt), {"overflow": over, "root_mass": tree.mm[0]}

    return step


def make_sharded_octree_step(cfg: SimConfig, mesh: Mesh, tile: int = 512,
                             list_path: bool = False, use_cuda: bool = True) -> Callable:
    """The --mesh octree step (make_sharded_octree_step, :185-275): the
    global Morton sort, then on every rank the padded bodies' heap (fast
    path) or level tree (list path, rebuilt from the sorted bodies, whose
    sort is then the identity), this rank's rows, the gather, the scatter
    back to the state's order and the leapfrog. The window takes its
    default width. aux: "overflow" (the ranks' sum), "tree_size" and
    "root_mass", each from the expression of the port's single-device step
    (the fast path's distinct key prefixes and float64 mass sum; the list
    path's occupied level nodes and root mass), over the padded bodies."""
    depth = max_depth(cfg.n, cfg.dim)

    def step(state: SystemState, k: int):
        n = state.n
        if list_path:
            lo, hi = scalar_bounds(state.x)
            _, perm, ms, xs = build_octree(state.m, state.x, lo, hi, depth)
        else:
            lo, hi = robust_quant_box(state.x)
            ms, xs, ks, perm = morton_sort(state.m, state.x, lo, hi, depth)
        npad, r0, nrows = sharded_rows(n, mesh, tile)
        mp, xp = pad_bodies(ms, xs, npad)
        if list_path:
            levels, _, mp, xp = build_octree(mp, xp, lo, hi, depth)
            a_loc, info = octree_grouped(levels, mp, xp, hi - lo, cfg.theta, cfg.G, cfg.eps,
                                         tile=tile, use_cuda=use_cuda, row_start=r0, nrows=nrows)
            tree_size, root_mass = (levels.count > 0).sum(), levels.mass[0]
        else:
            # the copies' keys are the last body's: the keys of the padded bodies
            ks = torch.cat([ks, ks[-1:].expand(npad - n)])
            a_loc, info = compute_force_grouped_fast(mp, xp, ks, depth, cfg.theta, cfg.G,
                                                     cfg.eps, tile=tile, row_start=r0,
                                                     nrows=nrows)
            tree_size = tree_size_from_keys(ks, depth, cfg.dim)
            root_mass = mp.sum(dtype=torch.float64).to(mp.dtype)
        a_sorted = all_gather_rows(mesh, a_loc)[:n]
        over = all_reduce_sum(mesh, info["node_overflow"].to(torch.int32))
        state = dataclasses.replace(state, a=unpermute_rows(a_sorted, perm))
        aux = {"overflow": over, "tree_size": tree_size, "root_mass": root_mass}
        return leapfrog_step(state, cfg.dt), aux

    return step
