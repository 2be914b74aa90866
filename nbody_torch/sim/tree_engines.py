"""Barnes-Hut engines wired into the runner interface (the port of
nbody_tpu.sim.tree_engines; the octree and bvh fast paths).

Phases of --csv-detailed mirror the reference's columns:
  bvh:    force, accel, bbox, sort, multipoles, force approx  (bvh.h:342)
  octree: force, accel, clear, bbox, insert, multipoles, force approx
          (octree.h:280-282)
The octree's rebuild-from-sort design has no clear pass and builds its
monopoles inside the force evaluation, so both report 0.00; `insert` is
the robust box, the Morton keys and the sort that replace CAS insertion,
and `force approx` the grouped evaluation plus the scatter back to the
caller's order. The bvh's `sort` is the Hilbert keys and the row sort,
`multipoles` the refit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops.bvh import build_tree, bvh_step_force, hilbert_order
from nbody_torch.ops.bvh_group import compute_force_grouped_windowed
from nbody_torch.ops.geometry import aabb_of_points, scalar_bounds
from nbody_torch.ops.integrator import leapfrog_step
from nbody_torch.ops.octree import (max_depth, morton_sort, octree_step_force,
                                    robust_quant_box, tree_size_from_keys)
from nbody_torch.ops.octree_group import compute_force_grouped_fast
from nbody_torch.ops.permutation import unpermute_rows
from nbody_torch.sim.engines import EngineOptions, _timed, check_kernel_backend
from nbody_torch.state import SystemState


def _check_fast_path(name: str, cfg: SimConfig, opts: EngineOptions, device: torch.device) -> None:
    """Refuse what only nbody_tpu runs on a tree engine; load the kernels."""
    if opts.traversal != "group" or opts.kernel == "torch" or np.dtype(cfg.dtype) != np.float32:
        raise NotImplementedError(f"the {name} is ported for --traversal group in float32, "
                                  "through the CUDA kernels' wrappers, only")
    check_kernel_backend(opts, device)


class BVHEngine:
    """Hilbert-sorted implicit BVH (ref: src/bvh.h), fast path. The sort
    reorders the state every step and it stays reordered."""

    name = "bvh"
    csv_phases = ("bbox", "sort", "multipoles", "force approx")
    header_in_detailed = True

    def make_step(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        _check_fast_path(self.name, cfg, opts, device)

        def step(state: SystemState):
            state, aux = bvh_step_force(state, cfg.theta, cfg.G, cfg.eps, opts.group_tile,
                                        opts.window_tiles)
            return leapfrog_step(state, cfg.dt), aux

        return step

    def make_detailed(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        _check_fast_path(self.name, cfg, opts, device)

        def force(tree, m, x):
            return compute_force_grouped_windowed(tree, m, x, cfg.theta, cfg.G, cfg.eps,
                                                  tile=opts.group_tile,
                                                  window_tiles=opts.window_tiles)

        def detailed(state: SystemState):
            phases = {}
            (xmin, xmax), phases["bbox"] = _timed(device, aabb_of_points, state.x, cfg.eps)
            state, phases["sort"] = _timed(device, hilbert_order, state, xmin, xmax)
            tree, phases["multipoles"] = _timed(device, build_tree, state.m, state.x, cfg.eps)
            (a, info), phases["force approx"] = _timed(device, force, tree, state.m, state.x)
            phases["force"] = sum(phases[k] for k in self.csv_phases)
            state, phases["accel"] = _timed(device, leapfrog_step,
                                            dataclasses.replace(state, a=a), cfg.dt)
            return state, phases, {"overflow": info["node_overflow"], "root_mass": tree.mm[0]}

        return detailed

    def info(self, state: SystemState, cfg: SimConfig, aux: dict) -> str:
        """--print-info: the total mass, the root monopole's (bvh.h:377)."""
        return f"Total mass: {float(aux['root_mass']): .5f}\n"


class OctreeEngine:
    """Prefix-derived Barnes-Hut octree (ref: src/octree.h), fast path."""

    name = "octree"
    csv_phases = ("clear", "bbox", "insert", "multipoles", "force approx")
    header_in_detailed = True
    pre_info = "Tree init complete\n"   # octree.h:287, once before the loop

    def _check(self, cfg: SimConfig, opts: EngineOptions, device: torch.device) -> int:
        """Refuse what only nbody_tpu runs; load the kernels; return the
        key depth."""
        _check_fast_path(self.name, cfg, opts, device)
        return max_depth(cfg.n, cfg.dim)

    def make_step(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        depth = self._check(cfg, opts, device)

        def step(state: SystemState):
            state, aux = octree_step_force(state, cfg.theta, cfg.G, cfg.eps, depth,
                                           opts.group_tile, opts.window_tiles)
            return leapfrog_step(state, cfg.dt), aux

        return step

    def make_detailed(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        depth = self._check(cfg, opts, device)

        def insert(m, x):
            lo_r, hi_r = robust_quant_box(x)
            return morton_sort(m, x, lo_r, hi_r, depth)

        def force(ms, xs, ks, perm):
            a_sorted, info = compute_force_grouped_fast(
                ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps, tile=opts.group_tile,
                window_tiles=opts.window_tiles)
            return unpermute_rows(a_sorted, perm), info

        def detailed(state: SystemState):
            phases = {"clear": 0.0, "multipoles": 0.0}
            _, phases["bbox"] = _timed(device, scalar_bounds, state.x)
            (ms, xs, ks, perm), phases["insert"] = _timed(device, insert, state.m, state.x)
            (a, info), phases["force approx"] = _timed(device, force, ms, xs, ks, perm)
            phases["force"] = sum(phases[k] for k in self.csv_phases)
            state, phases["accel"] = _timed(device, leapfrog_step,
                                            dataclasses.replace(state, a=a), cfg.dt)
            aux = {"overflow": info["node_overflow"],
                   "tree_size": tree_size_from_keys(ks, depth, cfg.dim),
                   "root_mass": state.m.sum(dtype=torch.float64).to(state.m.dtype)}
            return state, phases, aux

        return detailed

    def info(self, state: SystemState, cfg: SimConfig, aux: dict) -> str:
        """--print-info: the step's tree size and root mass (octree.h:313-316)."""
        return f"Tree size: {int(aux['tree_size'])}\nTotal mass: {float(aux['root_mass']): .5f}\n"
