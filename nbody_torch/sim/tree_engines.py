"""Barnes-Hut engines wired into the runner interface (the port of
nbody_tpu.sim.tree_engines; the octree and bvh group traversals).

Each tree takes nbody_tpu's path choice (_use_pallas_eval,
tree_engines.py:27-37): float32 takes the fast path; float64, or --kernel
torch, the list path, through the CUDA kernels (group_eval_kernel and the
all-pairs fallback) unless --kernel torch asks for their plain twins.

Phases of --csv-detailed mirror the reference's columns:
  bvh:    force, accel, bbox, sort, multipoles, force approx  (bvh.h:342)
  octree: force, accel, clear, bbox, insert, multipoles, force approx
          (octree.h:280-282)
The octree's rebuild-from-sort design has no clear pass and builds its
monopoles inside the force evaluation or the level build, so both report
0.00; `insert` is what replaces CAS insertion (the fast path's robust
box, Morton keys and sort; the list path's build_octree), and `force
approx` the grouped evaluation plus the scatter back to the caller's
order. The bvh's `sort` is the Hilbert keys and the row sort,
`multipoles` the refit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops import bvh_group, octree_group
from nbody_torch.ops.bvh import build_tree, bvh_step_force, hilbert_order
from nbody_torch.ops.geometry import aabb_of_points, scalar_bounds
from nbody_torch.ops.integrator import leapfrog_step
from nbody_torch.ops.octree import (build_octree, max_depth, morton_sort, octree_step_force,
                                    robust_quant_box, tree_size_from_keys)
from nbody_torch.ops.permutation import unpermute_rows
from nbody_torch.sim.engines import EngineOptions, _timed, check_kernel_backend
from nbody_torch.state import SystemState


def _paths(name: str, cfg: SimConfig, opts: EngineOptions, device: torch.device):
    """(list_path, use_cuda) of a tree engine: the list path for float64 or
    --kernel torch, the kernels unless --kernel torch. Refuses the per-body
    walk, which only nbody_tpu runs, and loads the kernels before any timer
    starts."""
    if opts.traversal != "group":
        raise NotImplementedError(f"the {name} is ported for --traversal group only")
    use_cuda = opts.kernel != "torch"
    if use_cuda:
        check_kernel_backend(opts, device)
    return np.dtype(cfg.dtype) != np.float32 or not use_cuda, use_cuda


class BVHEngine:
    """Hilbert-sorted implicit BVH (ref: src/bvh.h). The sort reorders the
    state every step and it stays reordered."""

    name = "bvh"
    csv_phases = ("bbox", "sort", "multipoles", "force approx")
    header_in_detailed = True

    def make_step(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        list_path, use_cuda = _paths(self.name, cfg, opts, device)

        def step(state: SystemState):
            state, aux = bvh_step_force(state, cfg.theta, cfg.G, cfg.eps, opts.group_tile,
                                        opts.window_tiles, list_path, use_cuda)
            return leapfrog_step(state, cfg.dt), aux

        return step

    def make_detailed(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        list_path, use_cuda = _paths(self.name, cfg, opts, device)

        def force(tree, m, x):
            if list_path:
                return bvh_group.compute_force_grouped(tree, m, x, cfg.theta, cfg.G, cfg.eps,
                                                       tile=opts.group_tile, use_cuda=use_cuda)
            return bvh_group.compute_force_grouped_windowed(tree, m, x, cfg.theta, cfg.G, cfg.eps,
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
    """Prefix-derived Barnes-Hut octree (ref: src/octree.h)."""

    name = "octree"
    csv_phases = ("clear", "bbox", "insert", "multipoles", "force approx")
    header_in_detailed = True
    pre_info = "Tree init complete\n"   # octree.h:287, once before the loop

    def make_step(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        list_path, use_cuda = _paths(self.name, cfg, opts, device)
        depth = max_depth(cfg.n, cfg.dim)

        def step(state: SystemState):
            state, aux = octree_step_force(state, cfg.theta, cfg.G, cfg.eps, depth,
                                           opts.group_tile, opts.window_tiles, list_path, use_cuda)
            return leapfrog_step(state, cfg.dt), aux

        return step

    def make_detailed(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        list_path, use_cuda = _paths(self.name, cfg, opts, device)
        depth = max_depth(cfg.n, cfg.dim)
        if list_path:
            return self._make_detailed_list(cfg, opts, device, depth, use_cuda)

        def insert(m, x):
            lo_r, hi_r = robust_quant_box(x)
            return morton_sort(m, x, lo_r, hi_r, depth)

        def force(ms, xs, ks, perm):
            a_sorted, info = octree_group.compute_force_grouped_fast(
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

    def _make_detailed_list(self, cfg: SimConfig, opts: EngineOptions, device: torch.device,
                            depth: int, use_cuda: bool):
        """The list path's phases (nbody_tpu tree_engines.py:287-337): bbox
        the scalar box, insert build_octree, force approx the list force
        and the scatter; the aux reads the levels."""

        def force(levels, ms, xs, side, perm):
            a_sorted, info = octree_group.compute_force_grouped(
                levels, ms, xs, side, cfg.theta, cfg.G, cfg.eps, tile=opts.group_tile,
                use_cuda=use_cuda)
            return unpermute_rows(a_sorted, perm), info

        def detailed(state: SystemState):
            phases = {"clear": 0.0, "multipoles": 0.0}
            (lo, hi), phases["bbox"] = _timed(device, scalar_bounds, state.x)
            (levels, perm, ms, xs), phases["insert"] = _timed(device, build_octree, state.m,
                                                              state.x, lo, hi, depth)
            (a, info), phases["force approx"] = _timed(device, force, levels, ms, xs, hi - lo,
                                                       perm)
            phases["force"] = sum(phases[k] for k in self.csv_phases)
            state, phases["accel"] = _timed(device, leapfrog_step,
                                            dataclasses.replace(state, a=a), cfg.dt)
            aux = {"overflow": info["node_overflow"], "tree_size": (levels.count > 0).sum(),
                   "root_mass": levels.mass[0]}
            return state, phases, aux

        return detailed

    def info(self, state: SystemState, cfg: SimConfig, aux: dict) -> str:
        """--print-info: the step's tree size and root mass (octree.h:313-316)."""
        return f"Tree size: {int(aux['tree_size'])}\nTotal mass: {float(aux['root_mass']): .5f}\n"
