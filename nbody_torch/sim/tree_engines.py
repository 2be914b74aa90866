"""Barnes-Hut engines wired into the runner interface (the port of
nbody_tpu.sim.tree_engines; the octree fast path so far).

Phases of --csv-detailed mirror the reference's octree columns
(octree.h:280-282): force, accel, clear, bbox, insert, multipoles,
force approx. The rebuild-from-sort design has no clear pass and builds
its monopoles inside the force evaluation, so both report 0.00; `insert`
is the robust box, the Morton keys and the sort that replace CAS
insertion, and `force approx` the grouped evaluation plus the scatter
back to the caller's order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops.geometry import scalar_bounds
from nbody_torch.ops.integrator import leapfrog_step
from nbody_torch.ops.octree import (max_depth, morton_sort, octree_step_force,
                                    robust_quant_box, tree_size_from_keys)
from nbody_torch.ops.octree_group import compute_force_grouped_fast
from nbody_torch.ops.permutation import unpermute_rows
from nbody_torch.sim.engines import EngineOptions, _timed, check_kernel_backend
from nbody_torch.state import SystemState


class OctreeEngine:
    """Prefix-derived Barnes-Hut octree (ref: src/octree.h), fast path."""

    name = "octree"
    csv_phases = ("clear", "bbox", "insert", "multipoles", "force approx")
    header_in_detailed = True
    pre_info = "Tree init complete\n"   # octree.h:287, once before the loop

    def _check(self, cfg: SimConfig, opts: EngineOptions, device: torch.device) -> int:
        """Refuse what only nbody_tpu runs; load the kernels; return the
        key depth."""
        if opts.traversal != "group" or opts.kernel == "torch" or np.dtype(cfg.dtype) != np.float32:
            raise NotImplementedError("the octree is ported for --traversal group in float32, "
                                      "through the CUDA kernels' wrappers, only")
        check_kernel_backend(opts, device)
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
