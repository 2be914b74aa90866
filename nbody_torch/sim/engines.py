"""Force-engine registry (the port of nbody_tpu.sim.engines).

Each engine owns one force algorithm and mirrors one of the reference's
run_* entry points (src/all_pairs.h:108-116, src/octree.h:266):

  make_step(cfg, opts, device)     -> (state, k) -> (state, aux): force +
                                      leapfrog, the unit of the step loop,
                                      k the global step index (the BVH's
                                      --sort-every cadence reads it); aux
                                      holds device scalars ("overflow", and
                                      the tree engines' "tree_size" and
                                      "root_mass" for --print-info)
  make_detailed(cfg, opts, device) -> state -> (state, {phase: seconds}, aux)
                                      for the --csv-detailed timing mode
  csv_phases                       -> extra CSV columns after force/accel
  info(state, cfg, aux)            -> per-step --print-info lines (or None)

The step order is force-then-integrate exactly as the reference kernels()
lambdas: the force engine fills `a` from current positions, then leapfrog
advances x/v and rolls ao <- a. The octree and bvh engines live in
sim/tree_engines.py.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable

import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops.allpairs import allpairs_accel, freeze_z
from nbody_torch.ops.cuda_allpairs import allpairs_accel_cuda
from nbody_torch.ops.integrator import leapfrog_step
from nbody_torch.state import SystemState

KERNELS = ("auto", "cuda", "torch")


@dataclasses.dataclass
class EngineOptions:
    """Runtime knobs that do not exist in the reference CLI."""
    kernel: str = "auto"        # auto|cuda|torch : force backend
    fix_z: bool = False         # fix the collapsed-force z-freeze quirk
    sort_every: int = 1         # re-sort cadence of the bvh
    traversal: str = "group"    # group|per-body : tree traversal strategy
    group_tile: int = 512       # bodies per tile in group traversal
    refine: int = -1            # BVH residual refinement levels (-1 = auto)
    window_tiles: int = 32      # tree near-field window width (body tiles)
    mesh: int = 1               # ranks to shard the bodies over (parallel/)
    mesh_layout: str = "replicated"  # replicated|partitioned tree layout
    mesh_tile: int = 1          # partitioned 2-D mesh: tile-axis shards

    def mesh_ranks(self, algorithm: str) -> int:
        """The ranks of a --mesh run: mesh * mesh_tile for a partitioned
        tree, mesh otherwise (nbody_tpu reads mesh_layout only in the
        trees, sim/tree_engines.py:58, :228, and mesh_tile only in the
        partitioned layout)."""
        if self.mesh_layout == "partitioned" and algorithm in ("octree", "bvh"):
            return self.mesh * self.mesh_tile
        return self.mesh


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_kernel_backend(opts: EngineOptions, device: torch.device) -> None:
    """Check --kernel against the device, and build and load the CUDA
    kernels before any timer starts when the device is a GPU."""
    if opts.kernel not in KERNELS:
        raise ValueError(f'Unknown kernel: "{opts.kernel}". Options are: auto, cuda, torch.')
    if device.type == "cuda":
        from nbody_torch._build import load_library

        load_library()
    elif opts.kernel == "cuda":
        raise ValueError(f"--kernel cuda needs a CUDA device, got {device}")


def _timed(device: torch.device, fn: Callable, *args):
    t0 = _time.perf_counter()
    out = fn(*args)
    sync(device)
    return out, _time.perf_counter() - t0


class AllPairsEngine:
    """O(N^2) direct sum (src/all_pairs.h:14-27)."""

    name = "all-pairs"
    csv_phases: tuple = ()
    header_in_detailed = False  # all-pairs prints the CSV header only in
    # --csv-total mode (all_pairs.h:58-66), unlike octree/bvh.

    def _accel_fn(self, cfg: SimConfig, opts: EngineOptions,
                  device: torch.device) -> Callable[[SystemState], torch.Tensor]:
        """state -> acceleration. `auto` and `cuda` take the CUDA kernel's
        wrapper (which runs its plain twin for CPU tensors); `torch` the
        plain torch path on any device. Both precisions go through the kernel.
        With --mesh N > 1 the ring over this rank's group (parallel/ring.py;
        nbody_tpu engines.py:93-96), whatever --mesh-layout says."""
        if opts.mesh > 1:
            from nbody_torch.parallel import mesh, ring

            use_cuda = opts.kernel != "torch"
            if use_cuda:
                check_kernel_backend(opts, device)
            accel = ring.make_ring_allpairs(cfg, mesh.current(device, opts.mesh), use_cuda)
            return lambda s: accel(s.m, s.x)
        if opts.kernel == "torch":
            return lambda s: allpairs_accel(s.m, s.x, cfg.G, cfg.eps)
        check_kernel_backend(opts, device)
        return lambda s: allpairs_accel_cuda(s.m, s.x, cfg.G, cfg.eps)

    def make_step(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        accel = self._accel_fn(cfg, opts, device)

        def step(state: SystemState, k: int):
            return leapfrog_step(dataclasses.replace(state, a=accel(state)), cfg.dt), {}

        return step

    def make_detailed(self, cfg: SimConfig, opts: EngineOptions, device: torch.device):
        accel = self._accel_fn(cfg, opts, device)

        def detailed(state: SystemState):
            a, t_force = _timed(device, accel, state)
            state, t_accel = _timed(device, leapfrog_step,
                                    dataclasses.replace(state, a=a), cfg.dt)
            return state, {"force": t_force, "accel": t_accel}, {}

        return detailed

    def info(self, state: SystemState, cfg: SimConfig, aux: dict):
        return None


class AllPairsCollapsedEngine(AllPairsEngine):
    """Pair-parallel direct sum (src/all_pairs.h:29-50). Same math; the
    reference's atomic accumulation touches only components [0] and [1], so
    by default the z-acceleration is frozen (see allpairs_collapsed_accel)."""

    name = "all-pairs-collapsed"

    def _accel_fn(self, cfg, opts, device):
        base = super()._accel_fn(cfg, opts, device)
        return lambda s: freeze_z(base(s), s.a, opts.fix_z)


def _octree_engine():
    from nbody_torch.sim.tree_engines import OctreeEngine

    return OctreeEngine()


def _bvh_engine():
    from nbody_torch.sim.tree_engines import BVHEngine

    return BVHEngine()


ENGINES = {
    "all-pairs": AllPairsEngine,
    "all-pairs-collapsed": AllPairsCollapsedEngine,
    "bvh": _bvh_engine,
    "octree": _octree_engine,
}


def get_engine(name: str):
    try:
        return ENGINES[name]()
    except KeyError:
        raise ValueError(
            f'Unknown algorithm: "{name}". '
            "Options are: all-pairs, all-pairs-collapsed, bvh, octree (default)."
        ) from None
