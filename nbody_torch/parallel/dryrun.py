"""The replicated layouts' dry run (the counterpart of nbody_tpu's
dryrun_multichip, __graft_entry__.py:75-150), and the one-step jobs that
hold a layout against the single-device engines.

    python -m nbody_torch.parallel.dryrun N [--device cpu|cuda]

starts N ranks (parallel.launch) and runs on each, on a 2-D float32 galaxy
of n = 16 * N bodies, what nbody_tpu's dry run runs on N devices: one ring
all-pairs step, one sharded BVH step and one sharded octree step, these
two at group_tile 16. Each must give (n, 2) finite positions, every rank
the same bits, and the trees no overflow; it prints OK and exits 0, or
fails with the first rank's error. nbody_tpu's partitioned blocks
(:152-189) belong to the partitioned layout, which is not yet ported.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nbody_torch.config import SimConfig
from nbody_torch.parallel.mesh import Mesh
from nbody_torch.state import SystemState


def _host_aux(aux: dict) -> dict:
    return {k: v.item() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}


def one_step(mesh: Mesh, algorithm: str, cfg: SimConfig, opts, arrays: dict,
             k: int = 0) -> tuple[dict, dict]:
    """Step k of `algorithm`'s engine (EngineOptions opts: the single-device
    step at mesh <= 1, else this rank's layout) from the host arrays m, x,
    v, a, ao on the rank's device. Returns the new state's host arrays and
    aux as Python numbers."""
    from nbody_torch.sim.engines import get_engine

    state = SystemState.from_numpy(arrays["m"], arrays["x"], arrays["v"], arrays["a"],
                                   arrays["ao"], device=mesh.device)
    state, aux = get_engine(algorithm).make_step(cfg, opts, mesh.device)(state, k)
    return state.to_numpy(), _host_aux(aux)


def step_parity(mesh: Mesh, algorithm: str, n: int, dim: int, precision: str,
                kernel: str = "auto", tile: int = 512) -> dict:
    """Step 0 of `algorithm` on an n-body galaxy (the CLI's model) twice on
    this rank: the single-device step and this rank's layout, from the same
    state. Returns the layout's force against the single-device one
    (max_rel_err: max |diff| / max |a|; sum_rel_err: sum |diff| / sum |a|),
    both aux dicts as Python numbers, whether the two states hold their
    bodies in one order (same_order: the BVH sorts them), and a digest of
    the layout's new state."""
    import hashlib

    from nbody_torch.config import precision_dtype
    from nbody_torch.models import build_model
    from nbody_torch.sim.engines import EngineOptions, get_engine

    cfg, start = build_model("galaxy", n, dim, precision_dtype(precision), None,
                             device=mesh.device)
    steps = {}
    for world in (1, mesh.world):
        state = SystemState(*(t.clone() for t in (start.m, start.x, start.v, start.a, start.ao)))
        opts = EngineOptions(kernel=kernel, group_tile=tile, mesh=world)
        steps[world] = get_engine(algorithm).make_step(cfg, opts, mesh.device)(state, 0)
    (one, aux1), (got, aux) = steps[1], steps[mesh.world]
    diff = (got.a - one.a).abs()
    digest = hashlib.sha256()
    for arr in got.to_numpy().values():
        digest.update(arr.tobytes())
    return {"max_rel_err": (diff.max() / one.a.abs().max()).item(),
            "sum_rel_err": (diff.sum() / one.a.abs().sum()).item(),
            "aux_single": _host_aux(aux1), "aux": _host_aux(aux),
            "same_order": bool(torch.equal(got.m, one.m) and torch.equal(got.x, one.x)),
            "state_digest": digest.hexdigest()}


def sharded_accel(mesh: Mesh, make, cfg: SimConfig, m: np.ndarray, x: np.ndarray,
                  kw: dict | None = None) -> np.ndarray:
    """The accelerations of the host bodies (m, x) by make(cfg, mesh,
    **kw)'s accel on this rank's group (ring.make_ring_allpairs or
    tree_sharded.make_sharded_bvh_force): all n rows."""
    t = (torch.tensor(a, device=mesh.device) for a in (m, x))
    return make(cfg, mesh, **(kw or {}))(*t).cpu().numpy()


def dryrun_rank(mesh: Mesh) -> dict:
    """nbody_tpu's three replicated blocks on this rank: the ring step, the
    sharded BVH step and the sharded octree step. Raises on a wrong shape,
    a non-finite position or an overflow. Returns each block's final
    positions."""
    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops.integrator import leapfrog_step
    from nbody_torch.parallel.ring import make_ring_allpairs
    from nbody_torch.parallel.tree_sharded import make_sharded_bvh_step, make_sharded_octree_step

    n = 16 * mesh.world
    out = {}
    cfg, state = build_galaxy_model(n, 2, np.float32, device=mesh.device)
    accel = make_ring_allpairs(cfg, mesh)
    out["ring"] = leapfrog_step(SystemState(state.m, state.x, state.v,
                                            accel(state.m, state.x), state.ao), cfg.dt)
    for name, make in (("bvh", make_sharded_bvh_step), ("octree", make_sharded_octree_step)):
        cfg, state = build_galaxy_model(n, 2, np.float32, device=mesh.device)
        out[name], aux = make(cfg.replace(theta=0.5), mesh, tile=16)(state, 0)
        if int(aux["overflow"]) != 0:
            raise RuntimeError(f"dry run: the sharded {name} step overflowed {aux}")
    for name, st in out.items():
        if st.x.shape != (n, 2) or not bool(torch.isfinite(st.x).all()):
            raise RuntimeError(f"dry run: the {name} step gave {tuple(st.x.shape)} positions, "
                               "or non-finite ones")
    return {name: st.x.cpu().numpy() for name, st in out.items()}


def dryrun_multichip(world: int, device_type: str = "cpu") -> None:
    """dryrun_rank on `world` ranks; raises unless every rank ends with the
    same positions."""
    from nbody_torch.parallel import launch

    ranks = launch.spawn(world, device_type, dryrun_rank)
    for r, got in enumerate(ranks[1:], 1):
        for name, x in got.items():
            if not np.array_equal(x, ranks[0][name]):
                raise RuntimeError(f"dry run: rank {r}'s {name} positions differ from rank 0's")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nbody_torch.parallel.dryrun",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("world", type=int, help="ranks to start")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 1
    dryrun_multichip(args.world, args.device)
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
