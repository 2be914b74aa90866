"""The multi-device layouts' dry run (the counterpart of nbody_tpu's
dryrun_multichip, __graft_entry__.py:75-189), and the one-step jobs that
hold a layout against the single-device engines or nbody_tpu.

    python -m nbody_torch.parallel.dryrun N [--device cpu|cuda]

starts N ranks (parallel.launch) and runs on each what nbody_tpu's dry run
runs on N devices, on 2-D float32 galaxies: on n = 16 * N bodies one ring
all-pairs step, one sharded BVH step and one sharded octree step, these
two at group_tile 16; on max(n, 32 * N) bodies at tile 8 one partitioned
octree step (whose communication accounting it prints and bounds: the
bytes a step outside the sort at most 96 * 2 * nl + 64 * C), one
partitioned BVH step (N a power of two, as nbody_tpu requires) and, where
N >= 4 is even, one partitioned octree step on the N/2 x 2 (body x tile)
mesh. Each must give finite positions of the model's shape, every rank
the same bits, and the replicated trees no overflow; it prints OK and
exits 0, or fails with the first rank's error.
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


def partitioned_step(mesh: Mesh, algorithm: str, cfg: SimConfig, arrays: dict,
                     kw: dict | None = None, steps: int = 1):
    """`steps` steps of the partitioned `algorithm` ("octree" or "bvh") on
    this rank's group (make_partitioned_*_step(cfg, mesh, **kw)) from the
    host arrays m, x, v (and a, ao), all n rows on every rank. Returns the
    gathered new state's host arrays and the last step's aux as Python
    numbers, or None on a rank outside the step's grid."""
    from nbody_torch.parallel import tree_partitioned as tp

    make = tp.make_partitioned_octree_step if algorithm == "octree" \
        else tp.make_partitioned_bvh_step
    step = make(cfg, mesh, **(kw or {}))
    if step is None:
        return None
    local = step.shard(SystemState.from_numpy(arrays["m"], arrays["x"], arrays["v"],
                                              arrays.get("a"), arrays.get("ao"),
                                              device=mesh.device))
    for k in range(steps):
        local, aux = step(local, k)
    return step.gather(local).to_numpy(), _host_aux(aux)


def sort_rows(mesh: Mesh, n_ranks: int, keys: np.ndarray, cols: np.ndarray,
              adaptive: bool = False):
    """distributed_sort_rows over the first n_ranks ranks of the group:
    rank r takes rows [r * nl, (r + 1) * nl) of keys (n, K) (int64 words)
    and cols (n, F). Returns the sorted blocks gathered, (keys, cols), or
    None on a rank outside the n_ranks."""
    from nbody_torch.parallel.distributed_sort import distributed_sort_rows
    from nbody_torch.parallel.mesh import all_gather_rows, body_tile_mesh

    grid = body_tile_mesh(mesh, n_ranks, 1)
    if grid is None:
        return None
    nl = keys.shape[0] // n_ranks
    block = slice(grid.body.rank * nl, (grid.body.rank + 1) * nl)
    k, c = distributed_sort_rows(grid.body, torch.tensor(keys[block], device=mesh.device),
                                 torch.tensor(cols[block], device=mesh.device), adaptive)
    return all_gather_rows(grid.body, k).cpu().numpy(), all_gather_rows(grid.body, c).cpu().numpy()


def dryrun_rank(mesh: Mesh) -> dict:
    """nbody_tpu's dry-run blocks on this rank: the ring step, the sharded
    BVH and octree steps, and the partitioned octree, BVH and 2-D mesh
    steps. Raises on a wrong shape, a non-finite position, an overflow or
    a communication accounting over its bound. Returns each block's final
    positions, and under "comm" the partitioned octree's accounting, ring
    flag and traced total."""
    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops.integrator import leapfrog_step
    from nbody_torch.parallel import tree_partitioned as tp
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
    cfg4, state4 = build_galaxy_model(max(n, 4 * mesh.world * 8), 2, np.float32,
                                      device=mesh.device)
    cfg4 = cfg4.replace(theta=0.5)
    blocks = [("partitioned_octree", tp.make_partitioned_octree_step, {}),
              ("partitioned_bvh", tp.make_partitioned_bvh_step, {})]
    if mesh.world % 2 == 0 and mesh.world >= 4:
        blocks.append(("partitioned_2d", tp.make_partitioned_octree_step,
                       {"n_shards": mesh.world // 2, "tile_shards": 2}))
    for name, make, kw in blocks:
        step = make(cfg4, mesh, tile=8, **kw)
        local, aux = step(step.shard(state4))
        out[name] = step.gather(local)
        if name == "partitioned_octree":
            comm = aux["comm"]
            nl4 = -(-cfg4.n // mesh.world)
            c4 = comm["beyond_need_psum_bytes"] // 4
            if comm["step_bytes_no_sort"] > 96 * 2 * nl4 + 64 * c4:
                raise RuntimeError(f"dry run: the partitioned octree's accounting {comm} is "
                                   f"over 96 * 2 * {nl4} + 64 * {c4} bytes")
            info = {"comm": comm, "ring_used": aux["beyond_used_ring"],
                    "traced_total": aux["comm_bytes_per_shard"]}
    for name, st in out.items():
        want = (cfg4.n if name.startswith("partitioned") else n, 2)
        if st.x.shape != want or not bool(torch.isfinite(st.x).all()):
            raise RuntimeError(f"dry run: the {name} step gave {tuple(st.x.shape)} positions, "
                               "or non-finite ones")
    return {**{name: st.x.cpu().numpy() for name, st in out.items()}, "comm": info}


def dryrun_multichip(world: int, device_type: str = "cpu") -> dict:
    """dryrun_rank on `world` ranks; raises unless every rank ends with the
    same positions. Returns rank 0's partitioned octree accounting."""
    from nbody_torch.parallel import launch

    ranks = launch.spawn(world, device_type, dryrun_rank)
    for r, got in enumerate(ranks[1:], 1):
        for name, x in got.items():
            if name != "comm" and not np.array_equal(x, ranks[0][name]):
                raise RuntimeError(f"dry run: rank {r}'s {name} positions differ from rank 0's")
    return ranks[0]["comm"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nbody_torch.parallel.dryrun",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("world", type=int, help="ranks to start")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 1
    info = dryrun_multichip(args.world, args.device)
    print("partitioned octree per-rank comm bytes/step:", info["comm"], "ring_used:",
          info["ring_used"], "traced_total:", info["traced_total"])
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
