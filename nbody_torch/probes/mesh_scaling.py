"""The multi-device scaling table (python -m nbody_torch.probe mesh-scaling):
the port of scripts/probe_mesh_scaling.py.

For each shard count S (1, 2, 4, 8) one group of S ranks
(parallel/launch.spawn) times, on a 2-D float32 galaxy of n bodies:

  ring_allpairs_s       the ring's acceleration alone (parallel/ring.py)
  sharded_bvh_s         the replicated BVH step (parallel/tree_sharded.py)
  sharded_octree_s      the replicated octree step
  partitioned_octree_s  the partitioned octree step on S body ranks
                        (parallel/tree_partitioned.py)
  partitioned_2d_s      the same on S/2 body ranks x 2 tile ranks (S >= 4)
  partitioned_weak_s    the partitioned octree on n * S / 8 bodies
                        (partitioned_weak_n), the weak configuration

in seconds a call: each rank makes one untimed call, then `steps` calls
(the steps chained, each from the state the last one left), then waits at
a barrier after its device is done; the row takes the largest mean over
the ranks, which is what the script's one SPMD program measures. Each row
also carries the group's backend, the ranks that share a card (0 on the
CPU), the device and, by layout, the kernels' launches summed over the
ranks (untimed call included).

The script runs on 8 virtual CPU devices that share the host's cores and
says its absolute times mean nothing. Here, with fewer cards than ranks,
the ranks share the cards in turn over gloo (parallel/mesh.py): the table
shows whether the work divides over the ranks and what the collectives
add, and is no scaling figure.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as dist

from nbody_torch.models import build_galaxy_model
from nbody_torch.parallel import launch
from nbody_torch.parallel.mesh import Mesh
from nbody_torch.parallel.ring import make_ring_allpairs
from nbody_torch.parallel.tree_partitioned import make_partitioned_octree_step
from nbody_torch.parallel.tree_sharded import make_sharded_bvh_step, make_sharded_octree_step
from nbody_torch.probes import device_name
from nbody_torch.sim.engines import sync
from nbody_torch.state import SystemState

SHARDS = (1, 2, 4, 8)
HEADER = ("| S | ring all-pairs | sharded bvh | sharded octree | partitioned octree "
          "| partitioned 2-D (S/2 x 2) | partitioned weak (n=n*S/8) |\n"
          "|---|---|---|---|---|---|---|\n")


def _timed(dev: torch.device, steps: int, call) -> float:
    """Mean seconds of `steps` calls of call(), after one untimed call and
    a barrier, to the barrier after the last."""
    call()
    sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        call()
    sync(dev)
    dist.barrier()
    return (time.perf_counter() - t0) / steps


def _chained(step, state: SystemState):
    """call() -> one step from the state the last call left (a copy of
    `state` first: the leapfrog updates x and v in place)."""
    box = [SystemState(*(t.clone() for t in (state.m, state.x, state.v, state.a, state.ao)))]

    def call():
        box[0] = step(box[0], 0)[0]

    return call


def _partitioned(cfg, state: SystemState, mesh: Mesh, dev: torch.device, steps: int,
                 n_shards: int, tile_shards: int = 1) -> float:
    """A partitioned octree step's mean seconds on this rank's block."""
    step = make_partitioned_octree_step(cfg, mesh, n_shards=n_shards, tile_shards=tile_shards)
    return _timed(dev, steps, _chained(step, step.shard(state)))


def scaling_rank(mesh: Mesh, n: int, steps: int) -> dict:
    """One rank's times of a row (launch.spawn's fn), and its kernel
    launches by layout (the key of its time without "_s")."""
    from nbody_torch.ops import cuda_allpairs, cuda_group_eval

    S, dev = mesh.world, mesh.device
    cfg, state = build_galaxy_model(n, 2, np.float32, dev)
    times, launches = {}, {}

    def timed(key, call_or_seconds):
        for module in (cuda_allpairs, cuda_group_eval):
            module.reset_launch_counts()
        times[key] = call_or_seconds()
        launches[key.removesuffix("_s")] = {
            k: v for module in (cuda_allpairs, cuda_group_eval)
            for k, v in module.launch_counts.items() if v}

    ring = make_ring_allpairs(cfg, mesh)
    timed("ring_allpairs_s", lambda: _timed(dev, steps, lambda: ring(state.m, state.x)))
    timed("sharded_bvh_s",
          lambda: _timed(dev, steps, _chained(make_sharded_bvh_step(cfg, mesh), state)))
    timed("sharded_octree_s",
          lambda: _timed(dev, steps, _chained(make_sharded_octree_step(cfg, mesh), state)))
    timed("partitioned_octree_s", lambda: _partitioned(cfg, state, mesh, dev, steps, S))
    if S >= 4:
        # the body x tile layout on the same ranks: the rows divide over the
        # tile axis, the sort and heap are repeated on each tile rank
        timed("partitioned_2d_s", lambda: _partitioned(cfg, state, mesh, dev, steps, S // 2, 2))
    nw = n * S // 8
    cfgw, statew = build_galaxy_model(nw, 2, np.float32, dev)
    times["partitioned_weak_n"] = nw
    timed("partitioned_weak_s", lambda: _partitioned(cfgw, statew, mesh, dev, steps, S))
    return {"times": times, "backend": mesh.backend, "ranks_per_card": mesh.ranks_per_card,
            "device": device_name(dev), "launches": launches}


def row_of(S: int, n: int, reports: list[dict]) -> dict:
    """A table row from the ranks' reports: each time the largest over the
    ranks, the launches by layout summed over them."""
    times = [r["times"] for r in reports]
    row = {"S": S, "n": n}
    for key in times[0]:
        row[key] = times[0][key] if key == "partitioned_weak_n" else max(t[key] for t in times)
    launches = {}
    for r in reports:
        for layout, counts in r["launches"].items():
            summed = launches.setdefault(layout, {})
            for k, v in counts.items():
                summed[k] = summed.get(k, 0) + v
    return {**row, "backend": reports[0]["backend"],
            "ranks_per_card": reports[0]["ranks_per_card"], "device": reports[0]["device"],
            "launches": launches}


def table(rows: list[dict]) -> str:
    """The script's markdown table."""
    lines = [HEADER]
    for r in rows:
        p2 = f"{r['partitioned_2d_s']:.3f} s" if "partitioned_2d_s" in r else "-"
        lines.append(f"| {r['S']} | {r['ring_allpairs_s']:.3f} s | {r['sharded_bvh_s']:.3f} s "
                     f"| {r['sharded_octree_s']:.3f} s | {r['partitioned_octree_s']:.3f} s "
                     f"| {p2} | {r['partitioned_weak_s']:.3f} s "
                     f"(n={r['partitioned_weak_n']}) |\n")
    return "".join(lines)


def run(n: int, steps: int, out: str | None, device: torch.device,
        shards=None) -> list[dict]:
    """One row per shard count (SHARDS unless given), each printed as a
    JSON line; the table written to `out` when given."""
    rows = []
    for S in shards or SHARDS:
        reports = launch.spawn(S, device.type, scaling_rank, n, steps)
        rows.append(row_of(S, n, reports))
        print(json.dumps(rows[-1]), flush=True)
    if out:
        with open(out, "w") as fh:
            fh.write(table(rows))
    return rows
