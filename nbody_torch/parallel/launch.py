"""Start the ranks of a --mesh run: one process a rank, the group set up,
each rank's result returned to the caller.

nbody_tpu needs no such module: its layouts run as one SPMD program in one
process. The port runs fn(mesh, *args) in `world` processes started with
torch.multiprocessing (the spawn start method, which CUDA requires), each
joined to one torch.distributed group through a file store in a fresh
temporary directory (so no TCP port can collide with another run's), on
the backend and device of parallel.mesh's rule. fn and args travel by
pickle, so fn is a module-level function of an importable module.

A rank that raises fails the whole run: torch.multiprocessing ends the
other ranks and raises its error, traceback and all, in the caller. The
CUDA kernels are built once in the caller before the ranks start, so that
the ranks load the library rather than each run nvcc.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nbody_torch.parallel.mesh import Mesh, backend_for, rank_device


def _rank_main(rank: int, world: int, device_type: str, store: str, fn, args) -> None:
    """One rank: join the group, run fn, leave its result beside the store."""
    backend = backend_for(device_type, world)
    device = rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world)
    result = fn(Mesh(rank, world, device, backend), *args)
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{store}.rank{rank}", "wb") as f:
        pickle.dump(result, f)


def run_jobs(mesh: Mesh, jobs) -> list:
    """[fn(mesh, *args) for fn, args in jobs]: several runs in one group,
    in order on every rank (one spawn for many checks)."""
    return [fn(mesh, *args) for fn, args in jobs]


def spawn(world: int, device_type: str, fn, *args) -> list:
    """fn(mesh, *args) on ranks 0..world-1 of a new group, on the CPU
    (device_type "cpu", gloo) or the cards ("cuda"). Returns the ranks'
    results in rank order; raises the first failing rank's error."""
    if world < 1:
        raise ValueError(f"a group needs at least one rank, got {world}")
    if device_type == "cuda":
        from nbody_torch import _build

        _build.build()
    with tempfile.TemporaryDirectory(prefix="nbody_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_rank_main, args=(world, device_type, store, fn, args), nprocs=world,
                           join=True, start_method="spawn")
        results = []
        for rank in range(world):
            with open(f"{store}.rank{rank}", "rb") as f:
                results.append(pickle.load(f))
    return results
