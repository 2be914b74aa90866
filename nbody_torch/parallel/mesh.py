"""One rank's view of the process group (the port of
nbody_tpu.parallel.mesh.body_mesh, mesh.py:33-44), and the three
collectives that the replicated layouts use.

nbody_tpu runs its layouts in one process, as shard_map over a 1-D mesh of
devices. The port runs one process a rank (torch.distributed, the ranks
started by parallel.launch), and a Mesh is what one rank knows of the
group: its rank, the world size, its device and the backend. The backend
rule (backend_for, rank_device):

  nccl  where every rank has a card of its own (torch.cuda.device_count()
        >= world): rank r on cuda:r;
  gloo  elsewhere: --device cpu, or a machine with fewer cards than ranks,
        where rank r takes cuda:(r % count) and the ranks share the cards
        in turn (the counterpart of nbody_tpu's virtual CPU devices). The
        kernels still run on the card; only the collectives pass through
        host memory, by the explicit copies below (gloo's send and receive
        take CPU tensors).

The collectives, each nbody_tpu's lax primitive over the body axis:
  ring_shift       lax.ppermute to the next shard (ring.py:43-44)
  all_gather_rows  lax.all_gather(..., tiled=True): the ranks' rows in
                   rank order
  all_reduce_sum   lax.psum
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D group over the bodies."""
    rank: int
    world: int
    device: torch.device
    backend: str  # "nccl" or "gloo"

    @property
    def via_host(self) -> bool:
        """True where the collectives copy a card's tensors through host
        memory (gloo with the ranks on cards)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def ranks_per_card(self) -> int:
        """Ranks that share this rank's card (0 on the CPU)."""
        if self.device.type != "cuda":
            return 0
        count = torch.cuda.device_count()
        return len(range(self.device.index, self.world, count))

    def rows(self, npad: int) -> tuple[int, int]:
        """(row_start, nrows): this rank's contiguous share of npad rows,
        which the world divides."""
        if npad % self.world:
            raise ValueError(f"{npad} rows do not split over {self.world} ranks")
        nrows = npad // self.world
        return self.rank * nrows, nrows


def backend_for(device_type: str, world: int) -> str:
    """nccl where every one of `world` ranks has a card of its own, else
    gloo (the module docstring's rule)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """Rank `rank`'s device: cuda:(rank % cards) on cards, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def current(device: torch.device, world: int) -> Mesh:
    """This process's rank of the group that parallel.launch started, on
    `device`; raises unless the group holds `world` ranks."""
    if not dist.is_initialized():
        raise RuntimeError(f"--mesh {world} runs on {world} torch.distributed ranks: start them "
                           "with nbody_torch.parallel.launch.spawn")
    if dist.get_world_size() != world:
        raise ValueError(f"--mesh {world} in a group of {dist.get_world_size()} ranks")
    return Mesh(dist.get_rank(), world, device, dist.get_backend())


def _out(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.via_host else t.contiguous()


def _back(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.via_host else t


def ring_shift(mesh: Mesh, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor of this rank sent to rank + 1, and rank - 1's received
    in its place (lax.ppermute with perm s -> s + 1 mod world)."""
    if mesh.world == 1:
        return list(tensors)
    nxt, prv = (mesh.rank + 1) % mesh.world, (mesh.rank - 1) % mesh.world
    send = [_out(mesh, t) for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prv) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_back(mesh, t) for t in recv]


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of t, equal shapes on every rank, concatenated on
    dim 0 in rank order (lax.all_gather(..., tiled=True))."""
    if mesh.world == 1:
        return t
    local = _out(mesh, t)
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local)
    return _back(mesh, torch.cat(parts))


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks (lax.psum), a new tensor."""
    if mesh.world == 1:
        return t
    total = _out(mesh, t).clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return _back(mesh, total)
