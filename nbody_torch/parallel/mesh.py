"""One rank's view of the process group (the port of
nbody_tpu.parallel.mesh: body_mesh, mesh.py:33-44, and body_tile_mesh,
:13-30), and the collectives of the multi-device layouts.

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

A Mesh may also be a sub-group (body_tile_mesh): its rank and world are
then the rank's place in the group and the group's size, and every
collective below runs over that group alone.

The collectives, each nbody_tpu's lax primitive over a mesh axis:
  ring_shift        lax.ppermute to the next shard (ring.py:43-44)
  shift             lax.ppermute s -> s - h: rank r gets rank r + h's
                    block, zeros where there is none (tree_partitioned.py
                    :173-175)
  exchange          lax.ppermute over one odd-even phase's pairs
                    (distributed_sort.py:88-89)
  all_gather_rows   lax.all_gather(..., tiled=True): the ranks' rows in
                    rank order
  all_reduce_sum    lax.psum
  sum_in_rank_order lax.psum as XLA adds it on the CPU: the ranks' tensors
                    gathered and added in rank order, so that every backend
                    gives the same floating-point sums
  all_reduce_min / all_reduce_max   lax.pmin / lax.pmax
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D group over the bodies: the whole world, or a
    sub-group whose members are the global ranks of its ranks 0..world-1."""
    rank: int
    world: int
    device: torch.device
    backend: str  # "nccl" or "gloo"
    group: object = None  # a torch.distributed group; None: the default group
    members: tuple = ()   # the sub-group's global ranks, in its rank order

    def peer(self, r: int) -> int:
        """The global rank of the group's rank r."""
        return self.members[r] if self.members else r

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
    return (t.cpu() if mesh.via_host else t).contiguous()


def _back(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.via_host else t


def _send_recv(mesh: Mesh, tensors, to: int | None, frm: int | None) -> list[torch.Tensor]:
    """Each tensor sent to the group's rank `to` and one like it received
    from rank `frm` (None: no send, or no receive and zeros in its place)."""
    send = [_out(mesh, t) for t in tensors]
    recv = [torch.zeros_like(t) for t in send]
    ops = [] if to is None else [dist.P2POp(dist.isend, t, mesh.peer(to), mesh.group)
                                 for t in send]
    if frm is not None:
        ops += [dist.P2POp(dist.irecv, t, mesh.peer(frm), mesh.group) for t in recv]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [_back(mesh, t) for t in recv]


def ring_shift(mesh: Mesh, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each tensor of this rank sent to rank + 1, and rank - 1's received
    in its place (lax.ppermute with perm s -> s + 1 mod world)."""
    if mesh.world == 1:
        return list(tensors)
    return _send_recv(mesh, tensors, (mesh.rank + 1) % mesh.world,
                      (mesh.rank - 1) % mesh.world)


def shift(mesh: Mesh, h: int, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Rank r + h's tensors on rank r, zeros where rank r + h does not
    exist (lax.ppermute with perm s -> s - h, which zero-fills a rank that
    no source sends to)."""
    to, frm = mesh.rank - h, mesh.rank + h
    return _send_recv(mesh, tensors, to if 0 <= to < mesh.world else None,
                      frm if 0 <= frm < mesh.world else None)


def exchange(mesh: Mesh, partner: int | None, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors of rank `partner`, which gets this rank's in turn (one
    pair of an odd-even phase); a rank without a partner keeps its own."""
    if partner is None:
        return list(tensors)
    return _send_recv(mesh, tensors, partner, partner)


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of t, equal shapes on every rank, concatenated on
    dim 0 in rank order (lax.all_gather(..., tiled=True))."""
    if mesh.world == 1:
        return t
    local = _out(mesh, t)
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local, group=mesh.group)
    return _back(mesh, torch.cat(parts))


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    if mesh.world == 1:
        return t
    total = _out(mesh, t).clone()
    dist.all_reduce(total, op=op, group=mesh.group)
    return _back(mesh, total)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks (lax.psum), a new tensor."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def all_reduce_min(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum of t over the ranks (lax.pmin)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MIN)


def all_reduce_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of t over the ranks (lax.pmax)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def sum_in_rank_order(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks, added rank 0 first, then rank 1, ...:
    the order of lax.psum on XLA's CPU devices, on any backend."""
    parts = all_gather_rows(mesh, t[None])
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


@dataclasses.dataclass(frozen=True)
class BodyTileMesh:
    """One rank's place in a 2-D (body x tile) grid of n_body * n_tile
    ranks (body_tile_mesh): its body group (the ranks of its tile column),
    its tile group (the ranks of its body row) and the whole grid."""
    body: Mesh
    tile: Mesh
    grid: Mesh


def _sub_mesh(world_mesh: Mesh, members: list[int], group) -> Mesh:
    if len(members) == world_mesh.world:
        return world_mesh
    return Mesh(members.index(world_mesh.rank), len(members), world_mesh.device,
                world_mesh.backend, group, tuple(members))


def body_tile_mesh(world_mesh: Mesh, n_body: int, n_tile: int) -> BodyTileMesh | None:
    """The 2-D mesh of body_tile_mesh(n_body, n_tile) (mesh.py:13-30) on
    the first n_body * n_tile ranks of the world: rank b * n_tile + t
    holds body shard b and tile shard t, as jax.make_mesh lays out
    devs[:need]. Every rank of the world calls this, and creates every
    group in the same order (torch.distributed.new_group's rule); a rank
    outside the grid gets None."""
    need = n_body * n_tile
    if need > world_mesh.world:
        raise ValueError(f"requested {n_body}x{n_tile} mesh but only {world_mesh.world} ranks")

    def group_of(members):
        if len(members) in (1, world_mesh.world):
            return None
        return dist.new_group(members)

    cols = [[b * n_tile + t for b in range(n_body)] for t in range(n_tile)]
    rows = [[b * n_tile + t for t in range(n_tile)] for b in range(n_body)]
    grid = list(range(need))
    col_groups = [group_of(c) for c in cols]
    row_groups = [group_of(r) for r in rows]
    grid_group = group_of(grid)
    if world_mesh.rank >= need:
        return None
    b, t = divmod(world_mesh.rank, n_tile)
    return BodyTileMesh(body=_sub_mesh(world_mesh, cols[t], col_groups[t]),
                        tile=_sub_mesh(world_mesh, rows[b], row_groups[b]),
                        grid=_sub_mesh(world_mesh, grid, grid_group))
