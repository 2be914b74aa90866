"""Partitioned Barnes-Hut trees (the port of
nbody_tpu.parallel.tree_partitioned): the bodies sharded over the ranks,
a distributed sort, one replicated coarse heap and a halo-exact near
field, O(n/S + C) a rank (S body ranks, C coarse cells).

A step on each rank of the body group (tree_partitioned.py:10-45):

  sort    the distributed sort (parallel.distributed_sort) by (pad flag,
          curve key): each rank then holds a contiguous range of the
          curve, and the pad rows the global tail;
  heap    every rank scatters its own rows into the leaf level of the
          coarse heap (levels 0..L, count, mass, m*x, extents), one sum
          over the ranks replicates it, and the levels above pool it;
  far     each tile's conservative group MAC against the heap, the cells
          that the tile's near interval covers dropped, those it straddles
          opened: masked_eval_bits_cuda (row 4's kernel) on the packed
          accepts;
  near    the +-halo neighbours' blocks (mesh.shift) form the window E,
          and every row takes the exact sum over E's rows inside the
          interval [lo, hi) (the octree's snapped to L-level cells):
          window_eval_interval_cuda (row 5's kernel), w0 = 0 and the
          window the whole of E, in tiles of the kernel's 512-row block
          where the rows allow (the interval is the same for every tile);
  beyond  the cells still open at L outside the interval, exactly: one
          sum over the ranks ORs the needed cells, each rank compacts its
          rows in them into a buffer of beyond_budget rows, one gather
          replicates the buffers, and each tile takes its own cells'
          rows (masked_eval_bits_cuda on the tile's bits over the buffer);
          if any rank's rows overflow the budget (one flag summed over the
          ranks, so every rank takes the same branch) the blocks travel
          round the ring instead, each rotation evaluated where a tile
          needs it.

float32 with the kernels (--kernel other than torch) takes the two
kernels, as nbody_tpu's _use_pallas_eval takes the Pallas ones; float64,
or --kernel torch, takes the plain torch sums of nbody_tpu's jnp branch
(_eval_far, _eval_near, the beyond tiles), chunked over tiles and rows.
On the CPU the kernels' wrappers run their plain twins, as every path of
the port does. No temporary grows past about 1 GiB a rank at 2^20 bodies:
the MAC's distances are summed one dimension at a time, the masks are
packed a few tiles at a time and the plain sums take bounded chunks.

The 2-D (body x tile) mesh (--mesh-tile T > 1): the sort, heap, halo and
beyond gathers run over the body group, each rank of a tile group
evaluates 1/T of its block's rows, and one gather over the tile group
reassembles the accelerations; the need and overflow sums span the grid.

A rank keeps its own block of the padded state between steps: a
PartitionedStep shards the caller's state before the first step (shard)
and gathers the real rows after the last (gather). Before each step its
pad rows are made again, zero-mass copies of global row n - 1, as
nbody_tpu pads the state that each step is given (_make_step, :427-467).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops.allpairs import pairs_per_chunk
from nbody_torch.ops.cuda_group_eval import (ROWS_PER_BLOCK, masked_eval_bits_cuda,
                                             pack_mask_bits, window_eval_interval_cuda)
from nbody_torch.ops.hilbert import hilbert_keys, quantize
from nbody_torch.ops.integrator import leapfrog_step
from nbody_torch.ops.octree import max_depth, morton_keys, robust_quant_box
from nbody_torch.parallel.distributed_sort import distributed_sort_rows
from nbody_torch.parallel.mesh import (BodyTileMesh, Mesh, all_gather_rows, all_reduce_max,
                                       all_reduce_min, all_reduce_sum, body_tile_mesh, ring_shift,
                                       shift, sum_in_rank_order)
from nbody_torch.state import SystemState

FIELDS = ("m", "x", "v", "a", "ao")
TILE = 256  # rows a tile (nbody_tpu's default; the CLI passes no other)
PACK_BYTES = 1 << 27  # the int64 intermediate of one chunk of packed mask rows
TEMP_BYTES = 1 << 30  # a plain sum's largest temporary, its (pairs, dim) differences


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def coarse_level(n: int, dim: int, cap_cells: int = 1 << 14) -> int:
    """L_top of the octree (_coarse_level, :92-105): ~16 bodies a cell at
    uniform density, at most cap_cells cells."""
    nbranch = 1 << dim
    level = 1
    while nbranch ** (level + 1) <= cap_cells and (nbranch ** level) * 16 < n * 4:
        level += 1
    return level


def comm_accounting(*, n_shards, nl, dim, esize, nkeys, C, halo, r_budget, T, nlt,
                    halo_key_words=0, ring_key_words=0, sub_rows=0) -> dict:
    """Each rank's send bytes a step by category (_comm_accounting,
    :382-424): the sort's static bound, the heap's sum, the halo blocks,
    the beyond need mask and gather, the ring fallback (counted apart) and
    the tile gather; step_bytes_no_sort adds all but the sort and the ring."""
    state_row = (1 + 4 * dim) * esize
    sort_row = nkeys * 4 + state_row
    heap = C * (4 + esize * (1 + 3 * dim))
    out = {
        "sort_bytes_max": n_shards * nl * sort_row,
        "box_subsample_bytes": sub_rows * dim * esize,
        "heap_psum_bytes": heap,
        "halo_bytes": 2 * halo * nl * ((1 + dim) * esize + 4 * halo_key_words),
        "beyond_need_psum_bytes": C * 4,
        "beyond_gather_bytes": r_budget * ((1 + dim) * esize + 4),
        "ring_fallback_bytes": (n_shards - 1) * nl * ((1 + dim) * esize + 4 * ring_key_words),
        "tile_gather_bytes": (nlt * dim * esize) if T > 1 else 0,
    }
    out["step_bytes_no_sort"] = (
        out["box_subsample_bytes"] + out["heap_psum_bytes"] + out["halo_bytes"]
        + out["beyond_need_psum_bytes"] + out["beyond_gather_bytes"] + out["tile_gather_bytes"])
    return out


def check_bvh_layout(n_shards: int, tile: int, tile_shards: int) -> None:
    """The partitioned BVH's sizes must be powers of two (:517-520)."""
    if n_shards & (n_shards - 1) or tile & (tile - 1) or tile_shards & (tile_shards - 1):
        raise ValueError("partitioned bvh requires power-of-two n_shards, "
                         f"tile and tile_shards (got {n_shards}, {tile}, {tile_shards})")


# ------------------------------------------------------------------ evaluation


def _softened(d2: torch.Tensor, eps: torch.Tensor, softening: str) -> torch.Tensor:
    """The denominator: d2 * sqrt(d2) + eps ("poly", the BVH) or
    (sqrt(d2) + eps)^3 ("sqrt3", the octree)."""
    if softening == "poly":
        return d2 * torch.sqrt(d2) + eps
    s = torch.sqrt(d2) + eps
    return s * s * s


def _keep(mask: torch.Tensor, cols: torch.Tensor | None, t0: int, t1: int) -> torch.Tensor:
    """Tiles t0..t1 of mask (T, W), its columns `cols` (None: all)."""
    rows = mask[t0:t1]
    return rows if cols is None else rows[:, cols]


def _pack(mask: torch.Tensor, cols: torch.Tensor | None) -> torch.Tensor:
    """pack_mask_bits of mask[:, cols], a few tiles at a time."""
    width = mask.shape[1] if cols is None else cols.shape[0]
    step = max(1, PACK_BYTES // (8 * _round_up(width, 32)))
    return torch.cat([pack_mask_bits(_keep(mask, cols, t, t + step))
                      for t in range(0, mask.shape[0], step)])


def _plain_sum(xt: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: torch.Tensor,
               softening: str, mask: torch.Tensor | None = None,
               cols: torch.Tensor | None = None) -> torch.Tensor:
    """nbody_tpu's jnp evaluation (_eval_far, _eval_near, the beyond
    tiles): row i of tile t against the sources j, where(keep[t, j],
    m_j / soften(d2), 0) * (x_j - x_i) summed over j, keep = mask[:,
    cols] (None: every source). xt (T, tb, dim) -> (T * tb, dim)."""
    ntiles, tb, dim = xt.shape
    nj = xj.shape[0]
    out = torch.empty_like(xt)
    budget = min(pairs_per_chunk(xt.device), TEMP_BYTES // (dim * xt.element_size()))
    g = max(1, budget // (tb * nj))
    rc = tb if g > 1 else max(1, min(tb, budget // nj))
    for t0 in range(0, ntiles, g):
        keep = None if mask is None else _keep(mask, cols, t0, t0 + g)[:, None, :]
        for r0 in range(0, tb, rc):
            xi = xt[t0:t0 + g, r0:r0 + rc]
            dx = xj[None, None] - xi[:, :, None]
            d2 = torch.sum(dx * dx, dim=-1)
            w = mj / _softened(d2, eps, softening)
            if keep is not None:
                w = torch.where(keep, w, torch.zeros((), dtype=w.dtype, device=w.device))
            out[t0:t0 + g, r0:r0 + rc] = torch.einsum("grj,grjd->grd", w, dx)
    return out.view(-1, dim)


@dataclasses.dataclass(frozen=True)
class _Eval:
    """The evaluations of one step: the kernels (float32, use_kernels) or
    the plain sums."""
    use_kernels: bool
    eps: float
    softening: str
    tile: int

    def masked(self, x_i: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
               mask: torch.Tensor, cols: torch.Tensor | None = None) -> torch.Tensor:
        """Row tile t against the sources j with mask[t, cols[j]] set (the
        far field, and the beyond sets)."""
        if self.use_kernels:
            return masked_eval_bits_cuda(x_i, mj, xj, _pack(mask, cols), self.eps,
                                         self.softening)
        eps = torch.tensor(self.eps, dtype=x_i.dtype, device=x_i.device)
        return _plain_sum(x_i.view(-1, self.tile, x_i.shape[1]), mj, xj, eps, self.softening,
                          mask, cols)

    def interval(self, x_i: torch.Tensor, m_e: torch.Tensor, x_e: torch.Tensor, lo, hi,
                 e0: int) -> torch.Tensor:
        """Every row against the window rows j with lo <= e0 + j < hi
        (_eval_near_pallas / _eval_near)."""
        ntiles = x_i.shape[0] // self.tile
        if self.use_kernels:
            # the near field's interval is the same for every tile, so it
            # takes tiles of the kernel's block where they divide the rows:
            # tiles of self.tile rows would leave half of each block idle
            dev = x_i.device
            whole = x_i.shape[0] % ROWS_PER_BLOCK == 0 and x_e.shape[0] % ROWS_PER_BLOCK == 0
            tb = ROWS_PER_BLOCK if whole else self.tile
            nt = x_i.shape[0] // tb
            zeros = torch.zeros(nt, dtype=torch.int32, device=dev)
            lo_b = (torch.as_tensor(lo, device=dev) - e0).to(torch.int32).expand(nt)
            hi_b = (torch.as_tensor(hi, device=dev) - e0).to(torch.int32).expand(nt)
            return window_eval_interval_cuda(x_i, m_e, x_e, zeros, lo_b.contiguous(),
                                             hi_b.contiguous(), self.eps, x_e.shape[0] // tb,
                                             self.softening)
        jrow = e0 + torch.arange(m_e.shape[0], device=m_e.device)
        mj = torch.where((jrow >= lo) & (jrow < hi), m_e, torch.zeros_like(m_e))
        eps = torch.tensor(self.eps, dtype=x_i.dtype, device=x_i.device)
        return _plain_sum(x_i.view(ntiles, self.tile, -1), mj, x_e, eps, self.softening)


# ------------------------------------------------------------------ the heap


def _pool(a: torch.Tensor, nbranch: int, op: str) -> torch.Tensor:
    """One level up: each node's nbranch children, added in child order
    (XLA's order on the CPU), or their min / max."""
    v = a.view(-1, nbranch, *a.shape[1:])
    if op == "min":
        return v.amin(1)
    if op == "max":
        return v.amax(1)
    total = v[:, 0].clone()
    for c in range(1, nbranch):
        total += v[:, c]
    return total


def _psum_heap(body: Mesh, index: torch.Tensor, m: torch.Tensor, x: torch.Tensor, C: int,
               nbranch: int, L: int) -> dict:
    """The replicated coarse heap (_psum_heap, :134-159): this rank's rows
    scattered into the C leaf cells (a pad row's index C drops), summed
    over the ranks in rank order (counts, mass, m*x) or reduced (extents),
    then pooled to levels 0..L. Returns per-level lists, index 0 the root."""
    dim, dtype, dev = x.shape[1], x.dtype, x.device
    big = torch.finfo(dtype).max
    rows = index[:, None].expand(-1, dim)
    cnt = torch.bincount(index, minlength=C + 1)[:C].to(torch.int32)
    mass = torch.zeros(C + 1, dtype=dtype, device=dev).index_add_(0, index, m)[:C]
    mx = torch.zeros(C + 1, dim, dtype=dtype, device=dev).index_add_(0, index, m[:, None] * x)[:C]
    cmin = torch.full((C + 1, dim), big, dtype=dtype, device=dev).scatter_reduce_(
        0, rows, x, "amin")[:C]
    cmax = torch.full((C + 1, dim), -big, dtype=dtype, device=dev).scatter_reduce_(
        0, rows, x, "amax")[:C]
    lvl = {"cnt": [all_reduce_sum(body, cnt)], "mass": [sum_in_rank_order(body, mass)],
           "mx": [sum_in_rank_order(body, mx)], "cmin": [all_reduce_min(body, cmin)],
           "cmax": [all_reduce_max(body, cmax)]}
    for _ in range(L):
        for key, op in (("cnt", "sum"), ("mass", "sum"), ("mx", "sum"), ("cmin", "min"),
                        ("cmax", "max")):
            lvl[key].insert(0, _pool(lvl[key][0], nbranch, op))
    return lvl


def _halo_window(body: Mesh, arrays, halo: int) -> list[torch.Tensor]:
    """The window E of each array: the blocks of ranks r - halo .. r + halo
    in order, zeros for a missing edge neighbour (_halo_window, :162-177)."""
    parts = {0: list(arrays)}
    for h in range(-halo, halo + 1):
        if h:
            parts[h] = shift(body, h, *arrays)
    return [torch.cat([parts[h][i] for h in range(-halo, halo + 1)])
            for i in range(len(arrays))]


def _mac_concat(lvl: dict, xt: torch.Tensor, range_fn: Callable, lo_t, hi_t,
                theta2: torch.Tensor, nbranch: int, L: int):
    """Each tile's conservative group MAC over the pooled heap, level by
    level (_mac_concat, :180-224): nodes inside [lo_t, hi_t) dropped (the
    near field has them), nodes that straddle it forced open, the rest
    tested. Returns the accept mask (T, W_all), the nodes' centres and
    masses, the open set at L beyond the interval, its cell count and its
    mass."""
    tmin, tmax = xt.amin(1), xt.amax(1)
    ntiles, dim = xt.shape[0], xt.shape[2]
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    floor = torch.tensor(1e-30, dtype=xt.dtype, device=xt.device)
    accepts, coms, masses = [], [], []
    open_mask = torch.ones((ntiles, 1), dtype=torch.bool, device=xt.device)
    for level in range(L + 1):
        cl, msl = lvl["cnt"][level], lvl["mass"][level]
        com = lvl["mx"][level] / torch.maximum(msl, floor)[:, None]
        alive = (cl > 0)[None, :]
        dmin2 = None
        for d in range(dim):  # one dimension at a time: no (T, W, dim) temporary
            v = torch.maximum(tmin[:, None, d] - com[None, :, d], zero)
            v = torch.maximum(v, com[None, :, d] - tmax[:, None, d])
            dmin2 = v * v if dmin2 is None else dmin2 + v * v
        width = (lvl["cmax"][level] - lvl["cmin"][level]).amax(-1)
        weff = torch.where(cl > 0, width, zero)[None, :]
        single = (cl == 1)[None, :]
        lstart, lend = range_fn(level)
        inside = (lstart >= lo_t) & (lend <= hi_t)
        partial_w = (lstart < hi_t) & (lend > lo_t) & ~inside
        mac = ((weff * weff < theta2 * dmin2) | single) & ~partial_w
        del dmin2
        accept = open_mask & alive & mac & ~inside
        open_ = open_mask & alive & ~mac & ~inside
        accepts.append(accept)
        coms.append(com)
        masses.append(msl)
        if level < L:
            open_mask = torch.repeat_interleave(open_, nbranch, dim=1)
    beyond_cells = open_.sum(dtype=torch.int32)
    beyond_mass = torch.where(open_.any(0), msl, zero).sum()
    return torch.cat(accepts, 1), torch.cat(coms), torch.cat(masses), open_, beyond_cells, \
        beyond_mass


# ------------------------------------------------------------------ beyond the halo


def _beyond(mesh: BodyTileMesh, ev: _Eval, x_i: torch.Tensor, beyond: torch.Tensor,
            m_l: torch.Tensor, x_l: torch.Tensor, cell_local: torch.Tensor, extras: list,
            cell_of_visitor: Callable, r_budget: int):
    """The beyond-halo cells' bodies, exactly (_beyond_exchange,
    :286-341): the compacted exchange, or the ring when a rank's rows
    overflow r_budget. Returns (accelerations of x_i's rows, ring used)."""
    body, C = mesh.body, beyond.shape[1]
    need = all_reduce_sum(mesh.grid, beyond.any(0).to(torch.int32)) > 0
    rowmask = (cell_local < C) & need[cell_local.clamp_max(C - 1)]
    count = rowmask.sum()
    dst = torch.where(rowmask, torch.cumsum(rowmask, 0) - 1,
                      torch.full_like(cell_local, r_budget)).clamp_max(r_budget)
    m_b = m_l.new_zeros(r_budget + 1)
    x_b = x_l.new_zeros(r_budget + 1, x_l.shape[1])
    c_b = torch.zeros(r_budget + 1, dtype=torch.int64, device=m_l.device)
    m_b[dst], x_b[dst], c_b[dst] = m_l, x_l, cell_local
    m_g, x_g, c_g = (all_gather_rows(body, t[:r_budget]) for t in (m_b, x_b, c_b))
    overflow = bool(all_reduce_sum(mesh.grid, (count > r_budget).to(torch.int32)) > 0)
    if overflow:  # all-reduced: every rank takes this branch or none does
        return _ring_beyond(body, ev, x_i, beyond, m_l, x_l, extras, cell_of_visitor), True
    if not bool(beyond.any(0)[c_g].any()):
        return torch.zeros_like(x_i), False
    return ev.masked(x_i, m_g, x_g, beyond, c_g), False


def _ring_beyond(body: Mesh, ev: _Eval, x_i: torch.Tensor, beyond: torch.Tensor,
                 m_l: torch.Tensor, x_l: torch.Tensor, extras: list,
                 cell_of_visitor: Callable) -> torch.Tensor:
    """The beyond cells' bodies by a block ring (_ring_beyond, :344-379):
    rotation r brings rank (r - rotation)'s block, whose rows in the
    tile's beyond cells are added; a rotation no tile needs is not
    evaluated, but every rank shifts every rotation."""
    ring = torch.zeros_like(x_i)
    mv, xv, ev_extras = m_l, x_l, list(extras)
    for r in range(body.world):
        cells = cell_of_visitor(r, ev_extras)
        if bool(beyond.any(0)[cells].any()):
            ring = ring + ev.masked(x_i, mv, xv, beyond, cells)
        if r + 1 < body.world:
            mv, xv, *ev_extras = ring_shift(body, mv, xv, *ev_extras)
    return ring


# ------------------------------------------------------------------ the steps


@dataclasses.dataclass(frozen=True)
class Layout:
    """The padded body count of a partitioned step and its grid."""
    n_shards: int
    tile_shards: int
    npad: int

    @property
    def nl(self) -> int:
        """Rows a body rank holds."""
        return self.npad // self.n_shards

    @property
    def nlt(self) -> int:
        """Rows a rank evaluates."""
        return self.nl // self.tile_shards


class PartitionedStep:
    """A partitioned step on one rank: step(state, k) -> (state, aux) on
    the rank's block of the padded state (shard makes it from the whole
    state, gather the whole state from the blocks). aux: beyond_halo_cells
    and beyond_halo_mass (over the grid), root_mass, comm (the static
    accounting), beyond_used_ring and comm_bytes_per_shard, as nbody_tpu's
    (_make_step, :451-465), and overflow, 0, as its engines add it
    (tree_engines.py:111-115)."""

    def __init__(self, cfg: SimConfig, mesh: BodyTileMesh, layout: Layout, comm: dict,
                 force: Callable):
        self.cfg, self.mesh, self.layout, self.comm, self._force = cfg, mesh, layout, comm, force

    def shard(self, state: SystemState) -> SystemState:
        """This rank's block of the caller's whole state, padded."""
        if state.n != self.cfg.n:
            raise ValueError(f"a step built for {self.cfg.n} bodies got {state.n}")
        r0 = self.mesh.body.rank * self.layout.nl
        pad = self.layout.npad - state.n
        blocks = {}
        for f in FIELDS:
            t = getattr(state, f)
            t = torch.cat([t, t.new_zeros(pad, *t.shape[1:])]) if pad else t
            blocks[f] = t[r0:r0 + self.layout.nl].clone()
        return self._repad(SystemState(**blocks))

    def gather(self, state: SystemState) -> SystemState:
        """The whole state from the body ranks' blocks, the pads dropped."""
        return SystemState(*(all_gather_rows(self.mesh.body, getattr(state, f))[:self.cfg.n]
                             for f in FIELDS))

    def _repad(self, st: SystemState) -> SystemState:
        """The block with its pad rows (global rows >= n) made zero-mass
        copies of global row n - 1 at rest (_make_step's padding)."""
        n, nl = self.cfg.n, self.layout.nl
        if self.layout.npad == n:
            return st
        owner, row = divmod(n - 1, nl)
        last = all_gather_rows(self.mesh.body, st.x[row][None])[owner]
        first = n - self.mesh.body.rank * nl  # this block's first pad row
        if first >= nl:
            return st
        first = max(first, 0)
        st.m[first:] = 0
        st.x[first:] = last
        for f in ("v", "a", "ao"):
            getattr(st, f)[first:] = 0
        return st

    def __call__(self, state: SystemState, k: int = 0):
        st = self._repad(state)
        m, x, v, ao, acc, bc, bm, root_mass, ring_used = self._force(st)
        comm = self.comm
        aux = {"beyond_halo_cells": bc, "beyond_halo_mass": bm, "root_mass": root_mass,
               "comm": dict(comm), "beyond_used_ring": ring_used,
               "comm_bytes_per_shard": comm["step_bytes_no_sort"]
               + (comm["ring_fallback_bytes"] if ring_used else 0),
               "overflow": torch.zeros((), dtype=torch.int32, device=acc.device)}
        return leapfrog_step(SystemState(m, x, v, acc, ao), self.cfg.dt), aux


def _sort_state(body: Mesh, key_words: torch.Tensor, st: SystemState, nreal: int):
    """The distributed sort of the block by (pad flag, *key words), the
    flag major (_sort_state, :112-131). Returns (key words, m, x, v, a, ao)."""
    nl, dim = st.n, st.dim
    grow = body.rank * nl + torch.arange(nl, device=st.x.device)
    keys = torch.cat([(grow >= nreal).to(torch.int64)[:, None], key_words], 1)
    cols = torch.cat([st.m[:, None], st.x, st.v, st.a, st.ao], 1)
    keys, cols = distributed_sort_rows(body, keys, cols)
    split = [c.contiguous() for c in torch.split(cols, [1, dim, dim, dim, dim], 1)]
    return keys[:, 1:], split[0][:, 0], *split[1:]


def _rows_of(mesh: BodyTileMesh, layout: Layout, x_l: torch.Tensor) -> torch.Tensor:
    """The rows this rank evaluates: its tile group's slice of the block."""
    t0 = mesh.tile.rank * layout.nlt
    return x_l[t0:t0 + layout.nlt]


def _finish(mesh: BodyTileMesh, far, near, ring, G: float, bc, bm):
    acc = G * (far + near + ring)
    return all_gather_rows(mesh.tile, acc), all_reduce_sum(mesh.grid, bc), \
        all_reduce_max(mesh.grid, bm)


def make_partitioned_bvh_step(cfg: SimConfig, world_mesh: Mesh | None, n_shards: int | None = None,
                              tile: int = TILE, halo: int = 1, l_top: int | None = None,
                              use_kernels: bool = True, beyond_budget: int | None = None,
                              tile_shards: int = 1, comm_only: bool = False):
    """The partitioned implicit-BVH step (make_partitioned_bvh_step,
    :479-626): the Hilbert curve (the true curve in 3-D) over the ranks'
    pmin/pmax box, node j of level l the rows [j * 2^(k-l), (j+1) *
    2^(k-l)) of the padded power-of-two stream, the poly softening. On the
    n_shards * tile_shards first ranks of world_mesh (n_shards: all of
    them by default), every rank of which calls this; returns a
    PartitionedStep, None on a rank outside the grid, or with comm_only
    the accounting dict alone (no mesh needed)."""
    T = int(tile_shards)
    S = n_shards or world_mesh.world // T
    dim, n = cfg.dim, cfg.n
    check_bvh_layout(S, tile, T)
    k = max(1, (max(n, 2) - 1).bit_length())
    npad = 1 << k
    while npad % (S * tile * T):
        npad *= 2
        k += 1
    nl = npad // S
    L = l_top if l_top is not None else max(1, min(k - 4, 14))
    L = min(L, k, (nl - 1).bit_length())
    C = 1 << L
    r_budget = beyond_budget if beyond_budget else max(256, nl // 4)
    layout = Layout(S, T, npad)
    comm = comm_accounting(n_shards=S, nl=nl, dim=dim, esize=np.dtype(cfg.dtype).itemsize,
                           nkeys=3, C=C, halo=halo, r_budget=r_budget, T=T, nlt=layout.nlt)
    if comm_only:
        return comm
    mesh = body_tile_mesh(world_mesh, S, T)
    if mesh is None:
        return None
    ev = _Eval(use_kernels and np.dtype(cfg.dtype) == np.float32, cfg.eps, "poly", tile)
    idx = mesh.body.rank
    shift_l = k - L

    def force(st: SystemState):
        x_l = st.x
        dev, dtype = x_l.device, x_l.dtype
        tol = torch.full((), 10.0 * cfg.eps, dtype=dtype, device=dev)
        zero = x_l.new_zeros(())
        lo = all_reduce_min(mesh.body, torch.minimum(x_l.amin(0), zero)) - tol
        hi = all_reduce_max(mesh.body, torch.maximum(x_l.amax(0), zero)) + tol
        key = hilbert_keys(quantize(x_l, lo, hi - lo), n_active=dim)
        _, m_l, x_l, v_l, _, ao_l = _sort_state(mesh.body, key[:, None], st, n)
        grow = idx * nl + torch.arange(nl, device=dev)
        node = torch.where(grow < n, grow >> shift_l, torch.full_like(grow, C))
        lvl = _psum_heap(mesh.body, node, m_l, x_l, C, 2, L)
        m_e, x_e = _halo_window(mesh.body, [m_l, x_l], halo)
        e0 = (idx - halo) * nl
        r0, r1 = max(0, e0), min(npad, (idx + halo + 1) * nl)
        x_i = _rows_of(mesh, layout, x_l)
        xt = x_i.view(-1, tile, dim)

        def range_fn(level):
            span = 1 << (k - level)
            lstart = torch.arange(1 << level, device=dev)[None, :] * span
            return lstart, lstart + span

        theta2 = torch.tensor(cfg.theta * cfg.theta, dtype=dtype, device=dev)
        acc_all, com_all, ms_all, beyond, bc, bm = _mac_concat(lvl, xt, range_fn, r0, r1,
                                                               theta2, 2, L)
        far = ev.masked(x_i, ms_all, com_all, acc_all)
        del acc_all
        near = ev.interval(x_i, m_e, x_e, r0, r1, e0)

        def cell_of_visitor(r, _extras):
            src = (idx - r) % S
            return (src * nl + torch.arange(nl, device=dev)) >> shift_l

        ring, ring_used = _beyond(mesh, ev, x_i, beyond, m_l, x_l, node, [], cell_of_visitor,
                                  r_budget)
        acc, bc, bm = _finish(mesh, far, near, ring, cfg.G, bc, bm)
        return m_l, x_l, v_l, ao_l, acc, bc, bm, lvl["mass"][0][0], ring_used

    return PartitionedStep(cfg, mesh, layout, comm, force)


def make_partitioned_octree_step(cfg: SimConfig, world_mesh: Mesh | None,
                                 n_shards: int | None = None, tile: int = TILE, halo: int = 1,
                                 l_top: int | None = None, use_kernels: bool = True,
                                 beyond_budget: int | None = None, tile_shards: int = 1,
                                 comm_only: bool = False):
    """The partitioned Morton-cell octree step
    (make_partitioned_octree_step, :629-785): the robust box of a strided
    subsample gathered from the ranks, cells' row ranges from the summed
    counts, the near interval snapped to L-level cells, the sqrt3
    softening. Arguments and result as make_partitioned_bvh_step's."""
    T = int(tile_shards)
    S = n_shards or world_mesh.world // T
    dim, n = cfg.dim, cfg.n
    depth = max_depth(n, dim)
    nbranch = 1 << dim
    L = l_top if l_top is not None else coarse_level(n, dim)
    L = min(L, depth)
    C = nbranch ** L
    npad = _round_up(n, S * tile * T)
    nl = npad // S
    r_budget = beyond_budget if beyond_budget else max(256, nl // 4)
    layout = Layout(S, T, npad)
    # each rank's strided subsample of the robust box (the single-device
    # path subsamples to at most 16,384 rows, octree.py:355)
    sub_stride = max(1, (npad // S) // max(1, 16384 // S))
    comm = comm_accounting(n_shards=S, nl=nl, dim=dim, esize=np.dtype(cfg.dtype).itemsize,
                           nkeys=2, C=C, halo=halo, r_budget=r_budget, T=T, nlt=layout.nlt,
                           halo_key_words=1, ring_key_words=1, sub_rows=-(-nl // sub_stride))
    if comm_only:
        return comm
    mesh = body_tile_mesh(world_mesh, S, T)
    if mesh is None:
        return None
    ev = _Eval(use_kernels and np.dtype(cfg.dtype) == np.float32, cfg.eps, "sqrt3", tile)
    idx = mesh.body.rank
    shift_l = (depth - L) * dim

    def force(st: SystemState):
        dev, dtype = st.x.device, st.x.dtype
        sub = all_gather_rows(mesh.body, st.x[::sub_stride])
        lo, hi = robust_quant_box(sub)
        keys0 = morton_keys(st.x, lo, hi, depth)
        keys, m_l, x_l, v_l, _, ao_l = _sort_state(mesh.body, keys0[:, None], st, n)
        keys = keys[:, 0]
        grow = idx * nl + torch.arange(nl, device=dev)
        cell = torch.where(grow >= n, torch.full_like(keys, C), keys >> shift_l)
        lvl = _psum_heap(mesh.body, cell, m_l, x_l, C, nbranch, L)
        cnt = lvl["cnt"][L].long()
        ce = torch.cumsum(cnt, 0)
        cs = torch.cat([ce - cnt, torch.tensor([n], device=dev)])
        ce = torch.cat([ce, torch.tensor([npad], device=dev)])
        m_e, x_e, k_e = _halo_window(mesh.body, [m_l, x_l, keys], halo)
        e0 = (idx - halo) * nl
        r0, r1 = max(0, e0), min(npad, (idx + halo + 1) * nl)
        jrow = e0 + torch.arange(k_e.shape[0], device=dev)
        cell_e = torch.where(jrow >= n, torch.full_like(k_e, C), k_e >> shift_l)
        c0, c1 = cell_e[r0 - e0], cell_e[r1 - 1 - e0]
        lo_t = torch.where(cs[c0] == r0, r0, ce[c0])
        hi_t = torch.maximum(torch.where(ce[c1] == r1, r1, cs[c1]), lo_t)
        x_i = _rows_of(mesh, layout, x_l)
        xt = x_i.view(-1, tile, dim)

        def range_fn(level):
            cl = lvl["cnt"][level].long()
            lend = torch.cumsum(cl, 0)
            return (lend - cl)[None, :], lend[None, :]

        theta2 = torch.tensor(cfg.theta * cfg.theta, dtype=dtype, device=dev)
        acc_all, com_all, ms_all, beyond, bc, bm = _mac_concat(lvl, xt, range_fn, lo_t, hi_t,
                                                               theta2, nbranch, L)
        far = ev.masked(x_i, ms_all, com_all, acc_all)
        del acc_all
        near = ev.interval(x_i, m_e, x_e, lo_t, hi_t, e0)

        def cell_of_visitor(_r, extras):
            return extras[0] >> shift_l

        ring, ring_used = _beyond(mesh, ev, x_i, beyond, m_l, x_l, cell, [keys],
                                  cell_of_visitor, r_budget)
        acc, bc, bm = _finish(mesh, far, near, ring, cfg.G, bc, bm)
        return m_l, x_l, v_l, ao_l, acc, bc, bm, lvl["mass"][0][0], ring_used

    return PartitionedStep(cfg, mesh, layout, comm, force)
