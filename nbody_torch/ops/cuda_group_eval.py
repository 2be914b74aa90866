"""Wrappers of the hand-written CUDA tree-evaluation kernels, their plain
twins, and the far field's accept-mask packing.

The port of the nbody_tpu.ops.pallas_group_eval kernels on the octree and
BVH fast and list paths. The kernels live in nbody_torch/csrc/group_eval.cu
(see its header for the design):

  masked_eval_bits_kernel      replaces masked_eval_bits_pallas
                               (pallas_group_eval.py:310; body
                               _masked_bits_kernel :270): the far field,
                               each tile's accepted nodes compacted in the
                               block (far_ids mirrors it), by the Newton
                               chain
  window_eval_interval_kernel  replaces window_eval_interval_pallas (:502;
                               body _window_interval_kernel :455): the
                               octree's near window, each tile's interval
                               split in the kernel into at most P parts
                               (interval_parts mirrors the split), by the
                               Newton chain
  window_eval_nodemask_kernel  replaces window_eval_nodemask_pallas (:614;
                               body _window_nodemask_kernel :563): the
                               BVH's near window, each tile's open bodies
                               split in the kernel into at most P parts
                               (window_parts mirrors the split), by the
                               Newton chain
  window_eval_dense_kernel     replaces window_eval_pallas (:383; body
                               _masked_eval_kernel :184): the BVH's near
                               window with a dense body mask (n <= 16, and
                               the densemask token), each tile's columns
                               split in the kernel into at most P parts
                               (dense_parts mirrors the split), stages of
                               zero weight skipped, by the Newton chain
  entries_lohi_kernel          replaces entries_lohi_eval_pallas (:963; body
                               _entries_lohi_kernel :823): the near-field
                               exact entries, in equal-work parts
                               (entries_plan), by the Newton chain
  entries_sum_kernel           adds each tile's parts in part order after
                               any of the three entries kernels (the TPU
                               grid's sequential walk of a tile's run)
  parts_sum_kernel             the same second pass after the list kernel
                               and the three windows: P slices a tile, the
                               first nparts[t] of them written
  masked_eval_kernel           replaces masked_eval_pallas (:216; body
                               _masked_eval_kernel :184): the far field
                               with a dense float32 weight mask (ablate
                               token densemask): the far field's walk over
                               each tile's nonzero weights, compacted in
                               the block (dense_ids mirrors it), each mass
                               folded as mask * m, by the Newton chain
  group_shared_masked_kernel   replaces group_shared_masked_eval_pallas
                               (:717; body _group_shared_masked_kernel
                               :684): supertile-shared monopole lists with
                               per-tile weight masks (farcompact, desc1 /
                               desc2), the same walk over list t // G
  entries_lohi_kernel<packed>  replaces _entries_lohi_packed_kernel (:896;
                               entries_lohi_eval_pallas(packed_j=True)
                               :1040): the entries with each source read
                               as one float4 (x, y, z | 0, m) (packedj)
  entries_tables_kernel        replaces entries_tables_eval_pallas (:1126;
                               body _entries_tables_kernel :777): the
                               table-driven entries that python -m
                               nbody_torch.probe entries times
  group_eval_kernel            computes group_eval_pallas's function (:83;
                               body _group_eval_kernel): the list paths'
                               evaluation, each tile against its own list.
                               On the float64 path it stands where nbody_tpu
                               runs its jnp evaluation (octree_group.py:375-
                               416, bvh_group.py:295-331): nbody_tpu reaches
                               group_eval_pallas only through
                               compute_force_grouped(use_pallas=...).
                               Each tile's live heads are split in the
                               kernel into at most P parts; a tile whose
                               heads are both empty costs nothing (the list
                               paths pass such heads for the tiles that the
                               exact fallback overwrites). The Newton chain
                               in float32, refined MUFU seeds in float64

Four of them take a mode that the knob probe's A/B tokens ask for (the
`ablate=` tokens of both fast paths), each a template flag of its kernel
with its own launch_counts name: masked_eval_bits_kernel<tg2>
(tile_group=2, the ftg2 token: a block holds two tiles' rows and walks the
OR of their accepted nodes, each row weighting a node by its own tile's
bit), window_eval_interval_kernel<full> and window_eval_nodemask_kernel<full>
(skip_outside=False, nowinskip: the whole window visited, the columns
outside the interval or of a closed slot weighted 0), and
entries_lohi_kernel<span> / <packed, span> (sub_width or skip_empty=False,
subwN and noskip: each entry visits a span around its [lo, hi), as the
Pallas kernel's guarded subwindows do, the rest of the span weighted 0).
A weight multiplies the mass before the chain, (sel * m) * r, as in
nbody_tpu, so a masked source adds 0 * dx. The twins take the same
arguments; their float64 sums are those of the default mode.

All of them take the rows xi of T tiles of tb rows each, as an (T*tb, dim)
array, and return their raw (G-less) accelerations in the same layout.
`softening`, which every caller names, is "poly" (t = d2 * sqrt(d2) + eps,
which the BVH passes, as in nbody_tpu) or "sqrt3" (t = (sqrt(d2) + eps)^3,
octree.h:156-160, which the octree passes).
Each wrapper checks its inputs, allocates the output (and the entries
kernels' scratch of partial rows) with torch.empty, launches on the
current stream, raises on a CUDA error and adds one to `launch_counts`
for each kernel it launched. It runs the plain twin beside
it only when its tensors lie on the CPU; on a CUDA tensor it launches the
kernel or raises. The fast paths' kernels take float32 only, as the Pallas
kernels do; group_eval_kernel takes float32 and float64 (the list paths
are what float64 runs take; float32 reaches them through the list_path
branch of the step functions); the twins take either precision.

Every kernel here takes the two-MUFU chain of csrc/pair.cuh: in float32
nbody_tpu's own reciprocal, the approximate one and a Newton step
(pallas_group_eval.py:73-74, :143-144, :206-208, :707-709, :877-878),
within 1 ulp of the division; in float64 (the list kernel) MUFU seeds
refined twice, within a few ulps of it. Every twin divides in IEEE (the
hardware's approximate reciprocal cannot be reproduced on the CPU), and
the kernels' tolerance against the twins covers the ulps.

The accept mask is packed node l -> word l // 32, bit l % 32
(pack_mask_bits / unpack_mask_bits). nbody_tpu's strided order
(pallas_group_eval.py:148-181) served the TPU's lane layout and is not
carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import accumulate

import torch

from nbody_torch.ops.allpairs import SOFTENINGS, pairs_per_chunk
from nbody_torch.ops.cuda_allpairs import _DTYPE_CODES, _on_cpu, _raise_on_error, sm_count_of

# Kernel launches since the last reset, by kernel name (the list kernel's
# by instantiation, group_eval_name); the twins never count.
launch_counts = {"masked_eval_bits_kernel": 0, "window_eval_interval_kernel": 0,
                 "window_eval_nodemask_kernel": 0, "window_eval_dense_kernel": 0,
                 "entries_lohi_kernel": 0, "masked_eval_kernel": 0,
                 "group_shared_masked_kernel": 0, "entries_lohi_kernel<packed>": 0,
                 "entries_tables_kernel": 0, "entries_sum_kernel": 0, "parts_sum_kernel": 0,
                 # the A/B modes of the ablate tokens ftg2, nowinskip, subwN / noskip
                 "masked_eval_bits_kernel<tg2>": 0, "window_eval_interval_kernel<full>": 0,
                 "window_eval_nodemask_kernel<full>": 0, "entries_lohi_kernel<span>": 0,
                 "entries_lohi_kernel<packed, span>": 0,
                 **{f"group_eval_kernel<{dtype}, {softening}>": 0
                    for dtype in ("float32", "float64") for softening in SOFTENINGS}}


def group_eval_name(dtype: torch.dtype, softening: str) -> str:
    """The launch_counts key of the list kernel's instantiation for these
    rows and softening, e.g. "group_eval_kernel<float64, sqrt3>"."""
    return f"group_eval_kernel<{str(dtype).removeprefix('torch.')}, {softening}>"


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# --------------------------------------------------------------------------
# accept-mask bit packing


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """(T, W) bool -> (T, ceil(W / 32)) int32 words, node l in word l // 32,
    bit l % 32 (bit 31 is the sign bit)."""
    t, w = mask.shape
    nw = -(-w // 32)
    bits = torch.nn.functional.pad(mask, (0, nw * 32 - w)).view(t, nw, 32).to(torch.int64)
    words = (bits << torch.arange(32, device=mask.device)).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_mask_bits(words: torch.Tensor, w: int) -> torch.Tensor:
    """The inverse of pack_mask_bits: (T, nw) int32 words -> (T, w) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.view(words.shape[0], -1)[:, :w].bool()


FAR_WORDS = 256  # mask words a far-field batch (csrc/group_eval.cu kFarWords, one a thread)


def far_ids(words: torch.Tensor, w: int) -> list[list[torch.Tensor]]:
    """The far-field kernel's compaction, in Python: for each tile, its
    batches in order, each the int64 ids of the accepted nodes of FAR_WORDS
    words (at most FAR_WORDS * 32 ids), in node order. A word's ids start
    at the exclusive sum of its batch's earlier words' bit counts, as the
    kernel's block scan gives it; bits past node w - 1 are not read, and
    bit 31 is a node like any other (the words are int32). The tests use
    it; the card's path compacts in the kernel."""
    nw = words.shape[1]
    if nw != -(-w // 32):
        raise ValueError(f"{nw} words do not pack {w} nodes")
    out = []
    for row in words.tolist():
        row = [v & 0xFFFFFFFF for v in row]  # int32 -> its unsigned bits
        if w % 32:
            row[-1] &= (1 << w % 32) - 1
        batches = []
        for b0 in range(0, nw, FAR_WORDS):
            batch = row[b0:b0 + FAR_WORDS]
            counts = [v.bit_count() for v in batch]
            ids = [0] * sum(counts)
            for k, (v, at) in enumerate(zip(batch, accumulate(counts, initial=0))):
                while v:
                    low = v & -v
                    ids[at] = (b0 + k) * 32 + low.bit_length() - 1
                    at += 1
                    v ^= low
            batches.append(torch.tensor(ids, dtype=torch.int64, device=words.device))
        out.append(batches)
    return out


def dense_ids(mask: torch.Tensor) -> list[list[torch.Tensor]]:
    """The compaction of masked_eval_kernel and group_shared_masked_kernel,
    in Python: for each tile of the (T, W) float weights, its batches in
    order, each the int64 ids of its nodes with a nonzero weight (a NaN
    counts; -0.0 does not) among FAR_WORDS * 32 consecutive nodes, in node
    order. The kernels form each word of 32 weights by a ballot of w != 0
    and compact the words as the far field does (far_ids). The tests use
    it; the card's path compacts in the kernel."""
    return far_ids(pack_mask_bits(mask != 0), mask.shape[1])


# --------------------------------------------------------------------------
# plain torch twins


def _chunks(n_items: int, rows: int, cols: int, device: torch.device):
    """(item slice, row slice) pairs that cover n_items x rows rows against
    `cols` columns each, in blocks of about pairs_per_chunk(device) pairs."""
    budget = pairs_per_chunk(device)
    g = max(1, budget // max(1, rows * cols))
    rc = rows if g > 1 else max(1, min(rows, budget // max(1, cols)))
    return [(slice(a, a + g), slice(r, r + rc))
            for a in range(0, n_items, g) for r in range(0, rows, rc)]


def _masked_block(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, keep: torch.Tensor,
                  eps: float, softening: str, absolute: bool) -> torch.Tensor:
    """sum_j keep_gj * m_gj * (x_gj - x_gi) / t for rows xi (g, r, dim)
    against per-group bodies (mj (g, c), xj (g, c, dim)), keep (g, c) bool:
    -> (g, r, dim), reduced over the contiguous body axis in float64 and
    rounded once: a float32 running sum that meets one close pair's huge
    term early drops the small terms after it (measured ~1e-4 of the row's
    sum of |term| on the CPU, depending on the buffer's alignment). Dropped
    terms are exact zeros, and so, under sqrt3, is a term whose t is not
    positive (nbody_tpu's den > 0 guard, octree_group.py:386-388). absolute=True
    sums |term| instead."""
    dx = [xj[:, None, :, d] - xi[:, :, None, d] for d in range(xi.shape[-1])]  # (g, r, c)
    d2 = dx[0] * dx[0]
    for v in dx[1:]:
        d2 += v * v
    if softening == "sqrt3":
        t = d2.sqrt_().add_(eps)
        t = t * t * t
    else:
        t = (d2 * d2.sqrt()).add_(eps)
    w = mj[:, None, :] / t
    if softening == "sqrt3":
        w.masked_fill_(t <= 0, 0)
    w.masked_fill_(~keep[:, None, :], 0)
    if absolute:
        w, dx = w.abs(), [v.abs() for v in dx]
    return torch.stack([torch.sum(w * v, dim=-1, dtype=torch.float64) for v in dx],
                       dim=-1).to(xi.dtype)


def masked_eval_bits_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                           words: torch.Tensor, eps: float, softening: str,
                           absolute: bool = False, tile_group: int = 1) -> torch.Tensor:
    """Far field: row tile t against the shared nodes (mj (W,), xj (W, dim))
    whose accept bit is set in words[t] -- the plain twin of
    masked_eval_bits_kernel. absolute=True gives each row's sum of |term|,
    the scale the kernel's tolerance is stated against (so for the other
    twins). tile_group 2 (the kernel's <tg2>) visits each row against the
    nodes of its pair of tiles, those of the other tile weighted 0: the
    same float64 sums."""
    _check_tile_group(tile_group)
    ntiles, w = words.shape[0], mj.shape[0]
    tb = xi.shape[0] // ntiles
    mask = unpack_mask_bits(words, w)
    xt = xi.view(ntiles, tb, -1)
    out = torch.empty_like(xt)
    for ts, rs in _chunks(ntiles, tb, w, xi.device):
        keep = mask[ts]
        g = keep.shape[0]
        out[ts, rs] = _masked_block(xt[ts, rs], mj.expand(g, w), xj.expand(g, *xj.shape), keep,
                                    eps, softening, absolute)
    return out.view_as(xi)


def masked_eval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, mask: torch.Tensor,
                      eps: float, softening: str, absolute: bool = False) -> torch.Tensor:
    """Far field with a dense weight mask: row tile t against the shared
    nodes (mj (W,), xj (W, dim)), node l weighted by mask[t, l] (T, W) on
    its mass -- the plain twin of masked_eval_kernel."""
    ntiles, w = mask.shape
    tb = xi.shape[0] // ntiles
    xt = xi.view(ntiles, tb, -1)
    out = torch.empty_like(xt)
    keep = torch.ones((), dtype=torch.bool, device=xi.device)
    for ts, rs in _chunks(ntiles, tb, w, xi.device):
        m = mask[ts] * mj
        out[ts, rs] = _masked_block(xt[ts, rs], m, xj.expand(m.shape[0], *xj.shape),
                                    keep.expand(m.shape), eps, softening, absolute)
    return out.view_as(xi)


def group_shared_masked_eval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                                   mask: torch.Tensor, eps: float, G: int, softening: str,
                                   absolute: bool = False) -> torch.Tensor:
    """Supertile-shared monopoles: row tile t against list t // G (mj
    (nsuper, M), xj (nsuper, M, dim)), entry k weighted by mask[t, k] (T,
    M) on its mass -- the plain twin of group_shared_masked_kernel."""
    ntiles, width = mask.shape
    tb = xi.shape[0] // ntiles
    xt = xi.view(ntiles, tb, -1)
    out = torch.empty_like(xt)
    keep = torch.ones((), dtype=torch.bool, device=xi.device)
    lists = torch.arange(ntiles, device=xi.device) // G
    for ts, rs in _chunks(ntiles, tb, width, xi.device):
        m = mj[lists[ts]] * mask[ts]
        out[ts, rs] = _masked_block(xt[ts, rs], m, xj[lists[ts]], keep.expand(m.shape), eps,
                                    softening, absolute)
    return out.view_as(xi)


def _check_tile_group(tile_group: int) -> None:
    if tile_group not in (1, 2):
        raise ValueError(f"tile_group must be 1 or 2, got {tile_group}")


def pack_sources(mj: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """The sources as one (nj, 4) array of rows (x, y, z | 0, m): what
    entries_lohi_kernel<packed> reads, one 16-byte float4 per body."""
    pad = xj.new_zeros(xj.shape[0], 3 - xj.shape[1])
    return torch.cat([xj, pad, mj[:, None]], dim=1).contiguous()


def tile_intervals(w0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, tb: int,
                   window_tiles: int, nj: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b), int64 (T,): tile t's interval [a, b), the bodies of its window
    [w0[t]*tb, (w0[t] + window_tiles)*tb) that lie in [lo[t], hi[t]) and
    below nj, as csrc/group_eval.cu tile_interval cuts it; empty where b <= a."""
    col0 = w0.long() * tb
    return (torch.maximum(lo.long(), col0),
            torch.minimum(hi.long(), col0 + window_tiles * tb).clamp_max(nj))


def window_eval_interval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                               w0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, eps: float,
                               window_tiles: int, softening: str,
                               absolute: bool = False, skip_outside: bool = True) -> torch.Tensor:
    """Near window: row tile t against the bodies j of the window
    [w0[t]*tb, (w0[t] + window_tiles)*tb) that lie in [lo[t], hi[t]) -- the
    plain twin of window_eval_interval_kernel. skip_outside=False (its
    <full>) visits every window column, those outside [lo, hi) weighted 0."""
    ntiles, nj = w0.shape[0], mj.shape[0]
    tb = xi.shape[0] // ntiles
    a, b = tile_intervals(w0, lo, hi, tb, window_tiles, nj)
    if not skip_outside:
        a, b = tile_intervals(w0, torch.zeros_like(lo), torch.full_like(hi, nj), tb,
                              window_tiles, nj)
    span = (b - a).clamp_min(0)
    xt = xi.view(ntiles, tb, -1)
    out = torch.zeros_like(xt)
    for ts, rs in _chunks(ntiles, tb, window_tiles * tb, xi.device):
        c = int(span[ts].max())
        if c == 0:
            continue
        cols = a[ts, None] + torch.arange(c, device=xi.device)
        keep = (cols < b[ts, None]) & (cols >= lo[ts, None]) & (cols < hi[ts, None])
        cols = cols.clamp_max(nj - 1)
        out[ts, rs] = _masked_block(xt[ts, rs], mj[cols], xj[cols], keep, eps, softening,
                                    absolute)
    return out.view_as(xi)


def _window_twin(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, w0: torch.Tensor,
                 weight: torch.Tensor, eps: float, softening: str, absolute: bool) -> torch.Tensor:
    """Row tile t against the window columns w0[t]*tb + [0, wb) whose
    weight[t, c] (bool keep, or a float factor on m_j) is set."""
    ntiles, wb = weight.shape
    nj = mj.shape[0]
    tb = xi.shape[0] // ntiles
    xt = xi.view(ntiles, tb, -1)
    out = torch.empty_like(xt)
    for ts, rs in _chunks(ntiles, tb, wb, xi.device):
        cols = w0[ts].long()[:, None] * tb + torch.arange(wb, device=xi.device)
        keep = cols < nj
        cols = cols.clamp_max(nj - 1)
        m = mj[cols]
        if weight.dtype == torch.bool:
            keep &= weight[ts]
        else:
            m = weight[ts] * m
        out[ts, rs] = _masked_block(xt[ts, rs], m, xj[cols], keep, eps, softening, absolute)
    return out.view_as(xi)


def window_eval_nodemask_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                               w0: torch.Tensor, in_win: torch.Tensor, eps: float,
                               window_tiles: int, S: int, softening: str,
                               absolute: bool = False, skip_outside: bool = True) -> torch.Tensor:
    """BVH near window: row tile t against the window bodies w0[t]*tb +
    [0, window_tiles*tb), slot v (S bodies) counting where in_win[t, v] --
    the plain twin of window_eval_nodemask_kernel. It visits every slot, a
    closed one weighted 0, as the kernel's <full> (skip_outside=False)
    does, so skip_outside changes nothing here."""
    return _window_twin(xi, mj, xj, w0, in_win.repeat_interleave(S, dim=1), eps, softening,
                        absolute)


def tile_parts(work, P: int):
    """The parts the list kernel and the three windows split a tile of
    `work` bodies (an int, or a tensor of them) into (csrc/group_eval.cu
    tile_parts): one per ENTRY_CHUNK bodies, at most P; none without work.
    Part p of np takes the bodies [work * p // np, work * (p + 1) // np) of
    the tile's order."""
    n = -(-work // ENTRY_CHUNK)
    return n.clamp(max=P) if isinstance(n, torch.Tensor) else min(P, n)


def interval_parts(w0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, tb: int,
                   window_tiles: int, nj: int, P: int) -> list[list[tuple[int, int]]]:
    """The interval window kernel's split, in Python: for each tile t, its
    parts in order, each the range [a, b) of sources it adds. Tile t's
    interval is tile_intervals' [a_t, b_t); tile_parts(b_t - a_t, P) parts
    take equal shares of it in order, none for an empty interval. The
    tests use it; the card's path computes the same split in the kernel."""
    a, b = tile_intervals(w0, lo, hi, tb, window_tiles, nj)
    out = []
    for at, bt in zip(a.tolist(), b.tolist()):
        work = max(bt - at, 0)
        n = tile_parts(work, P)
        out.append([(at + work * p // n, at + work * (p + 1) // n) for p in range(n)])
    return out


def dense_parts(w0: torch.Tensor, tb: int, wb: int, nj: int, P: int) -> list[list[tuple[int, int]]]:
    """The dense-mask window kernel's split, in Python: interval_parts of
    each tile's whole window, the columns [w0[t]*tb, min(w0[t]*tb + wb,
    nj)) (wb a multiple of tb). The kernel then skips each ENTRY_CHUNK-body
    stage of a part whose weights mask[t, c] * m_j are all zero. The tests
    use it; the card's path computes the same split in the kernel."""
    return interval_parts(w0, torch.zeros_like(w0), torch.full_like(w0, nj), tb, wb // tb, nj, P)


def window_parts(in_win: torch.Tensor, S: int, nj: int, w0: torch.Tensor, tb: int,
                 P: int) -> list[list[list[tuple[int, int]]]]:
    """The node-mask window kernel's split, in Python: for each tile t, its
    parts in order, each the ranges [a, b) of sources it adds, in slot
    order. Tile t's open bodies are those of the slots v with in_win[t, v]
    (the bodies w0[t]*tb + v*S + [0, S) below nj); tile_parts(their count,
    P) parts take equal shares of them in slot order, each walking the runs
    of consecutive open slots as ranges. The tests use it; the card's path
    computes the same split in the kernel."""
    out = []
    for t in range(in_win.shape[0]):
        col0 = int(w0[t]) * tb
        runs, v, slots = [], 0, in_win[t].tolist()
        while v < len(slots):
            if not slots[v]:
                v += 1
                continue
            v1 = v + 1
            while v1 < len(slots) and slots[v1]:
                v1 += 1
            a = col0 + v * S
            b = min(col0 + v1 * S, nj)
            if a < b:
                runs.append((a, b))
            v = v1
        work = sum(b - a for a, b in runs)
        n = tile_parts(work, P)
        parts = []
        for p in range(n):
            u0, u1 = work * p // n, work * (p + 1) // n
            ranges, c = [], 0
            for a, b in runs:
                lo, hi = max(u0 - c, 0), min(u1 - c, b - a)
                if lo < hi:
                    ranges.append((a + lo, a + hi))
                c += b - a
            parts.append(ranges)
        out.append(parts)
    return out


def window_eval_dense_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                            w0: torch.Tensor, mask: torch.Tensor, eps: float, window_tiles: int,
                            softening: str, absolute: bool = False) -> torch.Tensor:
    """BVH near window with a dense weight mask (T, window_tiles*tb) on
    m_j -- the plain twin of window_eval_dense_kernel."""
    return _window_twin(xi, mj, xj, w0, mask, eps, softening, absolute)


def _entries_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, tid: torch.Tensor,
                   start: torch.Tensor, stop: torch.Tensor, ntiles: int, eps: float,
                   softening: str, absolute: bool, keep=None) -> torch.Tensor:
    """Entry e adds the pairs of row tile tid[e] with the bodies [start[e],
    stop[e]) (below nj), and where keep = (keep_lo, keep_hi) is given only
    those in [keep_lo[e], keep_hi[e]) count, the others weighted 0 (the
    span mode). Each entry is cut into pieces of at most 256
    bodies; pieces are summed per entry, entries per tile, in float64 and
    rounded once: a float32 sum over a tile's thousands of entries drifts
    to ~7e-6 of the row's sum of |term| (measured on an H100 at 8,192
    entries a tile)."""
    tb, nj = xi.shape[0] // ntiles, mj.shape[0]
    dev = xi.device
    e = tid.shape[0]
    piece = 256
    npieces = ((stop - start).clamp_min(0) + piece - 1) // piece
    owner = torch.repeat_interleave(torch.arange(e, device=dev), npieces)
    first = torch.cumsum(npieces, 0) - npieces
    k = torch.arange(owner.shape[0], device=dev) - first[owner]
    start = start[owner] + k * piece                               # (pieces,)
    stop = stop[owner]
    if keep is not None:
        keep_lo, keep_hi = keep[0][owner], keep[1][owner]
    xt = xi.view(ntiles, tb, -1)
    per_entry = torch.zeros(e, tb, xi.shape[1], dtype=torch.float64, device=dev)
    for ps, rs in _chunks(owner.shape[0], tb, piece, dev):
        cols = start[ps, None] + torch.arange(piece, device=dev)
        live = (cols < stop[ps, None]) & (cols < nj)
        if keep is not None:
            live &= (cols >= keep_lo[ps, None]) & (cols < keep_hi[ps, None])
        cols = cols.clamp_max(nj - 1)
        part = _masked_block(xt[tid[owner[ps]], rs], mj[cols], xj[cols], live, eps, softening,
                             absolute)
        per_entry[:, rs].index_add_(0, owner[ps], part.double())
    out = torch.zeros(ntiles, tb, xi.shape[1], dtype=torch.float64, device=dev)
    return out.index_add_(0, tid, per_entry).to(xi.dtype).view_as(xi)


def lohi_ranges(entries: torch.Tensor, lohis: torch.Tensor, S: int):
    """(tile, start, stop), int64, of each near-field entry (tile << 16 |
    blk, lo | hi << 16): the bodies blk*S + [lo, hi). The twin and the
    kernels' plan (entries_plan's start) decode the entries here alone."""
    ent, lohi = entries.long(), lohis.long()
    base = (ent & 0xFFFF) * S
    return ent >> 16, base + (lohi & 0xFFFF), base + ((lohi >> 16) & 0xFFFF)


def sub_width_of(sub_width: int | None, S: int) -> int | None:
    """The subwindow width an entries call takes: None (the whole block)
    for None, 0 or a width of at least S; else it must divide S and be a
    multiple of 128 (entries_lohi_eval_pallas's ValueError,
    pallas_group_eval.py:1000-1003)."""
    if not sub_width or sub_width >= S:
        return None
    if S % sub_width or sub_width % 128:
        raise ValueError("sub_width must divide S and be a multiple of 128")
    return sub_width


def entry_spans(entries: torch.Tensor, lohis: torch.Tensor, S: int, sub_width: int | None = None,
                skip_empty: bool = True):
    """(tile, start, stop, keep_lo, keep_hi), int64, of each near-field
    entry in the span mode: it visits the sources [start, stop), of which
    its live range blk*S + [lo, hi) = [keep_lo, keep_hi) counts. Where
    skip_empty, entries_lohi_eval_pallas visits the sub_width-wide
    subwindows w0 of its block with hi > max(lo, w0) and lo < w0 +
    sub_width (pallas_group_eval.py:883-888): [floor(lo/W)*W, ceil(hi/W)*W)
    cut at S, nothing where hi <= lo. Under skip_empty=False (noskip) every
    entry, a pad with lo == hi included, visits its whole block."""
    tid, keep_lo, keep_hi = lohi_ranges(entries, lohis, S)
    base = (entries.long() & 0xFFFF) * S
    if not skip_empty:
        return tid, base, base + S, keep_lo, keep_hi
    W = sub_width_of(sub_width, S) or S
    lo, hi = keep_lo - base, keep_hi - base
    a = torch.where(hi > lo, lo // W * W, lo)
    b = torch.where(hi > lo, ((hi + W - 1) // W * W).clamp_max(S), lo)
    return tid, base + a, base + b, keep_lo, keep_hi


def table_ranges(entries: torch.Tensor, blk_tbl: torch.Tensor, lohi_tbl: torch.Tensor, S: int):
    """(tile, start, stop), int64, of each table-driven entry (tile << 16 |
    g): the bodies blk_tbl[g]*S + [lo, min(hi, S)), lohi_tbl[g] = lo | hi
    << 16 with hi read by an arithmetic shift; a row g past the tables adds
    nothing. The twin and the kernels' plan decode the entries here alone."""
    ent = entries.long()
    if blk_tbl.shape[0] == 0:  # every entry lies past the tables
        return ent >> 16, torch.zeros_like(ent), torch.zeros_like(ent)
    inside = (ent & 0xFFFF) < blk_tbl.shape[0]
    g = torch.where(inside, ent & 0xFFFF, 0)
    lohi = lohi_tbl.long()[g]
    base = blk_tbl.long()[g] * S
    start = base + (lohi & 0xFFFF)
    return ent >> 16, start, torch.where(inside, base + torch.clamp(lohi >> 16, max=S), start)


def entries_lohi_eval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                            entries: torch.Tensor, lohis: torch.Tensor, n_real, S: int,
                            ntiles: int, eps: float, softening: str, absolute: bool = False,
                            packed: bool = False, sub_width: int | None = None,
                            skip_empty: bool = True) -> torch.Tensor:
    """Near-field entries: for each of the first n_real entries
    (tile << 16 | blk, lo | hi << 16), row tile `tile` against the bodies
    blk*S + [lo, hi) -- the plain twin of entries_lohi_kernel, and with
    packed=True of entries_lohi_kernel<packed>, which reads the sources
    from pack_sources(mj, xj). With sub_width or skip_empty=False (the
    kernels' span mode) each entry visits entry_spans' span, the sources
    outside [lo, hi) weighted 0. Each entry is cut into pieces of at most
    256 bodies; pieces are summed per entry, entries per tile."""
    if packed:
        xm = pack_sources(mj, xj)
        mj, xj = xm[:, 3], xm[:, :xi.shape[1]]
    e = int(n_real)
    sub_width = sub_width_of(sub_width, S)
    if sub_width is None and skip_empty:
        return _entries_torch(xi, mj, xj, *lohi_ranges(entries[:e], lohis[:e], S), ntiles, eps,
                              softening, absolute)
    tid, start, stop, keep_lo, keep_hi = entry_spans(entries[:e], lohis[:e], S, sub_width,
                                                     skip_empty)
    return _entries_torch(xi, mj, xj, tid, start, stop, ntiles, eps, softening, absolute,
                          keep=(keep_lo, keep_hi))


def live_entries(entries: torch.Tensor,
                 n_real: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | int]:
    """The flattened entries of entries_tables_eval_pallas's chunks and how
    many of them its chunks evaluate: a 1-D list is one chunk, all of it;
    of an (nchunks, E) list chunk 0 always runs, and chunk c > 0 when
    c * E < n_real (n_real None: every chunk), all of a chunk that runs,
    its entries past n_real included. The count of a tensor n_real is a
    tensor, computed on its device without a sync."""
    if entries.ndim == 1:
        return entries, entries.shape[0]
    nchunks, width = entries.shape
    flat = entries.reshape(-1)
    if n_real is None:
        return flat, flat.shape[0]
    chunks = torch.clamp((n_real.long() + width - 1) // width, 1, nchunks)
    return flat, chunks * width


def entries_tables_eval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                              entries: torch.Tensor, blk_tbl: torch.Tensor,
                              lohi_tbl: torch.Tensor, eps: float, S: int, tb: int,
                              softening: str = "sqrt3", n_real: torch.Tensor | None = None,
                              absolute: bool = False) -> torch.Tensor:
    """Table-driven entries: each live entry (tile << 16 | g) adds the
    pairs of row tile `tile` with the bodies blk_tbl[g]*S + [lo, hi), where
    lohi_tbl[g] = lo | hi << 16, hi cut at S (live_entries says which are
    live) -- the plain twin of entries_tables_kernel. Raises on live
    entries that are not sorted by tile, the precondition the kernel
    relies on."""
    flat, live = live_entries(entries, n_real)
    tid, start, stop = table_ranges(flat[:int(live)], blk_tbl, lohi_tbl, S)
    if tid.numel() > 1 and bool((tid[1:] < tid[:-1]).any()):
        raise ValueError("entries must be sorted by tile within and across chunks")
    return _entries_torch(xi, mj, xj, tid, start, stop, xi.shape[0] // tb, eps, softening,
                          absolute)


def group_eval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: float,
                     softening: str, split: int, n0: torch.Tensor, n1: torch.Tensor,
                     absolute: bool = False) -> torch.Tensor:
    """List path: row tile t against its own list (mj (T, L), xj (T, L,
    dim)), over the live heads [0, n0[t]) and [split, split + n1[t]) of the
    list's two segments -- the plain twin of group_eval_kernel. Each chunk
    of tiles visits the columns of its longest heads, masked per tile."""
    ntiles, length = mj.shape
    tb = xi.shape[0] // ntiles
    n0, n1 = n0.long().clamp(0, split), n1.long().clamp(0, length - split)
    xt = xi.view(ntiles, tb, -1)
    out = torch.zeros_like(xt)
    for ts, rs in _chunks(ntiles, tb, length, xi.device):
        a, b = int(n0[ts].max()), int(n1[ts].max())
        if a + b == 0:
            continue
        cols = torch.cat([torch.arange(a, device=xi.device),
                          torch.arange(split, split + b, device=xi.device)])
        keep = (cols < n0[ts, None]) | ((cols >= split) & (cols < split + n1[ts, None]))
        out[ts, rs] = _masked_block(xt[ts, rs], mj[ts][:, cols], xj[ts][:, cols], keep, eps,
                                    softening, absolute)
    return out.view_as(xi)


# --------------------------------------------------------------------------
# kernel wrappers


def _check(xi: torch.Tensor, ntiles: int, mj: torch.Tensor, xj: torch.Tensor,
           *ints: torch.Tensor) -> None:
    if xi.ndim != 2 or xi.shape[1] not in (2, 3):
        raise ValueError(f"rows must be (n, 2) or (n, 3), got {tuple(xi.shape)}")
    if ntiles <= 0 or xi.shape[0] % ntiles:
        raise ValueError(f"{xi.shape[0]} rows do not split into {ntiles} tiles")
    if xj.ndim != 2 or xj.shape[1] != xi.shape[1] or mj.shape != (xj.shape[0],):
        raise ValueError(f"bodies {tuple(mj.shape)}, {tuple(xj.shape)} do not match rows "
                         f"{tuple(xi.shape)}")
    if mj.dtype != xi.dtype or xj.dtype != xi.dtype:
        raise TypeError(f"dtypes differ: {xi.dtype}, {mj.dtype}, {xj.dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("index arrays must be int32")
    if not all(t.is_contiguous() for t in (xi, mj, xj, *ints)):
        raise ValueError("the kernels take contiguous tensors")


def _sqrt3(softening: str) -> int:
    if softening not in SOFTENINGS:
        raise ValueError(f"softening must be one of {SOFTENINGS}, got {softening!r}")
    return int(softening == "sqrt3")


def _launch(kernel: str, fn: str, xi: torch.Tensor, ntiles: int, *args):
    """Launch csrc/group_eval.cu's C function `fn` on rows xi; the shared
    leading arguments are filled in here, `args` are the kernel's own."""
    from nbody_torch._build import load_library

    if xi.dtype != torch.float32:
        raise TypeError(f"{kernel} takes float32, got {xi.dtype}")
    out = torch.empty_like(xi)
    if xi.shape[0] == 0:
        return out
    err = getattr(load_library(), fn)(
        xi.device.index, xi.shape[1], xi.data_ptr(), ntiles,
        xi.shape[0] // ntiles, *args, out.data_ptr(), torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error(kernel, err)
    launch_counts[kernel] += 1
    return out


def masked_eval_bits_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                          words: torch.Tensor, eps: float, softening: str,
                          tile_group: int = 1) -> torch.Tensor:
    """Far field of T row tiles against W shared nodes gated per (tile,
    node) by the packed accept bits words (T, ceil(W/32)) -- the
    counterpart of masked_eval_bits_pallas. tile_group=2 (its
    tile_group=2, the ftg2 token) launches masked_eval_bits_kernel<tg2>,
    one block a pair of tiles."""
    _check(xi, words.shape[0], mj, xj, words)
    if words.shape[1] != -(-mj.shape[0] // 32):
        raise ValueError(f"words {tuple(words.shape)} do not pack {mj.shape[0]} nodes")
    sqrt3 = _sqrt3(softening)
    _check_tile_group(tile_group)
    if _on_cpu(xi, mj, xj, words):
        return masked_eval_bits_torch(xi, mj, xj, words, eps, softening, tile_group=tile_group)
    name = "masked_eval_bits_kernel" + ("<tg2>" if tile_group == 2 else "")
    return _launch(name, "nbody_masked_eval_bits", xi, words.shape[0], mj.data_ptr(),
                   xj.data_ptr(), mj.shape[0], words.data_ptr(), words.shape[1], tile_group,
                   sqrt3, float(eps))


ROWS_PER_BLOCK = 512  # rows a block of the window kernels (csrc/tiles.cuh kRowsPerBlock)


def window_eval_interval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                              w0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, eps: float,
                              window_tiles: int, softening: str,
                              parts: int | None = None, skip_outside: bool = True) -> torch.Tensor:
    """Near window of each row tile t: the bodies of [w0[t]*tb,
    (w0[t] + window_tiles)*tb) inside [lo[t], hi[t]) -- the counterpart of
    window_eval_interval_pallas with skip_outside (only the interval's
    columns are visited). Each tile's interval is split in the kernel into
    at most `parts` parts (split_parts' P by default; interval_parts
    mirrors the split), added in order by parts_sum_kernel.
    skip_outside=False (the nowinskip token) launches
    window_eval_interval_kernel<full>: the parts share the whole window,
    its columns outside [lo, hi) weighted 0."""
    _check(xi, w0.shape[0], mj, xj, w0, lo, hi)
    if lo.shape != w0.shape or hi.shape != w0.shape:
        raise ValueError(f"w0 {tuple(w0.shape)}, lo {tuple(lo.shape)} and hi {tuple(hi.shape)} "
                         "must be (T,)")
    if window_tiles < 0:
        raise ValueError(f"window_tiles must be >= 0, got {window_tiles}")
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, w0, lo, hi):
        return window_eval_interval_torch(xi, mj, xj, w0, lo, hi, eps, window_tiles, softening,
                                          skip_outside=skip_outside)
    if xi.dtype != torch.float32:
        raise TypeError(f"window_eval_interval_kernel takes float32, got {xi.dtype}")
    ntiles, tb = w0.shape[0], xi.shape[0] // w0.shape[0]
    P = split_parts(ntiles, window_tiles * tb, sm_count_of(xi.device.index)) if parts is None \
        else parts

    def launch(lib, nparts, scratch, stream):
        return lib.nbody_window_eval_interval(
            xi.device.index, xi.shape[1], xi.data_ptr(), ntiles, tb, mj.data_ptr(), xj.data_ptr(),
            mj.shape[0], w0.data_ptr(), lo.data_ptr(), hi.data_ptr(), int(window_tiles),
            int(not skip_outside), sqrt3, float(eps), P, nparts, scratch, stream)
    name = "window_eval_interval_kernel" + ("" if skip_outside else "<full>")
    return _launch_split(name, xi, ntiles, P, launch)


def _check_window(xi: torch.Tensor, w0: torch.Tensor, wb: int, window_tiles: int) -> None:
    tb = xi.shape[0] // w0.shape[0]
    if wb != window_tiles * tb:
        raise ValueError(f"a window of {window_tiles} tiles of {tb} rows is not {wb} bodies wide")


def window_eval_nodemask_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                              w0: torch.Tensor, in_win: torch.Tensor, eps: float,
                              window_tiles: int, S: int, softening: str,
                              parts: int | None = None, skip_outside: bool = True) -> torch.Tensor:
    """BVH near window of each row tile t: the bodies w0[t]*tb +
    [0, window_tiles*tb) in slots of S, a slot counting where in_win[t, v]
    (bool, (T, window_tiles*tb // S)) -- the counterpart of
    window_eval_nodemask_pallas with skip_outside (closed slots are not
    visited). Each tile's open bodies are split in the kernel into at most
    `parts` parts (split_parts' P by default; window_parts mirrors the
    split), added in order by parts_sum_kernel. skip_outside=False (the
    nowinskip token) launches window_eval_nodemask_kernel<full>: the parts
    share every window body, a closed slot's weighted 0."""
    _check(xi, w0.shape[0], mj, xj, w0)
    if in_win.dtype != torch.bool or in_win.shape[0] != w0.shape[0] or not in_win.is_contiguous():
        raise ValueError(f"in_win must be a contiguous (T, slots) bool tensor, got "
                         f"{in_win.dtype} {tuple(in_win.shape)}")
    if in_win.shape[1] > MAX_WINDOW_SLOTS:
        raise ValueError(f"{in_win.shape[1]} window slots a tile, at most {MAX_WINDOW_SLOTS}")
    _check_window(xi, w0, in_win.shape[1] * S, window_tiles)
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, w0, in_win):
        return window_eval_nodemask_torch(xi, mj, xj, w0, in_win, eps, window_tiles, S, softening,
                                          skip_outside=skip_outside)
    if xi.dtype != torch.float32:
        raise TypeError(f"window_eval_nodemask_kernel takes float32, got {xi.dtype}")
    ntiles, tb = w0.shape[0], xi.shape[0] // w0.shape[0]
    P = split_parts(ntiles, window_tiles * tb, sm_count_of(xi.device.index)) if parts is None \
        else parts

    def launch(lib, nparts, scratch, stream):
        return lib.nbody_window_eval_nodemask(
            xi.device.index, xi.shape[1], xi.data_ptr(), ntiles, tb, mj.data_ptr(), xj.data_ptr(),
            mj.shape[0], w0.data_ptr(), in_win.data_ptr(), in_win.shape[1], int(S),
            int(not skip_outside), sqrt3, float(eps), P, nparts, scratch, stream)
    name = "window_eval_nodemask_kernel" + ("" if skip_outside else "<full>")
    return _launch_split(name, xi, ntiles, P, launch)


def window_eval_dense_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                           w0: torch.Tensor, mask: torch.Tensor, eps: float, window_tiles: int,
                           softening: str, parts: int | None = None) -> torch.Tensor:
    """BVH near window with a dense float weight mask (T, window_tiles*tb)
    on the masses of the window bodies w0[t]*tb + [0, window_tiles*tb) --
    the counterpart of window_eval_pallas. Each tile's columns are split
    in the kernel into at most `parts` parts (split_parts' P by default;
    dense_parts mirrors the split), a stage of zero weights skipped, the
    parts added in order by parts_sum_kernel."""
    _check(xi, w0.shape[0], mj, xj, w0)
    if mask.dtype != xi.dtype or mask.shape[0] != w0.shape[0] or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous (T, window) {xi.dtype} tensor, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    _check_window(xi, w0, mask.shape[1], window_tiles)
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, w0, mask):
        return window_eval_dense_torch(xi, mj, xj, w0, mask, eps, window_tiles, softening)
    if xi.dtype != torch.float32:
        raise TypeError(f"window_eval_dense_kernel takes float32, got {xi.dtype}")
    ntiles, tb, wb = w0.shape[0], xi.shape[0] // w0.shape[0], mask.shape[1]
    P = split_parts(ntiles, wb, sm_count_of(xi.device.index)) if parts is None else parts

    def launch(lib, nparts, scratch, stream):
        return lib.nbody_window_eval_dense(
            xi.device.index, xi.shape[1], xi.data_ptr(), ntiles, tb, mj.data_ptr(), xj.data_ptr(),
            mj.shape[0], w0.data_ptr(), mask.data_ptr(), wb, sqrt3, float(eps), P, nparts,
            scratch, stream)
    return _launch_split("window_eval_dense_kernel", xi, ntiles, P, launch)


def tile_segments(entries: torch.Tensor, n_real: torch.Tensor, ntiles: int):
    """Each tile's run [first, last) of the tile-sorted entry list, found
    on the device: searchsorted over the entries' tile ids, with entries
    past n_real read as tile `ntiles`. Returns two int32 (ntiles,) tensors."""
    idx = torch.arange(entries.shape[0], device=entries.device)
    tids = torch.where(idx < n_real, (entries >> 16).long(), ntiles)
    t = torch.arange(ntiles, device=entries.device)
    first = torch.searchsorted(tids, t, right=False).to(torch.int32)
    last = torch.searchsorted(tids, t, right=True).to(torch.int32)
    return first, last


# --------------------------------------------------------------------------
# the entries kernels' plan

ENTRY_CHUNK = 256   # bodies a block stages at once (csrc/group_eval.cu kChunk)
PARTS_PER_SM = 64   # the plan's target parts a call: at most this many per SM,
PARTS_PER_TILE = 8  # this many per row tile, and one per ENTRY_CHUNK of E * S


@dataclass(frozen=True)
class EntriesPlan:
    """An entries launch: block b (of `blocks`) takes the bodies [u0[b],
    u1[b]) of row tile tile[b] in the live entries' body order, cum[e]
    (int64, (E + 1,)) of them before entry e, whose body u is the source
    start[e] + u - cum[e] (int64, (E,)); they lie in the entries [e0[b],
    e1[b]). tile[b] = -1 past the parts. Tile t's parts, in order, are the
    blocks [part_start[t], part_start[t + 1]), at least one each; all but
    a tile's last hold part_len bodies."""

    cum: torch.Tensor
    start: torch.Tensor
    tile: torch.Tensor
    e0: torch.Tensor
    e1: torch.Tensor
    u0: torch.Tensor
    u1: torch.Tensor
    part_start: torch.Tensor
    part_len: torch.Tensor

    @property
    def blocks(self) -> int:
        return self.tile.shape[0]


def plan_target(n_entries: int, S: int, ntiles: int, sm_count: int) -> int:
    """The parts an entries call aims for, from its shapes alone."""
    return max(1, min(PARTS_PER_SM * sm_count, PARTS_PER_TILE * ntiles,
                      -(-n_entries * S // ENTRY_CHUNK)))


def entries_plan(entries: torch.Tensor, start: torch.Tensor, stop: torch.Tensor, n_live,
                 ntiles: int, target: int) -> EntriesPlan:
    """Cut each tile's run of bodies into parts of about equal work, on
    the entries' device and without a host sync. Entry e < n_live (an int
    or a tensor) adds the bodies [start[e], stop[e]) to row tile entries[e]
    >> 16; the live entries are sorted by tile, and the later ones add
    nothing. The
    live bodies, numbered in entry order (cum), are cut into parts of
    part_len = ceil(total / target) bodies rounded up to ENTRY_CHUNK, each
    tile's run on its own (a part never spans two tiles; it may cut an
    entry); a tile with no bodies gets one empty part, so that its rows are
    written. There are target + ntiles blocks, enough for every part."""
    dev = entries.device
    live = torch.arange(entries.shape[0], device=dev) < n_live
    width = torch.where(live, (stop - start).clamp_min(0), 0)
    cum = torch.cat([width.new_zeros(1), width.cumsum(0)])
    first, last = tile_segments(entries, n_live, ntiles)
    base = cum[first.long()]
    work = cum[last.long()] - base
    per_part = ((cum[-1] + target - 1) // target).clamp_min(1)
    part_len = (per_part + ENTRY_CHUNK - 1) // ENTRY_CHUNK * ENTRY_CHUNK
    n_parts = ((work + part_len - 1) // part_len).clamp_min(1)
    part_start = torch.cat([work.new_zeros(1), n_parts.cumsum(0)])
    b = torch.arange(target + ntiles, device=dev)
    t = torch.searchsorted(part_start, b, right=True) - 1  # ntiles past the parts
    tc = t.clamp_max(ntiles - 1)
    end = base[tc] + work[tc]
    u0 = torch.minimum(base[tc] + (b - part_start[tc]) * part_len, end)
    u1 = torch.minimum(u0 + part_len, end)
    return EntriesPlan(cum=cum, start=start.long().contiguous(),
                       tile=torch.where(t < ntiles, t, -1).int(),
                       e0=(torch.searchsorted(cum, u0, right=True) - 1).int(),
                       e1=torch.searchsorted(cum, u1).int(), u0=u0, u1=u1,
                       part_start=part_start.int(), part_len=part_len)


def entries_sum_torch(parts: torch.Tensor, part_start: torch.Tensor) -> torch.Tensor:
    """(ntiles * tb, dim) rows: tile t's parts [part_start[t], part_start[t +
    1]) of parts (blocks, tb, dim) added in part order, as entries_sum_kernel
    adds them (so equal to it bit for bit)."""
    first, stop = part_start[:-1].long(), part_start[1:].long()
    v = parts[first]
    for k in range(1, int((stop - first).max()) if first.numel() else 0):
        idx = first + k
        more = (idx < stop)[:, None, None]
        v = torch.where(more, v + parts[idx.clamp_max(parts.shape[0] - 1)], v)
    return v.reshape(-1, parts.shape[2])


def entries_sum_cuda(parts: torch.Tensor, part_start: torch.Tensor) -> torch.Tensor:
    """The rows of an entries plan's partial rows parts (blocks, tb, dim),
    each tile's parts [part_start[t], part_start[t + 1]) added in part order."""
    if (parts.ndim != 3 or parts.dtype != torch.float32 or parts.shape[2] not in (2, 3)
            or not parts.is_contiguous()):
        raise ValueError(f"parts must be a contiguous (blocks, tb, 2 | 3) float32 tensor, got "
                         f"{parts.dtype} {tuple(parts.shape)}")
    if part_start.dtype != torch.int32 or part_start.ndim != 1 or not part_start.is_contiguous():
        raise TypeError("part_start must be a contiguous 1-D int32 tensor")
    if _on_cpu(parts, part_start):
        return entries_sum_torch(parts, part_start)
    from nbody_torch._build import load_library

    ntiles, (tb, dim) = part_start.shape[0] - 1, parts.shape[1:]
    out = torch.empty((ntiles * tb, dim), dtype=parts.dtype, device=parts.device)
    if out.numel() == 0:
        return out
    err = load_library().nbody_entries_sum(parts.device.index, dim, parts.data_ptr(),
                                           part_start.data_ptr(), ntiles, tb, out.data_ptr(),
                                           torch.cuda.current_stream(parts.device).cuda_stream)
    _raise_on_error("entries_sum_kernel", err)
    launch_counts["entries_sum_kernel"] += 1
    return out


# --------------------------------------------------------------------------
# the list kernel's and the windows' parts

MAX_WINDOW_SLOTS = 32768  # node-mask window slots a tile (csrc/group_eval.cu kMaxWindowSlots)


def split_parts(ntiles: int, work_max: int, sm_count: int) -> int:
    """P, the parts a tile that the list kernel and the three windows split
    each tile's work into, from shapes alone: about PARTS_PER_SM
    parts an SM, at most PARTS_PER_TILE a tile, and no more than one per
    ENTRY_CHUNK of the longest work a tile can hold."""
    return max(1, min(PARTS_PER_SM * sm_count // ntiles, PARTS_PER_TILE,
                      -(-work_max // ENTRY_CHUNK)))


def parts_sum_torch(parts: torch.Tensor, nparts: torch.Tensor, P: int) -> torch.Tensor:
    """(ntiles * tb, dim) rows: tile t's slices [t*P, t*P + nparts[t]) of
    parts (ntiles * P, tb, dim) added in part order, zero where nparts[t]
    is 0 -- parts_sum_kernel's plain version (equal to it bit for bit)."""
    tiles = parts.view(-1, P, *parts.shape[1:])
    count = nparts.long()[:, None, None]
    v = torch.where(count > 0, tiles[:, 0], torch.zeros((), dtype=parts.dtype,
                                                         device=parts.device))
    for k in range(1, P):
        v = torch.where(count > k, v + tiles[:, k], v)
    return v.reshape(-1, parts.shape[2])


def parts_sum_cuda(parts: torch.Tensor, nparts: torch.Tensor, P: int) -> torch.Tensor:
    """The rows of the list kernel's or a window's partial rows parts
    (ntiles * P, tb, dim), each tile's first nparts[t] slices added in part
    order (parts_sum_kernel)."""
    if (parts.ndim != 3 or parts.dtype not in _DTYPE_CODES or parts.shape[2] not in (2, 3)
            or not parts.is_contiguous() or P <= 0 or parts.shape[0] % P):
        raise ValueError(f"parts must be a contiguous (ntiles * {P}, tb, 2 | 3) float tensor, "
                         f"got {parts.dtype} {tuple(parts.shape)}")
    if (nparts.dtype != torch.int32 or nparts.shape != (parts.shape[0] // P,)
            or not nparts.is_contiguous()):
        raise TypeError(f"nparts must be a contiguous ({parts.shape[0] // P},) int32 tensor")
    if _on_cpu(parts, nparts):
        return parts_sum_torch(parts, nparts, P)
    from nbody_torch._build import load_library

    ntiles, (tb, dim) = nparts.shape[0], parts.shape[1:]
    out = torch.empty((ntiles * tb, dim), dtype=parts.dtype, device=parts.device)
    if out.numel() == 0:
        return out
    err = load_library().nbody_parts_sum(parts.device.index, _DTYPE_CODES[parts.dtype], dim,
                                         parts.data_ptr(), nparts.data_ptr(), P, ntiles, tb,
                                         out.data_ptr(),
                                         torch.cuda.current_stream(parts.device).cuda_stream)
    _raise_on_error("parts_sum_kernel", err)
    launch_counts["parts_sum_kernel"] += 1
    return out


def _launch_split(kernel: str, xi: torch.Tensor, ntiles: int, P: int, launch) -> torch.Tensor:
    """Run a split kernel (the list kernel or a window) on rows
    xi in P parts a tile into a scratch of partial rows, then
    parts_sum_kernel over it. launch(lib, nparts, scratch, stream) makes
    the C call with the scratch's pointers and returns its error."""
    from nbody_torch._build import load_library

    if P <= 0:
        raise ValueError(f"parts must be positive, got {P}")
    if xi.shape[0] == 0:
        return torch.empty_like(xi)
    tb, dim = xi.shape[0] // ntiles, xi.shape[1]
    scratch = torch.empty((ntiles * P, tb, dim), dtype=xi.dtype, device=xi.device)
    nparts = torch.empty(ntiles, dtype=torch.int32, device=xi.device)
    err = launch(load_library(), nparts.data_ptr(), scratch.data_ptr(),
                 torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error(kernel, err)
    launch_counts[kernel] += 1
    return parts_sum_cuda(scratch, nparts, P)


def _launch_entries(kernel: str, xi: torch.Tensor, ntiles: int, mj: torch.Tensor,
                    xj: torch.Tensor, xm: torch.Tensor | None, ranges, n_live, S: int,
                    softening: str, eps: float, parts: int | None, keep=None) -> torch.Tensor:
    """One entries kernel (csrc/group_eval.cu nbody_entries_eval, on the
    sources (mj, xj) or, given xm, the packed ones) on the plan of the
    entries' decoded ranges (entries, start, stop), then entries_sum_kernel
    over its parts. keep = (keep_lo, keep_hi), int64 a entry, selects the
    span mode: of the visited [start, stop) only [keep_lo, keep_hi) counts."""
    from nbody_torch._build import load_library

    if xi.dtype != torch.float32:
        raise TypeError(f"{kernel} takes float32, got {xi.dtype}")
    if xi.shape[0] == 0:
        return torch.empty_like(xi)
    tb = xi.shape[0] // ntiles
    nj = mj.shape[0]
    entries, start, stop = ranges
    if parts is None:
        parts = plan_target(entries.shape[0], S, ntiles, sm_count_of(xi.device.index))
    plan = entries_plan(entries, start.clamp_max(nj), stop.clamp_max(nj), n_live, ntiles, parts)
    if keep is not None:
        keep = tuple(k.long().contiguous() for k in keep)
    scratch = torch.empty((plan.blocks, tb, xi.shape[1]), dtype=xi.dtype, device=xi.device)
    err = load_library().nbody_entries_eval(
        xi.device.index, xi.shape[1], xi.data_ptr(), ntiles, tb, mj.data_ptr(), xj.data_ptr(),
        None if xm is None else xm.data_ptr(), _sqrt3(softening), float(eps),
        plan.cum.data_ptr(), plan.start.data_ptr(), plan.tile.data_ptr(), plan.e0.data_ptr(),
        plan.e1.data_ptr(), plan.u0.data_ptr(), plan.u1.data_ptr(),
        None if keep is None else keep[0].data_ptr(), None if keep is None else keep[1].data_ptr(),
        plan.blocks, scratch.data_ptr(), torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error(kernel, err)
    launch_counts[kernel] += 1
    return entries_sum_cuda(scratch, plan.part_start)


def entries_lohi_eval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                           entries: torch.Tensor, lohis: torch.Tensor, n_real: torch.Tensor,
                           S: int, ntiles: int, eps: float, softening: str,
                           packed: bool = False, parts: int | None = None,
                           sub_width: int | None = None, skip_empty: bool = True) -> torch.Tensor:
    """Near-field entries: the first n_real entries of the tile-sorted list
    (tile << 16 | blk, lo | hi << 16), each adding the pairs of row tile
    `tile` with bodies blk*S + [lo, hi) -- the counterpart of
    entries_lohi_eval_pallas. A tile with no entries gets zeros.
    packed=True (entries_lohi_eval_pallas(packed_j=True)) launches
    entries_lohi_kernel<packed> on pack_sources(mj, xj), built here once
    per call; its sums equal the unpacked kernel's bit for bit. The call
    runs on entries_plan's parts (`parts`: its target, plan_target's by
    default) and adds them with entries_sum_kernel. sub_width (the subwN
    token; sub_width_of's rules) or skip_empty=False (noskip) launch the
    span mode, entries_lohi_kernel<span> (<packed, span>): each entry
    visits entry_spans' span, its sources outside [lo, hi) weighted 0, and
    the plan cuts the parts on the visited sources."""
    _check(xi, ntiles, mj, xj, entries, lohis)
    if entries.shape != lohis.shape or entries.ndim != 1:
        raise ValueError(f"entries {tuple(entries.shape)} and lohis {tuple(lohis.shape)}")
    if S <= 0:
        raise ValueError(f"S must be positive, got {S}")
    _sqrt3(softening)  # raises on an unknown softening
    sub_width = sub_width_of(sub_width, S)
    if _on_cpu(xi, mj, xj, entries, lohis):
        return entries_lohi_eval_torch(xi, mj, xj, entries, lohis, n_real, S, ntiles, eps,
                                       softening, packed=packed, sub_width=sub_width,
                                       skip_empty=skip_empty)
    xm = pack_sources(mj, xj) if packed else None
    if sub_width is None and skip_empty:
        _, start, stop = lohi_ranges(entries, lohis, S)
        name = "entries_lohi_kernel<packed>" if packed else "entries_lohi_kernel"
        return _launch_entries(name, xi, ntiles, mj, xj, xm, (entries, start, stop), n_real, S,
                               softening, eps, parts)
    _, start, stop, keep_lo, keep_hi = entry_spans(entries, lohis, S, sub_width, skip_empty)
    name = "entries_lohi_kernel<packed, span>" if packed else "entries_lohi_kernel<span>"
    return _launch_entries(name, xi, ntiles, mj, xj, xm, (entries, start, stop), n_real, S,
                           softening, eps, parts, keep=(keep_lo, keep_hi))


def entries_tables_eval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                             entries: torch.Tensor, blk_tbl: torch.Tensor, lohi_tbl: torch.Tensor,
                             eps: float, S: int, tb: int, softening: str = "sqrt3",
                             n_real: torch.Tensor | None = None,
                             parts: int | None = None) -> torch.Tensor:
    """Table-driven entries -- the counterpart of entries_tables_eval_pallas,
    with xj (N, dim) where it takes xjt (dim, N). Entry (tile << 16 | g)
    adds the pairs of row tile `tile` (rows tile*tb + [0, tb) of xi) with
    the bodies blk_tbl[g]*S + [lo, hi), lohi_tbl[g] = lo | hi << 16, hi cut
    at S; lo >= hi adds nothing. entries is 1-D or (nchunks, E); the
    chunks that nbody_tpu would run (live_entries: under n_real, every
    chunk c with c * E < n_real, whole, and chunk 0) are one walk here, and
    a tile in none of them gets zeros. The live entries must be sorted by
    tile, within and across chunks, as nbody_tpu requires; the kernel does
    not check it (that would make the host wait), the twin raises. The
    plan and `parts` as in entries_lohi_eval_cuda."""
    ntiles = xi.shape[0] // tb if tb > 0 else 0
    _check(xi, ntiles, mj, xj, entries, blk_tbl, lohi_tbl)
    if entries.ndim not in (1, 2) or blk_tbl.shape != lohi_tbl.shape or blk_tbl.ndim != 1:
        raise ValueError(f"entries {tuple(entries.shape)}, tables {tuple(blk_tbl.shape)} and "
                         f"{tuple(lohi_tbl.shape)}")
    if S <= 0:
        raise ValueError(f"S must be positive, got {S}")
    _sqrt3(softening)  # raises on an unknown softening
    if _on_cpu(xi, mj, xj, entries, blk_tbl, lohi_tbl):
        return entries_tables_eval_torch(xi, mj, xj, entries, blk_tbl, lohi_tbl, eps, S, tb,
                                         softening, n_real)
    flat, live = live_entries(entries, n_real)
    _, start, stop = table_ranges(flat, blk_tbl, lohi_tbl, S)
    return _launch_entries("entries_tables_kernel", xi, ntiles, mj, xj, None,
                           (flat, start, stop), live, S, softening, eps, parts)


def _check_mask(mask: torch.Tensor, xi: torch.Tensor, width: int) -> None:
    if (mask.dtype != xi.dtype or mask.ndim != 2 or mask.shape[1] != width
            or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous (T, {width}) {xi.dtype} tensor, got "
                         f"{mask.dtype} {tuple(mask.shape)}")


def masked_eval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, mask: torch.Tensor,
                     eps: float, softening: str) -> torch.Tensor:
    """Far field of T row tiles against W shared nodes (mj (W,), xj (W,
    dim)) with a dense float weight mask (T, W) on their masses -- the
    counterpart of masked_eval_pallas. The kernel visits only each tile's
    nonzero weights (dense_ids mirrors its compaction)."""
    _check(xi, mask.shape[0], mj, xj)
    _check_mask(mask, xi, mj.shape[0])
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, mask):
        return masked_eval_torch(xi, mj, xj, mask, eps, softening)
    return _launch("masked_eval_kernel", "nbody_masked_eval", xi, mask.shape[0], mj.data_ptr(),
                   xj.data_ptr(), mj.shape[0], mask.data_ptr(), sqrt3, float(eps))


def group_shared_masked_eval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                                  mask: torch.Tensor, eps: float, G: int,
                                  softening: str) -> torch.Tensor:
    """Supertiles of G consecutive row tiles share one monopole list (mj
    (nsuper, M), xj (nsuper, M, dim), nsuper = ceil(T / G), padding of
    mass 0); tile t reads list t // G with its own weight mask row (T, M)
    -- the counterpart of group_shared_masked_eval_pallas, with xj
    untransposed. The kernel visits only each tile's nonzero weights
    (dense_ids)."""
    ntiles = mask.shape[0]
    if mj.ndim != 2 or xj.shape != (*mj.shape, xi.shape[-1]):
        raise ValueError(f"lists {tuple(mj.shape)}, {tuple(xj.shape)} do not match rows "
                         f"{tuple(xi.shape)}")
    if G <= 0 or mj.shape[0] != -(-ntiles // G):
        raise ValueError(f"{mj.shape[0]} lists for {ntiles} tiles in supertiles of {G}")
    if not (mj.is_contiguous() and xj.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")
    _check(xi, ntiles, mj.view(-1), xj.view(-1, xi.shape[-1]))
    _check_mask(mask, xi, mj.shape[1])
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, mask):
        return group_shared_masked_eval_torch(xi, mj, xj, mask, eps, G, softening)
    return _launch("group_shared_masked_kernel", "nbody_group_shared_masked_eval", xi, ntiles,
                   mj.data_ptr(), xj.data_ptr(), mj.shape[1], int(G), mask.data_ptr(), sqrt3,
                   float(eps))


def group_eval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: float,
                    softening: str, split: int, n0: torch.Tensor, n1: torch.Tensor,
                    parts: int | None = None) -> torch.Tensor:
    """List path: row tile t of xi (T*tb, dim) against its own list mj (T,
    L), xj (T, L, dim), float32 or float64, over the live heads [0, n0[t])
    and [split, split + n1[t]) (int32 (T,)) of the list's node and leaf
    segments -- the counterpart of group_eval_pallas, with xj untransposed
    and L unpadded (entries past the heads are not read). A tile whose
    heads are both empty gets zeros and costs nothing. Each tile's heads are
    split in the kernel into at most `parts` parts (split_parts' P by
    default), added in order by parts_sum_kernel."""
    if mj.ndim != 2 or xj.shape != (*mj.shape, xi.shape[-1]):
        raise ValueError(f"list {tuple(mj.shape)}, {tuple(xj.shape)} does not match rows "
                         f"{tuple(xi.shape)}")
    if xi.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_eval_kernel takes float32 or float64, got {xi.dtype}")
    if not 0 <= split <= mj.shape[1]:
        raise ValueError(f"split {split} outside the list's {mj.shape[1]} entries")
    if n0.shape != (mj.shape[0],) or n1.shape != n0.shape:
        raise ValueError(f"live lengths {tuple(n0.shape)}, {tuple(n1.shape)} for "
                         f"{mj.shape[0]} tiles")
    if not (mj.is_contiguous() and xj.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")
    # the list checked as if it were W = T * L shared sources
    _check(xi, mj.shape[0], mj.view(-1), xj.view(-1, xi.shape[-1]), n0, n1)
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, n0, n1):
        return group_eval_torch(xi, mj, xj, eps, softening, split, n0, n1)
    ntiles, tb = mj.shape[0], xi.shape[0] // mj.shape[0]
    P = split_parts(ntiles, mj.shape[1], sm_count_of(xi.device.index)) if parts is None else parts

    def launch(lib, nparts, scratch, stream):
        return lib.nbody_group_eval(
            xi.device.index, _DTYPE_CODES[xi.dtype], xi.shape[1], xi.data_ptr(), ntiles, tb,
            mj.data_ptr(), xj.data_ptr(), mj.shape[1], int(split), n0.data_ptr(), n1.data_ptr(),
            sqrt3, float(eps), P, nparts, scratch, stream)
    return _launch_split(group_eval_name(xi.dtype, softening), xi, ntiles, P, launch)
