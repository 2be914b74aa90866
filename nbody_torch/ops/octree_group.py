"""Grouped octree force (the port of nbody_tpu.ops.octree_group): the fast
path, compute_force_grouped_fast (its default branch), and the list path,
compute_force_grouped, which float64 runs and --kernel torch take (see
its docstring). The fast path:

Bodies arrive Morton-sorted, so consecutive bodies form spatially tight
tiles of `tile` rows. Per tile, with the conservative group MAC
w_cell^2 < theta^2 * dmin(tile box, COM)^2 over true cell extents:

  heap      a dense Morton-prefix heap for levels 0..L*: one scatter-add
            histogram at L* and reshape-sum pooling above it, with the
            reference's single-body demotion (a one-body cell's monopole
            is the body itself, octree.h:130-148);
  window    each tile evaluates the bodies of a window of `window_tiles`
            tiles around it exactly, snapped to L* cell boundaries;
  far       per-level accept masks (cells inside the window dropped, cells
            straddling it forced open), plus a sub-tile monopole re-test at
            L*; the accepted heap nodes, compacted to the nonempty cells
            unless they outgrow far_heap_cap, go to the far-field kernel;
  near      every cell still open at L* is evaluated as exact bodies: the
            (cell, S-block) run table of the sorted bodies gives each tile
            a list of self-describing (tile << 16 | blk, lo | hi << 16)
            entries, touching entries are merged, and the entries kernel
            evaluates them;
  fallback  tiles whose entry list outgrows its caps are evaluated exactly
            against all bodies by allpairs_block_cuda(..., "sqrt3").

Every sizing rule (L*, occ, S, far_cap, R_slice, E_cap, the 16-bit
packing guards and the 2^15-tile limit) is nbody_tpu's, so the integer
counters of `info` match it. The TPU's E_CHUNK chunking (a device for
TPU SMEM) is not carried over: the entries kernel takes the whole list,
and e_chunk only sizes E_cap, which decides tile overflow. sub_width is
not carried over either: the kernel visits [lo, hi) exactly. JAX's two
device-side branches (the far heap's lax.cond and the fallback's
while_loop) read two counters on the host: one synchronisation per call.
"""

from __future__ import annotations

import math

import torch

from nbody_torch.ops.cuda_allpairs import allpairs_block_cuda, allpairs_block_torch
from nbody_torch.ops.cuda_group_eval import (entries_lohi_eval_cuda, group_eval_cuda,
                                             group_eval_torch, masked_eval_bits_cuda,
                                             pack_mask_bits, window_eval_interval_cuda)
from nbody_torch.ops.octree import OctreeLevels

BIGK = 1 << 30  # sort sentinel of the per-tile entry rows (and of compact_rows)
K_CELL = 16  # bodies expanded per open max-depth cell of the list path (else fallback)
TILE_CHUNK = 256  # tiles per pass of the list path's traversal


def merge_contiguous_entries(entries: torch.Tensor, lohis: torch.Tensor, n_raw: torch.Tensor,
                             pad_entry: int):
    """Merge chains of touching same-block entries of a tile-sorted entry
    stream (octree_group.py:51-85, epg == 1): an entry equal to its
    predecessor whose lo is the predecessor's hi joins its run. Returns
    (entries, lohis, n_merged); entries past the merged stream are no-op
    pads (lo == hi == 0). int32 in, int32 out."""
    e_cap = entries.shape[0]
    dev = entries.device
    ii = torch.arange(e_cap, device=dev)
    prev_ent = torch.cat([entries[:1] - 1, entries[:-1]])
    prev_hi = torch.cat([entries.new_zeros(1), (lohis[:-1] >> 16) & 0xFFFF])
    cur_lo = lohis & 0xFFFF
    keep = ~((ii > 0) & (ii < n_raw) & (entries == prev_ent) & (cur_lo == prev_hi))
    gid = torch.cumsum(keep, 0) - 1
    glo = torch.full_like(entries, 0xFFFF).scatter_reduce_(0, gid, cur_lo, "amin")
    ghi = torch.zeros_like(entries).scatter_reduce_(0, gid, (lohis >> 16) & 0xFFFF, "amax")
    gent = torch.full_like(entries, -1).scatter_reduce_(0, gid, entries, "amax")
    entries = torch.where(ii <= gid[-1], gent, torch.full_like(gent, pad_entry))
    lohis = torch.minimum(glo, ghi) | (ghi << 16)
    n_merged = (keep & (ii < n_raw)).sum()
    return entries, lohis, n_merged


def _pool(a: torch.Tensor, nbranch: int, op: str) -> torch.Tensor:
    """Parent cells from their nbranch children (contiguous in Morton
    order): a sum taken child by child, or a min / max."""
    g = a.view(-1, nbranch, *a.shape[1:])
    if op == "min":
        return g.amin(1)
    if op == "max":
        return g.amax(1)
    out = g[:, 0]
    for j in range(1, nbranch):
        out = out + g[:, j]
    return out


def _box_dist2(lo: torch.Tensor, hi: torch.Tensor, com: torch.Tensor) -> torch.Tensor:
    """Squared distance from boxes [lo, hi] (T, dim) to points com, shared
    (C, dim) or per box (T, C, dim) -> (T, C): per dimension
    max(lo - c, 0, c - hi), summed in order."""
    d2 = None
    for d in range(com.shape[-1]):
        c = com[..., d]
        dd = torch.clamp_min(lo[:, d][:, None] - c, 0)
        dd = torch.maximum(dd, c - hi[:, d][:, None])
        d2 = dd * dd if d2 is None else d2 + dd * dd
    return d2


def compute_force_grouped_fast(ms: torch.Tensor, xs: torch.Tensor, keys: torch.Tensor,
                               depth: int, theta: float, G: float, eps: float, tile: int = 512,
                               window_tiles: int = 32, s_block: int | None = None,
                               far_heap_cap: int | None = None, e_chunk: int = 24576):
    """Gather-free grouped octree force (float32). ms, xs, keys are the
    Morton-sorted bodies and their full-depth int64 keys. Returns
    (G * accel in sorted order, info) with info's counters as device
    tensors: entries, fallback_tiles, open_cells, open_mass,
    near_width_sum, window_span_sum, window_capacity, max_nodes,
    entries_raw, node_overflow and, when the far heap is compacted,
    far_heap_nonempty."""
    n, dim = xs.shape
    dev, dtype = xs.device, xs.dtype
    if dtype != torch.float32:
        raise ValueError(f"the fast octree path is float32 only, got {dtype}")
    nbranch = 1 << dim
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)  # no host copy
    i64 = dict(dtype=torch.int64, device=dev)

    # ---- tiles, padding and sizing (octree_group.py:615-715) ----------
    ntiles = -(-n // tile)
    npad = ntiles * tile
    s_req = s_block if s_block is not None else (8192 if dim == 3 else 2048)
    s_req = max(128, min(s_req, npad))
    if npad % s_req:  # npad must be a multiple of both tile and S
        lcm = tile * s_req // math.gcd(tile, s_req)
        npad = -(-n // lcm) * lcm
        ntiles = npad // tile
    xp = torch.nn.functional.pad(xs, (0, 0, 0, npad - n))
    mp = torch.nn.functional.pad(ms, (0, npad - n))
    xt = xp.view(ntiles, tile, dim)
    validb = (torch.arange(npad, device=dev) < n).view(ntiles, tile)
    xt_real = torch.where(validb[:, :, None], xt, xt[:, :1, :])
    tmin, tmax = xt_real.amin(1), xt_real.amax(1)

    occ = 8 if dim == 3 else 4
    level_star = 1
    while (1 << (dim * level_star)) * 256 < npad * occ and level_star < depth:
        level_star += 1
    S = s_block if s_block is not None else (8192 if dim == 3 else 2048)
    S = max(128, min(S, npad))
    while npad % S:
        S //= 2
    while npad // S > 16384:
        S *= 2
    # the run table's entries pack a 16-bit gbe index
    while (1 << (dim * level_star)) + npad // S + 1 > (1 << 16) and level_star > 1:
        level_star -= 1
    C = 1 << (dim * level_star)
    if ntiles > (1 << 15):  # the tile id packs into 16 bits of an int32 entry
        raise ValueError("fast octree path supports at most 2^15 tiles; increase tile")

    # ---- dense prefix heap, levels 0..L* ------------------------------
    cellid = keys >> ((depth - level_star) * dim)                      # (n,) int64
    big = 3.4e38
    cnt = [torch.zeros(C, **i64).index_add_(0, cellid, torch.ones_like(cellid))]
    mass = [torch.zeros(C, dtype=dtype, device=dev).index_add_(0, cellid, ms)]
    mx = [torch.zeros(C, dim, dtype=dtype, device=dev).index_add_(0, cellid, ms[:, None] * xs)]
    idx2 = cellid[:, None].expand(n, dim)
    cmin = [torch.full((C, dim), big, dtype=dtype, device=dev).scatter_reduce_(0, idx2, xs, "amin")]
    cmax = [torch.full((C, dim), -big, dtype=dtype, device=dev).scatter_reduce_(0, idx2, xs, "amax")]
    for _ in range(level_star):
        cnt.insert(0, _pool(cnt[0], nbranch, "sum"))
        mass.insert(0, _pool(mass[0], nbranch, "sum"))
        mx.insert(0, _pool(mx[0], nbranch, "sum"))
        cmin.insert(0, _pool(cmin[0], nbranch, "min"))
        cmax.insert(0, _pool(cmax[0], nbranch, "max"))
    counts_L = cnt[level_star]
    com = []
    for level in range(level_star + 1):
        c = mx[level] / torch.clamp_min(mass[level], 1e-30)[:, None]
        start = torch.cumsum(cnt[level], 0) - cnt[level]
        single = xs[start.clamp(0, n - 1)]                          # single-body demotion
        com.append(torch.where((cnt[level] == 1)[:, None], single, c))

    # ---- near-field window, snapped to L* cell boundaries -------------
    wt = min(window_tiles, ntiles)
    t_idx = torch.arange(ntiles, **i64)
    wjf = 4 if wt % 4 == 0 else (2 if wt % 2 == 0 else 1)
    w0 = (t_idx - wt // 2).clamp(0, ntiles - wt)
    w0 = (w0 // wjf) * wjf
    w0_body = w0 * tile
    w1_body = w0_body + wt * tile
    cell_of_pad = torch.cat([cellid, torch.full((npad - n,), C, **i64)])
    cs_arr = torch.cumsum(counts_L, 0) - counts_L
    ce_arr = cs_arr + counts_L
    c0 = cell_of_pad[w0_body.clamp(0, npad - 1)]
    c1 = cell_of_pad[(w1_body - 1).clamp(0, npad - 1)]
    c0c, c1c = c0.clamp(0, C - 1), c1.clamp(0, C - 1)
    lo_t = torch.where(cs_arr[c0c] == w0_body, w0_body, ce_arr[c0c])
    hi_t = torch.where(c1 >= C, torch.full_like(c1, n),
                       torch.where(ce_arr[c1c] == w1_body, w1_body, cs_arr[c1c]))
    hi_t = torch.maximum(hi_t, lo_t)

    # ---- dense mask traversal (octree_group.py:842-869) ---------------
    accept_masks = []
    open_mask = torch.ones(ntiles, 1, dtype=torch.bool, device=dev)
    for level in range(level_star + 1):
        alive = (cnt[level] > 0)[None, :]
        dmin2 = _box_dist2(tmin, tmax, com[level])
        width = (cmax[level] - cmin[level]).amax(-1)
        weff = torch.where(cnt[level] > 0, width, torch.zeros_like(width))[None, :]
        single = (cnt[level] == 1)[None, :]
        lend = torch.cumsum(cnt[level], 0)[None, :]
        lstart = lend - cnt[level][None, :]
        inside = (lstart >= lo_t[:, None]) & (lend <= hi_t[:, None])
        partial = (lstart < hi_t[:, None]) & (lend > lo_t[:, None]) & ~inside
        mac = ((weff * weff < theta2 * dmin2) | single) & ~partial
        accept_masks.append(open_mask & alive & mac & ~inside)
        open_ = open_mask & alive & ~mac & ~inside
        open_mask = open_.repeat_interleave(nbranch, dim=1) if level < level_star else open_

    # sub-tile monopole re-test: an open L* cell whose MAC passes against
    # every sub-tile box is a monopole for the whole tile
    nsub = max(1, min(8, tile // 8))
    sub = xt_real.view(ntiles, nsub, tile // nsub, dim)
    sb_lo, sb_hi = sub.amin(2), sub.amax(2)
    w2_L = torch.where(counts_L > 0, (cmax[level_star] - cmin[level_star]).amax(-1),
                       torch.zeros((), dtype=dtype, device=dev)) ** 2
    min_dmin2 = None
    for s in range(nsub):
        d2s = _box_dist2(sb_lo[:, s], sb_hi[:, s], com[level_star])
        min_dmin2 = d2s if min_dmin2 is None else torch.minimum(min_dmin2, d2s)
    mono = open_mask & (w2_L[None, :] < theta2 * min_dmin2)
    del min_dmin2, d2s
    accept_masks[-1] = accept_masks[-1] | mono
    open_mask = open_mask & ~mono

    acc_bool = torch.cat(accept_masks, dim=1)                          # (T, W)
    mm_heap = torch.cat(mass)
    com_heap = torch.cat(com)
    w_heap = acc_bool.shape[1]
    info = {}

    # ---- far heap compaction (octree_group.py:1064-1112) --------------
    far_cap = far_heap_cap if far_heap_cap is not None else (2048 if dim == 3 else 8192)
    compact = 0 < far_cap < w_heap
    if compact:
        alive_w = torch.cat(cnt) > 0
        order_key = torch.where(alive_w, 0, w_heap) + torch.arange(w_heap, **i64)
        keep_idx = torch.argsort(order_key)[:far_cap]  # nonempty cells first, index-stable
        n_keep = alive_w.sum()
        info["far_heap_nonempty"] = n_keep
    else:
        n_keep = torch.zeros((), **i64)

    # ---- global (cell, S-block) run table (octree_group.py:1150-1177) -
    nblocks = npad // S
    bidx = torch.arange(npad, **i64)
    pairkey = cell_of_pad * nblocks + bidx // S
    flags = (bidx < n) & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                    pairkey[1:] != pairkey[:-1]])
    rank = torch.cumsum(flags, 0) - 1
    gbe_cap = C + nblocks
    drop = torch.where(flags, rank, gbe_cap)  # slot gbe_cap takes the non-run bodies
    gbe_pk = torch.full((gbe_cap + 1,), C * nblocks, **i64).scatter_(0, drop, pairkey)
    gbe_start = torch.zeros(gbe_cap + 1, **i64).scatter_(0, drop, bidx)
    n_gbe = rank[-1] + 1
    gi = torch.arange(gbe_cap + 1, **i64)
    gbe_end = torch.where(gi + 1 < n_gbe, torch.roll(gbe_start, -1), n)
    gbe_valid = gi < n_gbe
    gbe_cell = torch.where(gbe_valid, gbe_pk // nblocks, C)
    gbe_blk = torch.where(gbe_valid, gbe_pk % nblocks, 0)
    g_lo = torch.where(gbe_valid, gbe_start - gbe_blk * S, 0)
    g_hi = torch.where(gbe_valid, gbe_end - gbe_blk * S, 0)
    lohi_tbl = (g_lo | (g_hi << 16)).to(torch.int32)

    # ---- per-tile entry lists, wide extraction (:1180-1300) -----------
    r_slice = min(gbe_cap + 1, 2048)
    pad_gbe = gbe_cap
    open_c = torch.cat([open_mask, torch.zeros(ntiles, 1, dtype=torch.bool, device=dev)], dim=1)
    open_gbe = open_c[:, gbe_cell]                                    # (T, gbe_cap + 1)
    gkey = torch.where(open_gbe, gi[None, :], BIGK)
    sorted_g = torch.sort(gkey, dim=1).values[:, :r_slice]
    ent_count = open_gbe.sum(1)
    del open_gbe, gkey
    slot = torch.arange(r_slice, **i64)[None, :]
    vmask = slot < ent_count.clamp_max(r_slice)[:, None]
    ent_rows = torch.where(vmask, sorted_g.clamp_max(pad_gbe), pad_gbe)
    ent_rows = torch.cat([torch.full((ntiles, 1), pad_gbe, **i64), ent_rows], dim=1)
    vflag = torch.cat([torch.ones(ntiles, 1, dtype=torch.bool, device=dev), vmask], dim=1)
    flat_v = vflag.reshape(-1)
    flat_ent = ((t_idx[:, None] << 16) | ent_rows).reshape(-1)
    frank = torch.cumsum(flat_v, 0) - 1
    per_tile_est = 64 + ((560 if dim == 3 else 360) * 256) // S
    n_chunks = max(1, min(40, -(-(ntiles * per_tile_est + ntiles) // e_chunk)))
    e_cap = min(ntiles * (r_slice + 1), n_chunks * e_chunk)
    if e_cap > e_chunk:
        e_cap = -(-e_cap // e_chunk) * e_chunk
    pad_gbe_entry = ((ntiles - 1) << 16) | pad_gbe
    dst = torch.where(flat_v & (frank < e_cap), frank, e_cap)        # e_cap: dropped
    entries_gbe = torch.full((e_cap + 1,), pad_gbe_entry, **i64).scatter_(0, dst, flat_ent)[:e_cap]
    end_rank = torch.cumsum(1 + ent_count.clamp_max(r_slice), 0)
    tile_over = (ent_count > r_slice) | (end_rank > e_cap)

    # resolve the gbe indirection into self-describing entries and merge
    gidx = entries_gbe & 0xFFFF
    entries = ((entries_gbe & ~0xFFFF) | gbe_blk[gidx]).to(torch.int32)
    lohis = lohi_tbl[gidx]
    entries, lohis, n_merged = merge_contiguous_entries(entries, lohis, end_rank[-1],
                                                        (ntiles - 1) << 16)

    # ---- the host reads (lax.cond / while_loop in nbody_tpu) -----------
    n_over_t = tile_over.sum()
    cheap, n_over = torch.stack([(n_keep <= far_cap).long(), n_over_t]).tolist()

    # ---- evaluation: far + window + near ------------------------------
    if compact and cheap:
        far = masked_eval_bits_cuda(xp, mm_heap[keep_idx], com_heap[keep_idx].contiguous(),
                                    pack_mask_bits(acc_bool[:, keep_idx]), eps, "sqrt3")
    else:
        far = masked_eval_bits_cuda(xp, mm_heap, com_heap, pack_mask_bits(acc_bool), eps, "sqrt3")
    win = window_eval_interval_cuda(xp, mp, xp, w0.to(torch.int32), lo_t.to(torch.int32),
                                    hi_t.to(torch.int32), eps, wt)
    near = entries_lohi_eval_cuda(xp, mp, xp, entries, lohis, n_merged, S, ntiles, eps, "sqrt3")
    acc = (far + win) + near

    # ---- exact fallback for overflowed tiles --------------------------
    exact_fallback(acc, xt, tile_over, n_over, ms, xs, eps, "sqrt3")

    info.update({
        "max_nodes": ent_count.clamp_max(r_slice).max(),
        "fallback_tiles": n_over_t,
        "entries": n_merged,
        "entries_raw": end_rank[-1],
        "open_cells": open_mask.sum(),
        "open_mass": torch.where(open_mask, counts_L[None, :], 0).sum(),
        "near_width_sum": ((lohis >> 16) - (lohis & 0xFFFF)).sum(),
        "window_span_sum": (hi_t - lo_t).sum(),
        "window_capacity": torch.full((), ntiles * wt * tile, **i64),
        "node_overflow": torch.zeros((), dtype=torch.int32, device=dev),
    })
    return G * acc[:n], info


# --------------------------------------------------------------------------
# the list path


def default_caps(n: int, theta: float, dim: int) -> tuple[int, int]:
    """The list caps of nbody_tpu (octree_group.py:130-135): every node at
    theta = 0, else 512 (dim - 1) / theta^2, at least 1,024 and at most
    max(n, 64)."""
    if theta <= 1e-6:
        cap = max(n, 64)
    else:
        cap = int(min(max(n, 64), max(1024, (512.0 * (dim - 1)) / (theta * theta))))
    return cap, cap


def compact_rows(values: torch.Tensor, valid: torch.Tensor, width: int):
    """Each row's valid values, ascending, packed to the front and cut or
    padded to `width` columns with the sentinel BIGK: nbody_tpu's one row
    sort (octree_group.py:207-225). A cut keeps the smallest values, as
    JAX does, so an overflowing tile's later lists and counts match it.
    Returns (packed, pvalid, counts), counts taken before the cut."""
    counts = valid.sum(1)
    packed = torch.sort(torch.where(valid, values, BIGK), dim=1).values[:, :width]
    if packed.shape[1] < width:
        packed = torch.nn.functional.pad(packed, (0, width - packed.shape[1]), value=BIGK)
    pvalid = torch.arange(width, device=values.device)[None, :] < counts[:, None]
    return packed, pvalid, counts


def exact_fallback(acc: torch.Tensor, xt: torch.Tensor, tile_over: torch.Tensor, n_over: int,
                   m: torch.Tensor, x: torch.Tensor, eps: float, softening: str,
                   use_cuda: bool = True) -> None:
    """Overwrite the rows of the n_over tiles flagged in tile_over (the
    caller's host read of their count) with their exact sums against all
    bodies, in one call over all of them. nbody_tpu's bounded while_loop
    (octree_group.py:418-468, bvh_group.py:357-401) takes groups of
    K_GRP = min(8, T) tiles for its static shapes; each row's sum is its
    own, so the grouping changes no value, and on the card a group of 8
    tiles would fill 16 blocks of 132 SMs. acc is (T*tile, dim), xt (T,
    tile, dim); use_cuda=False takes the plain twin."""
    if not n_over:
        return
    ntiles, tile, dim = xt.shape
    fallback = allpairs_block_cuda if use_cuda else allpairs_block_torch
    over = torch.argsort((~tile_over).to(torch.int8), stable=True)[:n_over]
    fb = fallback(xt[over].reshape(-1, dim), m, x, eps, softening)
    acc.view(ntiles, tile, dim)[over] = fb.view(-1, tile, dim)


def tile_boxes(x: torch.Tensor, tile: int):
    """The zero-padded bodies as (T, tile, dim) row tiles, and each tile's
    box over its real bodies (a padding row takes the tile's first body)."""
    n, dim = x.shape
    ntiles = -(-n // tile)
    xt = torch.nn.functional.pad(x, (0, 0, 0, ntiles * tile - n)).view(ntiles, tile, dim)
    valid = (torch.arange(ntiles * tile, device=x.device) < n).view(ntiles, tile)
    xt_real = torch.where(valid[:, :, None], xt, xt[:, :1, :])
    return xt, xt_real.amin(1), xt_real.amax(1)


def compute_force_grouped(levels: OctreeLevels, ms: torch.Tensor, xs: torch.Tensor,
                          root_side: torch.Tensor, theta: float, G: float, eps: float,
                          tile: int = 512, cap_nodes: int | None = None,
                          cap_leaves: int | None = None, use_cuda: bool = True,
                          tile_chunk: int = TILE_CHUNK):
    """The octree's list path (octree_group.py:143-478, nrows=None): per
    tile of `tile` Morton-sorted bodies, an interaction list from a
    level-synchronous traversal with the group MAC
    side_l^2 < theta^2 * dmin(tile box, COM)^2 (side_l = root_side / 2^l),
    then one evaluation of every tile against its own list with the sqrt3
    softening, and the exact sum for the tiles that overflow a cap.

    The traversal: levels of capacity <= 2F (F = max(caps)) propagate a
    dense open mask through `parent`; deeper levels expand a compacted
    frontier through child_start/child_count. Single-body nodes are always
    accepted (and evaluated as their body); open cells at the deepest level
    give their bodies, K_CELL at most, as leaf entries. A tile overflows
    when its frontier, node list or leaf list outgrows its cap, or a leaf
    cell holds more than K_CELL bodies. Every rule is nbody_tpu's, so the
    counters of `info` match it. The traversal runs over tile_chunk tiles at
    a time (each tile's lists are its own): at 2^20 bodies in 3-D the
    deepest level holds T x 32,768 candidate cells, and nbody_tpu's
    expansion of each into K_CELL bodies, 8.6 GB of int64 for all 2,048
    tiles at once (here only the first cap_leaves open cells are expanded,
    which gives the same lists).

    The evaluation takes group_eval_cuda over the live heads of the two
    list segments, or its plain twin where not use_cuda (--kernel torch);
    the fallback takes allpairs_block_cuda(..., "sqrt3") or its twin. One
    host read per call: the fallback count. Returns (G * accel in sorted
    order, info) with device counters max_nodes, max_leaves,
    fallback_tiles, node_overflow and leaf_overflow."""
    n, dim = xs.shape
    dev, dtype = xs.device, xs.dtype
    if cap_nodes is None or cap_leaves is None:
        cn, cl = default_caps(n, theta, dim)
        cap_nodes, cap_leaves = cap_nodes or cn, cap_leaves or cl
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)
    side = [root_side / float(1 << level) for level in range(levels.depth + 1)]
    xt, tmin, tmax = tile_boxes(xs, tile)
    ntiles = xt.shape[0]

    parts = [_octree_lists(levels, tmin[c:c + tile_chunk], tmax[c:c + tile_chunk], side, theta2,
                           cap_nodes, cap_leaves) for c in range(0, ntiles, tile_chunk)]
    nodes, ncount, leaves, lcount, causes = (torch.cat(p) for p in zip(*parts))
    del parts
    tile_over = causes.any(1)
    ncnt, lcnt = ncount.clamp_max(cap_nodes), lcount.clamp_max(cap_leaves)

    # the lists: node monopoles, a single-body node demoted to its body
    # (octree_group.py:355-367), then the opened leaf bodies; mass 0 pads
    total = levels.mass.shape[0]
    nmask = torch.arange(cap_nodes, device=dev)[None, :] < ncnt[:, None]
    nidx = nodes.clamp(0, total - 1)
    cnt1 = levels.count[nidx] == 1
    bfirst = levels.start[nidx].clamp(0, n - 1)
    mj_n = torch.where(nmask, torch.where(cnt1, ms[bfirst], levels.mass[nidx]), 0)
    xj_n = torch.where(cnt1[..., None], xs[bfirst], levels.com[nidx])
    lmask = torch.arange(cap_leaves, device=dev)[None, :] < lcnt[:, None]
    bc = leaves.clamp(0, n - 1)
    mj_list = torch.cat([mj_n, torch.where(lmask, ms[bc], 0)], dim=1)
    xj_list = torch.cat([xj_n, xs[bc]], dim=1)
    del nidx, cnt1, bfirst, mj_n, xj_n, bc
    evaluate = group_eval_cuda if use_cuda else group_eval_torch
    acc = evaluate(xt.reshape(-1, dim), mj_list, xj_list, eps, "sqrt3", cap_nodes,
                   ncnt.to(torch.int32), lcnt.to(torch.int32))
    del mj_list, xj_list

    n_over = tile_over.sum()
    exact_fallback(acc, xt, tile_over, int(n_over), ms, xs, eps, "sqrt3", use_cuda)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    info = {"max_nodes": ncnt.max(), "max_leaves": lcnt.max(), "fallback_tiles": n_over,
            "node_overflow": zero, "leaf_overflow": zero,  # the fallback truncates nothing
            **overflow_causes(causes, OCTREE_CAUSES)}
    return G * acc[:n], info


OCTREE_CAUSES = ("frontier", "nodes", "leaves", "k_cell")


def overflow_causes(causes: torch.Tensor, names) -> dict:
    """info's over_<cause> counters: the tiles that each cause sent to the
    fallback, from causes (T, len(names)) bool; a tile may have several."""
    counts = causes.sum(0)
    return {f"over_{name}": counts[i] for i, name in enumerate(names)}


def _octree_lists(levels: OctreeLevels, tmin: torch.Tensor, tmax: torch.Tensor, side: list,
                  theta2: torch.Tensor, cap_nodes: int, cap_leaves: int):
    """The list traversal of the tiles with boxes [tmin, tmax] (T, dim)
    (octree_group.py:227-342). Returns (nodes (T, cap_nodes) flat node
    indices, ncount (T,), leaves (T, cap_leaves) sorted-body indices,
    lcount (T,), causes (T, 4) bool: the tile outgrew its frontier, its
    node cap, its leaf cap, or K_CELL); list slots past a count hold 0."""
    ntiles, dim = tmin.shape
    dev = tmin.device
    depth, caps, offsets = levels.depth, levels.caps, levels.offsets
    total = levels.mass.shape[0]
    width = max(cap_nodes, cap_leaves)  # nbody_tpu's F
    nbranch = 1 << dim
    k_cell = torch.arange(K_CELL, device=dev)

    def classify(level, flat, vmask):
        """Accept and open masks of the nodes `flat`, shared (W,) or per
        tile (T, W), where vmask (T, W) marks them as on the frontier."""
        fc = flat.clamp(0, total - 1)
        cnt = levels.count[fc]
        nonempty = vmask & (cnt > 0)
        mac = side[level] * side[level] < theta2 * _box_dist2(tmin, tmax, levels.com[fc])
        accept = nonempty & ((cnt == 1) | mac)
        return accept, nonempty & ~accept

    def leaf_lists(flat, open_):
        """The open deepest-level cells' first K_CELL bodies, compacted to
        (leaves, lvalid, lcount, over) as nbody_tpu's row sort of every
        cell's K_CELL candidates leaves them (emit_leaf_cells, :256-268).
        A level's cells are numbered in body order, so the open cells in
        index order give their bodies in ascending order, and the first
        cap_leaves open cells (each gives at least one body) hold every
        entry that sort keeps: only they are expanded."""
        cnt = levels.count[flat.clamp(0, total - 1)]
        lcount = torch.where(open_, cnt.clamp_max(K_CELL), 0).sum(1)
        over = (open_ & (cnt > K_CELL)).any(1)
        cells, cvalid, _ = compact_rows(flat.expand_as(open_), open_, cap_leaves)
        cells = cells.clamp(0, total - 1)
        take = torch.where(cvalid, levels.count[cells].clamp_max(K_CELL), 0)
        entries = (levels.start[cells][..., None] + k_cell).reshape(ntiles, -1)
        leaves, _, _ = compact_rows(entries, (k_cell < take[..., None]).reshape(ntiles, -1),
                                    cap_leaves)
        lvalid = torch.arange(cap_leaves, device=dev)[None, :] < lcount[:, None]
        return leaves, lvalid, lcount, over

    over_front = torch.zeros(ntiles, dtype=torch.bool, device=dev)
    over_nodes = torch.zeros_like(over_front)
    acc_idx, acc_valid = [], []
    leaf = None
    n_dense = sum(1 for level in range(depth + 1) if caps[level] <= 2 * width)
    frontier = fvalid = open_ = None
    for level in range(n_dense):  # dense: whole levels, masks through `parent`
        flat = torch.arange(offsets[level], offsets[level] + caps[level], device=dev)
        if level == 0:
            vmask = torch.ones(ntiles, caps[0], dtype=torch.bool, device=dev)
        else:
            vmask = open_[:, levels.parent[flat].clamp(0, caps[level - 1] - 1)]
        accept, open_ = classify(level, flat, vmask)
        acc_idx.append(flat.expand(ntiles, -1))
        acc_valid.append(accept)
        if level == depth:
            leaf = leaf_lists(flat, open_)
        elif level == n_dense - 1:  # to the sparse levels: the open level-local indices
            frontier, fvalid, counts = compact_rows((flat - offsets[level]).expand(ntiles, -1),
                                                    open_, width)
            over_front |= counts > width
    nodes, nvalid, ncount = compact_rows(torch.cat(acc_idx, 1), torch.cat(acc_valid, 1), cap_nodes)
    over_nodes |= ncount > cap_nodes
    del acc_idx, acc_valid

    kb = torch.arange(nbranch, device=dev)
    for level in range(n_dense, depth + 1):  # sparse: the frontier's children
        pflat = offsets[level - 1] + frontier.clamp(0, caps[level - 1] - 1)
        cs, cc = levels.child_start[pflat], levels.child_count[pflat]
        kids = (cs[:, :, None] + kb).reshape(ntiles, -1).clamp(0, caps[level] - 1)
        kmask = (fvalid[:, :, None] & (kb < cc[:, :, None])).reshape(ntiles, -1)
        flat = offsets[level] + kids
        accept, open_ = classify(level, flat, kmask)
        nodes, nvalid, ncount = compact_rows(torch.cat([torch.where(nvalid, nodes, 0), flat], 1),
                                             torch.cat([nvalid, accept], 1), cap_nodes)
        over_nodes |= ncount > cap_nodes
        if level == depth:
            leaf = leaf_lists(flat, open_)
        else:
            frontier, fvalid, counts = compact_rows(kids, open_, width)
            over_front |= counts > width

    leaves, lvalid, lcount, over_kcell = leaf
    causes = torch.stack([over_front, over_nodes, lcount > cap_leaves, over_kcell], dim=1)
    return (torch.where(nvalid, nodes, 0), ncount, torch.where(lvalid, leaves, 0), lcount,
            causes)
