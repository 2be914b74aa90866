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

The `ablate` tokens of nbody_tpu that the port runs (OCTREE_ABLATE) swap
in the A/B variants its knob probe times (python -m nbody_torch.probe
knobs): densemask, the dense float32 far mask (masked_eval_cuda) and the
dense body-mask window (window_eval_dense_cuda); farcompact, the far field
compacted per supertile of 8 tiles (group_shared_masked_eval_cuda);
packedj, the entries reading packed sources; desc1 / desc2, the sparse
supertile descent one or two levels below L* (descend_levels,
experimental/tree_descend.py), whose monopoles go to
group_shared_masked_eval_cuda and whose survivors become the entries.
"""

from __future__ import annotations

import math

import torch

from nbody_torch.experimental.tree_descend import (BIG32, _compact, fold_bits, supertile_descend,
                                                   unfold_bits)
from nbody_torch.ops.cuda_allpairs import allpairs_block_cuda, allpairs_block_torch
from nbody_torch.ops.cuda_group_eval import (entries_lohi_eval_cuda, group_eval_cuda,
                                             group_eval_torch, group_shared_masked_eval_cuda,
                                             masked_eval_bits_cuda, masked_eval_cuda,
                                             pack_mask_bits, window_eval_dense_cuda,
                                             window_eval_interval_cuda)
from nbody_torch.ops.octree import OctreeLevels

BIGK = 1 << 30  # sort sentinel of the per-tile entry rows (and of compact_rows)
# The ablate tokens of nbody_tpu's fast paths that the port runs: densemask,
# farcompact, packedj, desc1 / desc2 select ported kernels; fheap is a no-op
# alias in nbody_tpu (octree_group.py:1063) and sortunperm belongs to the knob
# probe (the port's un-permute is already a gather).
OCTREE_ABLATE = ("densemask", "farcompact", "packedj", "desc1", "desc2", "fheap", "sortunperm")

K_CELL = 16  # bodies expanded per open max-depth cell of the list path (else fallback)
TILE_CHUNK = 256  # tiles per pass of the list path's traversal
FAR_G = 8  # farcompact: tiles per supertile of the compacted far field


def ablate_tokens(ablate: str, ported) -> set:
    """The comma-separated tokens of `ablate` (whole tokens, never
    substrings: "farcompact" is not "far"). A token outside `ported` raises
    ValueError: nbody_tpu's other A/B knobs and wrong-force probes are not
    ported, and none is ignored silently."""
    tokens = {tok for tok in ablate.split(",") if tok}
    unported = sorted(tokens - set(ported))
    if unported:
        raise ValueError(f"ablate token {unported[0]!r} is not yet ported to nbody_torch")
    return tokens


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
                               far_heap_cap: int | None = None, e_chunk: int = 24576,
                               ablate: str = "", descend_levels: int = 0, descend_G: int = 8,
                               descend_caps: tuple = (1024, 1024, 2048), descend_maxb: int = 4,
                               row_start: int = 0, nrows: int | None = None):
    """Gather-free grouped octree force (float32). ms, xs, keys are the
    Morton-sorted bodies and their full-depth int64 keys. Returns
    (G * accel in sorted order, info) with info's counters as device
    tensors: entries, fallback_tiles, open_cells, open_mass,
    near_width_sum, near_unique_blocks, window_span_sum, window_capacity,
    max_nodes, node_overflow, descend_entries_raw, when the far heap is
    compacted far_heap_nonempty, with farcompact far_over_tiles (the tiles
    its supertile cap sent to the fallback), and with descend_levels the
    descent's descend_open_0, descend_mono_r, descend_open_r and
    descend_final_mass.
    ablate: comma-separated tokens of OCTREE_ABLATE (see the module
    docstring); descend_*: the descent's levels, supertile, caps (k0, k,
    m) and blocks per survivor, nbody_tpu's names and defaults.

    Row-range mode (nrows given; octree_group.py:615-650, the replicated
    multi-device layout): only the rows [row_start, row_start + nrows) of
    the sorted bodies are evaluated, against the whole heap and bodies, and
    the result has nrows rows. L*, S, the window's tile range and the run
    table are sized from the whole tile-padded body count (the pad is not
    widened to S, which halves instead until it divides it); the masks,
    entries and fallback are built for the range's tiles alone
    (row_range's rules)."""
    tokens = ablate_tokens(ablate, OCTREE_ABLATE)
    if "desc1" in tokens:
        descend_levels = 1
    if "desc2" in tokens:
        descend_levels = 2
    n, dim = xs.shape
    dev, dtype = xs.device, xs.dtype
    if dtype != torch.float32:
        raise ValueError(f"the fast octree path is float32 only, got {dtype}")
    nbranch = 1 << dim
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)  # no host copy
    i64 = dict(dtype=torch.int64, device=dev)

    # ---- tiles, padding and sizing (octree_group.py:615-715) ----------
    ntiles_g = -(-n // tile)
    npad_g = ntiles_g * tile
    s_req = s_block if s_block is not None else (8192 if dim == 3 else 2048)
    s_req = max(128, min(s_req, npad_g))
    if nrows is None and npad_g % s_req:  # the pad must be a multiple of both tile and S
        lcm = tile * s_req // math.gcd(tile, s_req)
        npad_g = -(-n // lcm) * lcm
        ntiles_g = npad_g // tile
    xp_g = torch.nn.functional.pad(xs, (0, 0, 0, npad_g - n))
    mp_g = torch.nn.functional.pad(ms, (0, npad_g - n))
    out_rows = n if nrows is None else nrows
    row_start, nrows = row_range(row_start, nrows, tile, npad_g)
    ntiles = nrows // tile
    xp = xp_g[row_start:row_start + nrows]
    xt = xp.view(ntiles, tile, dim)
    validb = (row_start + torch.arange(nrows, device=dev) < n).view(ntiles, tile)
    xt_real = torch.where(validb[:, :, None], xt, xt[:, :1, :])
    tmin, tmax = xt_real.amin(1), xt_real.amax(1)

    occ = 8 if dim == 3 else 4
    level_star = 1
    while (1 << (dim * level_star)) * 256 < npad_g * occ and level_star < depth:
        level_star += 1
    S = s_block if s_block is not None else (8192 if dim == 3 else 2048)
    S = max(128, min(S, npad_g))
    while npad_g % S:
        S //= 2
    while npad_g // S > 16384:
        S *= 2
    # the run table's entries pack a 16-bit gbe index
    while (1 << (dim * level_star)) + npad_g // S + 1 > (1 << 16) and level_star > 1:
        level_star -= 1
    C = 1 << (dim * level_star)
    if ntiles > (1 << 15):  # the tile id packs into 16 bits of an int32 entry
        raise ValueError("fast octree path supports at most 2^15 tiles; increase tile")

    # ---- dense prefix heap, levels 0..L* (:717-776) --------------------
    # one scatter at the deepest level the path reads, L* + r_levels (the
    # descent's), and sum / min / max pooling up to the root
    r_levels = min(level_star + descend_levels, depth) - level_star if descend_levels else 0
    deep = level_star + r_levels
    cid_d = keys >> ((depth - deep) * dim)                             # (n,) int64
    Cd = 1 << (dim * deep)
    big = 3.4e38
    cnt = [torch.zeros(Cd, **i64).index_add_(0, cid_d, torch.ones_like(cid_d))]
    mass = [torch.zeros(Cd, dtype=dtype, device=dev).index_add_(0, cid_d, ms)]
    mx = [torch.zeros(Cd, dim, dtype=dtype, device=dev).index_add_(0, cid_d, ms[:, None] * xs)]
    idx2 = cid_d[:, None].expand(n, dim)
    cmin = [torch.full((Cd, dim), big, dtype=dtype, device=dev).scatter_reduce_(0, idx2, xs, "amin")]
    cmax = [torch.full((Cd, dim), -big, dtype=dtype, device=dev).scatter_reduce_(0, idx2, xs, "amax")]
    for _ in range(deep):
        cnt.insert(0, _pool(cnt[0], nbranch, "sum"))
        mass.insert(0, _pool(mass[0], nbranch, "sum"))
        mx.insert(0, _pool(mx[0], nbranch, "sum"))
        cmin.insert(0, _pool(cmin[0], nbranch, "min"))
        cmax.insert(0, _pool(cmax[0], nbranch, "max"))
    cellid = cid_d >> (r_levels * dim)                                 # (n,) at L*
    counts_L = cnt[level_star]
    com = []
    for level in range(level_star + 1):
        c = mx[level] / torch.clamp_min(mass[level], 1e-30)[:, None]
        start = torch.cumsum(cnt[level], 0) - cnt[level]
        single = xs[start.clamp(0, n - 1)]                          # single-body demotion
        com.append(torch.where((cnt[level] == 1)[:, None], single, c))

    # ---- near-field window, snapped to L* cell boundaries -------------
    wt = min(window_tiles, ntiles_g)
    t_idx = torch.arange(ntiles, **i64)
    wjf = 4 if wt % 4 == 0 else (2 if wt % 2 == 0 else 1)
    w0 = (row_start // tile + t_idx - wt // 2).clamp(0, ntiles_g - wt)  # global tiles
    w0 = (w0 // wjf) * wjf
    w0_body = w0 * tile
    w1_body = w0_body + wt * tile
    cell_of_pad = torch.cat([cellid, torch.full((npad_g - n,), C, **i64)])
    cs_arr = torch.cumsum(counts_L, 0) - counts_L
    ce_arr = cs_arr + counts_L
    c0 = cell_of_pad[w0_body.clamp(0, npad_g - 1)]
    c1 = cell_of_pad[(w1_body - 1).clamp(0, npad_g - 1)]
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
    mm_heap = torch.cat(mass[:level_star + 1])
    com_heap = torch.cat(com)
    w_heap = acc_bool.shape[1]
    info = {}

    # ---- far field (octree_group.py:975-1112) --------------------------
    far_over = torch.zeros(ntiles, dtype=torch.bool, device=dev)
    compact = False
    if "farcompact" in tokens:
        # the accepts compacted per supertile of FAR_G tiles (:984-1009): the
        # supertile's monopole list and each member's mask; a supertile whose
        # union outgrows far_cap sends its tiles to the exact fallback
        far_cap = min(w_heap, 8192)
        tsf = -(-ntiles // FAR_G)
        accp = torch.nn.functional.pad(acc_bool, (0, 0, 0, tsf * FAR_G - ntiles))
        fids, fbits, fcnt = _compact(torch.arange(w_heap, **i64).expand(tsf, w_heap),
                                     fold_bits(accp.view(tsf, FAR_G, w_heap)), far_cap)
        far_over = (fcnt > far_cap).repeat_interleave(FAR_G)[:ntiles]
        info["far_over_tiles"] = far_over.sum()
        fvalid = fids != BIG32
        fidc = torch.where(fvalid, fids, 0)
        far_lists = (torch.where(fvalid, mm_heap[fidc], torch.zeros((), dtype=dtype, device=dev)),
                     com_heap[fidc].contiguous(),
                     unfold_bits(fbits, FAR_G).to(dtype).reshape(tsf * FAR_G, -1)[:ntiles]
                     .contiguous())
    elif "densemask" not in tokens:
        # the far heap compacted to its nonempty cells (:1064-1112)
        far_cap = far_heap_cap if far_heap_cap is not None else (2048 if dim == 3 else 8192)
        compact = 0 < far_cap < w_heap
        if compact:
            alive_w = torch.cat(cnt[:level_star + 1]) > 0
            order_key = torch.where(alive_w, 0, w_heap) + torch.arange(w_heap, **i64)
            keep_idx = torch.argsort(order_key)[:far_cap]  # nonempty first, index-stable
            n_keep = alive_w.sum()
            info["far_heap_nonempty"] = n_keep

    # ---- near field: exact entries of the cells open at L*, or of the
    #      descent's survivors below it ----------------------------------
    if r_levels == 0:
        entries, lohis, n_merged, ent_count, r_slice, tile_over, n_raw = _base_entries(
            open_mask, cell_of_pad, C, npad_g, n, S, ntiles, e_chunk, t_idx, dim)
        mono_args = None
    else:
        (entries, lohis, n_merged, ent_count, r_slice, tile_over, n_raw, mono_args,
         desc_info) = _descend_entries(open_mask, cnt, mass, mx, cmin, cmax, level_star, r_levels,
                                       xs, tmin, tmax, theta2, ntiles, npad_g, S, e_chunk, t_idx,
                                       descend_G, descend_caps, descend_maxb)
        info.update(desc_info)
    tile_over = tile_over | far_over

    # ---- the host reads (lax.cond / while_loop in nbody_tpu) -----------
    n_over_t = tile_over.sum()
    if compact:  # both in one read
        cheap, n_over = torch.stack([(n_keep <= far_cap).long(), n_over_t]).tolist()
    else:
        cheap, n_over = False, int(n_over_t)

    # ---- evaluation: far + window + near ------------------------------
    if "farcompact" in tokens:
        far = group_shared_masked_eval_cuda(xp, *far_lists, eps, FAR_G, "sqrt3")
    elif "densemask" in tokens:
        far = masked_eval_cuda(xp, mm_heap, com_heap, acc_bool.to(dtype), eps, "sqrt3")
    elif compact and cheap:
        far = masked_eval_bits_cuda(xp, mm_heap[keep_idx], com_heap[keep_idx].contiguous(),
                                    pack_mask_bits(acc_bool[:, keep_idx]), eps, "sqrt3")
    else:
        far = masked_eval_bits_cuda(xp, mm_heap, com_heap, pack_mask_bits(acc_bool), eps, "sqrt3")
    if "densemask" in tokens:  # the window as a dense body mask (:1117-1126)
        cols = w0_body[:, None] + torch.arange(wt * tile, **i64)[None, :]
        bmask = ((cols >= lo_t[:, None]) & (cols < hi_t[:, None])).to(dtype)
        win = window_eval_dense_cuda(xp, mp_g, xp_g, w0.to(torch.int32), bmask, eps, wt,
                                     "sqrt3")
        del cols, bmask
    else:
        win = window_eval_interval_cuda(xp, mp_g, xp_g, w0.to(torch.int32), lo_t.to(torch.int32),
                                        hi_t.to(torch.int32), eps, wt, "sqrt3")
    near_args = (xp, mp_g, xp_g, entries, lohis, n_merged, S, ntiles, eps, "sqrt3")
    if "packedj" in tokens:
        near = entries_lohi_eval_cuda(*near_args, packed=True)
    else:  # the default path's call, as before the ablation path existed
        near = entries_lohi_eval_cuda(*near_args)
    if mono_args is not None:  # the descent's monopoles
        near = near + group_shared_masked_eval_cuda(xp, *mono_args, eps, descend_G, "sqrt3")
    acc = (far + win) + near

    # ---- exact fallback for overflowed tiles --------------------------
    exact_fallback(acc, xt, tile_over, n_over, ms, xs, eps, "sqrt3")

    info.update({
        "max_nodes": ent_count.clamp_max(r_slice).max(),
        "fallback_tiles": n_over_t,
        "entries": n_merged,
        "descend_entries_raw": n_raw,
        "open_cells": open_mask.sum(),
        "open_mass": torch.where(open_mask, counts_L[None, :], 0).sum(),
        "near_width_sum": ((lohis >> 16) - (lohis & 0xFFFF)).sum(),
        "near_unique_blocks": unique_blocks(entries, n_merged),
        "window_span_sum": (hi_t - lo_t).sum(),
        "window_capacity": torch.full((), ntiles * wt * tile, **i64),
        "node_overflow": torch.zeros((), dtype=torch.int32, device=dev),
    })
    return G * acc[:out_rows], info


def unique_blocks(entries: torch.Tensor, n_real: torch.Tensor) -> torch.Tensor:
    """The distinct S-blocks among the first n_real entries, on the device
    (nbody_tpu's near_unique_blocks / res_unique_blocks)."""
    never = 0x7FFFFFFF
    idx = torch.arange(entries.shape[0], device=entries.device)
    blk = torch.sort(torch.where(idx < n_real, entries & 0xFFFF, never)).values
    return ((blk != torch.cat([blk.new_full((1,), -1), blk[:-1]])) & (blk != never)).sum()


def _entry_cap(ntiles: int, per_tile_est: int, widest: int, e_chunk: int) -> int:
    """E_cap, the entry budget beyond which tiles go to the fallback
    (octree_group.py:1282-1289, :1467-1475; epg 1)."""
    n_chunks = max(1, min(40, -(-(ntiles * per_tile_est + ntiles) // e_chunk)))
    e_cap = min(ntiles * (widest + 1), n_chunks * e_chunk)
    if e_cap > e_chunk:
        e_cap = -(-e_cap // e_chunk) * e_chunk
    return e_cap


def _base_entries(open_mask, cell_of_pad, C, npad, n, S, ntiles, e_chunk, t_idx, dim):
    """The exact entries of the cells open at L*: the global (cell,
    S-block) run table, then per tile the wide extraction
    (octree_group.py:1150-1324). Returns (entries, lohis, n_merged,
    ent_count, r_slice, tile_over, n_raw)."""
    dev = open_mask.device
    i64 = dict(dtype=torch.int64, device=dev)
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

    # per-tile entry lists, wide extraction
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
    e_cap = _entry_cap(ntiles, 64 + ((560 if dim == 3 else 360) * 256) // S, r_slice, e_chunk)
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
    return entries, lohis, n_merged, ent_count, r_slice, tile_over, end_rank[-1]


def _descend_entries(open_mask, cnt, mass, mx, cmin, cmax, level_star, r_levels, xs, tmin, tmax,
                     theta2, ntiles, npad, S, e_chunk, t_idx, Gd, caps, maxb):
    """The sparse supertile descent r_levels below L* (octree_group.py:
    1343-1513): per member tile MAC on the deeper cells' true extents, the
    accepted cells' monopoles (mass, com; a one-body cell is its body) as
    the args of group_shared_masked_eval_cuda, and the survivors as exact
    entries of at most maxb S-blocks each. Returns (entries, lohis,
    n_merged, ent_count, r_slice, tile_over, n_raw, (monopole masses,
    monopole coms, per-tile mask), info's descend_* counters)."""
    n, dim = xs.shape
    dev, dtype = xs.device, xs.dtype
    i64 = dict(dtype=torch.int64, device=dev)
    k0_cap, k_cap, m_cap = caps
    Ts = -(-ntiles // Gd)
    tp = Ts * Gd
    tminp = torch.nn.functional.pad(tmin, (0, 0, 0, tp - ntiles)).view(Ts, Gd, dim)
    tmaxp = torch.nn.functional.pad(tmax, (0, 0, 0, tp - ntiles)).view(Ts, Gd, dim)
    zero = torch.zeros((), dtype=dtype, device=dev)
    level = {r: level_star + r for r in range(r_levels + 1)}
    starts = {r: torch.cumsum(cnt[level[r]], 0) - cnt[level[r]] for r in range(1, r_levels + 1)}

    def mac_fn(r, ch):
        lv = level[r]
        idc = ch.clamp(0, cnt[lv].shape[0] - 1)
        c = cnt[lv][idc]
        alive = c > 0
        msafe = torch.clamp_min(mass[lv][idc], 1e-30)
        width = None
        dmin2 = None
        for d in range(dim):
            wd = cmax[lv][:, d][idc] - cmin[lv][:, d][idc]
            width = wd if width is None else torch.maximum(width, wd)
            com_d = mx[lv][:, d][idc] / msafe
            dd = torch.clamp_min(tminp[:, :, d][:, :, None] - com_d[:, None, :], 0)
            dd = torch.maximum(dd, com_d[:, None, :] - tmaxp[:, :, d][:, :, None])
            dmin2 = dd * dd if dmin2 is None else dmin2 + dd * dd
        weff = torch.where(alive, width, zero)
        accept = ((weff * weff)[:, None, :] < theta2 * dmin2) | (c == 1)[:, None, :]
        return {"accept": accept, "alive": alive}

    def mono_fn(r, mids):
        lv = level[r]
        idc = mids.clamp(0, cnt[lv].shape[0] - 1)
        m, c = mass[lv][idc], cnt[lv][idc]
        sb = starts[r][idc].clamp(0, n - 1)
        msafe = torch.clamp_min(m, 1e-30)
        com = torch.stack([torch.where(c == 1, xs[:, d][sb], mx[lv][:, d][idc] / msafe)
                           for d in range(dim)], dim=-1)
        return m, com

    res = supertile_descend(open_mask, 1 << dim, r_levels, Gd, k0=k0_cap, k_caps=[k_cap] * r_levels,
                            m_caps=[m_cap] * r_levels, mac_fn=mac_fn, mono_fn=mono_fn)
    mono_args = (res.mono_mass.contiguous(), res.mono_com.contiguous(),
                 res.mono_mask[:ntiles].contiguous())

    # the final survivors -> self-describing exact [lo, hi) entries
    cnt_d = cnt[level[r_levels]]
    kf = res.final_ids.shape[1]
    fidc = res.final_ids.clamp(0, cnt_d.shape[0] - 1)
    fst = torch.where(res.final_valid, starts[r_levels][fidc], 0)
    fcnt = torch.where(res.final_valid, cnt_d[fidc], 0)
    fend = fst + fcnt
    memb = unfold_bits(res.final_bits, Gd)                             # (Ts, Gd, kf)
    stm = fst[:, None, :].expand(Ts, Gd, kf).reshape(tp, kf)[:ntiles]
    enm = fend[:, None, :].expand(Ts, Gd, kf).reshape(tp, kf)[:ntiles]
    mem = memb.reshape(tp, kf)[:ntiles]
    nblocks = npad // S
    b0 = stm // S
    # a survivor spanning more than maxb S-blocks sends its tiles to the
    # exact fallback (no truncation)
    cell_over = mem & (enm > (b0 + maxb) * S)
    ent_cols, lohi_cols, val_cols = [], [], []
    for b in range(maxb):
        blk_u = b0 + b                                   # unclamped: drives [lo, hi)
        blk = blk_u.clamp_max(nblocks - 1)
        lo_b = (stm - blk_u * S).clamp(0, S)
        hi_b = (enm - blk_u * S).clamp(0, S)
        ent_cols.append((t_idx[:, None] << 16) | blk)
        lohi_cols.append(lo_b | (hi_b << 16))
        val_cols.append(mem & (hi_b > lo_b))
    # survivor-major columns: each tile's stream is sorted by (block, lo),
    # so the merge below finds every mergeable pair as a neighbour
    entm = torch.cat([t_idx[:, None] << 16, torch.stack(ent_cols, 2).reshape(ntiles, -1)], 1)
    lohim = torch.cat([torch.zeros(ntiles, 1, **i64), torch.stack(lohi_cols, 2).reshape(ntiles, -1)],
                      1)
    valm = torch.cat([torch.ones(ntiles, 1, dtype=torch.bool, device=dev),
                      torch.stack(val_cols, 2).reshape(ntiles, -1)], 1)
    flat_v = valm.reshape(-1)
    frank = torch.cumsum(flat_v, 0) - 1
    e_cap = _entry_cap(ntiles, 128 if dim == 2 else 256, kf * maxb, e_chunk)
    pad_entry = (ntiles - 1) << 16
    dst = torch.where(flat_v & (frank < e_cap), frank, e_cap)         # e_cap: dropped
    entries = torch.full((e_cap + 1,), pad_entry, **i64).scatter_(0, dst, entm.reshape(-1))[:e_cap]
    lohis = torch.zeros(e_cap + 1, **i64).scatter_(0, dst, lohim.reshape(-1))[:e_cap]
    ent_count = valm[:, 1:].sum(1)
    end_rank = torch.cumsum(ent_count + 1, 0)
    tile_over = res.overflow[:ntiles] | cell_over.any(1) | (end_rank > e_cap)
    n_raw = end_rank[-1]
    entries, lohis, n_merged = merge_contiguous_entries(entries.to(torch.int32),
                                                        lohis.to(torch.int32), n_raw, pad_entry)
    desc_info = {f"descend_{k}": v for k, v in res.diag.items()}
    desc_info["descend_final_mass"] = torch.where(memb, fcnt[:, None, :], 0).sum()
    return (entries, lohis, n_merged, ent_count, kf * maxb, tile_over, n_raw, mono_args,
            desc_info)


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


def live_heads(ncnt: torch.Tensor, lcnt: torch.Tensor, tile_over: torch.Tensor):
    """The list evaluation's live heads (int32 (T,) each): the node and
    leaf counts, zero for the tiles that the exact fallback overwrites
    (tile_over), whose lists are then not evaluated. nbody_tpu evaluates
    every tile before its fallback; the fallback writes every row of those
    tiles, so their list sums are never read and no returned value
    changes."""
    return (torch.where(tile_over, 0, ncnt).to(torch.int32),
            torch.where(tile_over, 0, lcnt).to(torch.int32))


def row_range(row_start: int, nrows: int | None, tile: int, npad: int) -> tuple[int, int]:
    """The rows [row_start, row_start + nrows) that a group path evaluates:
    all npad tile-padded rows where nrows is None, else the range the
    caller gives (nbody_tpu's row-range mode, the replicated multi-device
    layout), which must start and end on a tile boundary inside them."""
    if nrows is None:
        return 0, npad
    if nrows <= 0 or nrows % tile or row_start % tile:
        raise ValueError(f"rows [{row_start}, {row_start} + {nrows}) do not fall on tiles of "
                         f"{tile}")
    if not 0 <= row_start <= npad - nrows:
        raise ValueError(f"rows [{row_start}, {row_start + nrows}) lie outside the {npad} "
                         "tile-padded bodies")
    return row_start, nrows


def tile_boxes(x: torch.Tensor, tile: int, row_start: int = 0, nrows: int | None = None):
    """The zero-padded bodies of the rows [row_start, row_start + nrows)
    (all of them where nrows is None) as (T, tile, dim) row tiles, and
    each tile's box over its real bodies (a padding row takes the tile's
    first body)."""
    n, dim = x.shape
    npad = -(-n // tile) * tile
    row_start, nrows = row_range(row_start, nrows, tile, npad)
    ntiles = nrows // tile
    xp = torch.nn.functional.pad(x, (0, 0, 0, npad - n))
    xt = xp[row_start:row_start + nrows].view(ntiles, tile, dim)
    valid = (row_start + torch.arange(nrows, device=x.device) < n).view(ntiles, tile)
    xt_real = torch.where(valid[:, :, None], xt, xt[:, :1, :])
    return xt, xt_real.amin(1), xt_real.amax(1)


def compute_force_grouped(levels: OctreeLevels, ms: torch.Tensor, xs: torch.Tensor,
                          root_side: torch.Tensor, theta: float, G: float, eps: float,
                          tile: int = 512, cap_nodes: int | None = None,
                          cap_leaves: int | None = None, use_cuda: bool = True,
                          tile_chunk: int = TILE_CHUNK, row_start: int = 0,
                          nrows: int | None = None):
    """The octree's list path (octree_group.py:143-478): per
    tile of `tile` Morton-sorted bodies, an interaction list from a
    level-synchronous traversal with the group MAC
    side_l^2 < theta^2 * dmin(tile box, COM)^2 (side_l = root_side / 2^l),
    then one evaluation of every tile against its own list with the sqrt3
    softening, and the exact sum for the tiles that overflow a cap, whose
    lists are not evaluated (live_heads).

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
    list segments (empty for the fallback's tiles), or its plain twin where
    not use_cuda (--kernel torch);
    the fallback takes allpairs_block_cuda(..., "sqrt3") or its twin. One
    host read per call: the fallback count. Returns (G * accel in sorted
    order, info) with device counters max_nodes, max_leaves,
    fallback_tiles, node_overflow and leaf_overflow. With nrows
    (octree_group.py:184-199) only the rows [row_start, row_start + nrows)
    are evaluated, against the whole tree and bodies, and the result has
    nrows rows (row_range's rules)."""
    n, dim = xs.shape
    dev, dtype = xs.device, xs.dtype
    if cap_nodes is None or cap_leaves is None:
        cn, cl = default_caps(n, theta, dim)
        cap_nodes, cap_leaves = cap_nodes or cn, cap_leaves or cl
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)
    side = [root_side / float(1 << level) for level in range(levels.depth + 1)]
    xt, tmin, tmax = tile_boxes(xs, tile, row_start, nrows)
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
                   *live_heads(ncnt, lcnt, tile_over))
    del mj_list, xj_list

    n_over = tile_over.sum()
    exact_fallback(acc, xt, tile_over, int(n_over), ms, xs, eps, "sqrt3", use_cuda)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    info = {"max_nodes": ncnt.max(), "max_leaves": lcnt.max(), "fallback_tiles": n_over,
            "node_overflow": zero, "leaf_overflow": zero,  # the fallback truncates nothing
            **overflow_causes(causes, OCTREE_CAUSES)}
    return G * acc[:n if nrows is None else nrows], info


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
