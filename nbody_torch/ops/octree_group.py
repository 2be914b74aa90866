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
counters of `info` match it, and `info` holds every key of nbody_tpu's.
The TPU's E_CHUNK chunking (a device for TPU SMEM) is not carried over:
the entries kernel takes the whole list, and e_chunk only sizes E_cap,
which decides tile overflow. By default the entries kernel visits each
entry's [lo, hi) exactly and the window only its interval: nbody_tpu's
default sub_width (1024 in 3-D, 256 in 2-D) is a TPU tuning constant and
applies here only when asked for (sub_width= or subwN). JAX's two
device-side branches (the far heap's lax.cond and the fallback's
while_loop) read two counters on the host: one synchronisation per call.

The `ablate` tokens (comma-separated, whole tokens) are the A/B knobs,
wrong-force probes and diagnostics that nbody_tpu's fast path reads
(nbody_tpu/ops/octree_group.py), with its meaning; the knob probe
(python -m nbody_torch.probe knobs oct) replays them. A token that
nbody_tpu reads nowhere raises ValueError, but for the no-op aliases
fheap (the compacted far heap, the default since its round 4b), winskip
(the window's skip, the default since its round 5) and sortunperm (the
knob scripts' un-permute; the port's is a gather either way).

  token (parameter)     nbody_tpu               what the port does
  depth_bias=           :673-679                L* deeper by depth_bias; the
                                                16-bit guard walks it back
  epg1/8/16 (epg=)      :576-581, :51-117,      merge_contiguous_entries'
                        :1285, :1313-1314       tile-aligned recompaction with
                                                no-op pads; a tile past E_cap
                                                goes to the fallback
  subwN (sub_width=)    :586-589, pallas_group  entries_lohi_kernel<span>: each
                        _eval.py:855-893        entry visits its sub_width-
                                                aligned span (entry_spans)
  fheapcapN, nofheap    :590-593, :1065-1107    far_heap_cap; nofheap takes the
                                                dense bit-packed far field
  wj1, wj2              :800-803                cap the window's alignment wjf
  sidefloor             :852-854                MAC width at least the nominal
                                                side max(hi - lo) / 2^l (box=)
  mono                  :875, :902-911          no sub-tile monopole re-test
  subdiag               :892-917                info near_width_cell_tile,
                                                near_width_cell_subtile_xnsub
  pbdiag                :935-969                info pb_width_box, _com, _tile
  ftg2                  :1089, :1111            masked_eval_bits_kernel<tg2>
  nowinskip             :1143                   window_eval_interval_kernel
                                                <full>
  wordextract           :1195-1255              the word-compacted extraction
  (widextract cancels)                          (C % 32 == 0, C >= 32)
  noskip                :1336, :1504            entries_lohi_kernel<span>:
                                                every entry its whole block
  far, win, near        :1012, :1115, :1326,    that part is zeros (wrong
                        :1496                   forces, as in nbody_tpu)
  nlist                 :1328-1329              near = zeros + the int32 sum
                                                of the entry array
  dbg                   :1514-1520              the descent's tensors in
                                                info["descend__dbg"]
  densemask             :1026-1033, :1117-1126  masked_eval_cuda and
                                                window_eval_dense_cuda
  farcompact            :984-1025               group_shared_masked_eval_cuda
                                                per supertile of 8 tiles
  packedj               :1337                   entries_lohi_kernel<packed>
  desc1, desc2          :582-585, :1343-1513    the sparse supertile descent
                                                (experimental/tree_descend.py)
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
# The no-op aliases both fast paths take (see the module docstring).
ALIASES = ("fheap", "sortunperm", "winskip")
# The ablate tokens of nbody_tpu's octree fast path (the module docstring's
# table), and the prefixes of its numbered tokens (subwN, fheapcapN).
OCTREE_ABLATE = ("epg1", "epg8", "epg16", "desc1", "desc2", "wj1", "wj2", "sidefloor", "mono",
                 "subdiag", "pbdiag", "farcompact", "far", "densemask", "ftg2", "nofheap", "win",
                 "nowinskip", "wordextract", "widextract", "near", "nlist", "noskip", "packedj",
                 "dbg", *ALIASES)
OCTREE_NUMBERED = ("subw", "fheapcap")

K_CELL = 16  # bodies expanded per open max-depth cell of the list path (else fallback)
TILE_CHUNK = 256  # tiles per pass of the list path's traversal
FAR_G = 8  # farcompact: tiles per supertile of the compacted far field


def ablate_tokens(ablate: str, known, numbered=()) -> set:
    """The comma-separated tokens of `ablate` (whole tokens, never
    substrings: "farcompact" is not "far"). A token that is neither in
    `known` nor a prefix of `numbered` followed by digits (subw512) raises
    ValueError: nbody_tpu's fast path reads it nowhere, and no token is
    ignored silently."""
    tokens = {tok for tok in ablate.split(",") if tok}
    unknown = sorted(tok for tok in tokens if tok not in known and not any(
        tok.startswith(pre) and tok[len(pre):].isdigit() for pre in numbered))
    if unknown:
        raise ValueError(f"ablate token {unknown[0]!r} is read by no nbody_tpu fast path of "
                         "this tree")
    return tokens


def numbered_token(ablate: str, prefix: str, default, last: bool = False):
    """N of the first token prefixN of `ablate` (the last where `last`, as
    nbody_tpu's BVH reads subwN and dblkN), or `default` without one."""
    values = [int(tok[len(prefix):]) for tok in ablate.split(",")
              if tok.startswith(prefix) and tok[len(prefix):].isdigit()]
    return (values[-1] if last else values[0]) if values else default


def token_epg(tokens: set, epg: int) -> int:
    """epg after the tokens epg1, epg8, epg16 (read in that order, each
    overriding the last, octree_group.py:576-581, bvh_group.py:490-495)."""
    for tok, value in (("epg1", 1), ("epg8", 8), ("epg16", 16)):
        if tok in tokens:
            epg = value
    if epg < 1:
        raise ValueError(f"epg must be positive, got {epg}")
    return epg


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's values wrapped to int32, as JAX's int32 sums wrap."""
    return ((v.long() + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def merge_contiguous_entries(entries: torch.Tensor, lohis: torch.Tensor, n_raw: torch.Tensor,
                             pad_entry: int, ntiles: int | None = None, epg: int = 1):
    """Merge chains of touching same-block entries of a tile-sorted entry
    stream (octree_group.py:51-117): an entry equal to its predecessor
    whose lo is the predecessor's hi joins its run. Returns (entries,
    lohis, n_merged, tend); entries past the merged stream are no-op pads
    (lo == hi == 0). With epg > 1 the merged entries are recompacted tile
    by tile: each tile's run starts at the epg-rounded sum of the runs
    before it, its round-up slack holds no-op entries with its tile id,
    n_merged counts them, and tend (ntiles,) is each tile's stream end,
    past E_cap for a tile whose entries did not fit (the caller sends it
    to the exact fallback); tend is None at epg 1. int32 in, int32 out."""
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
    if epg == 1:
        entries = torch.where(ii <= gid[-1], gent, torch.full_like(gent, pad_entry))
        lohis = torch.minimum(glo, ghi) | (ghi << 16)
        n_merged = (keep & (ii < n_raw)).sum()
        return entries, lohis, n_merged, None
    # tile-aligned recompaction (:87-117): a kept entry goes to its tile's
    # base plus its rank in the tile (gids are consecutive within a tile)
    i64 = dict(dtype=torch.int64, device=dev)
    keepr = keep & (ii < n_raw)
    tid = (entries >> 16).long()
    tid_d = torch.where(keepr, tid, ntiles)
    mcnt = torch.zeros(ntiles + 1, **i64).index_add_(0, tid_d, torch.ones_like(tid_d))[:ntiles]
    padded = -(-mcnt // epg) * epg
    base = torch.cumsum(padded, 0) - padded
    gmin = torch.full((ntiles + 1,), 0x7FFFFFFF, **i64).scatter_reduce_(0, tid_d, gid, "amin")
    tid_c = tid.clamp_max(ntiles - 1)
    dst = torch.where(keepr, base[tid_c] + gid - gmin[tid_c], e_cap).clamp_max(e_cap)
    out_ent = torch.full((e_cap + 1,), pad_entry, **i64).scatter_(0, dst, gent[gid].long())
    lohi_i = torch.minimum(glo, ghi)[gid] | (ghi[gid] << 16)
    out_lohi = torch.zeros(e_cap + 1, **i64).scatter_(0, dst, lohi_i.long())
    # each tile's round-up slack: no-op entries with the tile's id
    jj = torch.arange(epg, **i64)[None, :]
    pdst = torch.where(jj < (padded - mcnt)[:, None], base[:, None] + mcnt[:, None] + jj, e_cap)
    tids = torch.arange(ntiles, **i64)[:, None].expand_as(pdst)
    out_ent.scatter_(0, pdst.clamp_max(e_cap).reshape(-1), (tids << 16).reshape(-1))
    return (out_ent[:e_cap].to(torch.int32), out_lohi[:e_cap].to(torch.int32),
            base[-1] + padded[-1], base + padded)


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
                               row_start: int = 0, nrows: int | None = None, depth_bias: int = 0,
                               epg: int = 1, sub_width: int | None = None, box=None):
    """Gather-free grouped octree force (float32). ms, xs, keys are the
    Morton-sorted bodies and their full-depth int64 keys. Returns
    (G * accel in sorted order, info) with info's counters as device
    tensors, nbody_tpu's keys: entries, fallback_tiles, open_cells,
    open_mass, near_width_sum, near_unique_blocks, window_span_sum,
    window_capacity, max_nodes, max_leaves, node_overflow, leaf_overflow,
    descend_entries_raw; without the descent bad_entries and the
    extraction's overflow reasons flag_entcnt, flag_rank, flag_extra; when
    the far heap is compacted far_heap_nonempty; with farcompact
    far_over_tiles (the tiles its supertile cap sent to the fallback, the
    port's own); with descend_levels the descent's descend_open_0,
    descend_mono_r, descend_open_r and descend_final_mass; and the keys of
    the diagnostic tokens (the module docstring).
    ablate: comma-separated tokens of OCTREE_ABLATE (see the module
    docstring); descend_*: the descent's levels, supertile, caps (k0, k,
    m) and blocks per survivor, nbody_tpu's names and defaults;
    depth_bias, epg, sub_width: nbody_tpu's (the module docstring), but
    sub_width None or 0 is the whole [lo, hi) here; box: (lo, hi), the
    quantization box, which only the sidefloor token reads.

    Row-range mode (nrows given; octree_group.py:615-650, the replicated
    multi-device layout): only the rows [row_start, row_start + nrows) of
    the sorted bodies are evaluated, against the whole heap and bodies, and
    the result has nrows rows. L*, S, the window's tile range and the run
    table are sized from the whole tile-padded body count (the pad is not
    widened to S, which halves instead until it divides it); the masks,
    entries and fallback are built for the range's tiles alone
    (row_range's rules)."""
    tokens = ablate_tokens(ablate, OCTREE_ABLATE, OCTREE_NUMBERED)
    epg = token_epg(tokens, epg)
    if "desc1" in tokens:
        descend_levels = 1
    if "desc2" in tokens:
        descend_levels = 2
    sub_width = numbered_token(ablate, "subw", sub_width)
    far_heap_cap = numbered_token(ablate, "fheapcap", far_heap_cap)
    if "sidefloor" in tokens and box is None:
        raise ValueError("the sidefloor token needs box=(lo, hi), the quantization box")
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
    level_star = min(level_star + depth_bias, depth)  # the guard below walks it back
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
    if "wj1" in tokens:
        wjf = 1
    elif "wj2" in tokens:
        wjf = min(wjf, 2)
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
        if "sidefloor" in tokens:  # the nominal side as the width's floor
            weff = torch.maximum(weff, (box[1] - box[0]).amax() / float(1 << level))
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
    info = {}
    sub_fail_w = torch.zeros((), **i64)  # subdiag: the widths each sub-tile's own MAC opens
    for s in range(nsub):
        d2s = _box_dist2(sb_lo[:, s], sb_hi[:, s], com[level_star])
        min_dmin2 = d2s if min_dmin2 is None else torch.minimum(min_dmin2, d2s)
        if "subdiag" in tokens:
            fail = open_mask & ~(w2_L[None, :] < theta2 * d2s)
            sub_fail_w = sub_fail_w + torch.where(fail, counts_L[None, :], 0).sum()
    mono = open_mask & (w2_L[None, :] < theta2 * min_dmin2)
    del min_dmin2, d2s
    if "mono" not in tokens:
        accept_masks[-1] = accept_masks[-1] | mono
        open_mask = open_mask & ~mono
    if "subdiag" in tokens:
        info["near_width_cell_subtile_xnsub"] = wrap_int32(sub_fail_w)
        info["near_width_cell_tile"] = wrap_int32(torch.where(open_mask, counts_L[None, :], 0).sum())
    if "pbdiag" in tokens:
        info.update(per_body_widths(xt_real, open_mask, counts_L, cmin[level_star],
                                    cmax[level_star], com[level_star], w2_L, theta2))

    acc_bool = torch.cat(accept_masks, dim=1)                          # (T, W)
    mm_heap = torch.cat(mass[:level_star + 1])
    com_heap = torch.cat(com)
    w_heap = acc_bool.shape[1]

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
    elif "densemask" not in tokens and "far" not in tokens:
        # the far heap compacted to its nonempty cells (:1064-1112), unless
        # nofheap or a cap of 0
        far_cap = far_heap_cap
        if far_cap is None and "nofheap" not in tokens:
            far_cap = 2048 if dim == 3 else 8192
        compact = far_cap is not None and 0 < far_cap < w_heap
        if compact:
            alive_w = torch.cat(cnt[:level_star + 1]) > 0
            order_key = torch.where(alive_w, 0, w_heap) + torch.arange(w_heap, **i64)
            keep_idx = torch.argsort(order_key)[:far_cap]  # nonempty first, index-stable
            n_keep = alive_w.sum()
            info["far_heap_nonempty"] = n_keep

    # ---- near field: exact entries of the cells open at L*, or of the
    #      descent's survivors below it ----------------------------------
    if r_levels == 0:
        wordex = C % 32 == 0 and C >= 32 and "wordextract" in tokens and "widextract" not in tokens
        entries, lohis, n_merged, ent_count, r_slice, tile_over, n_raw, flags = _base_entries(
            open_mask, cell_of_pad, C, npad_g, n, S, ntiles, e_chunk, t_idx, dim, epg, wordex)
        info.update(flags)
        info["bad_entries"] = ((entries >> 16) >= ntiles).sum()
        mono_args = None
    else:
        (entries, lohis, n_merged, ent_count, r_slice, tile_over, n_raw, mono_args,
         desc_info) = _descend_entries(open_mask, cnt, mass, mx, cmin, cmax, level_star, r_levels,
                                       xs, tmin, tmax, theta2, ntiles, npad_g, S, e_chunk, t_idx,
                                       descend_G, descend_caps, descend_maxb, epg)
        info.update(desc_info)
    tile_over = tile_over | far_over

    # ---- the host reads (lax.cond / while_loop in nbody_tpu) -----------
    n_over_t = tile_over.sum()
    if compact:  # both in one read
        cheap, n_over = torch.stack([(n_keep <= far_cap).long(), n_over_t]).tolist()
    else:
        cheap, n_over = False, int(n_over_t)

    # ---- evaluation: far + window + near ------------------------------
    tg = 2 if "ftg2" in tokens else 1
    if "far" in tokens:  # the wrong-force probes: that part is zeros
        far = torch.zeros_like(xp)
    elif "farcompact" in tokens:
        far = group_shared_masked_eval_cuda(xp, *far_lists, eps, FAR_G, "sqrt3")
    elif "densemask" in tokens:
        far = masked_eval_cuda(xp, mm_heap, com_heap, acc_bool.to(dtype), eps, "sqrt3")
    elif compact and cheap:
        far = masked_eval_bits_cuda(xp, mm_heap[keep_idx], com_heap[keep_idx].contiguous(),
                                    pack_mask_bits(acc_bool[:, keep_idx]), eps, "sqrt3",
                                    tile_group=tg)
    else:
        far = masked_eval_bits_cuda(xp, mm_heap, com_heap, pack_mask_bits(acc_bool), eps, "sqrt3",
                                    tile_group=tg)
    if "win" in tokens:
        win = torch.zeros_like(xp)
    elif "densemask" in tokens:  # the window as a dense body mask (:1117-1126)
        cols = w0_body[:, None] + torch.arange(wt * tile, **i64)[None, :]
        bmask = ((cols >= lo_t[:, None]) & (cols < hi_t[:, None])).to(dtype)
        win = window_eval_dense_cuda(xp, mp_g, xp_g, w0.to(torch.int32), bmask, eps, wt,
                                     "sqrt3")
        del cols, bmask
    else:
        win = window_eval_interval_cuda(xp, mp_g, xp_g, w0.to(torch.int32), lo_t.to(torch.int32),
                                        hi_t.to(torch.int32), eps, wt, "sqrt3",
                                        skip_outside="nowinskip" not in tokens)
    far_win = far + win
    if "near" in tokens:
        near = torch.zeros_like(xp)
    elif "nlist" in tokens and mono_args is None:  # the list built, its evaluation not
        near = torch.zeros_like(xp) + wrap_int32(entries.long().sum()).to(dtype)
    else:
        near = entries_lohi_eval_cuda(xp, mp_g, xp_g, entries, lohis, n_merged, S, ntiles, eps,
                                      "sqrt3", packed="packedj" in tokens, sub_width=sub_width,
                                      skip_empty="noskip" not in tokens)
    if mono_args is not None:  # the descent's monopoles
        mono_far = group_shared_masked_eval_cuda(xp, *mono_args[:3], eps, descend_G, "sqrt3")
        if "dbg" in tokens:  # the descent's tensors, by nbody_tpu's names (:1514-1520)
            info["descend__dbg"] = {
                "res": mono_args[-1], "entries": entries, "lohis": lohis, "mono_far": mono_far,
                "ent_near": near, "open_mask": open_mask, "win_lo": lo_t, "win_hi": hi_t,
                "cellid": cellid, "cid_d": cid_d, "far_win": far_win}
        near = near + mono_far
    acc = far_win + near

    # ---- exact fallback for overflowed tiles --------------------------
    exact_fallback(acc, xt, tile_over, n_over, ms, xs, eps, "sqrt3")

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    info.update({
        "max_nodes": ent_count.clamp_max(r_slice).max(),
        "max_leaves": zero,
        "leaf_overflow": zero,
        "fallback_tiles": n_over_t,
        "entries": n_merged,
        "descend_entries_raw": n_raw,
        "open_cells": open_mask.sum(),
        "open_mass": torch.where(open_mask, counts_L[None, :], 0).sum(),
        "near_width_sum": ((lohis >> 16) - (lohis & 0xFFFF)).sum(),
        "near_unique_blocks": unique_blocks(entries, n_merged),
        "window_span_sum": (hi_t - lo_t).sum(),
        "window_capacity": torch.full((), ntiles * wt * tile, **i64),
        "node_overflow": zero,
    })
    return G * acc[:out_rows], info


def per_body_widths(xt_real: torch.Tensor, open_mask: torch.Tensor, counts: torch.Tensor,
                    cmin: torch.Tensor, cmax: torch.Tensor, com: torch.Tensor, w2: torch.Tensor,
                    theta2: torch.Tensor, samples: int = 64) -> dict:
    """The pbdiag token's sampled per-body MAC pricing (octree_group.py:
    935-969): for min(samples, T) tiles at a stride of T // samples, the
    pairs (body, source body) of the cells open at L* that fail the MAC
    taken per body against the cell's box (pb_width_box) and its COM
    (pb_width_com), beside the tile MAC's pairs (pb_width_tile); float32,
    summed here in float64."""
    ntiles, tile, dim = xt_real.shape
    st = min(samples, ntiles)
    samp = torch.arange(st, device=xt_real.device) * max(1, ntiles // st)
    cnt = counts.double()
    sums = torch.zeros(3, dtype=torch.float64, device=xt_real.device)
    for t in samp.tolist():
        xb, op = xt_real[t], open_mask[t]
        d2box = d2com = None
        for d in range(dim):
            xv = xb[:, d][:, None]
            dd = torch.maximum(torch.clamp_min(cmin[:, d][None, :] - xv, 0), xv - cmax[:, d][None, :])
            dc = xv - com[:, d][None, :]
            d2box = dd * dd if d2box is None else d2box + dd * dd
            d2com = dc * dc if d2com is None else d2com + dc * dc
        sums[0] += torch.where(op[None, :] & ~(w2[None, :] < theta2 * d2box), cnt, 0).sum()
        sums[1] += torch.where(op[None, :] & ~(w2[None, :] < theta2 * d2com), cnt, 0).sum()
        sums[2] += torch.where(op, cnt, 0).sum() * tile
    box, com_w, tile_w = sums.float()
    return {"pb_width_box": box, "pb_width_com": com_w, "pb_width_tile": tile_w}


def unique_blocks(entries: torch.Tensor, n_real: torch.Tensor) -> torch.Tensor:
    """The distinct S-blocks among the first n_real entries, on the device
    (nbody_tpu's near_unique_blocks / res_unique_blocks)."""
    never = 0x7FFFFFFF
    idx = torch.arange(entries.shape[0], device=entries.device)
    blk = torch.sort(torch.where(idx < n_real, entries & 0xFFFF, never)).values
    return ((blk != torch.cat([blk.new_full((1,), -1), blk[:-1]])) & (blk != never)).sum()


def _entry_cap(ntiles: int, per_tile_est: int, widest: int, e_chunk: int, epg: int = 1) -> int:
    """E_cap, the entry budget beyond which tiles go to the fallback
    (octree_group.py:1282-1289, :1467-1475; bvh_group.py:882-889): a
    multiple of epg, and of e_chunk past one chunk."""
    n_chunks = max(1, min(40, -(-(ntiles * per_tile_est + ntiles) // e_chunk)))
    e_cap = min(ntiles * (widest + 1), n_chunks * e_chunk)
    e_cap = -(-e_cap // epg) * epg
    if e_cap > e_chunk:
        e_cap = -(-e_cap // e_chunk) * e_chunk
    return e_cap


def _base_entries(open_mask, cell_of_pad, C, npad, n, S, ntiles, e_chunk, t_idx, dim, epg=1,
                  wordex=False):
    """The exact entries of the cells open at L*: the global (cell,
    S-block) run table, then per tile the wide extraction, or with wordex
    the word-compacted one (octree_group.py:1150-1324). Returns (entries,
    lohis, n_merged, ent_count, r_slice, tile_over, n_raw, the overflow
    reasons flag_entcnt, flag_rank, flag_extra)."""
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

    # per-tile entry lists
    r_slice = min(gbe_cap + 1, 2048)
    pad_gbe = gbe_cap
    extra_over = torch.zeros(ntiles, dtype=torch.bool, device=dev)
    if not wordex:  # the wide extraction: a (T, gbe) gather and row sort
        open_c = torch.cat([open_mask, torch.zeros(ntiles, 1, dtype=torch.bool, device=dev)], dim=1)
        open_gbe = open_c[:, gbe_cell]                                # (T, gbe_cap + 1)
        gkey = torch.where(open_gbe, gi[None, :], BIGK)
        sorted_g = torch.sort(gkey, dim=1).values[:, :r_slice]
        ent_count = open_gbe.sum(1)
        del open_gbe, gkey
    else:
        sorted_g, ent_count, extra_over = _word_extract(open_mask, gbe_cell, gbe_valid, gi, C,
                                                        gbe_cap, r_slice)
    slot = torch.arange(r_slice, **i64)[None, :]
    vmask = slot < ent_count.clamp_max(r_slice)[:, None]
    ent_rows = torch.where(vmask, sorted_g.clamp_max(pad_gbe), pad_gbe)
    ent_rows = torch.cat([torch.full((ntiles, 1), pad_gbe, **i64), ent_rows], dim=1)
    vflag = torch.cat([torch.ones(ntiles, 1, dtype=torch.bool, device=dev), vmask], dim=1)
    flat_v = vflag.reshape(-1)
    flat_ent = ((t_idx[:, None] << 16) | ent_rows).reshape(-1)
    frank = torch.cumsum(flat_v, 0) - 1
    e_cap = _entry_cap(ntiles, 64 + ((560 if dim == 3 else 360) * 256) // S, r_slice, e_chunk,
                       epg)
    pad_gbe_entry = ((ntiles - 1) << 16) | pad_gbe
    dst = torch.where(flat_v & (frank < e_cap), frank, e_cap)        # e_cap: dropped
    entries_gbe = torch.full((e_cap + 1,), pad_gbe_entry, **i64).scatter_(0, dst, flat_ent)[:e_cap]
    end_rank = torch.cumsum(1 + ent_count.clamp_max(r_slice), 0)
    tile_over = (ent_count > r_slice) | (end_rank > e_cap) | extra_over
    flags = {"flag_entcnt": (ent_count > r_slice).sum(), "flag_rank": (end_rank > e_cap).sum(),
             "flag_extra": extra_over.sum()}

    # resolve the gbe indirection into self-describing entries and merge
    gidx = entries_gbe & 0xFFFF
    entries = ((entries_gbe & ~0xFFFF) | gbe_blk[gidx]).to(torch.int32)
    lohis = lohi_tbl[gidx]
    entries, lohis, n_merged, tend = merge_contiguous_entries(entries, lohis, end_rank[-1],
                                                              (ntiles - 1) << 16, ntiles, epg)
    if tend is not None:
        tile_over = tile_over | (tend > e_cap)
    return entries, lohis, n_merged, ent_count, r_slice, tile_over, end_rank[-1], flags


def _word_extract(open_mask, gbe_cell, gbe_valid, gi, C, gbe_cap, r_slice, maxb=4):
    """The wordextract token's extraction (octree_group.py:1209-1255): the
    (T, C) open mask folded into 32-cell words, a tile's first RW = min(C /
    32, 256) nonzero words kept, their open cells (at most R_CELL = min(
    r_slice, RW * 32)) and each cell's first maxb runs of the table, in
    ascending run order. Returns (sorted run ids (T, r_slice), BIGK past a
    tile's runs, the run count a tile (all of each cell's runs), and the
    tiles that overflowed a word, cell or block limit)."""
    ntiles = open_mask.shape[0]
    dev = open_mask.device
    i64 = dict(dtype=torch.int64, device=dev)
    nwords = C // 32
    rw = min(nwords, 256)
    sh32 = torch.arange(32, **i64)
    words = (open_mask.view(ntiles, nwords, 32).long() << sh32).sum(2)   # bits 0..31
    wkey = torch.where(words != 0, torch.arange(nwords, **i64)[None, :], BIGK)
    sw = torch.sort(wkey, dim=1).values[:, :rw]
    swc = sw.clamp_max(nwords - 1)
    wv = torch.where(sw < BIGK, torch.gather(words, 1, swc), 0)
    wcnt = (words != 0).sum(1)
    first = torch.full((C + 1,), gbe_cap, **i64).scatter_reduce_(0, gbe_cell, gi, "amin")
    nblk = torch.zeros(C + 1, **i64).index_add_(0, gbe_cell, gbe_valid.long())
    obit = ((wv[:, :, None] >> sh32) & 1) > 0
    r_cell = min(r_slice, rw * 32)
    ckey = torch.where(obit, swc[:, :, None] * 32 + sh32, BIGK).reshape(ntiles, rw * 32)
    sc = torch.sort(ckey, dim=1).values[:, :r_cell]
    cvalid = sc < BIGK
    scc = sc.clamp_max(C - 1)
    kb = torch.where(cvalid, nblk[scc], 0)
    jj = torch.arange(maxb, **i64)
    ekey = torch.where(cvalid[:, :, None] & (jj < kb.clamp_max(maxb)[:, :, None]),
                       first[scc][:, :, None] + jj, BIGK).reshape(ntiles, -1)
    sorted_g = torch.sort(ekey, dim=1).values[:, :r_slice]
    if sorted_g.shape[1] < r_slice:
        sorted_g = torch.nn.functional.pad(sorted_g, (0, r_slice - sorted_g.shape[1]), value=BIGK)
    extra_over = (wcnt > rw) | (obit.sum((1, 2)) > r_cell) | (cvalid & (nblk[scc] > maxb)).any(1)
    return sorted_g, kb.sum(1), extra_over


def _descend_entries(open_mask, cnt, mass, mx, cmin, cmax, level_star, r_levels, xs, tmin, tmax,
                     theta2, ntiles, npad, S, e_chunk, t_idx, Gd, caps, maxb, epg=1):
    """The sparse supertile descent r_levels below L* (octree_group.py:
    1343-1513): per member tile MAC on the deeper cells' true extents, the
    accepted cells' monopoles (mass, com; a one-body cell is its body) as
    the args of group_shared_masked_eval_cuda, and the survivors as exact
    entries of at most maxb S-blocks each. Returns (entries, lohis,
    n_merged, ent_count, r_slice, tile_over, n_raw, (monopole masses,
    monopole coms, per-tile mask, the descent's result), info's descend_*
    counters)."""
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
                 res.mono_mask[:ntiles].contiguous(), res)

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
    e_cap = _entry_cap(ntiles, 128 if dim == 2 else 256, kf * maxb, e_chunk, epg)
    pad_entry = (ntiles - 1) << 16
    dst = torch.where(flat_v & (frank < e_cap), frank, e_cap)         # e_cap: dropped
    entries = torch.full((e_cap + 1,), pad_entry, **i64).scatter_(0, dst, entm.reshape(-1))[:e_cap]
    lohis = torch.zeros(e_cap + 1, **i64).scatter_(0, dst, lohim.reshape(-1))[:e_cap]
    ent_count = valm[:, 1:].sum(1)
    end_rank = torch.cumsum(ent_count + 1, 0)
    tile_over = res.overflow[:ntiles] | cell_over.any(1) | (end_rank > e_cap)
    n_raw = end_rank[-1]
    entries, lohis, n_merged, tend = merge_contiguous_entries(
        entries.to(torch.int32), lohis.to(torch.int32), n_raw, pad_entry, ntiles, epg)
    if tend is not None:
        tile_over = tile_over | (tend > e_cap)
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
