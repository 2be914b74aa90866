"""Grouped BVH force (the port of nbody_tpu.ops.bvh_group): the fast path,
compute_force_grouped_windowed (its default branch), and the list path,
compute_force_grouped, which float64 runs and --kernel torch take (see
its docstring). The fast path:

Bodies arrive Hilbert-sorted, so consecutive bodies form spatially tight
tiles of `tile` rows; the tree is the implicit heap of ops.bvh. Per tile,
with the conservative group MAC bw^2 < theta^2 * dmin(tile box, COM)^2
(never less accurate than the reference's per-body MAC, bvh.h:246-324):

  far       dense per-level accept masks over heap levels 0..L*, an L*
            node covering S = 2^(nlevels - L*) bodies (S = 512 at the
            defaults), plus a sub-tile monopole re-test of the nodes still
            open outside the window; the accepted nodes go to the far-field
            kernel with the packed mask;
  window    each tile evaluates the bodies of a window of `window_tiles`
            tiles around it exactly, counting the S-body slots whose L*
            node is open (the node-mask kernel, or the dense-mask kernel
            where a window block would hold more than 64 slots);
  residual  open L* nodes outside the window become exact S-body entries
            (tile << 16 | blk, lo | hi << 16) over Sd-wide blocks, merged
            where they touch, for the entries kernel;
  fallback  tiles whose entry list outgrows its caps are evaluated exactly
            against all bodies by allpairs_block_cuda(..., "poly").

Every pair uses the reference's softening d2 * sqrt(d2) + eps (bvh.h:297,
308). Every sizing rule (L*, S, the d_block widening of the pad to Sd, the
window alignment wjf, R_slice, RW, E_cap from e_chunk, the 2^15-tile and
2^16-node guards) is nbody_tpu's, so the integer counters of `info` match
it. The TPU's E_CHUNK chunking is not carried over: the entries kernel
takes the whole list. By default it visits each entry's [lo, hi) exactly:
nbody_tpu's default sub_width (1024 in 3-D, 512 in 2-D) is a TPU tuning
constant and applies here only when asked for (sub_width= or subwN). The
word-compacted residual extraction becomes one row sort, with the same
word limit RW and the same overflow flag (residual_ids). JAX's
while_loop over overflowed tiles reads one counter on the host: one
synchronisation per call.

refine_levels R (None: nbody_tpu's default, 0) first refines the open
nodes outside the window R levels down (at most nlevels - 1 - L*): each
child is re-tested with the group MAC and joins the far field when it
passes, so the far field's heap prefix widens to levels 0..L*+R; the
survivors, S2 = S / 2^R bodies each, become the residual entries, and
sibling runs that survived whole merge back into one entry.

The `ablate` tokens (comma-separated, whole tokens) are those that
nbody_tpu's windowed path reads (nbody_tpu/ops/bvh_group.py), with its
meaning; the knob probe (python -m nbody_torch.probe knobs bvh) replays
them. A token that nbody_tpu reads nowhere raises ValueError, but for the
no-op aliases fheap, sortunperm and winskip (octree_group.ALIASES).

  token (parameter)     nbody_tpu               what the port does
  epg1/8/16 (epg=)      :490-495, :885,         merge_contiguous_entries'
                        :911-914                tile-aligned recompaction; a
                                                tile past E_cap to the fallback
  subwN (sub_width=)    :496-498, :514-524      entries_lohi_kernel<span>
                                                (the last subwN counts)
  dblkN (d_block=)      :499-513, :559-606      the residual's block width Sd:
                                                the pad widened to it, halved
                                                until it fits; dblk0 node-sized
  wj1, wj2              :668-671                cap the window's alignment wjf
                                                (wjf * npt > 64: the dense
                                                window, :682)
  win, far, resid       :680, :784, :922        that part is zeros (wrong
                                                forces, as in nbody_tpu)
  rlist                 :924-925                resid = zeros + the int32 sum
                                                of the entry array
  ftg2                  :799                    masked_eval_bits_kernel<tg2>
  nowinskip             :702                    window_eval_nodemask_kernel
                                                <full>
  densemask             :682-691, :786-791      masked_eval_cuda and
                                                window_eval_dense_cuda
  packedj               :932                    entries_lohi_kernel<packed>
  widextract            :810                    residual_ids(wide=True)
  forceover0            :843-847                tile 0 to the exact fallback as
                                                if its words overflowed
"""

from __future__ import annotations

import math

import torch

from nbody_torch.ops.bvh import BVHTree
from nbody_torch.ops.cuda_allpairs import allpairs_block_cuda
from nbody_torch.ops.cuda_group_eval import (entries_lohi_eval_cuda, group_eval_cuda,
                                             group_eval_torch, masked_eval_bits_cuda,
                                             masked_eval_cuda, pack_mask_bits,
                                             window_eval_dense_cuda, window_eval_nodemask_cuda)
from nbody_torch.ops.octree_group import (ALIASES, _box_dist2, _entry_cap, ablate_tokens,
                                          compact_rows, exact_fallback, live_heads,
                                          merge_contiguous_entries, numbered_token,
                                          overflow_causes, row_range, tile_boxes, token_epg,
                                          unique_blocks, wrap_int32)

BIG = 1 << 30  # sort sentinel of the residual node ids
# The ablate tokens of nbody_tpu's windowed path (the module docstring's
# table), and the prefixes of its numbered tokens (subwN, dblkN).
BVH_ABLATE = ("epg1", "epg8", "epg16", "wj1", "wj2", "win", "far", "resid", "rlist", "ftg2",
              "nowinskip", "densemask", "packedj", "widextract", "forceover0", *ALIASES)
BVH_NUMBERED = ("subw", "dblk")


def residual_ids(out_open: torch.Tensor, r_slice: int, wide: bool = False):
    """Per tile, the ascending ids of its open residual nodes, padded with
    BIG to r_slice columns, and a per-tile flag that forces the tile into
    the exact fallback: nbody_tpu's word-compacted extraction
    (bvh_group.py:810-842) keeps only the nodes of a tile's first RW
    nonzero 32-node words (RW = min(words, max(256, r_slice // 4))) and
    flags the tiles with more such words. Below 32 nodes, or at a node
    count that is not a multiple of 32, every node is kept (its wide
    branch, which wide takes at any count). Returns (ids (T, r_slice)
    int64, word_overflow (T,) bool)."""
    ntiles, nodes = out_open.shape
    key = torch.where(out_open, torch.arange(nodes, device=out_open.device), BIG)
    word_over = torch.zeros(ntiles, dtype=torch.bool, device=out_open.device)
    if nodes % 32 == 0 and nodes >= 32 and not wide:
        nwords = nodes // 32
        rw = min(nwords, max(256, r_slice // 4))
        if rw < nwords:  # otherwise no tile can hold more than rw nonzero words
            nonzero = out_open.view(ntiles, nwords, 32).any(2)
            kept = (torch.cumsum(nonzero, 1) <= rw).repeat_interleave(32, dim=1)
            key = torch.where(kept, key, BIG)
            word_over = nonzero.sum(1) > rw
    return torch.sort(key, dim=1).values[:, :r_slice], word_over


def compute_force_grouped_windowed(tree: BVHTree, m: torch.Tensor, x: torch.Tensor,
                                   theta: float, G: float, eps: float, tile: int = 512,
                                   window_tiles: int = 32, e_chunk: int = 24576,
                                   s_target: int = 512, refine_levels: int | None = None,
                                   ablate: str = "", row_start: int = 0, nrows: int | None = None,
                                   epg: int = 1, d_block: int | None = None,
                                   sub_width: int | None = None):
    """Gather-free grouped BVH force (float32). m, x are the Hilbert-sorted
    bodies and tree their refit; an L* node covers min(s_target, tile)
    bodies, and the residual's nodes S2 = S / 2^R after refine_levels R
    (see the module docstring). Returns (G * accel in sorted order, info) with info's counters
    as device tensors, nbody_tpu's keys: max_nodes, max_leaves,
    fallback_tiles, node_overflow, leaf_overflow, entries, res_pairs,
    bad_entries, res_width_sum, res_unique_blocks and
    res_pass_0..res_pass_nsub. ablate: comma-separated tokens of
    BVH_ABLATE (see the module docstring). epg, d_block (None: 4096 in 3-D,
    2048 in 2-D; 0 node-sized blocks) and sub_width are nbody_tpu's, but
    sub_width None or 0 is the whole [lo, hi) here.

    Row-range mode (nrows given; bvh_group.py:548-556, the replicated
    multi-device layout): only the rows [row_start, row_start + nrows) of
    the sorted bodies are evaluated, against the whole tree and body arrays,
    and the result has nrows rows. The lists, windows and fallback are built
    for those tiles alone; the windows and the entries still address the
    whole tile-padded arrays (the pad is not widened to d_block, which
    halves instead until it divides it). nrows and row_start are multiples
    of the tile, and the range lies inside the tile-padded bodies."""
    tokens = ablate_tokens(ablate, BVH_ABLATE, BVH_NUMBERED)
    epg = token_epg(tokens, epg)
    sub_width = numbered_token(ablate, "subw", sub_width, last=True)
    d_block = numbered_token(ablate, "dblk", d_block, last=True)
    n, dim = x.shape
    dev, dtype = x.device, x.dtype
    if dtype != torch.float32:
        raise ValueError(f"the windowed BVH path is float32 only, got {dtype}")
    nlevels = tree.nlevels
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)  # no host copy
    i64 = dict(dtype=torch.int64, device=dev)

    # ---- tiles, the d_block-widened pad, L*, S and Sd (:544-629) -------
    if d_block is None:
        d_block = 4096 if dim == 3 else 2048
    d_block = max(d_block, 0)  # 0: node-sized blocks, the pad not widened
    ntiles_g = -(-n // tile)
    npad_g = ntiles_g * tile
    # a residual block wider than the pad needs npad % Sd == 0; a row range keeps the pad
    if nrows is None and d_block and npad_g % d_block:
        lcm = tile * d_block // math.gcd(tile, d_block)
        npad_g = -(-n // lcm) * lcm
        ntiles_g = npad_g // tile
    xp_g = torch.nn.functional.pad(x, (0, 0, 0, npad_g - n))
    mp_g = torch.nn.functional.pad(m, (0, npad_g - n))
    out_rows = n if nrows is None else nrows
    row_start, nrows = row_range(row_start, nrows, tile, npad_g)
    ntiles = nrows // tile
    xp = xp_g[row_start:row_start + nrows]
    xt = xp.view(ntiles, tile, dim)
    valid = (row_start + torch.arange(nrows, device=dev) < n).view(ntiles, tile)
    xt_real = torch.where(valid[:, :, None], xt, xt[:, :1, :])  # padding tiles sit at the origin
    tmin, tmax = xt_real.amin(1), xt_real.amax(1)

    s_first = min(s_target, tile)
    level_star = max(0, nlevels - (s_first.bit_length() - 1))
    S = 1 << (nlevels - level_star)
    while S > tile and level_star < nlevels:
        level_star += 1
        S = 1 << (nlevels - level_star)
    Sd = max(S, min(128, npad_g))
    while d_block > S and (d_block % S or npad_g % d_block):
        d_block //= 2
    if d_block > S:
        Sd = d_block
    if refine_levels is None:  # refinement measured counterproductive (bvh_group.py:607-616)
        refine_levels = 0
    refine_levels = min(refine_levels, nlevels - 1 - level_star)
    if (1 << (level_star + refine_levels)) + 1 > (1 << 16):  # entries pack a 16-bit node id
        raise ValueError("windowed BVH path supports at most 2^16 residual nodes; lower "
                         "refine_levels/s_target")
    if ntiles > (1 << 15):  # the tile id packs into 16 bits of an int32 entry
        raise ValueError("windowed BVH path supports at most 2^15 tiles; increase tile")

    mm, mx, bw = tree.mm, tree.mx, tree.bw
    w2 = bw * bw

    # ---- dense per-level accept masks (:632-656) -----------------------
    accept_masks = []
    open_mask = torch.ones(ntiles, 1, dtype=torch.bool, device=dev)
    for level in range(level_star + 1):
        lo_i, hi_i = (1 << level) - 1, (1 << (level + 1)) - 1
        accept = open_mask & (w2[lo_i:hi_i][None, :] < theta2 * _box_dist2(tmin, tmax,
                                                                            mx[lo_i:hi_i]))
        accept_masks.append(accept)
        open_ = open_mask & ~accept
        open_mask = open_.repeat_interleave(2, dim=1) if level < level_star else open_
    nodes_total = 1 << level_star
    lvl_lo = nodes_total - 1
    open_mask = open_mask & (mm[lvl_lo:lvl_lo + nodes_total] > 0)[None, :]  # dead nodes

    # ---- near field: a window of wt tiles around each tile (:658-703) --
    wt = min(window_tiles, ntiles_g)
    npt = tile // S
    wnodes = wt * npt
    t_idx = torch.arange(ntiles, **i64)
    wjf = 4 if wt % 4 == 0 else (2 if wt % 2 == 0 else 1)
    if "wj1" in tokens:
        wjf = 1
    elif "wj2" in tokens:
        wjf = min(wjf, 2)
    w0 = (row_start // tile + t_idx - wt // 2).clamp(0, ntiles_g - wt)  # global tiles
    w0 = (w0 // wjf) * wjf
    w0n = w0 * npt
    col = w0n[:, None] + torch.arange(wnodes, **i64)[None, :]
    in_win = torch.gather(open_mask, 1, col.clamp_max(nodes_total - 1))  # (T, wnodes)
    w0_i32 = w0.to(torch.int32)
    if "win" in tokens:  # the wrong-force probes: that part is zeros
        near = torch.zeros_like(xp)
    elif "densemask" in tokens or wjf * npt > 64:  # the dense branch: in_win broadcast S-fold
        body_mask = in_win.to(dtype)[:, :, None].expand(ntiles, wnodes, S).reshape(ntiles, wt * tile)
        near = window_eval_dense_cuda(xp, mp_g, xp_g, w0_i32, body_mask, eps, wt, "poly")
    else:
        near = window_eval_nodemask_cuda(xp, mp_g, xp_g, w0_i32, in_win, eps, wt, S, "poly",
                                         skip_outside="nowinskip" not in tokens)

    # ---- residual: open nodes outside the window (:705-777) -----------
    all_nodes = torch.arange(nodes_total, **i64)[None, :]
    out_open = open_mask & ((all_nodes < w0n[:, None]) | (all_nodes >= w0n[:, None] + wnodes))
    # refinement: re-test the children of the open nodes, live ones only;
    # the passing ones join the far field (:722-732)
    for level in range(level_star + 1, level_star + refine_levels + 1):
        out_open = out_open.repeat_interleave(2, dim=1)
        lo_i, hi_i = (1 << level) - 1, (1 << (level + 1)) - 1
        alive = (mm[lo_i:hi_i] > 0)[None, :]
        accept = out_open & alive & (w2[lo_i:hi_i][None, :] < theta2 * _box_dist2(
            tmin, tmax, mx[lo_i:hi_i]))
        accept_masks.append(accept)
        out_open = out_open & alive & ~accept
    nodes_res = 1 << (level_star + refine_levels)  # the residual's granularity
    S2 = 1 << (nlevels - level_star - refine_levels)
    # sub-tile monopole re-test: a residual node whose MAC passes against
    # every sub-tile box is a monopole for the whole tile
    nsub = max(1, min(8, tile // 8))
    sub = xt_real.view(ntiles, nsub, tile // nsub, dim)
    sb_lo, sb_hi = sub.amin(2), sub.amax(2)
    com_res, w2_res = mx[nodes_res - 1:2 * nodes_res - 1], w2[nodes_res - 1:2 * nodes_res - 1]
    min_dmin2 = None
    passcnt = torch.zeros(ntiles, nodes_res, **i64)
    for s in range(nsub):
        d2s = _box_dist2(sb_lo[:, s], sb_hi[:, s], com_res)
        min_dmin2 = d2s if min_dmin2 is None else torch.minimum(min_dmin2, d2s)
        passcnt += w2_res[None, :] < theta2 * d2s
    res_pass = [(out_open & (passcnt == k)).sum() for k in range(nsub + 1)]
    res_pairs = out_open.sum()
    mono = out_open & (w2_res[None, :] < theta2 * min_dmin2)
    del min_dmin2, d2s, passcnt
    accept_masks[-1] = accept_masks[-1] | mono
    out_open = out_open & ~mono

    # ---- far field over heap levels 0..L*+R (:779-800) -----------------
    W = (1 << (level_star + refine_levels + 1)) - 1
    far_bool = torch.cat(accept_masks, dim=1)
    if "far" in tokens:
        far = torch.zeros_like(xp)
    elif "densemask" in tokens:
        far = masked_eval_cuda(xp, mm[:W], mx[:W], far_bool.to(dtype), eps, "poly")
    else:
        far = masked_eval_bits_cuda(xp, mm[:W], mx[:W], pack_mask_bits(far_bool), eps, "poly",
                                    tile_group=2 if "ftg2" in tokens else 1)

    # ---- residual entry lists (:802-920) -------------------------------
    out_count = out_open.sum(1)
    r_slice = min(nodes_res, 1024)
    sorted_ids, word_over = residual_ids(out_open, r_slice, wide="widextract" in tokens)
    out_count = torch.where(word_over, r_slice + 1, out_count)
    if "forceover0" in tokens:
        out_count[0] = r_slice + 1
    slot = torch.arange(r_slice, **i64)[None, :]
    vmask = slot < out_count.clamp_max(r_slice)[:, None]
    pad_node = nodes_res
    row0 = torch.arange(nodes_res, **i64) * S2  # the node's first sorted row
    blk_tbl = torch.cat([row0 // Sd, torch.zeros(1, **i64)])
    lo_arr = row0 % Sd  # S2 <= Sd: a node never straddles a block
    lohi_tbl = torch.cat([lo_arr | ((lo_arr + S2) << 16), torch.zeros(1, **i64)]).to(torch.int32)
    nid_rows = torch.cat([torch.full((ntiles, 1), pad_node, **i64),  # the per-tile sentinel
                          torch.where(vmask, sorted_ids.clamp_max(pad_node), pad_node)], dim=1)
    vflag = torch.cat([torch.ones(ntiles, 1, dtype=torch.bool, device=dev), vmask], dim=1)
    flat_v = vflag.reshape(-1)
    flat_ent = ((t_idx[:, None] << 16) | nid_rows).reshape(-1)
    rank = torch.cumsum(flat_v, 0) - 1
    per_tile_est = min(r_slice, (96 if dim == 2 else 400) << refine_levels)
    e_cap = _entry_cap(ntiles, per_tile_est, r_slice, e_chunk, epg)
    pad_entry_gbe = ((ntiles - 1) << 16) | pad_node
    dst = torch.where(flat_v & (rank < e_cap), rank, e_cap)  # e_cap: dropped
    entries_gbe = torch.full((e_cap + 1,), pad_entry_gbe, **i64).scatter_(0, dst, flat_ent)[:e_cap]
    end_rank = torch.cumsum(1 + out_count.clamp_max(r_slice), 0)
    tile_over = (out_count > r_slice) | (end_rank > e_cap)

    # resolve node ids into self-describing entries and merge touching ones
    gidx = entries_gbe & 0xFFFF
    entries = ((entries_gbe & ~0xFFFF) | blk_tbl[gidx]).to(torch.int32)
    entries, lohis, n_merged, tend = merge_contiguous_entries(
        entries, lohi_tbl[gidx], end_rank[-1], (ntiles - 1) << 16, ntiles, epg)
    if tend is not None:
        tile_over = tile_over | (tend > e_cap)
    if "resid" in tokens:
        resid = torch.zeros_like(xp)
    elif "rlist" in tokens:  # the list built, its evaluation not
        resid = torch.zeros_like(xp) + wrap_int32(entries.long().sum()).to(dtype)
    else:
        resid = entries_lohi_eval_cuda(xp, mp_g, xp_g, entries, lohis, n_merged, Sd, ntiles, eps,
                                       "poly", packed="packedj" in tokens, sub_width=sub_width)
    acc = (far + near) + resid

    # ---- exact fallback for overflowed tiles (:338-401) ---------------
    n_over_t = tile_over.sum()
    n_over = int(n_over_t)  # the one host read (while_loop in nbody_tpu)
    if n_over:
        over = torch.argsort((~tile_over).to(torch.int8), stable=True)[:n_over]
        fb = allpairs_block_cuda(xt[over].reshape(-1, dim), m, x, eps, "poly")
        acc.view(ntiles, tile, dim)[over] = fb.view(-1, tile, dim)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    info = {
        # nbody_tpu's windowed path hands zero list counts to its finisher
        "max_nodes": zero, "max_leaves": zero,
        "fallback_tiles": n_over_t,
        "node_overflow": zero, "leaf_overflow": zero,  # the fallback truncates nothing
        "entries": n_merged,
        "res_pairs": res_pairs,
        "bad_entries": ((entries >> 16) >= ntiles).sum(),
        "res_width_sum": ((lohis >> 16) - (lohis & 0xFFFF)).sum(),
        "res_unique_blocks": unique_blocks(entries, n_merged),
        **{f"res_pass_{k}": v for k, v in enumerate(res_pass)},
    }
    return G * acc[:out_rows], info


# --------------------------------------------------------------------------
# the list path


def default_caps(n: int, theta: float) -> tuple[int, int]:
    """The list caps of nbody_tpu (bvh_group.py:58-68): every leaf pair at
    theta = 0, else 640 / theta^2, at least 1,024 and at most
    bit_ceil(n) / 2 + 8."""
    nleafs = 1 << max(0, (max(n, 2) - 1).bit_length())
    full = nleafs // 2 + 8
    cap = full if theta <= 1e-6 else int(min(full, max(1024, 640.0 / (theta * theta))))
    return cap, cap


def compute_force_grouped(tree: BVHTree, m: torch.Tensor, x: torch.Tensor, theta: float,
                          G: float, eps: float, tile: int = 512, cap_nodes: int | None = None,
                          cap_leaves: int | None = None, use_cuda: bool = True,
                          row_start: int = 0, nrows: int | None = None):
    """The BVH's list path (bvh_group.py:76-335): per tile of
    `tile` Hilbert-sorted bodies, an interaction list from a
    level-synchronous walk of the heap with the group MAC
    bw^2 < theta^2 * dmin(tile box, COM)^2, then one evaluation of every
    tile against its own list with the poly softening, and the exact sum
    for the tiles that overflow a cap (_finish_grouped).

    Levels with 2^l <= 2F (F = max(caps)) keep a dense open mask over the
    whole level; deeper levels a compacted frontier of left children.
    Nodes still open at the deepest stored level give their body pairs
    (s0, s0 + 1), the pair's second body masked where it is past n. A tile
    overflows when its frontier, node list or leaf list outgrows its cap.
    Every rule is nbody_tpu's, so the counters of `info` match it; the
    widest arrays at 2^20 bodies are (T, 8,191), so the walk takes all
    tiles at once. The evaluation takes group_eval_cuda over the live
    heads of the node segment and the 2 * lcnt leaf bodies (empty for the
    tiles that overflow, which the fallback overwrites: live_heads), or its
    plain twin where not use_cuda (--kernel torch); the fallback
    allpairs_block_cuda(..., "poly") or its twin. One host read per call.
    Returns (G * accel in sorted order, info). With nrows (bvh_group.py:
    123-131) only the rows [row_start, row_start + nrows) are evaluated,
    against the whole tree and bodies, and the result has nrows rows
    (row_range's rules)."""
    n, dim = x.shape
    dev, dtype = x.device, x.dtype
    if cap_nodes is None or cap_leaves is None:
        cn, cl = default_caps(n, theta)
        cap_nodes, cap_leaves = cap_nodes or cn, cap_leaves or cl
    nlevels = tree.nlevels
    nnodes = (1 << nlevels) - 1
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)
    xt, tmin, tmax = tile_boxes(x, tile, row_start, nrows)
    ntiles = xt.shape[0]
    mm, mx, w2 = tree.mm, tree.mx, tree.bw * tree.bw
    width = max(cap_nodes, cap_leaves)  # nbody_tpu's F
    n_dense = sum(1 for level in range(nlevels) if (1 << level) <= 2 * width)

    def mac_accept(nodes, vmask):
        """The group MAC of heap nodes, shared (W,) or per tile (T, W)."""
        return vmask & (w2[nodes] < theta2 * _box_dist2(tmin, tmax, mx[nodes]))

    # dense levels: an open mask over each whole level
    over_front = torch.zeros(ntiles, dtype=torch.bool, device=dev)
    over_nodes = torch.zeros_like(over_front)
    acc_idx, acc_valid = [], []
    open_mask = torch.ones(ntiles, 1, dtype=torch.bool, device=dev)
    leaf_idx = leaf_valid = frontier = fvalid = None
    for level in range(n_dense):
        lo_i = (1 << level) - 1
        idxs = torch.arange(lo_i, 2 * lo_i + 1, device=dev)
        accept = mac_accept(idxs, open_mask)
        open_ = open_mask & ~accept
        acc_idx.append(idxs.expand(ntiles, -1))
        acc_valid.append(accept)
        if level == nlevels - 1:
            leaf_idx, leaf_valid = (2 * (idxs - lo_i)).expand(ntiles, -1), open_
        elif level == n_dense - 1:  # to the sparse levels: the open nodes' left children
            frontier, fvalid, counts = compact_rows((2 * idxs + 1).expand(ntiles, -1), open_, width)
            over_front |= counts > width
        else:
            open_mask = open_.repeat_interleave(2, dim=1)
    nodes, nvalid, ncount = compact_rows(torch.cat(acc_idx, 1), torch.cat(acc_valid, 1), cap_nodes)
    over_nodes |= ncount > cap_nodes
    del acc_idx, acc_valid

    # sparse levels: both children of each frontier node
    for level in range(n_dense, nlevels):
        kids = torch.stack([frontier, frontier + 1], dim=-1).reshape(ntiles, -1)
        kvalid = fvalid.repeat_interleave(2, dim=1)
        tc = kids.clamp(0, nnodes - 1)
        accept = mac_accept(tc, kvalid)
        open_ = kvalid & ~accept
        nodes, nvalid, ncount = compact_rows(torch.cat([torch.where(nvalid, nodes, 0), tc], 1),
                                             torch.cat([nvalid, accept], 1), cap_nodes)
        over_nodes |= ncount > cap_nodes
        if level == nlevels - 1:
            leaf_idx, leaf_valid = 2 * (tc - ((1 << level) - 1)), open_
        else:
            frontier, fvalid, counts = compact_rows(2 * tc + 1, open_, width)
            over_front |= counts > width

    ncnt = ncount.clamp_max(cap_nodes)
    leaves, lvalid, lcount = compact_rows(leaf_idx, leaf_valid, cap_leaves)
    causes = torch.stack([over_front, over_nodes, lcount > cap_leaves], dim=1)
    lcnt = lcount.clamp_max(cap_leaves)

    # the lists (bvh_group.py:270-283): node monopoles, then the opened
    # pairs' bodies; mass 0 pads
    nidx = torch.where(nvalid, nodes, 0)
    mj_n = torch.where(nvalid, mm[nidx], 0)
    s0 = torch.where(lvalid, leaves, 0)
    bidx = torch.stack([s0, s0 + 1], dim=-1).reshape(ntiles, -1)
    bvalid = lvalid.repeat_interleave(2, dim=1) & (bidx < n)
    bc = bidx.clamp(0, n - 1)
    mj_list = torch.cat([mj_n, torch.where(bvalid, m[bc], 0)], dim=1)
    xj_list = torch.cat([mx[nidx], x[bc]], dim=1)
    del nidx, mj_n, s0, bidx, bvalid, bc
    evaluate = group_eval_cuda if use_cuda else group_eval_torch
    tile_over = causes.any(1)
    acc = evaluate(xt.reshape(-1, dim), mj_list, xj_list, eps, "poly", cap_nodes,
                   *live_heads(ncnt, 2 * lcnt, tile_over))
    del mj_list, xj_list
    return _finish_grouped(acc, xt, causes, tile_over, ncnt, lcnt, m, x, G, eps, use_cuda,
                           n if nrows is None else nrows)


BVH_CAUSES = ("frontier", "nodes", "leaves")


def _finish_grouped(acc: torch.Tensor, xt: torch.Tensor, causes: torch.Tensor,
                    tile_over: torch.Tensor, ncnt: torch.Tensor, lcnt: torch.Tensor,
                    m: torch.Tensor, x: torch.Tensor, G: float, eps: float, use_cuda: bool,
                    out_rows: int):
    """The exact poly fallback over the tiles that overflowed (causes (T,
    3) bool: frontier, node cap, leaf cap; tile_over, any of them) and the
    info dict (bvh_group.py:338-415); the result's first out_rows rows."""
    n_over = tile_over.sum()
    exact_fallback(acc, xt, tile_over, int(n_over), m, x, eps, "poly", use_cuda)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    info = {"max_nodes": ncnt.max(), "max_leaves": lcnt.max(), "fallback_tiles": n_over,
            "node_overflow": zero, "leaf_overflow": zero,  # the fallback truncates nothing
            **overflow_causes(causes, BVH_CAUSES)}
    return G * acc[:out_rows], info
