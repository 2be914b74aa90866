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
it. The TPU's E_CHUNK chunking and sub_width are not carried over: the
entries kernel takes the whole list and visits [lo, hi) exactly. The
word-compacted residual extraction becomes one row sort, with the same
word limit RW and the same overflow flag (residual_ids). JAX's
while_loop over overflowed tiles reads one counter on the host: one
synchronisation per call. refine_levels is 0 (nbody_tpu's default) and
not a parameter here.
"""

from __future__ import annotations

import math

import torch

from nbody_torch.ops.bvh import BVHTree
from nbody_torch.ops.cuda_allpairs import allpairs_block_cuda
from nbody_torch.ops.cuda_group_eval import (entries_lohi_eval_cuda, group_eval_cuda,
                                             group_eval_torch, masked_eval_bits_cuda,
                                             pack_mask_bits, window_eval_dense_cuda,
                                             window_eval_nodemask_cuda)
from nbody_torch.ops.octree_group import (_box_dist2, compact_rows, exact_fallback,
                                          merge_contiguous_entries, overflow_causes, tile_boxes)

BIG = 1 << 30  # sort sentinel of the residual node ids
S_TARGET = 512  # bodies per L* node (nbody_tpu's s_target default)


def residual_ids(out_open: torch.Tensor, r_slice: int):
    """Per tile, the ascending ids of its open residual nodes, padded with
    BIG to r_slice columns, and a per-tile flag that forces the tile into
    the exact fallback: nbody_tpu's word-compacted extraction
    (bvh_group.py:810-842) keeps only the nodes of a tile's first RW
    nonzero 32-node words (RW = min(words, max(256, r_slice // 4))) and
    flags the tiles with more such words. Below 32 nodes, or at a node
    count that is not a multiple of 32, every node is kept (its wide
    branch). Returns (ids (T, r_slice) int64, word_overflow (T,) bool)."""
    ntiles, nodes = out_open.shape
    key = torch.where(out_open, torch.arange(nodes, device=out_open.device), BIG)
    word_over = torch.zeros(ntiles, dtype=torch.bool, device=out_open.device)
    if nodes % 32 == 0 and nodes >= 32:
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
                                   window_tiles: int = 32, e_chunk: int = 24576):
    """Gather-free grouped BVH force (float32). m, x are the Hilbert-sorted
    bodies and tree their refit. Returns (G * accel in sorted order, info)
    with info's counters as device tensors, nbody_tpu's keys: max_nodes,
    max_leaves, fallback_tiles, node_overflow, leaf_overflow, entries,
    res_pairs, bad_entries, res_width_sum, res_unique_blocks and
    res_pass_0..res_pass_nsub."""
    n, dim = x.shape
    dev, dtype = x.device, x.dtype
    if dtype != torch.float32:
        raise ValueError(f"the windowed BVH path is float32 only, got {dtype}")
    nlevels = tree.nlevels
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)  # no host copy
    i64 = dict(dtype=torch.int64, device=dev)

    # ---- tiles, the d_block-widened pad, L*, S and Sd (:544-629) -------
    d_block = 4096 if dim == 3 else 2048
    ntiles = -(-n // tile)
    npad = ntiles * tile
    if npad % d_block:  # a residual block wider than the pad needs npad % Sd == 0
        lcm = tile * d_block // math.gcd(tile, d_block)
        npad = -(-n // lcm) * lcm
        ntiles = npad // tile
    xp = torch.nn.functional.pad(x, (0, 0, 0, npad - n))
    mp = torch.nn.functional.pad(m, (0, npad - n))
    xt = xp.view(ntiles, tile, dim)
    valid = (torch.arange(npad, device=dev) < n).view(ntiles, tile)
    xt_real = torch.where(valid[:, :, None], xt, xt[:, :1, :])  # padding tiles sit at the origin
    tmin, tmax = xt_real.amin(1), xt_real.amax(1)

    s_first = min(S_TARGET, tile)
    level_star = max(0, nlevels - (s_first.bit_length() - 1))
    S = 1 << (nlevels - level_star)
    while S > tile and level_star < nlevels:
        level_star += 1
        S = 1 << (nlevels - level_star)
    Sd = max(S, min(128, npad))
    while d_block > S and (d_block % S or npad % d_block):
        d_block //= 2
    if d_block > S:
        Sd = d_block
    if (1 << level_star) + 1 > (1 << 16):  # the entries pack a 16-bit node id
        raise ValueError("windowed BVH path supports at most 2^16 residual nodes (2^25 bodies)")
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
    wt = min(window_tiles, ntiles)
    npt = tile // S
    wnodes = wt * npt
    t_idx = torch.arange(ntiles, **i64)
    wjf = 4 if wt % 4 == 0 else (2 if wt % 2 == 0 else 1)
    w0 = (t_idx - wt // 2).clamp(0, ntiles - wt)
    w0 = (w0 // wjf) * wjf
    w0n = w0 * npt
    col = w0n[:, None] + torch.arange(wnodes, **i64)[None, :]
    in_win = torch.gather(open_mask, 1, col.clamp_max(nodes_total - 1))  # (T, wnodes)
    w0_i32 = w0.to(torch.int32)
    if wjf * npt > 64:  # nbody_tpu's dense branch: the S-fold broadcast of in_win
        body_mask = in_win.to(dtype)[:, :, None].expand(ntiles, wnodes, S).reshape(ntiles, wt * tile)
        near = window_eval_dense_cuda(xp, mp, xp, w0_i32, body_mask, eps, wt, "poly")
    else:
        near = window_eval_nodemask_cuda(xp, mp, xp, w0_i32, in_win, eps, wt, S, "poly")

    # ---- residual: open nodes outside the window (:705-777) -----------
    all_nodes = torch.arange(nodes_total, **i64)[None, :]
    out_open = open_mask & ((all_nodes < w0n[:, None]) | (all_nodes >= w0n[:, None] + wnodes))
    # sub-tile monopole re-test: a residual node whose MAC passes against
    # every sub-tile box is a monopole for the whole tile
    nsub = max(1, min(8, tile // 8))
    sub = xt_real.view(ntiles, nsub, tile // nsub, dim)
    sb_lo, sb_hi = sub.amin(2), sub.amax(2)
    com_res, w2_res = mx[lvl_lo:lvl_lo + nodes_total], w2[lvl_lo:lvl_lo + nodes_total]
    min_dmin2 = None
    passcnt = torch.zeros(ntiles, nodes_total, **i64)
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

    # ---- far field over heap levels 0..L* (:779-800) -------------------
    W = (1 << (level_star + 1)) - 1
    far = masked_eval_bits_cuda(xp, mm[:W], mx[:W], pack_mask_bits(torch.cat(accept_masks, dim=1)),
                                eps, "poly")

    # ---- residual entry lists (:802-920) -------------------------------
    out_count = out_open.sum(1)
    r_slice = min(nodes_total, 1024)
    sorted_ids, word_over = residual_ids(out_open, r_slice)
    out_count = torch.where(word_over, r_slice + 1, out_count)
    slot = torch.arange(r_slice, **i64)[None, :]
    vmask = slot < out_count.clamp_max(r_slice)[:, None]
    pad_node = nodes_total
    row0 = torch.arange(nodes_total, **i64) * S  # the node's first sorted row
    blk_tbl = torch.cat([row0 // Sd, torch.zeros(1, **i64)])
    lo_arr = row0 % Sd  # S <= Sd: a node never straddles a block
    lohi_tbl = torch.cat([lo_arr | ((lo_arr + S) << 16), torch.zeros(1, **i64)]).to(torch.int32)
    nid_rows = torch.cat([torch.full((ntiles, 1), pad_node, **i64),  # the per-tile sentinel
                          torch.where(vmask, sorted_ids.clamp_max(pad_node), pad_node)], dim=1)
    vflag = torch.cat([torch.ones(ntiles, 1, dtype=torch.bool, device=dev), vmask], dim=1)
    flat_v = vflag.reshape(-1)
    flat_ent = ((t_idx[:, None] << 16) | nid_rows).reshape(-1)
    rank = torch.cumsum(flat_v, 0) - 1
    per_tile_est = min(r_slice, 96 if dim == 2 else 400)
    n_chunks = max(1, min(40, -(-(ntiles * per_tile_est + ntiles) // e_chunk)))
    e_cap = min(ntiles * (r_slice + 1), n_chunks * e_chunk)
    if e_cap > e_chunk:
        e_cap = -(-e_cap // e_chunk) * e_chunk
    pad_entry_gbe = ((ntiles - 1) << 16) | pad_node
    dst = torch.where(flat_v & (rank < e_cap), rank, e_cap)  # e_cap: dropped
    entries_gbe = torch.full((e_cap + 1,), pad_entry_gbe, **i64).scatter_(0, dst, flat_ent)[:e_cap]
    end_rank = torch.cumsum(1 + out_count.clamp_max(r_slice), 0)
    tile_over = (out_count > r_slice) | (end_rank > e_cap)

    # resolve node ids into self-describing entries and merge touching ones
    gidx = entries_gbe & 0xFFFF
    entries = ((entries_gbe & ~0xFFFF) | blk_tbl[gidx]).to(torch.int32)
    entries, lohis, n_merged = merge_contiguous_entries(entries, lohi_tbl[gidx], end_rank[-1],
                                                        (ntiles - 1) << 16)
    resid = entries_lohi_eval_cuda(xp, mp, xp, entries, lohis, n_merged, Sd, ntiles, eps, "poly")
    acc = (far + near) + resid

    # ---- exact fallback for overflowed tiles (:338-401) ---------------
    n_over_t = tile_over.sum()
    n_over = int(n_over_t)  # the one host read (while_loop in nbody_tpu)
    if n_over:
        over = torch.argsort((~tile_over).to(torch.int8), stable=True)[:n_over]
        fb = allpairs_block_cuda(xt[over].reshape(-1, dim), m, x, eps, "poly")
        acc.view(ntiles, tile, dim)[over] = fb.view(-1, tile, dim)

    # distinct S-blocks among the real entries, counted on the device
    never = 0x7FFFFFFF
    blk = torch.sort(torch.where(torch.arange(entries.shape[0], device=dev) < n_merged,
                                 entries & 0xFFFF, never)).values
    new_blk = (blk != torch.cat([blk.new_full((1,), -1), blk[:-1]])) & (blk != never)
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
        "res_unique_blocks": new_blk.sum(),
        **{f"res_pass_{k}": v for k, v in enumerate(res_pass)},
    }
    return G * acc[:n], info


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
                          cap_leaves: int | None = None, use_cuda: bool = True):
    """The BVH's list path (bvh_group.py:76-335, nrows=None): per tile of
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
    heads of the node segment and the 2 * lcnt leaf bodies, or its plain
    twin where not use_cuda (--kernel torch); the fallback
    allpairs_block_cuda(..., "poly") or its twin. One host read per call.
    Returns (G * accel in sorted order, info)."""
    n, dim = x.shape
    dev, dtype = x.device, x.dtype
    if cap_nodes is None or cap_leaves is None:
        cn, cl = default_caps(n, theta)
        cap_nodes, cap_leaves = cap_nodes or cn, cap_leaves or cl
    nlevels = tree.nlevels
    nnodes = (1 << nlevels) - 1
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)
    xt, tmin, tmax = tile_boxes(x, tile)
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
    acc = evaluate(xt.reshape(-1, dim), mj_list, xj_list, eps, "poly", cap_nodes,
                   ncnt.to(torch.int32), (2 * lcnt).to(torch.int32))
    del mj_list, xj_list
    return _finish_grouped(acc, xt, causes, ncnt, lcnt, m, x, G, eps, use_cuda)


BVH_CAUSES = ("frontier", "nodes", "leaves")


def _finish_grouped(acc: torch.Tensor, xt: torch.Tensor, causes: torch.Tensor,
                    ncnt: torch.Tensor, lcnt: torch.Tensor, m: torch.Tensor, x: torch.Tensor,
                    G: float, eps: float, use_cuda: bool):
    """The exact poly fallback over the tiles that overflowed (causes (T,
    3) bool: frontier, node cap, leaf cap) and the info dict
    (bvh_group.py:338-415)."""
    tile_over = causes.any(1)
    n_over = tile_over.sum()
    exact_fallback(acc, xt, tile_over, int(n_over), m, x, eps, "poly", use_cuda)
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    info = {"max_nodes": ncnt.max(), "max_leaves": lcnt.max(), "fallback_tiles": n_over,
            "node_overflow": zero, "leaf_overflow": zero,  # the fallback truncates nothing
            **overflow_causes(causes, BVH_CAUSES)}
    return G * acc[:x.shape[0]], info
