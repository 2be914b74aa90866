"""Wrappers of the hand-written CUDA tree-evaluation kernels, their plain
twins, and the far field's accept-mask packing.

The port of the nbody_tpu.ops.pallas_group_eval kernels on the octree and
BVH fast and list paths. The kernels live in nbody_torch/csrc/group_eval.cu
(see its header for the design):

  masked_eval_bits_kernel      replaces masked_eval_bits_pallas
                               (pallas_group_eval.py:310; body
                               _masked_bits_kernel :270): the far field
  window_eval_interval_kernel  replaces window_eval_interval_pallas (:502;
                               body _window_interval_kernel :455): the
                               octree's near window
  window_eval_nodemask_kernel  replaces window_eval_nodemask_pallas (:614;
                               body _window_nodemask_kernel :563): the
                               BVH's near window
  window_eval_dense_kernel     replaces window_eval_pallas (:383; body
                               _masked_eval_kernel :184): the BVH's near
                               window with a dense body mask
  entries_lohi_kernel          replaces entries_lohi_eval_pallas (:963; body
                               _entries_lohi_kernel :823): the near-field
                               exact entries
  group_eval_kernel            computes group_eval_pallas's function (:83;
                               body _group_eval_kernel): the list paths'
                               evaluation, each tile against its own list.
                               On the float64 path it stands where nbody_tpu
                               runs its jnp evaluation (octree_group.py:375-
                               416, bvh_group.py:295-331): nbody_tpu reaches
                               group_eval_pallas only through
                               compute_force_grouped(use_pallas=...)

All of them take the rows xi of T tiles of tb rows each, as an (T*tb, dim)
array, and return their raw (G-less) accelerations in the same layout.
`softening`, which every caller names, is "poly" (t = d2 * sqrt(d2) + eps,
which the BVH passes, as in nbody_tpu) or "sqrt3" (t = (sqrt(d2) + eps)^3,
octree.h:156-160, which the octree passes); the interval window is sqrt3
only.
Each wrapper checks its inputs, allocates the output with torch.empty,
launches on the current stream, raises on a CUDA error and adds one to
`launch_counts` for the kernel it launched. It runs the plain twin beside
it only when its tensors lie on the CPU; on a CUDA tensor it launches the
kernel or raises. The fast paths' kernels take float32 only, as the Pallas
kernels do; group_eval_kernel takes float32 and float64 (the list paths
are what float64 runs take; float32 reaches them through the list_path
branch of the step functions); the twins take either precision.

The accept mask is packed node l -> word l // 32, bit l % 32
(pack_mask_bits / unpack_mask_bits). nbody_tpu's strided order
(pallas_group_eval.py:148-181) served the TPU's lane layout and is not
carried over.
"""

from __future__ import annotations

import torch

from nbody_torch.ops.allpairs import SOFTENINGS, pairs_per_chunk
from nbody_torch.ops.cuda_allpairs import _DTYPE_CODES, _on_cpu, _raise_on_error

# Kernel launches since the last reset, by kernel name (the list kernel's
# by instantiation, group_eval_name); the twins never count.
launch_counts = {"masked_eval_bits_kernel": 0, "window_eval_interval_kernel": 0,
                 "window_eval_nodemask_kernel": 0, "window_eval_dense_kernel": 0,
                 "entries_lohi_kernel": 0,
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
                           absolute: bool = False) -> torch.Tensor:
    """Far field: row tile t against the shared nodes (mj (W,), xj (W, dim))
    whose accept bit is set in words[t] -- the plain twin of
    masked_eval_bits_kernel. absolute=True gives each row's sum of |term|,
    the scale the kernel's tolerance is stated against (so for the other
    twins)."""
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


def window_eval_interval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                               w0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, eps: float,
                               window_tiles: int, absolute: bool = False) -> torch.Tensor:
    """Near window: row tile t against the bodies j of the window
    [w0[t]*tb, (w0[t] + window_tiles)*tb) that lie in [lo[t], hi[t]) -- the
    plain twin of window_eval_interval_kernel."""
    ntiles, nj = w0.shape[0], mj.shape[0]
    tb = xi.shape[0] // ntiles
    col0 = w0.long() * tb
    a = torch.maximum(lo.long(), col0)
    b = torch.minimum(hi.long(), col0 + window_tiles * tb).clamp_max(nj)
    span = (b - a).clamp_min(0)
    xt = xi.view(ntiles, tb, -1)
    out = torch.zeros_like(xt)
    for ts, rs in _chunks(ntiles, tb, window_tiles * tb, xi.device):
        c = int(span[ts].max())
        if c == 0:
            continue
        cols = a[ts, None] + torch.arange(c, device=xi.device)
        keep = cols < b[ts, None]
        cols = cols.clamp_max(nj - 1)
        out[ts, rs] = _masked_block(xt[ts, rs], mj[cols], xj[cols], keep, eps, "sqrt3",
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
                               absolute: bool = False) -> torch.Tensor:
    """BVH near window: row tile t against the window bodies w0[t]*tb +
    [0, window_tiles*tb), slot v (S bodies) counting where in_win[t, v] --
    the plain twin of window_eval_nodemask_kernel."""
    return _window_twin(xi, mj, xj, w0, in_win.repeat_interleave(S, dim=1), eps, softening,
                        absolute)


def window_eval_dense_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                            w0: torch.Tensor, mask: torch.Tensor, eps: float, window_tiles: int,
                            softening: str, absolute: bool = False) -> torch.Tensor:
    """BVH near window with a dense weight mask (T, window_tiles*tb) on
    m_j -- the plain twin of window_eval_dense_kernel."""
    return _window_twin(xi, mj, xj, w0, mask, eps, softening, absolute)


def entries_lohi_eval_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                            entries: torch.Tensor, lohis: torch.Tensor, n_real, S: int,
                            ntiles: int, eps: float, softening: str,
                            absolute: bool = False) -> torch.Tensor:
    """Near-field entries: for each of the first n_real entries
    (tile << 16 | blk, lo | hi << 16), row tile `tile` against the bodies
    blk*S + [lo, hi) -- the plain twin of entries_lohi_kernel. Each entry
    is cut into pieces of at most 256 bodies; pieces are summed per entry,
    entries per tile."""
    tb, nj = xi.shape[0] // ntiles, mj.shape[0]
    dev = xi.device
    e = int(n_real)
    ent, lohi = entries[:e].long(), lohis[:e].long()
    tid, blk = ent >> 16, ent & 0xFFFF
    lo, hi = lohi & 0xFFFF, (lohi >> 16) & 0xFFFF
    piece = 256
    npieces = ((hi - lo).clamp_min(0) + piece - 1) // piece
    owner = torch.repeat_interleave(torch.arange(e, device=dev), npieces)
    first = torch.cumsum(npieces, 0) - npieces
    k = torch.arange(owner.shape[0], device=dev) - first[owner]
    start = blk[owner] * S + lo[owner] + k * piece                 # (pieces,)
    stop = blk[owner] * S + hi[owner]
    xt = xi.view(ntiles, tb, -1)
    per_entry = torch.zeros(e, tb, xi.shape[1], dtype=xi.dtype, device=dev)
    for ps, rs in _chunks(owner.shape[0], tb, piece, dev):
        cols = start[ps, None] + torch.arange(piece, device=dev)
        keep = (cols < stop[ps, None]) & (cols < nj)
        cols = cols.clamp_max(nj - 1)
        part = _masked_block(xt[tid[owner[ps]], rs], mj[cols], xj[cols], keep, eps, softening,
                             absolute)
        per_entry[:, rs].index_add_(0, owner[ps], part)
    return torch.zeros_like(xt).index_add_(0, tid, per_entry).view_as(xi)


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
                          words: torch.Tensor, eps: float, softening: str) -> torch.Tensor:
    """Far field of T row tiles against W shared nodes gated per (tile,
    node) by the packed accept bits words (T, ceil(W/32)) -- the
    counterpart of masked_eval_bits_pallas."""
    _check(xi, words.shape[0], mj, xj, words)
    if words.shape[1] != -(-mj.shape[0] // 32):
        raise ValueError(f"words {tuple(words.shape)} do not pack {mj.shape[0]} nodes")
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, words):
        return masked_eval_bits_torch(xi, mj, xj, words, eps, softening)
    return _launch("masked_eval_bits_kernel", "nbody_masked_eval_bits", xi, words.shape[0],
                   mj.data_ptr(), xj.data_ptr(), mj.shape[0], words.data_ptr(), words.shape[1],
                   sqrt3, float(eps))


def window_eval_interval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                              w0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, eps: float,
                              window_tiles: int) -> torch.Tensor:
    """Near window of each row tile t: the bodies of [w0[t]*tb,
    (w0[t] + window_tiles)*tb) inside [lo[t], hi[t]) -- the counterpart of
    window_eval_interval_pallas (with skip_outside: only the interval's
    columns are visited)."""
    _check(xi, w0.shape[0], mj, xj, w0, lo, hi)
    if _on_cpu(xi, mj, xj, w0, lo, hi):
        return window_eval_interval_torch(xi, mj, xj, w0, lo, hi, eps, window_tiles)
    return _launch("window_eval_interval_kernel", "nbody_window_eval_interval", xi, w0.shape[0],
                   mj.data_ptr(), xj.data_ptr(), mj.shape[0], w0.data_ptr(), lo.data_ptr(),
                   hi.data_ptr(), int(window_tiles), float(eps))


def _check_window(xi: torch.Tensor, w0: torch.Tensor, wb: int, window_tiles: int) -> None:
    tb = xi.shape[0] // w0.shape[0]
    if wb != window_tiles * tb:
        raise ValueError(f"a window of {window_tiles} tiles of {tb} rows is not {wb} bodies wide")


def window_eval_nodemask_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                              w0: torch.Tensor, in_win: torch.Tensor, eps: float,
                              window_tiles: int, S: int, softening: str) -> torch.Tensor:
    """BVH near window of each row tile t: the bodies w0[t]*tb +
    [0, window_tiles*tb) in slots of S, a slot counting where in_win[t, v]
    (bool, (T, window_tiles*tb // S)) -- the counterpart of
    window_eval_nodemask_pallas with skip_outside (closed slots are not
    visited)."""
    _check(xi, w0.shape[0], mj, xj, w0)
    if in_win.dtype != torch.bool or in_win.shape[0] != w0.shape[0] or not in_win.is_contiguous():
        raise ValueError(f"in_win must be a contiguous (T, slots) bool tensor, got "
                         f"{in_win.dtype} {tuple(in_win.shape)}")
    _check_window(xi, w0, in_win.shape[1] * S, window_tiles)
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, w0, in_win):
        return window_eval_nodemask_torch(xi, mj, xj, w0, in_win, eps, window_tiles, S, softening)
    return _launch("window_eval_nodemask_kernel", "nbody_window_eval_nodemask", xi, w0.shape[0],
                   mj.data_ptr(), xj.data_ptr(), mj.shape[0], w0.data_ptr(), in_win.data_ptr(),
                   in_win.shape[1], int(S), sqrt3, float(eps))


def window_eval_dense_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                           w0: torch.Tensor, mask: torch.Tensor, eps: float, window_tiles: int,
                           softening: str) -> torch.Tensor:
    """BVH near window with a dense float weight mask (T, window_tiles*tb)
    on the masses of the window bodies w0[t]*tb + [0, window_tiles*tb) --
    the counterpart of window_eval_pallas."""
    _check(xi, w0.shape[0], mj, xj, w0)
    if mask.dtype != xi.dtype or mask.shape[0] != w0.shape[0] or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous (T, window) {xi.dtype} tensor, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    _check_window(xi, w0, mask.shape[1], window_tiles)
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, w0, mask):
        return window_eval_dense_torch(xi, mj, xj, w0, mask, eps, window_tiles, softening)
    return _launch("window_eval_dense_kernel", "nbody_window_eval_dense", xi, w0.shape[0],
                   mj.data_ptr(), xj.data_ptr(), mj.shape[0], w0.data_ptr(), mask.data_ptr(),
                   mask.shape[1], sqrt3, float(eps))


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


def entries_lohi_eval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor,
                           entries: torch.Tensor, lohis: torch.Tensor, n_real: torch.Tensor,
                           S: int, ntiles: int, eps: float, softening: str) -> torch.Tensor:
    """Near-field entries: the first n_real entries of the tile-sorted list
    (tile << 16 | blk, lo | hi << 16), each adding the pairs of row tile
    `tile` with bodies blk*S + [lo, hi) -- the counterpart of
    entries_lohi_eval_pallas. A tile with no entries gets zeros."""
    _check(xi, ntiles, mj, xj, entries, lohis)
    if entries.shape != lohis.shape or entries.ndim != 1:
        raise ValueError(f"entries {tuple(entries.shape)} and lohis {tuple(lohis.shape)}")
    sqrt3 = _sqrt3(softening)
    if _on_cpu(xi, mj, xj, entries, lohis):
        return entries_lohi_eval_torch(xi, mj, xj, entries, lohis, n_real, S, ntiles, eps,
                                       softening)
    first, last = tile_segments(entries, n_real, ntiles)
    return _launch("entries_lohi_kernel", "nbody_entries_lohi_eval", xi, ntiles,
                   mj.data_ptr(), xj.data_ptr(), mj.shape[0], entries.data_ptr(),
                   lohis.data_ptr(), first.data_ptr(), last.data_ptr(), int(S), sqrt3, float(eps))


def group_eval_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: float,
                    softening: str, split: int, n0: torch.Tensor,
                    n1: torch.Tensor) -> torch.Tensor:
    """List path: row tile t of xi (T*tb, dim) against its own list mj (T,
    L), xj (T, L, dim), float32 or float64, over the live heads [0, n0[t])
    and [split, split + n1[t]) (int32 (T,)) of the list's node and leaf
    segments -- the counterpart of group_eval_pallas, with xj untransposed
    and L unpadded (entries past the heads are not read)."""
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
    from nbody_torch._build import load_library

    out = torch.empty_like(xi)
    if xi.shape[0] == 0:
        return out
    err = load_library().nbody_group_eval(
        xi.device.index, _DTYPE_CODES[xi.dtype], xi.shape[1], xi.data_ptr(), mj.shape[0],
        xi.shape[0] // mj.shape[0], mj.data_ptr(), xj.data_ptr(), mj.shape[1], int(split),
        n0.data_ptr(), n1.data_ptr(), sqrt3, float(eps), out.data_ptr(),
        torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error("group_eval_kernel", err)
    launch_counts[group_eval_name(xi.dtype, softening)] += 1
    return out
