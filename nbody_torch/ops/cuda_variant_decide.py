"""The branch of every (i-tile, j-tile) pair of the all-pairs variants, decided
before their force kernels run: the wrappers of tile_stats_kernel and
tile_decide_kernel (nbody_torch/csrc/tile_decide.cu), and their plain
versions.

nbody_tpu decides inside each variant's body (no kernel of its own):
  fast      allpairs_accel_pallas(fast=True) (pallas_allpairs.py:96-105):
            far (1) iff the tile pair's least d2 > far_thresh, else
            softened (0); d2 = (dx0^2 + dx1^2) + dx2^2, dx = xj - xi;
  mxu       allpairs_accel_mxu (pallas_allpairs_mxu.py:106-133): in the
            frame c = 0.5 (mean_i + mean_j) of the two padded tiles' means,
            y = x - c, z = (y0^2 + y1^2) + y2^2, d2 = ((zi + zj) + yi0
            (-2 yj0)) + ...; near (0) iff min d2 <= near_coef (max zi + max
            zj), else far (1);
  mxu-fast  (fast=True, :186-199) far-fast (2) where not near and min d2 >
            far_thresh.
The table is (ni, nj) int8 over JAX's padding (bodies past n at the origin
count in every minimum, as they do in JAX). Every operation is rounded
apart, in the order written above, and the means are pairwise tree sums
(tile_stats_torch), so the kernel and decide_torch give the same table bit
for bit; the kernel settles most tile pairs from the tiles' boxes and runs
the exact pass only on the rest (its header derives the margins).

The wrappers check their tensors, allocate with torch.empty, launch on the
current stream, raise on a launch error and count each launch in
`launch_counts`; on CPU tensors they run the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.ops.cuda_allpairs import _raise_on_error, _stream, pad_rows

MODES = ("fast", "mxu", "mxu-fast")
_MODE_CODES = {mode: k for k, mode in enumerate(MODES)}
STATS = "tile_stats_kernel"
DECIDE = {mode: f"tile_decide_kernel<{mode}>" for mode in MODES}
# Kernel launches since the last reset, by kernel; plain-version calls do not count.
launch_counts = {STATS: 0, **{name: 0 for name in DECIDE.values()}}

MAX_TILE = 4096      # the largest tile (csrc/tile_decide.cu kMaxTile)
SUB = 16             # bodies a sub-tile (kSub): tiles are multiples of it


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _inv(tile: int) -> float:
    """1 / tile rounded to float32, the factor of a tile's mean."""
    return float(np.float32(1.0 / tile))


def tree_mean(t: torch.Tensor) -> torch.Tensor:
    """(tiles, T, dim) -> (tiles, dim): the pairwise tree sum of each tile
    padded with zeros to a power of two (v[k] + v[k + h], h = P/2, ..., 1),
    times 1 / T in float32: the order tile_stats_kernel sums in."""
    T = t.shape[1]
    P = 1 << (T - 1).bit_length()
    v = torch.cat([t, t.new_zeros((t.shape[0], P - T, t.shape[2]))], dim=1)
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0] * torch.tensor(_inv(T), dtype=t.dtype, device=t.device)


def tile_stats_torch(x: torch.Tensor, npad: int, tile_i: int, tile_j: int,
                     means: bool = True) -> torch.Tensor:
    """The plain version of tile_stats_kernel: (ni + nj + npad / SUB, 3,
    dim) float32, each tile's [lo, hi, mean] (mean 0 without `means`), the
    i-tiles of tile_i bodies first, then the j-tiles, then the SUB-body
    sub-tiles [lo, hi, 0] that the exact pass tests first; padding bodies
    at the origin."""
    xp = pad_rows(x, npad)
    dim = x.shape[1]
    out = []
    for tile, mean in ((tile_i, means), (tile_j, means), (SUB, False)):
        t = xp.view(npad // tile, tile, dim)
        mu = tree_mean(t) if mean else torch.zeros_like(t[:, 0])
        out.append(torch.stack([t.amin(1), t.amax(1), mu], dim=1))
    return torch.cat(out)


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """(v0^2 + v1^2) + v2^2 over the last axis, in that order."""
    s = v[..., 0] * v[..., 0]
    for d in range(1, v.shape[-1]):
        s = s + v[..., d] * v[..., d]
    return s


def decide_torch(x: torch.Tensor, mode: str, npad: int, tile_i: int, tile_j: int,
                 near_coef: float = 0.0, thresh: float = 0.0,
                 itiles=None) -> torch.Tensor:
    """The plain version of tile_decide_kernel: the exact branch of each
    tile pair from the least d2 over all its pairs (module docstring), as
    an int8 (len(itiles), nj) table of the i-tiles `itiles` (all by
    default). near_coef and thresh are rounded to float32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dim = x.shape[1]
    xp = pad_rows(x, npad)
    ni, nj = npad // tile_i, npad // tile_j
    itiles = list(range(ni)) if itiles is None else [int(i) for i in itiles]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    nc, th = f32(near_coef), f32(thresh)
    xi_t, xj_t = xp.view(ni, tile_i, dim), xp.view(nj, tile_j, dim)
    if mode != "fast":
        stats = tile_stats_torch(x, npad, tile_i, tile_j)
        mi, mj = stats[:ni, 2], stats[ni:ni + nj, 2]
    step = max(1, (1 << 25) // (tile_i * tile_j))  # j-tiles a chunk
    table = torch.empty((len(itiles), nj), dtype=torch.int8, device=x.device)
    for row, I in enumerate(itiles):
        xi = xi_t[I]
        for J0 in range(0, nj, step):
            xj = xj_t[J0:J0 + step]                                   # (J, tj, dim)
            if mode == "fast":
                d2 = _norm2(xj[:, None, :, :] - xi[None, :, None, :])
                table[row, J0:J0 + step] = (d2.amin(dim=(1, 2)) > th).to(torch.int8)
                continue
            c = 0.5 * (mi[I][None, :] + mj[J0:J0 + step])              # (J, dim)
            yi = xi[None, :, :] - c[:, None, :]
            yj = xj - c[:, None, :]
            zi, zj = _norm2(yi), _norm2(yj)
            d2 = zi[:, :, None] + zj[:, None, :]
            for d in range(dim):
                d2 = d2 + yi[:, :, None, d] * (-2.0 * yj[:, None, :, d])
            dmin = d2.amin(dim=(1, 2))
            near = dmin <= nc * (zi.amax(dim=1) + zj.amax(dim=1))
            branch = torch.ones_like(dmin, dtype=torch.int8)
            if mode == "mxu-fast":
                branch[dmin > th] = 2
            branch[near] = 0
            table[row, J0:J0 + step] = branch
    return table


MARGIN = 2.0 ** -15  # M = MARGIN * (L + Zb_i + Zb_j), the MXU modes' box margin


def box_table_torch(stats: torch.Tensor, ni: int, nj: int, mode: str, near_coef: float = 0.0,
                    thresh: float = 0.0) -> torch.Tensor:
    """The branches that tile_decide_kernel's box tests settle, operation
    for operation: (ni, nj) int8, the branch where the boxes settle it, -1
    where the tile pair takes the exact pass, -2 where it does so knowing
    it is not near (mxu-fast). stats: tile_stats_torch's (or the kernel's).
    Where it is >= 0 it must equal decide_torch's table: the tests hold it
    there, and its -1 and -2 entries count the exact pass's tile pairs."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=stats.device)  # noqa: E731
    lo_i, hi_i, mean_i = stats[:ni, 0, None], stats[:ni, 1, None], stats[:ni, 2, None]
    tj = stats[None, ni:ni + nj]
    lo_j, hi_j, mean_j = tj[..., 0, :], tj[..., 1, :], tj[..., 2, :]
    zero = f32(0.0)
    g = torch.maximum(zero, torch.maximum(lo_j - hi_i, lo_i - hi_j))   # (ni, nj, dim)
    L = _norm2(g)
    if mode == "fast":
        return torch.where(L > f32(thresh), 1, -1).to(torch.int8)
    c = 0.5 * (mean_i + mean_j)
    zb = (_norm2(torch.maximum(hi_i - c, c - lo_i))
          + _norm2(torch.maximum(hi_j - c, c - lo_j)))
    lm = L - f32(MARGIN) * (L + zb)
    not_near = lm > f32(near_coef) * zb
    if mode == "mxu":
        return torch.where(not_near, 1, -1).to(torch.int8)
    return torch.where(not_near, torch.where(lm > f32(thresh), 2, -2), -1).to(torch.int8)


def _check(x: torch.Tensor, npad: int, tile_i: int, tile_j: int) -> None:
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] not in (2, 3):
        raise ValueError(f"positions must be (n, 2) or (n, 3) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernels take contiguous tensors")
    if (tile_i <= 0 or tile_j <= 0 or tile_i % SUB or tile_j % SUB or tile_i > MAX_TILE
            or tile_j > MAX_TILE or npad < x.shape[0] or npad % tile_i or npad % tile_j):
        raise ValueError(f"tiles ({tile_i}, {tile_j}) over {npad} bodies: multiples of {SUB} "
                         f"up to {MAX_TILE}, dividing npad")


def tile_stats_cuda(x: torch.Tensor, npad: int, tile_i: int, tile_j: int,
                    means: bool = True) -> torch.Tensor:
    """Each tile's [lo, hi, mean] and each sub-tile's [lo, hi, 0] by
    tile_stats_kernel: tile_stats_torch's (ni + nj + npad / SUB, 3, dim)."""
    _check(x, npad, tile_i, tile_j)
    if x.device.type == "cpu":
        return tile_stats_torch(x, npad, tile_i, tile_j, means)
    from nbody_torch._build import load_library

    n, dim = x.shape
    stats = torch.empty((npad // tile_i + npad // tile_j + npad // SUB, 3, dim),
                        dtype=torch.float32, device=x.device)
    err = load_library().nbody_tile_stats(x.device.index, dim, x.data_ptr(), n, npad, tile_i,
                                          tile_j, _inv(tile_i), _inv(tile_j), int(means),
                                          stats.data_ptr(), _stream(x))
    _raise_on_error(STATS, err)
    launch_counts[STATS] += 1
    return stats


def table_cuda(x: torch.Tensor, stats: torch.Tensor, mode: str, npad: int, tile_i: int,
               tile_j: int, near_coef: float = 0.0, thresh: float = 0.0, work: bool = False):
    """The (ni, nj) int8 branches by tile_decide_kernel from tile_stats_cuda's
    statistics (with means in the MXU modes); with `work`, (table, the int64
    (ni, 2) tile pairs that took the exact pass and the pairs it evaluated,
    by i-tile). On CPU tensors decide_torch's table, and work None."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check(x, npad, tile_i, tile_j)
    n, dim = x.shape
    ni, nj = npad // tile_i, npad // tile_j
    if (stats.shape != (ni + nj + npad // SUB, 3, dim) or stats.dtype != torch.float32
            or not stats.is_contiguous()):
        raise ValueError(f"stats {tuple(stats.shape)} are not the statistics of these tiles")
    if x.device.type == "cpu":
        table = decide_torch(x, mode, npad, tile_i, tile_j, near_coef, thresh)
        return (table, None) if work else table
    from nbody_torch._build import load_library

    table = torch.empty((ni, nj), dtype=torch.int8, device=x.device)
    counts = torch.empty((ni, 2), dtype=torch.int64, device=x.device) if work else None
    err = load_library().nbody_tile_decide(
        x.device.index, dim, _MODE_CODES[mode], x.data_ptr(), n, npad, tile_i, tile_j,
        stats.data_ptr(), float(near_coef), float(thresh), table.data_ptr(),
        None if counts is None else counts.data_ptr(), _stream(x))
    _raise_on_error(DECIDE[mode], err)
    launch_counts[DECIDE[mode]] += 1
    return (table, counts) if work else table


def decide_cuda(x: torch.Tensor, mode: str, npad: int, tile_i: int, tile_j: int,
                near_coef: float = 0.0, thresh: float = 0.0, work: bool = False):
    """(table, stats[, work]): tile_stats_cuda's statistics (with means in
    the MXU modes), then table_cuda's branches decided from them (and its
    work). On CPU tensors the plain versions, and work None."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    stats = tile_stats_cuda(x, npad, tile_i, tile_j, means=mode != "fast")
    out = table_cuda(x, stats, mode, npad, tile_i, tile_j, near_coef, thresh, work)
    return (out[0], stats, out[1]) if work else (out, stats)


def branch_counts(table: torch.Tensor, branches: int) -> torch.Tensor:
    """The int32 (ni, branches) count of each i-tile's j-tiles by branch."""
    return torch.stack([(table == b).sum(1) for b in range(branches)], dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# layouts whose tile pairs straddle a threshold by a few ulps


def _bits(v: float) -> int:
    return int(np.array(v, dtype=np.float32).view(np.int32))


def _from_bits(b: int) -> float:
    return float(np.array(b, dtype=np.int32).view(np.float32))


STRADDLES = {
    # mode: (what straddles, the layout of the parameter v; bisection range)
    "fast": ("corner", "far_thresh: tile B at (v, 0...), tile A at the origin"),
    "fast-notch": ("notch", "far_thresh: B half at (v, 1/16), half at (v + 1/16, 0); its box's "
                            "corner nearest A is empty, so the boxes leave it open"),
    "mxu": ("near", "near_coef Z: A 63 bodies at the origin and one at (v, 0...), B at (8, 0...)"),
    "mxu-fast": ("far-fast", "far_thresh: A 63 at the origin and one at (v, 0...), B at "
                             "(1/2, 0...)"),
}


def straddle_layout(kind: str, dim: int, v: float, tile: int = 64) -> torch.Tensor:
    """x (2 tile, dim) float32 of one STRADDLES layout at parameter v: tile
    A (bodies [0, tile)) and tile B. Every coordinate but the first is 0,
    and every tile mean is one rounding (p / tile, or a power of two), so any
    order of summation gives the same frame."""
    x = np.zeros((2 * tile, dim), np.float32)
    if kind == "fast":
        x[tile:, 0] = v
    elif kind == "fast-notch":
        h = 1.0 / 16
        x[tile:tile + tile // 2, 0], x[tile:tile + tile // 2, 1] = v, h
        x[tile + tile // 2:, 0] = np.float32(v) + np.float32(h)
    elif kind == "mxu":
        x[tile - 1, 0], x[tile:, 0] = v, 8.0
    else:
        x[tile - 1, 0], x[tile:, 0] = v, 0.5
    return torch.tensor(x)


def straddle_layouts(kind: str, dim: int, near_coef: float, thresh: float, steps: int = 4,
                     tile: int = 64) -> list[tuple[float, torch.Tensor]]:
    """[(v, x)] of 2 * steps + 1 layouts: v the float32 values from `steps`
    ulps below to `steps` above the one where the exact branch of the tile
    pair (A, B) changes (found by bisection over v's bits); both branches
    occur among them. thresh is far_thresh (the MXU modes' and the fast
    variant's)."""
    mode = {"fast": "fast", "fast-notch": "fast", "mxu": "mxu", "mxu-fast": "mxu-fast"}[kind]
    lo, hi = {"fast": (0.25, 0.75), "fast-notch": (0.25, 0.75), "mxu": (7.0, 7.9),
              "mxu-fast": (0.3, 0.45)}[kind]

    def branch(b: int) -> int:
        x = straddle_layout(kind, dim, _from_bits(b), tile)
        return int(decide_torch(x, mode, 2 * tile, tile, tile, near_coef, thresh)[0, 1])

    b_lo, b_hi = _bits(lo), _bits(hi)
    first = branch(b_lo)
    if branch(b_hi) == first:
        raise ValueError(f"{kind}: the branch does not change over [{lo}, {hi}]")
    while b_hi - b_lo > 1:
        mid = (b_lo + b_hi) // 2
        if branch(mid) == first:
            b_lo = mid
        else:
            b_hi = mid
    return [(_from_bits(b), straddle_layout(kind, dim, _from_bits(b), tile))
            for b in range(b_hi - steps, b_hi + steps + 1)]
