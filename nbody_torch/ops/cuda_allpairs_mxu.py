"""The hybrid all-pairs kernel's wrapper, and its plain twin.

The port of nbody_tpu.ops.pallas_allpairs_mxu. The kernel,
allpairs_mxu_kernel<DIM, FAST> in nbody_torch/csrc/allpairs_mxu.cu,
replaces allpairs_accel_mxu (pallas_allpairs_mxu.py:207) and computes its
function, float32 only; see its header for the design and for why the far
branch splits both operands of its tensor-core contraction ("bf16x3").

Per (i-tile, j-tile) pair over JAX's padding: the midpoint frame of the
two tiles' means, d2 by the quadratic form in that frame, and one of three
branches:
  near      min d2 <= near_factor * eps * (max zi + max zj): the exact
            per-dimension chain on the raw coordinates;
  far       w = 1 / (d2^1.5 + eps) and S = W @ [m yj, m], finalized as
            a += S[:, :dim] - yi * S[:, dim];
  far-fast  (fast=True, min d2 > far_thresh) w = rsqrt(d2)^3, W and
            [m yj, m] in bf16.
Body order does not change the result beyond rounding, but on unsorted
bodies every tile pair is near: sort them (ops.hilbert.hilbert_sort_perm)
so that far tile pairs exist.

On the card the branches are decided first, for every tile pair at once
(ops.cuda_variant_decide: tile_stats_kernel, then tile_decide_kernel in
mode mxu or mxu-fast), and the kernel reads each tile pair's branch from
that table and its frame from the tiles' means there.

The wrapper checks device, dtype, shape and contiguity, allocates its
output with torch.empty, launches on the current stream, raises on a
launch error and counts its launches per instantiation in
`launch_counts`; on CPU tensors it runs the twin.
"""

from __future__ import annotations

import torch

from nbody_torch.ops.cuda_allpairs import (_check_bodies, _on_cpu, _raise_on_error, pad_rows,
                                           round_up, tile_counts, tiles_per_chunk)

PLAIN = "allpairs_mxu_kernel<float32>"
FAST = "allpairs_mxu_kernel<float32, fast>"
BRANCHES = ("near", "far", "far_fast")
# Kernel launches since the last reset, by instantiation; twin calls do not count.
launch_counts = {PLAIN: 0, FAST: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mxu_padding(n: int, tile_i: int, tile_j: int) -> int:
    """JAX's padded body count (pallas_allpairs_mxu.py:229)."""
    return round_up(max(n, tile_i, tile_j), max(tile_i, tile_j))


def split_f32(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """_split_f32 (pallas_allpairs_mxu.py:76-83): w = hi + lo, hi the
    bf16 rounding of w (to nearest even), both returned as float32."""
    hi = w.to(torch.bfloat16).to(torch.float32)
    return hi, w - hi


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float64)


def _contract(w: torch.Tensor, b: torch.Tensor, fast: bool) -> torch.Tensor:
    """S = W @ B over each tile pair's bodies, as the kernel's MMAs form it:
    bf16(W) bf16(B) under fast, else Wh Bh + Wh Bl + Wl Bh with both
    operands split (each half rounded to bf16). The bf16 products are
    exact in float64, and so is their sum to a float64 ulp."""
    if fast:
        return torch.einsum("jik,jkc->jic", _bf16(w), _bf16(b))
    wh, wl = split_f32(w)
    bh, bl = split_f32(b)
    wh, wl, bh, bl = _bf16(wh), _bf16(wl), _bf16(bh), _bf16(bl)
    return (torch.einsum("jik,jkc->jic", wh, bh) + torch.einsum("jik,jkc->jic", wh, bl)
            + torch.einsum("jik,jkc->jic", wl, bh))


def allpairs_accel_mxu_torch(m: torch.Tensor, x: torch.Tensor, G: float, eps: float,
                             tile_i: int = 512, tile_j: int = 1024, near_factor: float = 1e5,
                             fast: bool = False, far_thresh: float = 0.0,
                             rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of allpairs_mxu_kernel: the same padding, tile loop,
    frame, near test and split, in float32 up to the contraction, with
    IEEE division where the kernel takes the Newton reciprocal and sums
    in float64. Returns G * a (n, dim) float32 and the int64 counts
    (i-tiles, 3) of each i-tile's j-tiles by branch, in BRANCHES order;
    with `rows`, only the i-tiles that hold the first `rows` rows run, and
    a has those rows (a sample of a large evaluation)."""
    n, dim = x.shape
    if x.dtype != torch.float32:
        raise ValueError("the MXU kernel is float32 only")
    npad = mxu_padding(n, tile_i, tile_j)
    xp, mp = pad_rows(x, npad), pad_rows(m, npad)
    ntj = npad // tile_j
    xjt, mjt = xp.view(ntj, tile_j, dim), mp.view(ntj, tile_j)
    cj_all = xjt.mean(dim=1)                                  # (ntj, dim)
    near_coef = torch.tensor(near_factor * eps, dtype=torch.float32, device=x.device)
    step = tiles_per_chunk(tile_i, tile_j, x.device)
    counts, sums = [], []
    for i0 in range(0, npad if rows is None else min(rows, n), tile_i):
        xi = xp[i0:i0 + tile_i]
        ci = xi.mean(dim=0)
        acc = xi.new_zeros(xi.shape, dtype=torch.float64)
        tiles = torch.zeros(3, dtype=torch.int64)
        for j0 in range(0, ntj, step):
            xj, mj = xjt[j0:j0 + step], mjt[j0:j0 + step]
            c = 0.5 * (ci[None, :] + cj_all[j0:j0 + step])     # (J, dim)
            yi = xi[None, :, :] - c[:, None, :]                 # (J, ti, dim)
            yj = xj - c[:, None, :]                             # (J, tj, dim)
            zi, zj = torch.sum(yi * yi, dim=-1), torch.sum(yj * yj, dim=-1)
            d2 = zi[:, :, None] + zj[:, None, :]
            for d in range(dim):
                d2 = d2 + yi[:, :, None, d] * (-2.0 * yj[:, None, :, d])
            dmin = d2.amin(dim=(1, 2))
            near = dmin <= near_coef * (zi.amax(dim=1) + zj.amax(dim=1))
            far_fast = ~near & (dmin > far_thresh) if fast else torch.zeros_like(near)
            far = ~near & ~far_fast
            tiles += torch.stack([near.sum(), far.sum(), far_fast.sum()]).cpu()
            if near.any():  # the exact chain on the raw coordinates
                xn, mn = xj[near], mj[near]
                dx = xn[:, None, :, :] - xi[None, :, None, :]   # (J, ti, tj, dim)
                d2e = torch.sum(dx * dx, dim=-1)
                w = torch.where(d2e > 0, mn[:, None, :] / (d2e * torch.sqrt(d2e) + eps), 0.0)
                for d in range(dim):
                    acc[:, d] += torch.sum(w.double() * dx[..., d].double(), dim=(0, 2))
            for sel, is_fast in ((far, False), (far_fast, True)):
                if not sel.any():
                    continue
                d2s = d2[sel]
                if is_fast:
                    r = torch.rsqrt(d2s)
                    w = r * r * r
                else:
                    d2c = d2s.clamp_min(0.0)
                    w = torch.where(d2c > 0, 1.0 / (d2c * torch.sqrt(d2c) + eps), 0.0)
                b = torch.cat([yj[sel] * mj[sel][:, :, None], mj[sel][:, :, None]], dim=-1)
                S = _contract(w, b, is_fast)                    # (J, ti, dim + 1)
                acc += torch.sum(S[..., :dim] - yi[sel].double() * S[..., dim:], dim=0)
        sums.append(acc)
        counts.append(tiles)
    a = torch.cat(sums)[:n if rows is None else min(rows, n)]
    return G * a.to(torch.float32), torch.stack(counts)


def allpairs_accel_mxu_cuda(m: torch.Tensor, x: torch.Tensor, G: float, eps: float,
                            tile_i: int = 512, tile_j: int = 1024, near_factor: float = 1e5,
                            fast: bool = False, far_thresh: float = 0.0,
                            return_counts: bool = False):
    """All-pairs accelerations by the hybrid kernel -- the counterpart of
    allpairs_accel_mxu, with its defaults (:207-219). float32 only.
    tile_i is a multiple of 64 up to 1024, tile_j a multiple of 16 up to
    4096 (cuda_variant_decide.MAX_TILE). With
    return_counts returns (a, counts), counts the int (i-tiles, 3) tensor
    of each i-tile's j-tiles by branch, as allpairs_accel_mxu_torch
    returns them."""
    _check_bodies(x, m, x)
    if x.dtype != torch.float32:
        raise ValueError("the MXU kernel is float32 only; use allpairs_accel_cuda for float64")
    if tile_i % 64 or not 64 <= tile_i <= 1024 or tile_j % 16 or not 0 < tile_j <= 4096:
        raise ValueError(f"tile_i must be a multiple of 64 in [64, 1024] and tile_j a multiple "
                         f"of 16 up to 4096, got {tile_i}, {tile_j}")
    if _on_cpu(m, x):
        a, counts = allpairs_accel_mxu_torch(m, x, G, eps, tile_i, tile_j, near_factor, fast,
                                             far_thresh)
        return (a, counts) if return_counts else a
    from nbody_torch._build import load_library
    from nbody_torch.ops import cuda_variant_decide as vd

    n, dim = x.shape
    npad = mxu_padding(n, tile_i, tile_j)
    out = torch.empty_like(x)
    if n == 0:
        return (out, tile_counts(npad, tile_i, 3, x)) if return_counts else out
    near_coef = float(torch.tensor(near_factor * eps, dtype=torch.float32))
    table, stats = vd.decide_cuda(x, "mxu-fast" if fast else "mxu", npad, tile_i, tile_j,
                                  near_coef, far_thresh)
    err = load_library().nbody_allpairs_mxu(
        x.device.index, dim, int(fast), x.data_ptr(), m.data_ptr(), n, npad, tile_i, tile_j,
        table.data_ptr(), stats.data_ptr(), float(eps), float(G), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    name = FAST if fast else PLAIN
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return (out, vd.branch_counts(table, 3)) if return_counts else out
