"""Wrappers of the hand-written CUDA all-pairs kernels, and their plain twins.

The port of nbody_tpu.ops.pallas_allpairs. The kernels live in
nbody_torch/csrc/allpairs.cu (see its header for the design):

  allpairs_block_kernel     replaces allpairs_accel_pallas and
                            allpairs_block_pallas (pallas_allpairs.py:113,
                            :181; body _allpairs_kernel)
  potential_rowsums_kernel  replaces potential_rowsums_pallas (:255; body
                            _pe_kernel)

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with torch.empty, launches on the current stream, raises if the
launch returns a CUDA error, and adds one to `launch_counts` for the
kernel it launched. A wrapper runs the plain torch twin beside it
(allpairs_block_torch, allpairs_fast_torch, potential_rowsums_torch)
only when its tensors lie on the CPU; on a CUDA tensor it launches the
kernel or raises.

The Pallas knobs `exact` and `fast` of allpairs_accel_cuda select float32
instantiations of the same kernel, each counted under its own name:
  exact=True (the default)   IEEE division, float32 and float64; the CLI's
                             paths and the trees' fallbacks take it;
  exact=False                allpairs_block_kernel<float32, newton>: the
                             approximate reciprocal plus one Newton step;
  fast=True, exact=False     allpairs_block_kernel<float32, fast>: per
                             (i-tile, j-tile) pair, rsqrt^3 without the
                             softening where the tile's least d2 exceeds
                             (eps / fast_tol)^(2/3), else the Newton chain.
The defaults differ from allpairs_accel_pallas's exact=False on purpose:
the port's paths keep IEEE division, within 1 ulp of the Newton form.
Neither variant takes float64 (the Pallas kernel was float32-only), and
fast requires exact=False: nbody_tpu only ever calls it so. The block
wrapper allpairs_block_cuda, which the trees' fallbacks call, takes
neither: no caller of allpairs_block_pallas in nbody_tpu passes them.
The twin of the Newton form is allpairs_block_torch, in IEEE division:
the hardware's approximate reciprocal cannot be reproduced on the CPU.
"""

from __future__ import annotations

import torch

from nbody_torch.ops.allpairs import (SOFTENINGS, accel_rows_raw, cat_rows, pair_terms,
                                      pairs_per_chunk, row_chunks, sum_terms)

NEWTON = "allpairs_block_kernel<float32, newton>"
FAST = "allpairs_block_kernel<float32, fast>"
# Kernel launches since the last reset, by kernel name. Only a launch of
# the CUDA kernel counts; a CPU call of a wrapper runs the twin and does not.
launch_counts = {"allpairs_block_kernel": 0, NEWTON: 0, FAST: 0, "potential_rowsums_kernel": 0}

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# --------------------------------------------------------------------------
# plain torch twins


def allpairs_block_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: float,
                         softening: str = "poly") -> torch.Tensor:
    """Raw (G-less) accelerations of the rows xi (ni, dim) against the
    bodies (mj (nj,), xj (nj, dim)): the plain twin of allpairs_block_kernel."""
    return accel_rows_raw(xi, mj, xj, eps, softening)


def allpairs_block_abs_torch(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: float,
                             softening: str = "poly") -> torch.Tensor:
    """sum_j |m_j * (x_j - x_i) / t| per row and component: the scale that
    bounds the rounding error of any order of summation of the block, and
    the one the kernel's tolerance is stated against."""
    parts = []
    for a, b in row_chunks(xi.shape[0], xj.shape[0], xi.device):
        w, d = pair_terms(xi[a:b], mj, xj, eps, softening)
        parts.append(sum_terms(w.abs(), d.abs()))
    return cat_rows(parts, xi)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """t with zero rows appended up to n rows: JAX's padding (bodies at the
    origin with mass 0)."""
    return torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))]) if n > t.shape[0] else t


def fast_tiling(n: int, dim: int, tile_i: int, tile_j: int) -> tuple[int, int]:
    """(padded count, tile_j) of the fast variant, as allpairs_accel_pallas
    tiles: tile_j clamped to 1024 in 3-D, and rows and bodies both padded
    to round_up(max(n, ti, tj), max(ti, tj)) (pallas_allpairs.py:138-144)."""
    if dim >= 3:
        tile_j = min(tile_j, 1024)
    return round_up(max(n, tile_i, tile_j), max(tile_i, tile_j)), tile_j


def far_threshold(eps: float, fast_tol: float = 1e-6) -> float:
    """d2 above which dropping the softening changes each weight by less
    than fast_tol relative: (eps / fast_tol)^(2/3) (pallas_allpairs.py:151)."""
    return float((eps / fast_tol) ** (2.0 / 3.0))


def tiles_per_chunk(tile_i: int, tile_j: int, device: torch.device) -> int:
    """j-tiles a twin evaluates at once: one row chunk's pair budget."""
    return max(1, pairs_per_chunk(device) // (tile_i * tile_j))


def allpairs_fast_torch(m: torch.Tensor, x: torch.Tensor, G: float, eps: float,
                        fast_tol: float = 1e-6, tile_i: int = 512, tile_j: int = 2048,
                        rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of allpairs_block_kernel<float32, fast>: the square
    evaluation over JAX's tiles and padding (fast_tiling), deciding per
    (i-tile, j-tile) pair as the kernel and allpairs_accel_pallas(fast=True)
    decide: m rsqrt(d2)^3 where the tile's least float32 d2 exceeds
    far_threshold(eps, fast_tol), else the softened weight (IEEE division).
    Sums reduce in float64. Returns G * a (n, dim) and the int64 counts
    (i-tiles, 2) of each i-tile's [softened, far] j-tiles; with `rows`, only
    the i-tiles that hold the first `rows` rows run, and a has those rows
    (a sample of a large evaluation)."""
    n, dim = x.shape
    npad, tile_j = fast_tiling(n, dim, tile_i, tile_j)
    far_thresh = far_threshold(eps, fast_tol)
    xp, mp = pad_rows(x, npad), pad_rows(m, npad)
    ntj = npad // tile_j
    xjt, mjt = xp.view(ntj, tile_j, dim), mp.view(ntj, tile_j)
    step = tiles_per_chunk(tile_i, tile_j, x.device)
    counts, sums = [], []
    for i0 in range(0, npad if rows is None else min(rows, n), tile_i):
        xt = xp[i0:i0 + tile_i]
        acc = xt.new_zeros(xt.shape, dtype=torch.float64)
        n_far = 0
        for j0 in range(0, ntj, step):
            d = xjt[j0:j0 + step, None, :, :] - xt[None, :, None, :]   # (J, ti, tj, dim)
            d2 = torch.sum(d * d, dim=-1)
            far = d2.amin(dim=(1, 2)) > far_thresh
            n_far += int(far.sum())
            mt = mjt[j0:j0 + step, None, :]
            r = torch.rsqrt(d2)
            w = torch.where(far[:, None, None], (mt * r) * (r * r),
                            mt / (d2 * torch.sqrt(d2) + eps))
            for c in range(dim):
                acc[:, c] += torch.sum(w.double() * d[..., c].double(), dim=(0, 2))
        sums.append(acc)
        counts.append([ntj - n_far, n_far])
    a = torch.cat(sums)[:n if rows is None else min(rows, n)]
    return G * a.to(x.dtype), torch.tensor(counts, dtype=torch.int64)


def potential_rowsums_torch(m: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """pe_i = m_i * sum_{j != i} m_j / (sqrt(d2) + eps), the diagonal masked
    by global index: the plain twin of potential_rowsums_kernel."""
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)
    parts = []
    for a, b in row_chunks(n, n, x.device):
        d = x[None, :, :] - x[a:b, None, :]
        w = m[None, :] / (torch.sqrt(torch.sum(d * d, dim=-1)) + eps)
        rows = torch.arange(a, b, device=x.device)
        parts.append(torch.sum(w.masked_fill(rows[:, None] == cols[None, :], 0), dim=1))
    return m * cat_rows(parts, m)


# --------------------------------------------------------------------------
# kernel wrappers


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors, False for CUDA ones; raises on a mix or on
    any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors are on different devices: {sorted(map(str, devices))}")
    kind = next(iter(devices)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind!r}: expected cpu or cuda")
    return kind == "cpu"


def _check_bodies(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor) -> None:
    if xi.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or float64, got {xi.dtype}")
    if mj.dtype != xi.dtype or xj.dtype != xi.dtype:
        raise TypeError(f"dtypes differ: {xi.dtype}, {mj.dtype}, {xj.dtype}")
    if xi.ndim != 2 or xi.shape[1] not in (2, 3):
        raise ValueError(f"positions must be (n, 2) or (n, 3), got {tuple(xi.shape)}")
    if xj.ndim != 2 or xj.shape[1] != xi.shape[1]:
        raise ValueError(f"body positions {tuple(xj.shape)} do not match rows {tuple(xi.shape)}")
    if mj.shape != (xj.shape[0],):
        raise ValueError(f"masses {tuple(mj.shape)} do not match bodies {tuple(xj.shape)}")
    if not (xi.is_contiguous() and mj.is_contiguous() and xj.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")


def _raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        from nbody_torch._build import load_library

        msg = load_library().nbody_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def _launch_block(xi, mj, xj, eps: float, softening: str, scale: float) -> torch.Tensor:
    from nbody_torch._build import load_library

    if softening not in SOFTENINGS:
        raise ValueError(f"softening must be one of {SOFTENINGS}, got {softening!r}")
    out = torch.empty_like(xi)
    if xi.shape[0] == 0:
        return out
    err = load_library().nbody_allpairs_block(
        xi.device.index, _DTYPE_CODES[xi.dtype], xi.shape[1], int(softening == "sqrt3"),
        xi.data_ptr(), xi.shape[0], mj.data_ptr(), xj.data_ptr(), xj.shape[0],
        float(eps), float(scale), out.data_ptr(),
        torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error("allpairs_block_kernel", err)
    launch_counts["allpairs_block_kernel"] += 1
    return out


def allpairs_block_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: float,
                        softening: str = "poly") -> torch.Tensor:
    """Raw (G-less) accelerations of the rows xi against the body block
    (mj, xj) -- the counterpart of allpairs_block_pallas."""
    _check_bodies(xi, mj, xj)
    if _on_cpu(xi, mj, xj):
        return allpairs_block_torch(xi, mj, xj, eps, softening)
    return _launch_block(xi, mj, xj, eps, softening, 1.0)


def _check_variant(dtype: torch.dtype, exact: bool, fast: bool, return_counts: bool) -> None:
    if return_counts and not fast:
        raise ValueError("return_counts counts the fast variant's branches: pass fast=True")
    if exact and not fast:
        return
    if fast and exact:
        raise ValueError("fast=True runs the Newton chain on its near tiles, as nbody_tpu "
                         "calls it: pass exact=False")
    if dtype != torch.float32:
        raise TypeError(f"exact=False and fast=True are float32 only, got {dtype}")


def tile_counts(npad: int, tile_i: int, branches: int, like: torch.Tensor) -> torch.Tensor:
    """The zeroed int32 (i-tiles, branches) tensor in which a kernel counts
    each i-tile's j-tiles by branch."""
    return torch.zeros((npad // tile_i, branches), dtype=torch.int32, device=like.device)


def allpairs_accel_cuda(m: torch.Tensor, x: torch.Tensor, G: float, eps: float,
                        exact: bool = True, fast: bool = False, fast_tol: float = 1e-6,
                        tile_i: int = 512, tile_j: int = 2048,
                        return_counts: bool = False):
    """All-pairs accelerations G * block(x, m, x) -- the counterpart of
    allpairs_accel_pallas. The kernel applies G after the sum, as the
    Pallas wrapper does (pallas_allpairs.py:173). exact=True (the
    default, unlike the Pallas function's) keeps IEEE division; the tiles
    and fast_tol matter to fast=True only. With return_counts (fast=True
    only) returns (a, counts), counts the int (i-tiles, 2) tensor of each
    i-tile's [softened, far] j-tiles, as allpairs_fast_torch returns them."""
    _check_bodies(x, m, x)
    _check_variant(x.dtype, exact, fast, return_counts)
    if _on_cpu(m, x):
        if not fast:
            return G * allpairs_block_torch(x, m, x, eps)
        a, counts = allpairs_fast_torch(m, x, G, eps, fast_tol, tile_i, tile_j)
        return (a, counts) if return_counts else a
    if exact:
        return _launch_block(x, m, x, eps, "poly", G)
    from nbody_torch._build import load_library

    n, dim = x.shape
    npad, tile_j = fast_tiling(n, dim, tile_i, tile_j)
    if fast and (tile_i % 64 or not 64 <= tile_i <= 512 or tile_j * (dim + 1) > 12288):
        raise ValueError(f"fast takes tile_i a multiple of 64 in [64, 512] and a j-tile of at "
                         f"most 48 KB, got tile_i={tile_i}, tile_j={tile_j}")
    out = torch.empty_like(x)
    counts = tile_counts(npad, tile_i, 2, x) if return_counts else None
    if n == 0:
        return (out, counts) if return_counts else out
    err = load_library().nbody_allpairs_variant(
        x.device.index, dim, int(fast), x.data_ptr(), m.data_ptr(), n, npad, tile_i, tile_j,
        float(eps), far_threshold(eps, fast_tol), float(G), out.data_ptr(),
        None if counts is None else counts.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    name = FAST if fast else NEWTON
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return (out, counts) if return_counts else out


def potential_rowsums_cuda(m: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-body pe_i = m_i * sum_{j != i} m_j / dist(i, j); the total PE is
    -0.5 * G * sum(pe). The counterpart of potential_rowsums_pallas."""
    _check_bodies(x, m, x)
    if _on_cpu(m, x):
        return potential_rowsums_torch(m, x, eps)
    from nbody_torch._build import load_library

    out = torch.empty_like(m)
    if m.shape[0] == 0:
        return out
    err = load_library().nbody_potential_rowsums(
        x.device.index, _DTYPE_CODES[x.dtype], x.shape[1], m.data_ptr(), x.data_ptr(),
        x.shape[0], float(eps), out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error("potential_rowsums_kernel", err)
    launch_counts["potential_rowsums_kernel"] += 1
    return out
