"""Wrappers of the hand-written CUDA all-pairs kernels, and their plain twins.

The port of nbody_tpu.ops.pallas_allpairs. The kernels live in
nbody_torch/csrc/allpairs.cu (see its header for the design):

  allpairs_block_kernel     replaces allpairs_accel_pallas and
                            allpairs_block_pallas (pallas_allpairs.py:113,
                            :181; body _allpairs_kernel), fast=True too: a
                            weight policy that reads each tile pair's branch
                            from tile_decide_kernel's table
                            (ops.cuda_variant_decide)
  potential_rowsums_kernel  replaces potential_rowsums_pallas (:255; body
                            _pe_kernel)
  split_sum_kernel          adds the body splits of a launch plan in order
                            (the Pallas grid's sequential j axis)

Each wrapper checks device, dtype, shape and contiguity, allocates its
output (and a split plan's scratch) with torch.empty, launches on the
current stream, raises if a launch returns a CUDA error, and adds one to
`launch_counts` for each kernel it launched. A wrapper runs the plain
torch twin beside it (allpairs_block_torch, allpairs_fast_torch,
potential_rowsums_torch, split_sum_torch) only when its tensors lie on the
CPU; on a CUDA tensor it launches the kernel or raises.

The weight of a pair, by the wrappers' `exact` (each form counted under
its own name):
  exact=False (the default)  NEWTON in float32: rsqrt.approx for the root
                             and the approximate reciprocal plus one Newton
                             step (pallas_allpairs.py:79-84), what
                             allpairs_accel_pallas and allpairs_block_pallas
                             run by default and so what nbody_tpu's CLI
                             runs; NEWTON64 in float64: the MUFU seeds
                             refined to within an ulp or two of IEEE sqrt
                             and division. The CLI's all-pairs engine and
                             the trees' exact fallbacks take it;
  exact=True                 EXACT: IEEE sqrt and division, float32 and
                             float64 (kernel_bench's `exact`);
  fast=True, exact=False     FAST, float32: per (i-tile, j-tile) pair,
                             rsqrt^3 without the softening where the tile's
                             least d2 exceeds (eps / fast_tol)^(2/3), else
                             the Newton chain; the branches are decided
                             first (cuda_variant_decide.decide_cuda), then
                             the block kernel runs on block_plan's plan.
The Newton form lies within 1 ulp of the division (JAX measured 1.7e-7
relative, pallas_allpairs.py:81-82), so the twins divide exactly in IEEE:
the hardware's approximate reciprocal cannot be reproduced on the CPU.

The potential takes the chain (rsqrt.approx and the Newton reciprocal in
float32, the refined seeds in float64) although nbody_tpu's _pe_kernel
takes an IEEE sqrt and a true division (pallas_allpairs.py:243-244): a
departure from nbody_tpu's numerics, made so that the potential shares
the force's two-MUFU chain and its speed. Its error stays within the
kernels' tolerance of the IEEE twin (1e-5 of |pe| in float32, 1e-12 in
float64; tests/test_torch_kernels.py, chip_smoke.py phase 2).

block_plan chooses a launch's row blocks and its body splits.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from nbody_torch.ops.allpairs import (SOFTENINGS, accel_rows_raw, cat_rows, pair_terms,
                                      pairs_per_chunk, row_chunks, sum_terms)

EXACT = "allpairs_block_kernel<ieee>"
NEWTON = "allpairs_block_kernel<float32, newton>"
NEWTON64 = "allpairs_block_kernel<float64, newton>"
FAST = "allpairs_block_kernel<float32, fast>"
POTENTIAL = "potential_rowsums_kernel"
SPLIT_SUM = "split_sum_kernel"
# Kernel launches since the last reset, by kernel name. Only a launch of
# the CUDA kernel counts; a CPU call of a wrapper runs the twin and does not.
launch_counts = {EXACT: 0, NEWTON: 0, NEWTON64: 0, FAST: 0, POTENTIAL: 0, SPLIT_SUM: 0}

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def block_name(dtype: torch.dtype, exact: bool = False) -> str:
    """The launch_counts name of the force instantiation that a call in
    `dtype` with `exact` launches."""
    if exact:
        return EXACT
    return NEWTON if dtype == torch.float32 else NEWTON64


# --------------------------------------------------------------------------
# launch plan

THREADS = 256  # threads a block (csrc/allpairs.cu kRowThreads)
TILE = 256     # bodies staged at once, one partial sum (kTile = kPartBodies)
# rows a thread (csrc/allpairs.cu kRows<T>): the fastest on an H100 of
# float32 2, 4, 8 and float64 1, 2, 4 (PERF.md)
ROWS = {torch.float32: 2, torch.float64: 1}
BLOCKS_PER_SM = 4  # the least blocks a plan aims for, per SM


@dataclass(frozen=True)
class Plan:
    """One launch: `blocks` row blocks of rows_per_block rows (block b
    takes rows [b * rows_per_block, (b + 1) * rows_per_block)) by `splits`
    body ranges (split s takes bodies [s * split_len, (s + 1) * split_len)),
    each pair of them one CUDA block: the grid is (blocks, splits)."""

    rows_per_block: int
    blocks: int
    splits: int
    split_len: int


def block_plan(ni: int, nj: int, dtype: torch.dtype, sm_count: int) -> Plan:
    """The plan of ni rows against nj bodies: row blocks of ROWS[dtype] *
    THREADS rows, and the bodies split into ranges of whole tiles, enough
    that blocks * splits comes to about BLOCKS_PER_SM * sm_count (one split
    when the row blocks alone reach it; never less than a tile a split)."""
    rows_per_block = ROWS[dtype] * THREADS
    blocks = max(1, -(-ni // rows_per_block))
    tiles = max(1, -(-nj // TILE))
    splits = max(1, min(tiles, -(-BLOCKS_PER_SM * sm_count // blocks)))
    split_len = -(-tiles // splits) * TILE
    return Plan(rows_per_block, blocks, max(1, -(-nj // split_len)), split_len)


@functools.cache
def sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def potential_rowsums_torch(m: torch.Tensor, x: torch.Tensor, eps: float,
                            rows: int | None = None) -> torch.Tensor:
    """pe_i = m_i * sum_{j != i} m_j / (sqrt(d2) + eps), the diagonal masked
    by global index: the plain twin of potential_rowsums_kernel (on the
    first `rows` rows only, when given)."""
    n = x.shape[0]
    ni = n if rows is None else min(rows, n)
    cols = torch.arange(n, device=x.device)
    parts = []
    for a, b in row_chunks(ni, n, x.device):
        d = x[None, :, :] - x[a:b, None, :]
        w = m[None, :] / (torch.sqrt(torch.sum(d * d, dim=-1)) + eps)
        rows = torch.arange(a, b, device=x.device)
        parts.append(torch.sum(w.masked_fill(rows[:, None] == cols[None, :], 0), dim=1))
    return m[:ni] * cat_rows(parts, m[:ni])


def split_sum_torch(parts: torch.Tensor, scale: float = 1.0,
                    mi: torch.Tensor | None = None) -> torch.Tensor:
    """f * (parts[0] + parts[1] + ...) over the splits of (splits, ni,
    width) partial rows, added in split order as split_sum_kernel adds
    them (so equal to it bit for bit); f = mi[i] with mi, else scale."""
    v = parts[0]
    for s in range(1, parts.shape[0]):
        v = v + parts[s]
    return (scale * v) if mi is None else mi[:, None] * v


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def split_sum_cuda(parts: torch.Tensor, scale: float = 1.0,
                   mi: torch.Tensor | None = None) -> torch.Tensor:
    """The (ni, width) rows f * sum_s parts[s] of a plan's (splits, ni,
    width) partial rows, the splits added in order; f = mi[i] (a (ni,)
    tensor) with mi, else scale."""
    if parts.ndim != 3 or parts.dtype not in _DTYPE_CODES or not parts.is_contiguous():
        raise ValueError(f"parts must be a contiguous (splits, ni, width) float32 or float64 "
                         f"tensor, got {tuple(parts.shape)} {parts.dtype}")
    if mi is not None and (mi.shape != (parts.shape[1],) or mi.dtype != parts.dtype
                           or not mi.is_contiguous()):
        raise ValueError(f"mi {tuple(mi.shape)} does not match parts {tuple(parts.shape)}")
    if _on_cpu(parts, *([] if mi is None else [mi])):
        return split_sum_torch(parts, scale, mi)
    from nbody_torch._build import load_library

    splits, ni, width = parts.shape
    out = torch.empty((ni, width), dtype=parts.dtype, device=parts.device)
    if ni * width == 0:
        return out
    err = load_library().nbody_split_sum(
        parts.device.index, _DTYPE_CODES[parts.dtype], parts.data_ptr(), splits, ni * width,
        width, float(scale), None if mi is None else mi.data_ptr(), out.data_ptr(),
        _stream(parts))
    _raise_on_error(SPLIT_SUM, err)
    launch_counts[SPLIT_SUM] += 1
    return out


def _launch_rows(name: str, xi, mj, xj, eps: float, softening: str, exact: bool,
                 scale: float, mi, plan: Plan | None) -> torch.Tensor:
    """One plan of the rows kernel (the force, or with mi the potential),
    and, when the plan splits the bodies, split_sum_kernel over its
    partial rows. Returns (ni, width) rows."""
    from nbody_torch._build import load_library

    if softening not in SOFTENINGS:
        raise ValueError(f"softening must be one of {SOFTENINGS}, got {softening!r}")
    (ni, dim), nj = xi.shape, xj.shape[0]
    width = 1 if mi is not None else dim
    if ni == 0:
        return xi.new_empty((0, width))
    if plan is None:
        plan = block_plan(ni, nj, xi.dtype, sm_count_of(xi.device.index))
    if plan.rows_per_block != ROWS[xi.dtype] * THREADS:
        raise ValueError(f"{plan} is not a plan of {xi.dtype} rows: its blocks hold "
                         f"{ROWS[xi.dtype] * THREADS} rows")
    split = plan.splits > 1
    out = torch.empty((plan.splits, ni, width), dtype=xi.dtype, device=xi.device)
    err = load_library().nbody_allpairs_rows(
        xi.device.index, _DTYPE_CODES[xi.dtype], dim, int(mi is not None),
        int(softening == "sqrt3"), int(exact), xi.data_ptr(), ni, mj.data_ptr(), xj.data_ptr(),
        nj, plan.blocks, plan.splits, plan.split_len, float(eps),
        1.0 if split else float(scale), None if split or mi is None else mi.data_ptr(),
        out.data_ptr(), _stream(xi))
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return split_sum_cuda(out, scale, mi) if split else out[0]


def allpairs_block_cuda(xi: torch.Tensor, mj: torch.Tensor, xj: torch.Tensor, eps: float,
                        softening: str = "poly", exact: bool = False,
                        plan: Plan | None = None) -> torch.Tensor:
    """Raw (G-less) accelerations of the rows xi against the body block
    (mj, xj) -- the counterpart of allpairs_block_pallas, whose default
    exact=False it shares. plan: block_plan's by default."""
    _check_bodies(xi, mj, xj)
    if _on_cpu(xi, mj, xj):
        return allpairs_block_torch(xi, mj, xj, eps, softening)
    return _launch_rows(block_name(xi.dtype, exact), xi, mj, xj, eps, softening, exact, 1.0,
                        None, plan)


def _check_variant(dtype: torch.dtype, exact: bool, fast: bool, return_counts: bool) -> None:
    if return_counts and not fast:
        raise ValueError("return_counts counts the fast variant's branches: pass fast=True")
    if not fast:
        return
    if exact:
        raise ValueError("fast=True runs the Newton chain on its near tiles, as nbody_tpu "
                         "calls it: pass exact=False")
    if dtype != torch.float32:
        raise TypeError(f"fast=True is float32 only, got {dtype}")


def tile_counts(npad: int, tile_i: int, branches: int, like: torch.Tensor) -> torch.Tensor:
    """The zeroed int32 (i-tiles, branches) tensor in which a kernel counts
    each i-tile's j-tiles by branch."""
    return torch.zeros((npad // tile_i, branches), dtype=torch.int32, device=like.device)


def allpairs_accel_cuda(m: torch.Tensor, x: torch.Tensor, G: float, eps: float,
                        exact: bool = False, fast: bool = False, fast_tol: float = 1e-6,
                        tile_i: int = 512, tile_j: int = 2048,
                        return_counts: bool = False, plan: Plan | None = None):
    """All-pairs accelerations G * block(x, m, x) -- the counterpart of
    allpairs_accel_pallas, whose default exact=False it shares. The kernel
    applies G after the sum, as the Pallas wrapper does
    (pallas_allpairs.py:173). The tiles and fast_tol matter to fast=True
    only. With return_counts (fast=True only) returns (a, counts), counts
    the int (i-tiles, 2) tensor of each i-tile's [softened, far] j-tiles,
    as allpairs_fast_torch returns them."""
    _check_bodies(x, m, x)
    _check_variant(x.dtype, exact, fast, return_counts)
    if _on_cpu(m, x):
        if not fast:
            return G * allpairs_block_torch(x, m, x, eps)
        a, counts = allpairs_fast_torch(m, x, G, eps, fast_tol, tile_i, tile_j)
        return (a, counts) if return_counts else a
    if not fast:
        return _launch_rows(block_name(x.dtype, exact), x, m, x, eps, "poly", exact, G, None,
                            plan)
    from nbody_torch._build import load_library
    from nbody_torch.ops import cuda_variant_decide as vd

    n, dim = x.shape
    npad, tile_j = fast_tiling(n, dim, tile_i, tile_j)
    if tile_i % 32 or not 32 <= tile_i <= vd.MAX_TILE or tile_j % vd.SUB or tile_j > vd.MAX_TILE:
        raise ValueError(f"fast takes tile_i a multiple of 32 and tile_j a multiple of {vd.SUB}, "
                         f"both up to {vd.MAX_TILE}, got tile_i={tile_i}, tile_j={tile_j}")
    if n == 0:
        out = torch.empty_like(x)
        return (out, tile_counts(npad, tile_i, 2, x)) if return_counts else out
    table, _ = vd.decide_cuda(x, "fast", npad, tile_i, tile_j,
                              thresh=far_threshold(eps, fast_tol))
    if plan is None:
        plan = block_plan(n, n, x.dtype, sm_count_of(x.device.index))
    if plan.rows_per_block != ROWS[x.dtype] * THREADS:
        raise ValueError(f"{plan} is not a plan of float32 rows")
    split = plan.splits > 1
    out = torch.empty((plan.splits, n, dim), dtype=x.dtype, device=x.device)
    err = load_library().nbody_allpairs_fast(
        x.device.index, dim, x.data_ptr(), m.data_ptr(), n, plan.blocks, plan.splits,
        plan.split_len, table.data_ptr(), tile_i, tile_j, table.shape[1], float(eps),
        1.0 if split else float(G), out.data_ptr(), _stream(x))
    _raise_on_error(FAST, err)
    launch_counts[FAST] += 1
    a = split_sum_cuda(out, G) if split else out[0]
    return (a, vd.branch_counts(table, 2)) if return_counts else a


def potential_rowsums_cuda(m: torch.Tensor, x: torch.Tensor, eps: float,
                           plan: Plan | None = None) -> torch.Tensor:
    """Per-body pe_i = m_i * sum_{j != i} m_j / dist(i, j); the total PE is
    -0.5 * G * sum(pe). The counterpart of potential_rowsums_pallas."""
    _check_bodies(x, m, x)
    if _on_cpu(m, x):
        return potential_rowsums_torch(m, x, eps)
    return _launch_rows(POTENTIAL, x, m, x, eps, "poly", False, 1.0, m, plan).view(-1)
