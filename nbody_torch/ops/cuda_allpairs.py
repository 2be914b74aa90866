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
(allpairs_block_torch, potential_rowsums_torch) only when its tensors lie
on the CPU; on a CUDA tensor it launches the kernel or raises.

The Pallas knobs `exact` and `fast` are not carried over: the kernel
always uses IEEE division, which the Pallas default (approximate
reciprocal plus one Newton step) lies within 1 ulp of.
"""

from __future__ import annotations

import torch

from nbody_torch.ops.allpairs import (SOFTENINGS, accel_rows_raw, cat_rows, pair_terms,
                                      row_chunks, sum_terms)

# Kernel launches since the last reset, by kernel name. Only a launch of
# the CUDA kernel counts; a CPU call of a wrapper runs the twin and does not.
launch_counts = {"allpairs_block_kernel": 0, "potential_rowsums_kernel": 0}

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


def allpairs_accel_cuda(m: torch.Tensor, x: torch.Tensor, G: float, eps: float) -> torch.Tensor:
    """All-pairs accelerations G * block(x, m, x) -- the counterpart of
    allpairs_accel_pallas. The kernel applies G after the sum, as the
    Pallas wrapper does (pallas_allpairs.py:173)."""
    _check_bodies(x, m, x)
    if _on_cpu(m, x):
        return G * allpairs_block_torch(x, m, x, eps)
    return _launch_block(x, m, x, eps, "poly", G)


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
