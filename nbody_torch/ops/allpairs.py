"""O(N^2) all-pairs gravity in plain torch (the port of nbody_tpu.ops.allpairs).

The pairwise interaction is a dense broadcast, evaluated in row chunks
sized from n so memory stays bounded. This module is the sequential oracle (the analog
of the reference's -DSEQUENTIAL build, execution.h:4-6) and the `--kernel
torch` path; the hand-written CUDA kernel of the same math is driven from
nbody_torch.ops.cuda_allpairs.

Math (all_pairs.h:17-26):
    a_i = G * sum_j m_j * (x_j - x_i) / (dist2(i,j)^(3/2) + eps)
The j == i term is exactly zero because the numerator vanishes while the
denominator is eps, so no diagonal masking is needed.
"""

from __future__ import annotations

import torch

from nbody_torch.ops.geometry import dist3_from_d2

SOFTENINGS = ("poly", "sqrt3")


def pair_terms(xi: torch.Tensor, m: torch.Tensor, x: torch.Tensor, eps: float,
               softening: str = "poly") -> tuple[torch.Tensor, torch.Tensor]:
    """Weights w (k, n) = m_j / t and separations d (k, n, dim) = x_j - x_i
    of query rows xi against bodies (m, x); the force on row i is
    sum_j w_ij * d_ij. softening "poly" is t = d2*sqrt(d2) + eps, "sqrt3"
    the octree quirk t = (sqrt(d2) + eps)^3 (octree.h:156-160)."""
    d = x[None, :, :] - xi[:, None, :]            # (k, n, dim)
    d2 = torch.sum(d * d, dim=-1)                 # (k, n)
    if softening == "poly":
        t = dist3_from_d2(d2, eps)
    elif softening == "sqrt3":
        s = torch.sqrt(d2) + eps
        t = s * s * s
    else:
        raise ValueError(f"softening must be one of {SOFTENINGS}, got {softening!r}")
    return m[None, :] / t, d


def sum_terms(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sum_j w_kj * d_kjc -> (k, dim), reduced over the contiguous body axis
    of each component. torch's reductions over a contiguous axis sum in a
    tree (CUDA) or in cascade (CPU); a matrix product (einsum) accumulates
    in long runs, where one huge close-pair term absorbs the small ones
    (measured 4.6e-4 of the row's sum of |term| in float32 at n = 65,536
    with the sqrt3 softening)."""
    return torch.stack([torch.sum(w * d[..., c], dim=-1) for c in range(d.shape[-1])], dim=-1)


# A row chunk of the plain path holds at most this many (row, body) pairs
# on a GPU, so its (rows, n, dim) temporaries stay near 1 GB in float32
# and the launches few; on the CPU at most CPU_PAIRS_PER_CHUNK, so they
# stay in cache (3.5x faster on one core at 12,288 x 17,000 pairs).
PAIRS_PER_CHUNK = 1 << 26
CPU_PAIRS_PER_CHUNK = 1 << 18


def pairs_per_chunk(device: torch.device | None = None) -> int:
    """The pair budget of one chunk on `device` (None: a GPU's)."""
    if device is None or device.type == "cuda":
        return PAIRS_PER_CHUNK
    return min(PAIRS_PER_CHUNK, CPU_PAIRS_PER_CHUNK)


def row_chunks(n_rows: int, n_cols: int, device: torch.device | None = None) -> list[tuple[int, int]]:
    """[start, stop) row ranges of at most pairs_per_chunk(device) pairs each."""
    step = max(1, pairs_per_chunk(device) // max(1, n_cols))
    return [(r, min(r + step, n_rows)) for r in range(0, n_rows, step)]


def cat_rows(parts: list[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Concatenate row chunks; an empty list gives an empty tensor like `like`."""
    return torch.cat(parts) if parts else torch.empty_like(like)


def accel_rows_raw(xi: torch.Tensor, m: torch.Tensor, x: torch.Tensor, eps: float,
                   softening: str = "poly") -> torch.Tensor:
    """Unscaled (no G) accelerations for query positions xi (k, dim) against
    bodies (m: (n,), x: (n, dim)), in row chunks sized from n. Returns
    (k, dim); the chunking changes no value (each row sums its own terms)."""
    return cat_rows([sum_terms(*pair_terms(xi[a:b], m, x, eps, softening))
                     for a, b in row_chunks(xi.shape[0], x.shape[0], xi.device)], xi)


def allpairs_accel(m: torch.Tensor, x: torch.Tensor, G: float, eps: float) -> torch.Tensor:
    """All-pairs accelerations G * sum_j (...), G applied after the sum."""
    return G * accel_rows_raw(x, m, x, eps)


def allpairs_collapsed_accel(m: torch.Tensor, x: torch.Tensor, a_old: torch.Tensor,
                             G: float, eps: float, fix_z: bool = False) -> torch.Tensor:
    """all-pairs-collapsed (src/all_pairs.h:29-50): same pairwise math,
    pair-parallel in the reference with atomic accumulation that only ever
    touches components [0] and [1] (all_pairs.h:37-38,47-48). So in 3-D the
    z-acceleration keeps its previous value -- a reference quirk replicated
    by default; fix_z=True gives the corrected physics."""
    return freeze_z(allpairs_accel(m, x, G, eps), a_old, fix_z)


def freeze_z(a_new: torch.Tensor, a_old: torch.Tensor, fix_z: bool) -> torch.Tensor:
    """The collapsed engine's z-freeze: components 2+ come from a_old unless
    fix_z (or the run is 2-D)."""
    if fix_z or a_new.shape[1] <= 2:
        return a_new
    return torch.cat([a_new[:, :2], a_old[:, 2:]], dim=1)
