"""Row permutations (the port of nbody_tpu.ops.permutation).

nbody_tpu moves rows through payload-carrying key sorts, because scatters
and gathers are slow on the TPU (permutation.py:3-10). On the GPU a row
gather and an index scatter are the plain way; they move the same
values, so the results are bit-equal.
"""

from __future__ import annotations

import torch

INT64_MIN = torch.iinfo(torch.int64).min


def sort_rows_by_key(keys: torch.Tensor, *arrays: torch.Tensor) -> tuple:
    """The arrays' rows in the order of a stable sort of the int64 keys
    read as unsigned 64-bit values (the counterpart of
    sort_arrays_by_u32pair: bit-equal to lax.sort over (hi, lo) with
    num_keys=2, is_stable=True). Flipping the top bit makes the signed
    order the unsigned one; equal keys keep their order."""
    perm = torch.sort(keys ^ INT64_MIN, stable=True).indices
    return tuple(a[perm] for a in arrays)


def unpermute_rows(a_sorted: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out with out[perm[i]] = a_sorted[i]; perm is a permutation of
    0..n-1 (the counterpart of permutation.unpermute_rows)."""
    out = torch.empty_like(a_sorted)
    out[perm] = a_sorted
    return out
