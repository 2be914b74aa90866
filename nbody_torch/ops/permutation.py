"""Row permutations (the port of nbody_tpu.ops.permutation).

nbody_tpu inverts a permutation with a second payload-carrying key sort,
because scatters are slow on the TPU (permutation.py:3-10). On the GPU an
index scatter is the plain way; it moves the same values, so the result is
bit-equal.
"""

from __future__ import annotations

import torch


def unpermute_rows(a_sorted: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """out with out[perm[i]] = a_sorted[i]; perm is a permutation of
    0..n-1 (the counterpart of permutation.unpermute_rows)."""
    out = torch.empty_like(a_sorted)
    out[perm] = a_sorted
    return out
