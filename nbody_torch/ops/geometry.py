"""Distances with epsilon softening (the torch port of nbody_tpu.ops.geometry).

Reproduces the semantics of src/vec.h:
  dist2(a, b) = sum_i (a_i - b_i)^2                    (vec.h:232-240)
  dist(a, b)  = sqrt(dist2) + eps                      (vec.h:243-246)
  dist3(a, b) = dist2^(3/2) + eps                      (vec.h:249-252)
where eps = numeric_limits<T>::epsilon(). The epsilon softening means the
self-interaction term of the force is exactly zero (0/eps * m = 0).

All functions broadcast over leading axes; the last axis is the spatial
dimension. The bounding boxes of nbody_tpu.ops.geometry are ported with the
tree algorithms that use them.
"""

from __future__ import annotations

import torch


def dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sum(d * d, dim=-1)


def dist(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.sqrt(dist2(a, b)) + eps


def dist3_from_d2(d2: torch.Tensor, eps: float) -> torch.Tensor:
    """dist2^(3/2) + eps, computed as d2*sqrt(d2) + eps (equal in exact
    arithmetic to the reference's pow(d2, 1.5), differs by <=1 ulp)."""
    return d2 * torch.sqrt(d2) + eps
