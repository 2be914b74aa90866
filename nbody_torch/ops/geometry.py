"""Distances with epsilon softening (the torch port of nbody_tpu.ops.geometry).

Reproduces the semantics of src/vec.h:
  dist2(a, b) = sum_i (a_i - b_i)^2                    (vec.h:232-240)
  dist(a, b)  = sqrt(dist2) + eps                      (vec.h:243-246)
  dist3(a, b) = dist2^(3/2) + eps                      (vec.h:249-252)
where eps = numeric_limits<T>::epsilon(). The epsilon softening means the
self-interaction term of the force is exactly zero (0/eps * m = 0).

All functions broadcast over leading axes; the last axis is the spatial
dimension. scalar_bounds is the octree's root box, aabb_of_points the
BVH's.
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


def aabb_of_points(x: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Bounding box of the bodies and the origin, widened by the
    reference's 10*eps point tolerance (bounding_box(), bvh.h:16-22, whose
    reduction starts from the point box of the origin, vec.h:388-392).
    Returns (xmin, xmax), each of shape (dim,), on x's device."""
    tol = torch.full((), 10.0 * eps, dtype=x.dtype, device=x.device)
    zero = x.new_zeros(())
    return torch.minimum(x.amin(0), zero) - tol, torch.maximum(x.amax(0), zero) + tol


def scalar_bounds(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scalar min/max over all coordinates of all bodies, the octree root
    bound (octree.h:93-112): the reference's reduction starts from (0, 0),
    so the bounds include zero, and are then widened by +-1. Returns
    0-dim tensors (min - 1, max + 1) on x's device."""
    zero = x.new_zeros(())
    return torch.minimum(x.min(), zero) - 1.0, torch.maximum(x.max(), zero) + 1.0
