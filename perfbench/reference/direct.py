"""The plain reference of one step: a direct sum and the leapfrog, in plain torch.

It imports nothing of the program. Force on row i (stdpar-nbody
all_pairs.h:17-26 with the tree's softening):

    a_i = G * sum_j m_j * (x_j - x_i) / t(d2_ij)
    t = d2 * sqrt(d2) + eps        ("poly", the BVH's, vec.h:243-252)
    t = (sqrt(d2) + eps)^3         ("sqrt3", the octree's, octree.h:156-160)

The j == i term is 0 (its numerator is 0, its denominator eps). The
leapfrog is System::accelerate_step (system.h:52-60):

    x += dt * v + 0.5 * dt^2 * ao;   v += 0.5 * dt * (a + ao);   ao = a
"""

from __future__ import annotations

import torch

# pairs in one block of rows: the (rows, n, dim) temporaries stay under a GB
BLOCK_PAIRS = 1 << 25


def accel(xi: torch.Tensor, m: torch.Tensor, x: torch.Tensor, G: float, eps: float,
          softening: str, dtype: torch.dtype) -> torch.Tensor:
    """Direct-sum accelerations of the query rows xi (k, dim) against every
    body (m, x), computed in `dtype` in blocks of rows; returns (k, dim) in
    `dtype`. Each component is a sum over the contiguous body axis, which
    torch reduces in a tree."""
    xi, m, x = xi.to(dtype), m.to(dtype), x.to(dtype)
    rows = max(1, BLOCK_PAIRS // max(1, x.shape[0]))
    out = []
    for r in range(0, xi.shape[0], rows):
        d = x[None, :, :] - xi[r:r + rows, None, :]
        d2 = torch.sum(d * d, dim=-1)
        if softening == "poly":
            t = d2 * torch.sqrt(d2) + eps
        elif softening == "sqrt3":
            s = torch.sqrt(d2) + eps
            t = s * s * s
        else:
            raise ValueError(f"unknown softening {softening!r}")
        w = m[None, :] / t
        out.append(torch.stack([torch.sum(w * d[..., c], dim=-1) for c in range(x.shape[1])],
                               dim=-1))
    return G * torch.cat(out) if out else xi.new_zeros((0, x.shape[1]))


def drift(x: torch.Tensor, v: torch.Tensor, ao: torch.Tensor, dt: float,
          dtype: torch.dtype) -> torch.Tensor:
    """The leapfrog's new positions, computed in `dtype`."""
    x, v, ao = x.to(dtype), v.to(dtype), ao.to(dtype)
    return x + dt * v + (0.5 * dt * dt) * ao


def kick(v: torch.Tensor, a: torch.Tensor, ao: torch.Tensor, dt: float,
         dtype: torch.dtype) -> torch.Tensor:
    """The leapfrog's new velocities from the step's force a, in `dtype`."""
    v, a, ao = v.to(dtype), a.to(dtype), ao.to(dtype)
    return v + (0.5 * dt) * (a + ao)


def step_rows(m: torch.Tensor, x: torch.Tensor, v: torch.Tensor, ao: torch.Tensor,
              rows: torch.Tensor, G: float, eps: float, dt: float, softening: str,
              dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """One whole step computed in `dtype`, the force only on `rows` (0
    elsewhere: no comparison reads another row's force), returned in the
    state's own dtype: the control that stands in the program's place."""
    a = torch.zeros_like(x, dtype=dtype)
    a[rows] = accel(x[rows], m, x, G, eps, softening, dtype)
    out = {"m": m.clone(), "x": drift(x, v, ao, dt, dtype), "v": kick(v, a, ao, dt, dtype),
           "a": a}
    out = {k: t.to(x.dtype) for k, t in out.items()}
    out["ao"] = out["a"]
    return out
