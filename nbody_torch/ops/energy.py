"""Kinetic / gravitational energy diagnostics (the port of nbody_tpu.ops.energy).

System::calc_energies (src/system.h:62-79):
    KE =  0.5     * sum_i m_i * |v_i|^2
    PE = -0.5 * G * sum_i sum_{j != i} m_i * m_j / dist(x_i, x_j)
with dist = sqrt(dist2) + eps (vec.h:243-246). The PE inner loop skips
j == i explicitly in the reference; here the diagonal term m_i^2 / eps is
nonzero, so it is masked.
"""

from __future__ import annotations

import torch

from nbody_torch.ops.cuda_allpairs import potential_rowsums_cuda


def calc_energies(m: torch.Tensor, x: torch.Tensor, v: torch.Tensor, G: float,
                  eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (kinetic, gravitational) as 0-d tensors of the state dtype.
    The O(N^2) potential runs potential_rowsums_kernel on CUDA tensors and
    its plain rowsums on CPU tensors."""
    ke = 0.5 * torch.sum(m * torch.sum(v * v, dim=-1))
    pe = (-0.5 * G) * torch.sum(potential_rowsums_cuda(m, x, eps))
    return ke, pe
