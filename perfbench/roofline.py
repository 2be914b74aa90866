"""The yardstick of force_roofline and step_mfu: the least time one H100
needs for the force work a step of these bodies requires.

Work: the interactions that the plain walk (reference/walk.py) counts for a
Barnes-Hut configuration, or n * (n - 1) pairs for an all-pairs one. Each
interaction costs flops_per_interaction operations (the arithmetic of
chip_smoke.py's flops_per_pair). Bytes: the bodies read once and their
accelerations written once. The bound is the larger of operations over the
peak rate and bytes over the memory bandwidth.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM at its 700 W limit: float32 and float64
# outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12


def flops_per_interaction(dim: int, softening: str) -> int:
    """dim subtractions, 2*dim - 1 for d2, the square root, the softening
    (poly: a multiply and an add; sqrt3: an add and two multiplies), the
    division, and 2*dim to accumulate the weighted separation."""
    return 5 * dim + 3 + (softening == "sqrt3")


def interactions(config: dict, m: np.ndarray, x: np.ndarray, sample_size: int, seed: int) -> dict:
    """The interactions of one step over the bodies (m, x): the plain walk's
    count for a tree, every ordered pair for all-pairs (so that a later
    all-pairs cell reads force_roofline with no edit here)."""
    n = int(m.shape[0])
    if config["algorithm"] in ("all-pairs", "all-pairs-collapsed"):
        return {"interactions": float(n * (n - 1)), "per_body": float(n - 1)}
    from perfbench.reference.walk import interactions_per_step

    return interactions_per_step(m, x, config["theta"], sample_size, seed)


def bound_seconds(count: float, n: int, dim: int, softening: str, dtype_name: str) -> dict:
    """The least seconds a step's force work takes on one chip, and what
    bounds it."""
    itemsize = np.dtype(dtype_name).itemsize
    t_ops = count * flops_per_interaction(dim, softening) / PEAK_FLOPS[dtype_name]
    t_bytes = n * (2 * dim + 1) * itemsize / HBM_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
