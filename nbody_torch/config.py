"""Static simulation configuration.

The reference fixes spatial dimension at compile time (-DDIM_SIZE,
src/main.cpp:5-7) and dispatches precision at runtime (src/main.cpp:70-71).
Here both are fields of SimConfig; the CUDA kernels are templated on
(dtype, dim), the analog of the reference's template instantiation.
Numpy-only, like nbody_tpu.config, whose meaning it keeps unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


def precision_dtype(name: str) -> Any:
    """Map the CLI precision name to a numpy dtype (ref: src/arguments.h:61-71)."""
    if name == "float":
        return np.float32
    if name == "double":
        return np.float64
    raise ValueError(f'Unknown precision: "{name}". Options are: double, float (default).')


def machine_eps(dtype: Any) -> float:
    """numeric_limits<T>::epsilon() -- the softening constant used by
    dist/dist3 (ref: src/vec.h:243-252)."""
    return float(np.finfo(np.dtype(dtype)).eps)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static parameters of a simulation run.

    Mirrors the compile/construct-time state of the reference's System<T,N>
    (src/system.h:10-36) plus the Arguments fields that affect compute
    (src/arguments.h:23-38).
    """

    n: int                      # number of bodies (System::size)
    dim: int = 2                # spatial dimension N in {2,3}
    dtype: Any = np.float32     # precision T in {float32, float64}
    dt: float = 1e-1            # time step (System::dt)
    G: float = 1.0              # gravitational constant (System::constant)
    theta: float = 0.5          # Barnes-Hut MAC threshold

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        # normalize dtype to a hashable canonical form
        object.__setattr__(self, "dtype", np.dtype(self.dtype).type)

    @property
    def eps(self) -> float:
        """Softening epsilon = numeric_limits<T>::epsilon()."""
        return machine_eps(self.dtype)

    @property
    def child_count(self) -> int:
        """Children per octree node: 2^dim (ref: src/vec.h:10-14)."""
        return 1 << self.dim

    @property
    def max_tree_nodes(self) -> int:
        """Octree capacity bound: max(2^dim * n, 1000) (ref: src/system.h:29)."""
        return max(self.child_count * self.n, 1000)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
