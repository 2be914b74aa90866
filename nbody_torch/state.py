"""SoA body state as a dataclass of torch tensors.

The analog of the reference's System<T,N> SoA arrays m, x, v, a, ao
(src/system.h:18-19) and of nbody_tpu.state.SystemState. `ao` is the
previous step's acceleration used by the leapfrog scheme
(src/system.h:52-60). Every tensor lives on the device the state was made
on; nothing here picks a device by default.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SystemState:
    m: torch.Tensor   # (n,)       masses
    x: torch.Tensor   # (n, dim)   positions
    v: torch.Tensor   # (n, dim)   velocities
    a: torch.Tensor   # (n, dim)   accelerations (current step)
    ao: torch.Tensor  # (n, dim)   accelerations (previous step)

    @property
    def n(self) -> int:
        return self.m.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @staticmethod
    def from_numpy(m, x, v, a=None, ao=None, *, dtype=None, device) -> "SystemState":
        """State on `device` from host arrays, copied (a = ao = 0 unless
        given). The tests hand the same numpy arrays to this and to
        nbody_tpu.state.SystemState."""
        x = np.asarray(x)
        np_dtype = np.dtype(x.dtype if dtype is None else dtype)

        def put(arr):
            return torch.tensor(np.asarray(arr, dtype=np_dtype), device=device)

        zeros = np.zeros(x.shape, np_dtype)
        return SystemState(m=put(m), x=put(x), v=put(v), a=put(zeros if a is None else a),
                           ao=put(zeros if ao is None else ao))

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of every field, keyed by name (copies on the CPU too:
        the leapfrog updates x and v in place)."""
        return {f.name: getattr(self, f.name).detach().to("cpu", copy=True).numpy()
                for f in dataclasses.fields(self)}


def format_state(state: SystemState) -> str:
    """Human dump of the state, byte-for-byte matching System::print()
    (src/system.h:90-97) and nbody_tpu.state.format_state: one line per
    body, only the first two components of p/v/f are printed even in 3-D."""
    h = state.to_numpy()
    m, x, v, a = h["m"], h["x"], h["v"], h["a"]
    lines = []
    for i in range(m.shape[0]):
        lines.append(
            "{:02}: m={: .3e}, p=({: .3e}, {: .3e}), v=({: .3e}, {: .3e}), "
            "f=({: .3e}, {: .3e})".format(
                i, m[i], x[i, 0], x[i, 1], v[i, 0], v[i, 1], a[i, 0], a[i, 1]
            )
        )
    return "\n".join(lines)
