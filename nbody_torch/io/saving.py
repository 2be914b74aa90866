"""Byte-compatible binary I/O.

File formats are identical to the reference's Saver (src/saving.h) so its
plotter (scripts/plotter.py), check_state.py and the NASA conversion
pipeline work unchanged:

positions.bin (saving.h:85-98,110-114):
    u32 nbodies | u32 nsteps | u32 sizeof(T) | u32 dim
    then per save_all call: x as raw T, nbodies*dim values.
energy.bin (saving.h:100-108,116-122):
    u32 nsteps | u32 sizeof(T)
    then per save_all call: T kinetic | T gravitational.
state file (load format, saving.h:25-68; produced by
scripts/thuering_nbody/conv_csv.py in the reference):
    u32 size | u32 dim | f32 dt | f32 G
    then per body: f32 mass | f32 pos[dim] | f32 vel[dim]  (always float32).

As in the reference, a Saver writes one frame per save_all call; the run
loops call it once before stepping and once per step only in --csv-detailed
mode (all_pairs.h:55,81). This is nbody_tpu.io.saving with torch state;
its energies come from nbody_torch.ops.energy.
"""

from __future__ import annotations

import struct

import numpy as np

from nbody_torch.config import SimConfig
from nbody_torch.ops.energy import calc_energies
from nbody_torch.state import SystemState


class Saver:
    """Streams positions.bin / energy.bin frames."""

    def __init__(self, save_pos: bool, save_energy: bool, n: int, steps: int,
                 dim: int, dtype, pos_path: str = "positions.bin",
                 energy_path: str = "energy.bin"):
        self.save_pos = save_pos
        self.save_energy = save_energy
        self.dtype = np.dtype(dtype)
        self._pos_file = None
        self._energy_file = None
        itemsize = self.dtype.itemsize
        if save_pos:
            self._pos_file = open(pos_path, "wb")
            self._pos_file.write(struct.pack("<IIII", n, steps, itemsize, dim))
        if save_energy:
            self._energy_file = open(energy_path, "wb")
            self._energy_file.write(struct.pack("<II", steps, itemsize))
        self._n = n

    def save_all(self, state: SystemState, cfg: SimConfig) -> None:
        if self._pos_file is not None:
            x = np.ascontiguousarray(state.x.cpu().numpy(), dtype=self.dtype)
            self._pos_file.write(x.tobytes())
        if self._energy_file is not None:
            ke, pe = calc_energies(state.m, state.x, state.v, cfg.G, cfg.eps)
            self._energy_file.write(
                np.array([ke.item(), pe.item()], dtype=self.dtype).tobytes()
            )

    def close(self) -> None:
        if self._pos_file is not None:
            self._pos_file.close()
            self._pos_file = None
        if self._energy_file is not None:
            self._energy_file.close()
            self._energy_file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_system(path: str, dim: int, dtype, device) -> tuple[SimConfig, SystemState]:
    """Saver::load_system (saving.h:25-68): reads the float32 state format,
    raising on dimension mismatch exactly like the reference (saving.h:41-44).
    """
    with open(path, "rb") as f:
        size, fdim = struct.unpack("<II", f.read(8))
        dt, G = struct.unpack("<ff", f.read(8))
        if fdim != dim:
            raise ValueError(
                f"This version is running with D={dim}, but the file provided is D={fdim}"
            )
        per = 1 + 2 * fdim
        data = np.frombuffer(f.read(size * per * 4), dtype=np.float32).reshape(size, per)
    m = data[:, 0].astype(dtype)
    x = data[:, 1 : 1 + fdim].astype(dtype)
    v = data[:, 1 + fdim : 1 + 2 * fdim].astype(dtype)
    cfg = SimConfig(n=size, dim=dim, dtype=dtype, dt=float(dt), G=float(G))
    return cfg, SystemState.from_numpy(m, x, v, dtype=dtype, device=device)


def save_system(path: str, state: SystemState, cfg: SimConfig) -> None:
    """Symmetric writer of the loadable state format. The reference never
    writes this format itself (only conv_csv.py does); having a writer makes
    checkpoint/restart first-class: save_system + load_system round-trips."""
    h = state.to_numpy()
    m = h["m"].astype(np.float32)
    x = h["x"].astype(np.float32)
    v = h["v"].astype(np.float32)
    n, dim = x.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<II", n, dim))
        f.write(struct.pack("<ff", float(cfg.dt), float(cfg.G)))
        rec = np.concatenate([m[:, None], x, v], axis=1).astype(np.float32)
        f.write(np.ascontiguousarray(rec).tobytes())
