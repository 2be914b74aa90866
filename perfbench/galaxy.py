"""The galaxy workload of stdpar-nbody (src/models.h:73-141), drawn from a seed.

Two spinning galaxies on a collision course: central masses 1e4 and 1e3 at
+-100 * (-1, 1/2, 0), each with int(n/2 - 1) orbiters of total mass 1 on
radii 30-50 at the circular speed sqrt(G * (M + 1) / (r + eps)); in 3-D each
orbiter gets a z of +-10 and a vz of +-1e-5, and the orbiters' positions
and velocities are turned by the fixed matrix of models.h:101. Every
constant is the published one and comes from the configuration file.

The reference draws from mt19937{42}; here each orbiter's four uniforms
(radius, angle, z, vz, in the reference's order) come from
numpy.random.default_rng(seed). The model is built in float64 and cast to
the run's precision at the end, as the reference's model code casts.

A run's bodies (`bodies`) are the configuration's one galaxy, drawn from its
`galaxy_seed`, in an order drawn from the run's seed: a galaxy drawn from
the run's seed changed the work of a step (one seed in three read 7% more
seconds a step in a host-bound cell, the same on a second run), so every
seed gets the same bodies, and a seed changes their order, the window step
that is checked and the rows sampled.
"""

from __future__ import annotations

import numpy as np


def make(seed: int, n: int, dim: int, dtype, spec: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(m, x, v) host arrays of `n` bodies in `dtype`; `spec` is the
    configuration's "galaxy" block and G its constant."""
    if dim not in (2, 3):
        raise ValueError(f"the galaxy is 2-D or 3-D, got dim={dim}")
    eps = float(np.finfo(np.dtype(dtype)).eps)
    G = float(spec["G"])
    rot = np.asarray(spec["rotation"], dtype=np.float64)
    rng = np.random.default_rng(seed)
    count = int(n / 2.0 - 1)
    m = np.zeros(n)
    x = np.zeros((n, dim))
    v = np.zeros((n, dim))
    row = 0
    for centre_mass, sign in zip(spec["centre_masses"], (1.0, -1.0)):
        centre = float(spec["offset"]) * sign * np.asarray(spec["direction"][:dim], dtype=np.float64)
        m[row] = centre_mass
        x[row] = centre
        row += 1
        u = rng.random((count, 4))
        r_lo, r_hi = spec["radius"]
        radius = r_lo + (r_hi - r_lo) * u[:, 0]
        angle = 2.0 * np.pi * u[:, 1]
        pos = np.zeros((count, dim))
        pos[:, 0] = radius * np.sin(angle)
        pos[:, 1] = radius * np.cos(angle)
        speed = np.sqrt(G * (centre_mass + spec["orbit_mass"]) / (radius + eps))
        norm = np.sqrt(np.sum(pos * pos, axis=1)) + eps
        vel = np.zeros((count, dim))
        vel[:, 0] = speed / norm * -pos[:, 1]
        vel[:, 1] = speed / norm * pos[:, 0]
        if dim == 3:
            pos[:, 2] = spec["z_jitter"] * (2.0 * u[:, 2] - 1.0)
            vel[:, 2] = spec["vz_jitter"] * (2.0 * u[:, 3] - 1.0)
            pos = pos @ rot.T
            vel = vel @ rot.T
        m[row:row + count] = spec["orbit_mass"] / count
        x[row:row + count] = pos + centre
        v[row:row + count] = vel
        row += count
    return m.astype(dtype), x.astype(dtype), v.astype(dtype)


def bodies(cfg: dict, seed: int, n: int, dtype) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The configuration's galaxy of n bodies in the order the seed draws."""
    m, x, v = make(cfg["galaxy_seed"], n, cfg["dim"], dtype, cfg["galaxy"])
    order = np.random.default_rng([seed, 4]).permutation(n)
    return m[order], x[order], v[order]
