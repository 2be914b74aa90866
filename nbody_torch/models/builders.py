"""Host-side workload builders, reproducing src/models.h semantics.

Each builder returns (SimConfig, SystemState) with the state on the
`device` it is given. The RNG stream is the reference's single
mt19937{42} consumed through three uniform_real_distribution<double>
objects in the exact per-body order of models.h (see nbody_torch.rng for
the bit-exact stream). The code is nbody_tpu.models.builders with torch
state: that package cannot be imported without loading jax. Model math is done in
float64 and cast to the target dtype at the end; the reference computes some
intermediates in the run precision T, so float32 runs may differ from the
reference in the last ulp (documented divergence; everything else is exact).

Like the reference (src/main.cpp:45-57), model construction is host code --
fixed-seed serial RNG has no GPU analog and is not performance-relevant.
The accelerated path is the C++ native builder in nbody_torch.native (same
stream, same order); this module is the pure-Python fallback and oracle.
"""

from __future__ import annotations

import numpy as np

from nbody_torch.config import SimConfig
from nbody_torch.rng import ReferenceDistributions
from nbody_torch.state import SystemState

# 3-D orbiter rotation matrix (models.h:101)
_GALAXY_ROT = np.array(
    [[0.0, -1.0, 0.0], [0.9, 0.0, 0.5], [0.5, 0.0, 0.9]], dtype=np.float64
)


def _use_native() -> bool:
    import os

    if os.environ.get("NBODY_TORCH_NO_NATIVE"):
        return False
    from nbody_torch import native

    return native.available()


def build_uniform_model(n: int, dim: int, dtype, device) -> tuple[SimConfig, SystemState]:
    """Uniform box: mass 1/n, pos & vel ~ U(-1,1)^dim; System(n, dt=1e-1, G=1)
    (models.h:12-28). Per body the stream order is pos[0], vel[0], pos[1],
    vel[1], ... (interleaved per dimension)."""
    cfg = SimConfig(n=n, dim=dim, dtype=dtype, dt=1e-1, G=1.0)
    if _use_native():
        from nbody_torch import native

        m, x, v = native.build_uniform(n, dim)
        return cfg, _to_state(m, x, v, dtype, device)
    dists = ReferenceDistributions(42)
    draws = dists.sym(2 * dim * n).reshape(n, dim, 2)
    m = np.full((n,), 1.0 / n, dtype=np.float64)
    x = draws[:, :, 0]
    v = draws[:, :, 1]
    return cfg, _to_state(m, x, v, dtype, device)


def build_plummer_model(n: int, dim: int, dtype, device) -> tuple[SimConfig, SystemState]:
    """Plummer sphere, 3-D only (models.h:30-71); System(n, dt=1, G=6.674e-11).

    Per body: radius <- unit, p_theta <- acos(sym), p_phi <- angle, then a
    rejection loop drawing (unit, unit) pairs for the velocity magnitude,
    then v_theta <- acos(sym), v_phi <- angle. The rejection loop makes the
    per-body draw count data-dependent, so bodies are built sequentially.
    """
    if dim != 3:
        raise ValueError(f"Cannot build Plummer model for D={dim}")
    cfg = SimConfig(n=n, dim=3, dtype=dtype, dt=1.0, G=6.674e-11)
    if _use_native():
        from nbody_torch import native

        m, x, v = native.build_plummer(n)
        return cfg, _to_state(m, x, v, dtype, device)
    dists = ReferenceDistributions(42)
    m = np.full((n,), 1.0 / n, dtype=np.float64)
    x = np.zeros((n, 3), dtype=np.float64)
    v = np.zeros((n, 3), dtype=np.float64)
    for i in range(n):
        radius = 1.0 / np.sqrt(float(dists.unit(1)[0]) ** (-2.0 / 3.0) - 1.0)
        p_theta = np.arccos(float(dists.sym(1)[0]))
        p_phi = float(dists.angle(1)[0])
        x[i] = radius * np.array(
            [
                np.sin(p_theta) * np.cos(p_phi),
                np.sin(p_theta) * np.sin(p_phi),
                np.cos(p_theta),
            ]
        )
        # rejection sampling for velocity magnitude (models.h:47-53)
        q, g = 0.0, 0.1
        while g > q * q * (1.0 - q * q) ** 3.5:
            q = float(dists.unit(1)[0])
            g = 0.1 * float(dists.unit(1)[0])
        velocity_norm = q * np.sqrt(2.0) * (radius * radius + 1.0) ** -0.25
        v_theta = np.arccos(float(dists.sym(1)[0]))
        v_phi = float(dists.angle(1)[0])
        v[i] = velocity_norm * np.array(
            [
                np.sin(v_theta) * np.cos(v_phi),
                np.sin(v_theta) * np.sin(v_phi),
                np.cos(v_theta),
            ]
        )
    return cfg, _to_state(m, x, v, dtype, device)


def _circular_orbit(dists, count, total_mass, orbit_mass, centre, dim, G, eps):
    """One galaxy's orbiter population (models.h:81-110), vectorized: the
    per-orbiter stream order is fixed -- 2-D: (radius<-unit, angle<-angle);
    3-D: (radius<-unit, angle<-angle, z<-sym, vz<-sym)."""
    if count <= 0:
        return (np.zeros((0,)), np.zeros((0, dim)), np.zeros((0, dim)))
    # Draw the interleaved per-orbiter stream in one block, preserving order:
    per = 2 if dim == 2 else 4
    canon = dists.gen.canonical(per * count).reshape(count, per)
    radius = 30.0 + 20.0 * canon[:, 0]
    angle = canon[:, 1] * (2.0 * np.pi)
    mass = np.full((count,), orbit_mass / count)
    pos = np.zeros((count, dim))
    pos[:, 0] = radius * np.sin(angle)
    pos[:, 1] = radius * np.cos(angle)
    velocity_norm = np.sqrt(G * total_mass / (radius + eps))
    norm = np.sqrt(np.sum(pos * pos, axis=1)) + eps
    vel = np.zeros((count, dim))
    vel[:, 0] = velocity_norm / norm * (-pos[:, 1])
    vel[:, 1] = velocity_norm / norm * (pos[:, 0])
    if dim == 3:
        pos[:, 2] = 10.0 * (canon[:, 2] * 2.0 - 1.0)
        vel[:, 2] = 1e-5 * (canon[:, 3] * 2.0 - 1.0)
        pos = pos @ _GALAXY_ROT.T
        vel = vel @ _GALAXY_ROT.T
    return mass, pos + centre[None, :], vel


def build_galaxy_model(n: int, dim: int, dtype, device) -> tuple[SimConfig, SystemState]:
    """Two colliding spinning galaxies (models.h:112-136);
    System(n, dt=1e1, G=1e-4). Central masses 1e4 and 1e3 at
    +-100*(-1, 1/2), each with int(n/2 - 1) orbiters of total mass 1.
    For odd n the last body stays zero-initialized, exactly like the
    reference's truncating size_t conversions."""
    if dim not in (2, 3):
        raise ValueError(f"Cannot build Galaxy model for D={dim}")
    gal_n = n / 2.0
    size = int(2 * gal_n)
    cfg = SimConfig(n=size, dim=dim, dtype=dtype, dt=1e1, G=1e-4)
    eps = float(np.finfo(np.dtype(dtype)).eps)
    if _use_native():
        from nbody_torch import native

        m, x, v = native.build_galaxy(n, dim, cfg.G, eps)
        return cfg, _to_state(m, x, v, dtype, device)
    dists = ReferenceDistributions(42)

    masses, xs, vs = [], [], []

    centre_mass = 1e4
    offset = 100.0
    for sign in (1.0, -1.0):
        opos = offset * sign * np.array([-1.0, 0.5, 0.0][:dim])
        masses.append(np.array([centre_mass]))
        xs.append(opos[None, :])
        vs.append(np.zeros((1, dim)))
        count = int(gal_n - 1)
        om, ox, ov = _circular_orbit(
            dists, count, centre_mass + 1.0, 1.0, opos, dim, cfg.G, eps
        )
        masses.append(om)
        xs.append(ox)
        vs.append(ov)
        centre_mass /= 10.0

    m = np.zeros((size,), dtype=np.float64)
    x = np.zeros((size, dim), dtype=np.float64)
    v = np.zeros((size, dim), dtype=np.float64)
    filled = int(np.sum([a.shape[0] for a in masses]))
    m[:filled] = np.concatenate(masses)
    x[:filled] = np.concatenate(xs)
    v[:filled] = np.concatenate(vs)
    return cfg, _to_state(m, x, v, dtype, device)


def _to_state(m, x, v, dtype, device) -> SystemState:
    return SystemState.from_numpy(
        m.astype(dtype), x.astype(dtype), v.astype(dtype), dtype=dtype,
        device=device,
    )


def build_model(workload: str, n: int, dim: int, dtype, load_path: str | None = None,
                *, device):
    """Dispatch mirroring run_precision's workload switch (main.cpp:45-57)."""
    if workload == "uniform":
        return build_uniform_model(n, dim, dtype, device)
    if workload == "plummer":
        return build_plummer_model(n, dim, dtype, device)
    if workload == "galaxy":
        return build_galaxy_model(n, dim, dtype, device)
    if workload == "load":
        from nbody_torch.io.saving import load_system

        return load_system(load_path, dim, dtype, device)
    raise ValueError(f'Unknown workload: "{workload}"')
