"""Leapfrog (velocity-Verlet) integrator (the port of nbody_tpu.ops.integrator).

Exact form of System::accelerate_step (src/system.h:52-60):

    x  += dt * v + 0.5 * dt^2 * ao      (uses the PREVIOUS accel ao)
    v  += 0.5 * dt * (a + ao)
    ao  = a

where `a` is the acceleration just produced by the force engine for the
current positions and `ao` is the one from the previous step. A step is
therefore: accel = force(state); state = leapfrog_step(state with a=accel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbody_torch.state import SystemState


def leapfrog_step(state: SystemState, dt: float) -> SystemState:
    """One leapfrog update. x and v are updated IN PLACE (the caller's
    state sees the new values); the returned state shares them and has
    ao = a. The scalar coefficients are rounded in the state's precision,
    as the JAX version computes them, so both give the same bits."""
    scalar = np.float64 if state.x.dtype == torch.float64 else np.float32
    dtv = scalar(dt)
    half = scalar(0.5)
    state.x.add_(float(dtv) * state.v).add_(float(half * dtv * dtv) * state.ao)
    state.v.add_(float(half * dtv) * (state.a + state.ao))
    return dataclasses.replace(state, ao=state.a)
