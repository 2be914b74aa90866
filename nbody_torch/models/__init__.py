"""Workload generators (ref: src/models.h)."""

from nbody_torch.models.builders import (
    build_galaxy_model,
    build_plummer_model,
    build_uniform_model,
    build_model,
)

__all__ = [
    "build_uniform_model",
    "build_plummer_model",
    "build_galaxy_model",
    "build_model",
]
