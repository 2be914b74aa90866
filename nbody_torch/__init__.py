"""nbody_torch: the PyTorch + CUDA port of nbody_tpu, for NVIDIA Hopper GPUs.

It keeps nbody_tpu's module layout and function names, so each module has a
counterpart there; nbody_tpu stays the reference the port is tested against.
It imports torch and never jax. Kernels that nbody_tpu wrote in Pallas are
hand-written CUDA here (csrc/), built by _build.py at first use, each with
a plain torch twin that runs for CPU tensors.

Layer map:
  config/state  - static sim config + SoA body-state dataclass of tensors
  rng, native   - bit-exact std::mt19937 stream; ctypes bridge to native/
  models/       - workload generators (ref: src/models.h)
  ops/          - all-pairs and octree forces (plain torch and CUDA), leapfrog,
                  energies
  io/           - binary trajectory/energy/state formats (ref: src/saving.h)
  sim/          - engines, step loop, warmup protocol, CSV (ref: run_* loops)
  cli.py        - python -m nbody_torch.cli

Ported so far: the all-pairs and all-pairs-collapsed algorithms, and the
octree's fast path. The BVH, the octree's list paths and the multi-device
layouts are still to come (ROADMAP.md).
"""

__version__ = "0.1.0"

from nbody_torch.config import SimConfig, precision_dtype
from nbody_torch.state import SystemState

__all__ = ["SimConfig", "SystemState", "precision_dtype", "__version__"]
