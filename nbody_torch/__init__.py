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
  ops/          - all-pairs (plain torch, CUDA, the float32 variants and the
                  hybrid tensor-core kernel) and tree forces, leapfrog,
                  energies
  io/           - binary trajectory/energy/state formats (ref: src/saving.h)
  sim/          - engines, step loop, warmup protocol, CSV (ref: run_* loops)
  utils/        - device sync and the seconds-per-step estimator
  experimental/ - the octree's supertile descent (ablate tokens desc1 / desc2)
  parallel/     - --mesh N: the ranks (one process each, torch.distributed),
                  the ring all-pairs and the replicated trees
  cli.py        - python -m nbody_torch.cli
  kernel_bench  - python -m nbody_torch.kernel_bench (scripts/kernel_bench.py)
  probe         - python -m nbody_torch.probe (trace, knobs, sass)

Ported so far: the all-pairs and all-pairs-collapsed algorithms, the
octree and BVH fast paths with their ablation path (the knob probe's
ablate tokens), the trees' list paths (float64) and per-body walks, the
BVH's re-sort cadence and refinement, the all-pairs kernel variants, the
entry-cost probes and the replicated multi-device layouts. The partitioned
layout is still to come (ROADMAP.md).
"""

__version__ = "0.1.0"

from nbody_torch.config import SimConfig, precision_dtype
from nbody_torch.state import SystemState

__all__ = ["SimConfig", "SystemState", "precision_dtype", "__version__"]
