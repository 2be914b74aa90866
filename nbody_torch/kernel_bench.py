"""All-pairs kernel throughput (the port of scripts/kernel_bench.py).

    python -m nbody_torch.kernel_bench [--n 1048576] [--dims 2,3]
        [--kernels newton,exact,fast] [--repeats 3] [--device auto|cpu|cuda]

Kernels: `exact`, `newton` and `fast` are the float32 instantiations of
allpairs_block_kernel (ops.cuda_allpairs.allpairs_accel_cuda with
exact=True, exact=False, and exact=False with fast=True); `mxu` and
`mxu-fast` the hybrid kernel (ops.cuda_allpairs_mxu, mxu-fast with
far_thresh 1e-2, as scripts/kernel_bench.py:60-64); `torch` the plain
ops.allpairs.allpairs_accel, in place of nbody_tpu's `jnp`.

The inputs are nbody_tpu's, bit for bit: numpy's default_rng(0), masses
U(0.1, 1) and positions U(-1, 1) in float32, unsorted; the timed unit is
a chain of force evaluations c <- c + 1e-12 a(c), and utils.measure takes
its seconds per step. Prints one JSON line per (kernel, dim) with
nbody_tpu's keys (kernel, dim, n, sec_per_step, int_per_s), plus the
device and the kernel launches of that configuration. A configuration
that fails ends the run with a nonzero exit; every configuration runs in
this process (nbody_tpu's one process per configuration guarded against
TPU worker crashes).

The default device is the GPU: without one, --device auto and cuda exit
1; --device cpu runs the plain twins on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

KERNELS = ("torch", "exact", "newton", "fast", "mxu", "mxu-fast")
ITERS_SHORT = 2
ITERS_LONG = 10


def inputs(n: int, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """(m, x) as scripts/kernel_bench.py:83-86 makes them."""
    rng = np.random.default_rng(0)
    m = rng.uniform(0.1, 1.0, n).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32)
    return m, x


def accel_fn(kernel: str, eps: float):
    """a(m, x) of one kernel name, G = 1."""
    from nbody_torch.ops.allpairs import allpairs_accel
    from nbody_torch.ops.cuda_allpairs import allpairs_accel_cuda
    from nbody_torch.ops.cuda_allpairs_mxu import allpairs_accel_mxu_cuda

    calls = {
        "torch": lambda m, x: allpairs_accel(m, x, 1.0, eps),
        "exact": lambda m, x: allpairs_accel_cuda(m, x, 1.0, eps, exact=True),
        "newton": lambda m, x: allpairs_accel_cuda(m, x, 1.0, eps, exact=False),
        "fast": lambda m, x: allpairs_accel_cuda(m, x, 1.0, eps, exact=False, fast=True),
        "mxu": lambda m, x: allpairs_accel_mxu_cuda(m, x, 1.0, eps),
        "mxu-fast": lambda m, x: allpairs_accel_mxu_cuda(m, x, 1.0, eps, fast=True,
                                                         far_thresh=1e-2),
    }
    return calls[kernel]


def _modules():
    from nbody_torch.ops import cuda_allpairs, cuda_allpairs_mxu, cuda_variant_decide

    return cuda_allpairs, cuda_allpairs_mxu, cuda_variant_decide


def reset_launch_counts() -> None:
    for module in _modules():
        module.reset_launch_counts()


def launches() -> dict[str, int]:
    """The nonzero launch counts of the all-pairs kernels and of the
    variants' decision kernels."""
    counts = {name: c for module in _modules() for name, c in module.launch_counts.items()}
    return {name: c for name, c in counts.items() if c}


def measure(kernel: str, n: int, dim: int, repeats: int, device) -> dict:
    import torch

    from nbody_torch.utils.measure import scan_seconds_per_step

    eps = float(np.finfo(np.float32).eps)
    m_np, x_np = inputs(n, dim)
    m, x = torch.tensor(m_np, device=device), torch.tensor(x_np, device=device)
    accel = accel_fn(kernel, eps)

    def loop(m, x, iters):
        c = x
        for _ in range(iters):
            c = c + 1e-12 * accel(m, c)
        return c

    reset_launch_counts()
    dt = scan_seconds_per_step(loop, (m, x), device, ITERS_SHORT, ITERS_LONG, repeats)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"kernel": kernel, "dim": dim, "n": n, "sec_per_step": dt,
            "int_per_s": n * (n - 1) / dt, "device": name, "launches": launches()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nbody_torch.kernel_bench")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dims", default="2,3")
    ap.add_argument("--kernels", default="newton,exact,fast")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", choices=("auto", "cpu", "cuda"), default="auto")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    unknown = [k for k in kernels if k not in KERNELS]
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose from {','.join(KERNELS)}")
    dims = [int(d) for d in args.dims.split(",")]
    if any(d not in (2, 3) for d in dims):
        ap.error(f"--dims takes 2 and 3, got {args.dims}")

    from nbody_torch.cli import resolve_device

    device = resolve_device(args.device)
    for kernel in kernels:
        for dim in dims:
            print(json.dumps(measure(kernel, args.n, dim, args.repeats, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
