"""Device-side probes of the main paths, for a machine with a CUDA GPU.

    python -m nbody_torch.probe trace [-n N] [-d DIM] [--steps K] [--algorithm A]
                                      [--precision float|double]
        Builds an N-body galaxy (default 2^20, 3-D, float32; double takes
        the trees' list paths), runs one untimed step of algorithm A
        (default all-pairs; or octree, bvh) through the engine, then K
        steps (default 3) under torch.profiler. Prints
        the kernel table, the wall time of the K steps, the summed device
        kernel time, the device idle share 1 - kernel time / wall, the
        peak device memory of the K steps, and the host synchronisations
        of one more step (CUDA's sync debug mode).

    python -m nbody_torch.probe sass OUT.txt
        Compiles each nbody_torch/csrc/*.cu to a cubin with the build's
        nvcc flags and writes `cuobjdump -sass` of them to OUT.txt, for
        counting the instructions per pair of each kernel instantiation.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
import warnings


def trace(n: int, dim: int, steps: int, algorithm: str, precision: str = "float") -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nbody_torch.config import precision_dtype
    from nbody_torch.models import build_model
    from nbody_torch.sim.engines import EngineOptions, get_engine

    dev = torch.device("cuda", 0)
    cfg, s = build_model("galaxy", n, dim, precision_dtype(precision), device=dev)
    step = get_engine(algorithm).make_step(cfg, EngineOptions(), dev)
    s, _ = step(s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            s, _ = step(s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e6
    peak = torch.cuda.max_memory_allocated() / 2**30
    # one more step with CUDA's sync debug mode on: every operation that
    # makes the host wait for the device warns once per call
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s, _ = step(s)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    print(f"{algorithm}, {n} bodies, {dim}-D {np.dtype(cfg.dtype).name}, {steps} steps: "
          f"wall {wall:.4f} s, device "
          f"kernel time {busy:.4f} s, idle share {1 - busy / wall:.4f}, {len(events)} kernels, "
          f"peak memory {peak:.2f} GiB; host synchronisations in one step: {len(syncs)} {syncs}")


def sass(out: str) -> None:
    from nbody_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    nvcc = _build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with open(out, "w") as f:
        for src in _build.sources():
            cubin = _build.BUILD_DIR / f"probe.{src.stem}.cubin"
            subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)], check=True)
            f.flush()
            subprocess.run([cuobjdump, "-sass", str(cubin)], stdout=f, check=True)
    print(f"wrote {out}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m nbody_torch.probe")
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace", help="profile K steps; print the idle share")
    t.add_argument("-n", type=int, default=1 << 20)
    t.add_argument("--algorithm", choices=("all-pairs", "octree", "bvh"), default="all-pairs")
    t.add_argument("-d", "--dim", type=int, default=3)
    t.add_argument("--steps", type=int, default=3)
    t.add_argument("--precision", choices=("float", "double"), default="float")
    s = sub.add_parser("sass", help="write the kernels' SASS to a file")
    s.add_argument("out")
    args = parser.parse_args(argv)
    if args.cmd == "trace":
        trace(args.n, args.dim, args.steps, args.algorithm, args.precision)
    else:
        sass(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
