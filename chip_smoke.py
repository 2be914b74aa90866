#!/usr/bin/env python3
"""GPU smoke check of the nbody_torch port. Run from the repo root on a
machine with one NVIDIA Hopper GPU (H100):

    python3 chip_smoke.py

Phases, each printed on its own lines:
  1. the card (nvidia-smi name and power limit) and the CUDA kernels'
     build from nbody_torch/csrc/;
  2. each kernel against its plain torch twin on the card, on the same
     inputs: n = 65,536 in float32 and float64, 2-D and 3-D, both
     softenings, a ragged n and a rectangular block; then both kernels at
     the main path's shape, N = 2^20 3-D float32, timed beside the twin;
  3. the main path at full size through the CLI: an all-pairs run of
     2^20 galaxy bodies in 3-D, and a small run whose final state must
     match the CPU's;
  4. energies and saving: a 65,536-body 2-D galaxy with --csv-detailed
     --save all, checked through energy.bin and positions.bin.
The kernels' launch counts are set to 0 just before each CLI run that
drives the main path and read just after it: the force kernel's from the
2^20 run of phase 3, the potential kernel's from the run of phase 4 (the
2^20 --csv-total run computes no energies). Launches made to compare a
kernel with its twin, and those of the small run, do not count.

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a GPU, or if any phase
fails, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
# Per-row tolerance of a kernel against its twin, as a fraction of the row's
# sum of |term|: both sum the same terms in different orders, so they
# differ by a few ulps of that sum, times ~sqrt of the terms per partial sum.
TOL = {"float32": 1e-5, "float64": 1e-12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA GPU.",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from nbody_torch import _build, cli
    from nbody_torch.ops import cuda_allpairs as ca

    dev = torch.device("cuda", 0)

    # -- phase 1: card and build -------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({'already built' if cached else 'nvcc ' + ' '.join(_build.NVCC_FLAGS)}) "
          f"-> {_build.library_path().name}")

    # -- phase 2: kernels vs plain twins -----------------------------------
    rng = np.random.default_rng(SEED)

    def bodies(n, dim, dtype):
        m = torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dtype, device=dev)
        x = torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=dtype, device=dev)
        return m, x

    def scaled(got, ref, scale):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "kernel output is not finite")
        err = ((got - ref).abs() / scale.clamp_min(torch.finfo(scale.dtype).tiny)).max().item()
        return err, (got - ref).abs().max().item()

    def report(label, dtype, err):
        tol = TOL[str(dtype).split(".")[-1]]
        print(f"[2] {label}: max |kernel - plain| / sum|term| = {err:.3e} (limit {tol:g})")
        check(err <= tol, f"{label}: scaled error {err:.3e} above {tol:g}")

    n = 65536
    for dtype in (torch.float32, torch.float64):
        for dim in (2, 3):
            m, x = bodies(n, dim, dtype)
            for soft in ("poly", "sqrt3"):
                got = ca.allpairs_block_cuda(x, m, x, eps_of(dtype), soft)
                ref = ca.allpairs_block_torch(x, m, x, eps_of(dtype), soft)
                scale = ca.allpairs_block_abs_torch(x, m, x, eps_of(dtype), soft)
                report(f"block {soft} {dim}-D {dtype} n={n}", dtype,
                       scaled(got, ref, scale)[0])
            got = ca.potential_rowsums_cuda(m, x, eps_of(dtype))
            ref = ca.potential_rowsums_torch(m, x, eps_of(dtype))
            report(f"potential {dim}-D {dtype} n={n}", dtype, scaled(got, ref, ref.abs())[0])
    # ragged edges: n not a multiple of the 256-row block, and ni != nj
    for dtype in (torch.float32, torch.float64):
        mj, xj = bodies(n + 37, 3, dtype)
        xi = xj[:4099].contiguous()
        got = ca.allpairs_block_cuda(xi, mj, xj, eps_of(dtype), "poly")
        ref = ca.allpairs_block_torch(xi, mj, xj, eps_of(dtype), "poly")
        scale = ca.allpairs_block_abs_torch(xi, mj, xj, eps_of(dtype), "poly")
        report(f"block poly 3-D {dtype} ni=4099 nj={n + 37}", dtype, scaled(got, ref, scale)[0])
        G = 6.674e-11
        got = ca.allpairs_accel_cuda(mj, xj, G, eps_of(dtype))
        ref = G * ca.allpairs_block_torch(xj, mj, xj, eps_of(dtype))
        scale = G * ca.allpairs_block_abs_torch(xj, mj, xj, eps_of(dtype))
        report(f"accel (G={G}) 3-D {dtype} n={n + 37}", dtype, scaled(got, ref, scale)[0])
        got = ca.potential_rowsums_cuda(mj, xj, eps_of(dtype))
        ref = ca.potential_rowsums_torch(mj, xj, eps_of(dtype))
        report(f"potential 3-D {dtype} n={n + 37}", dtype, scaled(got, ref, ref.abs())[0])

    # the main path's shape: N = 2^20, 3-D, float32
    big = 1 << 20
    m, x = bodies(big, 3, torch.float32)
    eps = eps_of(torch.float32)
    kernels = {}
    for name, kern, plain, scale_fn in (
        ("allpairs_block_kernel",
         lambda: ca.allpairs_accel_cuda(m, x, 1.0, eps),
         lambda: ca.allpairs_block_torch(x, m, x, eps),
         lambda: ca.allpairs_block_abs_torch(x, m, x, eps)),
        ("potential_rowsums_kernel",
         lambda: ca.potential_rowsums_cuda(m, x, eps),
         lambda: ca.potential_rowsums_torch(m, x, eps),
         None),
    ):
        got = kern()  # warm-up launch
        ms = event_ms(kern, reps=3)
        plain_ms, ref = event_ms(plain, reps=1, keep=True)
        scale = ref.abs() if scale_fn is None else scale_fn()
        err, abs_err = scaled(got, ref, scale)
        report(f"{name} at N=2^20 3-D float32 (kernel {ms:.1f} ms, plain {plain_ms:.1f} ms)",
               torch.float32, err)
        kernels[name] = {"max_abs_err": abs_err, "max_scaled_err": err,
                         "scaled_err_limit": TOL["float32"], "ms": ms, "plain_ms": plain_ms}
        del got, ref, scale
    del m, x
    torch.cuda.empty_cache()

    # -- phase 3: the main path at full size -------------------------------
    ca.reset_launch_counts()
    argv = ["-n", str(big), "-s", "12", "-d", "3", "--algorithm", "all-pairs",
            "--workload", "galaxy", "--device", "cuda", "--csv-total"]
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    phase3_launches = dict(ca.launch_counts)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 2, f"CLI run failed: rc={rc}, output {lines!r}")
    check(lines[0] == "algorithm,dim,precision,nsteps,nbodies,total [s]", f"header {lines[0]!r}")
    fields = lines[1].split(",")
    check(fields[:5] == ["all-pairs", "3", "32", "2", str(big)], f"CSV row {lines[1]!r}")
    total = float(fields[5])
    force_launches = phase3_launches["allpairs_block_kernel"]
    check(force_launches >= 12, f"force kernel launched {force_launches} times, expected >= 12")
    per_step = total / 2
    rate = big * (big - 1) * 2 / total if total > 0 else float("inf")
    print(f"[3] python -m nbody_torch.cli {' '.join(argv)}")
    print(f"[3]   {lines[1]}  ->  {per_step:.3f} s/step, {rate:.4e} interactions/s "
          f"(N(N-1)*nsteps/total); wall {wall:.1f} s with model build and warmup; "
          f"force kernel launches {force_launches}")

    # small input: the same path on the card and on the CPU (plain twins)
    with tempfile.TemporaryDirectory() as tmp:
        finals = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"final_{device}.bin")
            cli.main(["-n", "2048", "-s", "12", "-d", "3", "--algorithm", "all-pairs",
                      "--workload", "galaxy", "--precision", "double", "--device", device,
                      "--csv-total", "--save-state", path], out=io.StringIO())
            finals[device] = read_state(path)
    gpu, cpu = finals["cuda"], finals["cpu"]
    check(gpu.shape == (2048, 7) and bool(np.isfinite(gpu).all()), "final state malformed")
    # per column (m, x, v): float32 files of float64 states that agree to
    # ~1e-15 differ by at most one float32 ulp of the column's largest value
    diff = float((np.abs(gpu - cpu).max(axis=0) / np.abs(cpu).max(axis=0)).max())
    print(f"[3] 2048-body 3-D galaxy, 12 steps in float64: final state on the card vs "
          f"the CPU twins, max over columns of max |diff| / max |value| = {diff:.3e} "
          f"(limit 1e-6)")
    check(diff <= 1e-6, "card and CPU final states differ")

    # -- phase 4: energies and saving ----------------------------------------
    n4 = 65536
    with tempfile.TemporaryDirectory() as tmp:
        here = os.getcwd()
        os.chdir(tmp)
        try:
            out = io.StringIO()
            ca.reset_launch_counts()
            cli.main(["-n", str(n4), "-s", "3", "-d", "2", "--algorithm", "all-pairs",
                      "--workload", "galaxy", "--device", "cuda", "--csv-detailed",
                      "--save", "all"], out=out)
            phase4_launches = dict(ca.launch_counts)
            energy = Path("energy.bin").read_bytes()
            positions = Path("positions.bin").read_bytes()
        finally:
            os.chdir(here)
    row = out.getvalue().strip().splitlines()[-1].split(",")
    check(row[:5] == ["all-pairs", "2", "32", "3", str(n4)] and len(row) == 8,
          f"detailed CSV row {row!r}")
    pe_launches = phase4_launches["potential_rowsums_kernel"]
    check(pe_launches >= 4, f"potential kernel launched {pe_launches} times, expected >= 4")
    check(struct.unpack("<II", energy[:8]) == (3, 4), "energy.bin header")
    e = np.frombuffer(energy[8:], np.float32).reshape(-1, 2)
    check(e.shape == (4, 2) and bool(np.isfinite(e).all()), f"energy records {e!r}")
    check(struct.unpack("<IIII", positions[:16]) == (n4, 3, 4, 2)
          and len(positions) == 16 + 4 * n4 * 2 * 4, "positions.bin header or length")
    tot = e.sum(axis=1).astype(np.float64)
    drift = abs(tot[-1] - tot[0]) / abs(tot[0])
    print(f"[4] {n4}-body 2-D galaxy, 3 steps, --csv-detailed --save all: "
          f"{','.join(row)}; E0 = {tot[0]:.6e}, E3 = {tot[-1]:.6e}, "
          f"relative drift {drift:.3e} (limit 1e-3); potential kernel launches {pe_launches}")
    check(drift <= 1e-3, "energy drift too large")

    entries = []
    for name, replaces, launches, run in (
        ("allpairs_block_kernel", "nbody_tpu/ops/pallas_allpairs.py:113", phase3_launches,
         f"phase 3: {big}-body 3-D all-pairs --csv-total"),
        ("potential_rowsums_kernel", "nbody_tpu/ops/pallas_allpairs.py:255", phase4_launches,
         f"phase 4: {n4}-body 2-D all-pairs --csv-detailed --save all"),
    ):
        check(launches[name] > 0, f"{name} was not launched on the main path")
        entries.append({"name": name, "route": "cuda", "source": "nbody_torch/csrc/allpairs.cu",
                        "replaces": replaces, "launches": launches[name], "launches_in": run,
                        **kernels[name], "n": big, "dim": 3, "dtype": "float32"})
    entries[0]["also_replaces"] = "nbody_tpu/ops/pallas_allpairs.py:181"
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def eps_of(dtype) -> float:
    import torch

    return float(torch.finfo(dtype).eps)


def event_ms(fn, reps: int, keep: bool = False):
    """Mean milliseconds of `reps` calls of fn, timed with CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    return (ms, out) if keep else ms


def read_state(path: str) -> np.ndarray:
    """The loadable state format (nbody_torch.io.saving): (n, 1 + 2*dim) float32."""
    with open(path, "rb") as f:
        n, dim = struct.unpack("<II", f.read(8))
        f.read(8)
        return np.frombuffer(f.read(), np.float32).reshape(n, 1 + 2 * dim)


if __name__ == "__main__":
    sys.exit(main())
