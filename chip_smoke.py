#!/usr/bin/env python3
"""GPU smoke check of the nbody_torch port. Run from the repo root on a
machine with one NVIDIA Hopper GPU (H100):

    python3 chip_smoke.py

Phases, each printed on its own lines:
  1. the card (nvidia-smi name and power limit) and the CUDA kernels'
     build from nbody_torch/csrc/;
  2. the all-pairs kernels against their plain torch twins on the card,
     on the same inputs: n = 65,536 in float32 and float64, 2-D and 3-D,
     both softenings, a ragged n and a rectangular block; then both
     kernels at the main path's shape, N = 2^20 3-D float32, timed beside
     the twin;
  3. the all-pairs main path at full size through the CLI: 2^20 galaxy
     bodies in 3-D, and a small run whose final state must match the CPU's;
  4. energies and saving: a 65,536-body 2-D galaxy with --csv-detailed
     --save all, checked through energy.bin and positions.bin;
  5. the octree fast path (the CLI's default algorithm):
     a. one octree force evaluation of a 2^20-body galaxy, in 3-D and in
        2-D, whose far, window and entries kernel calls are recorded; each
        kernel is then run again on its recorded inputs and timed beside
        its plain twin;
     b. the CLI at full size, -n 1048576 -s 12 --algorithm octree in 3-D
        and in 2-D;
     c. the 3-D force of (a) against the sqrt3 all-pairs kernel on the
        same sorted bodies (sanity bounds on the relative error);
     d. a 17,000-body 3-D evaluation on the card and through the CPU
        twins: equal counters, forces within 1e-5 of sum |a|;
  6. the BVH fast path (--algorithm bvh):
     a. one BVH force evaluation of a 2^20-body galaxy, in 3-D and in 2-D,
        whose far, node-mask window and entries kernel calls are recorded
        and re-run as in 5a, each timed beside its twin; the dense-mask
        window, which the BVH reaches only at n <= 16, is timed on a
        synthetic 2^20 window built from the node-mask window's slots and
        on the inputs of an n = 16 evaluation;
     b. the CLI at full size, -n 1048576 -s 12 --algorithm bvh in 3-D and
        in 2-D;
     c. the 3-D force of (a) against the poly all-pairs kernel on the same
        Hilbert-sorted bodies (the sanity bounds of 5c);
     d. a 17,000-body 3-D evaluation with a window of 2 tiles and a small
        e_chunk, so that the residual and the exact fallback run, on the
        card and through the CPU twins: equal counters, forces within 1e-5
        of sum |a|;
     e. the small path, -n 10 -s 5 --algorithm bvh --theta 0, on the card
        (through the dense-mask window) and on the CPU: the same final
        state, in the same body order.
Every kernel call that 5a and 6a time prints its pair count, the pairs
its inputs need (all-pairs N(N-1); a window the columns it visits times
the rows; entries sum(hi - lo) times the rows; the far field the set
accept bits times the rows), and the bound: the larger of those pairs
times the FLOPs per pair (5*dim + 3 for a force, one more under sqrt3,
3*dim + 3 for the potential; a square root and a division counted as
one each) over the H100's 67 TFLOP/s in
float32, and the bytes (each input read once, the output written once)
over its 3.35 TB/s. No single PyTorch call computes a softened gravity
sum (torch.cdist gives distances, not forces), so library_ms is null.
The kernels' launch counts are set to 0 just before each CLI run that
drives a main path and read just after it: the all-pairs force kernel's
from the 2^20 run of phase 3, the potential kernel's from the run of
phase 4 (the 2^20 --csv-total run computes no energies), the octree
kernels' from the 3-D run of phase 5b, the BVH's far, node-mask and
entries kernels' from the 3-D run of phase 6b and the dense-mask
window's from the small run of phase 6e (the 2-D runs' counts and the
fallback launches of the all-pairs kernel are reported beside them).
Launches made to compare a kernel with its twin, and those of the other
small runs, do not count.

The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. Without a GPU, or if any phase
fails, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import contextlib
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


def scaled(got, ref, scale):
    """(max |got - ref| / scale, max |got - ref|) once the card is done;
    fails on a non-finite kernel output."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    err = ((got - ref).abs() / scale.clamp_min(torch.finfo(scale.dtype).tiny)).max().item()
    return err, (got - ref).abs().max().item()


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
        pairs = big * (big - 1)
        flops = flops_per_pair(3, "poly") if name == "allpairs_block_kernel" else 3 * 3 + 3
        nbytes = big * 4 * (3 + 1) + big * 4 * (3 if name == "allpairs_block_kernel" else 1)
        bound_ms, bound_by = bound(pairs, flops, nbytes)
        print(f"[2] {name}: {pairs} pairs, {flops} FLOPs per pair, bound {bound_ms:.3f} ms "
              f"({bound_by})")
        kernels[name] = {"max_abs_err": abs_err, "max_scaled_err": err,
                         "scaled_err_limit": TOL["float32"], "ms": ms, "plain_ms": plain_ms,
                         "pairs": pairs, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
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

    octree_kernels, octree_fallback = octree_phases(dev, big)
    bvh_kernels, bvh_fallback = bvh_phases(dev, big)

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
    entries[0]["octree_fallback_launches"] = octree_fallback  # sqrt3
    entries[0]["bvh_fallback_launches"] = bvh_fallback        # poly
    print(json.dumps({"kernels": entries + octree_kernels + bvh_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores, HBM3
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
GROUP_EVAL = "nbody_torch/csrc/group_eval.cu"
PALLAS_GROUP_EVAL = "nbody_tpu/ops/pallas_group_eval.py"


def flops_per_pair(dim: int, softening: str) -> int:
    """dim subtractions, 2*dim - 1 for d2, the square root, the softening
    (poly: a multiply and an add; sqrt3: an add and two multiplies), the
    division, and 2*dim to accumulate the weighted separation."""
    return 5 * dim + 3 + (softening == "sqrt3")


def bound(pairs: int, flops: int, nbytes: int):
    """(least milliseconds the card could take, what bounds it)."""
    t_ops, t_bytes = pairs * flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def pairs_of(name: str, args) -> int:
    """The (row, source) pairs a group kernel's inputs need: the rows of a
    tile times the sources it visits that can add to its rows. A source of
    mass 0 (padding, a dead node) or of mask weight 0 adds exactly 0
    (0 * m / t with t >= eps > 0), so it is not counted."""
    import torch

    from nbody_torch.ops import cuda_group_eval as cg

    xi, mj = args[0], args[1]
    nj = mj.shape[0]
    live = mj != 0
    if name.startswith("masked_eval_bits"):
        words = args[3]
        return int((cg.unpack_mask_bits(words, nj) & live).sum()) * (xi.shape[0] // words.shape[0])

    def in_ranges(a, b):  # live sources in [a, b), summed over the ranges
        ends = torch.cat([live.new_zeros(1, dtype=torch.int64), live.long().cumsum(0)])
        a, b = a.clamp(0, nj), b.clamp(0, nj)
        return int((ends[b] - ends[torch.minimum(a, b)]).sum())

    if name.startswith("entries_lohi"):
        ent, lohi, n_real, S = args[3], args[4], int(args[5]), args[6]
        tb = xi.shape[0] // args[7]
        base = (ent[:n_real].long() & 0xFFFF) * S
        lohi = lohi[:n_real].long()
        return in_ranges(base + (lohi & 0xFFFF), base + ((lohi >> 16) & 0xFFFF)) * tb
    w0 = args[3].long()
    tb = xi.shape[0] // w0.shape[0]
    if name == "window_eval_interval_kernel":
        lo, hi, wt = args[4].long(), args[5].long(), args[7]
        return in_ranges(torch.maximum(lo, w0 * tb), torch.minimum(hi, (w0 + wt) * tb)) * tb
    if name not in ("window_eval_nodemask_kernel", "window_eval_dense_kernel"):
        raise ValueError(name)
    mask = args[4]
    wb = mask.shape[1] * (args[7] if name == "window_eval_nodemask_kernel" else 1)
    cols = w0[:, None] * tb + torch.arange(wb, device=w0.device)
    inside = cols < nj
    cols = cols.clamp_max(nj - 1)
    if name == "window_eval_nodemask_kernel":  # the live bodies of the open S-body slots
        keep = mask.repeat_interleave(args[7], dim=1) & live[cols]
    else:  # the columns whose weight mask[t, c] * m_j is nonzero
        keep = mask * mj[cols] != 0
    return int((keep & inside).sum()) * tb


def bytes_of(args) -> int:
    """Each distinct input tensor read once, the (rows, dim) output written once."""
    import torch

    seen = {t.data_ptr(): t.numel() * t.element_size()
            for t in args if isinstance(t, torch.Tensor)}
    return sum(seen.values()) + args[0].numel() * args[0].element_size()


def measure(tag: str, name: str, kern, twin, args, dim: int, softening: str) -> dict:
    """Time kernel `name` (5 launches after a warm-up, CUDA events) and its
    twin (one call) on the recorded args; hold it against the twin and
    both against the twin in float64, as fractions of sum |term|; count
    its pairs and compute its bound. Fails above 1e-5."""
    import torch

    got = kern(*args)  # warm-up launch
    kms = event_ms(lambda: kern(*args), reps=5)
    plain_ms, ref = event_ms(lambda: twin(*args), reps=1, keep=True)
    scale = twin(*args, absolute=True)
    err, abs_err = scaled(got, ref, scale)
    ref64 = twin(*(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                   for a in args))
    err64 = [scaled(v, ref64, scale)[0] for v in (got, ref)]
    pairs, flops = pairs_of(name, args), flops_per_pair(dim, softening)
    bound_ms, bound_by = bound(pairs, flops, bytes_of(args))
    print(f"[{tag}] {name}<{softening}>: kernel {kms:.3f} ms, plain {plain_ms:.1f} ms; max |kernel - "
          f"plain| / sum|term| = {err:.3e} (limit 1e-5); against float64: kernel {err64[0]:.3e}, "
          f"plain {err64[1]:.3e}; {pairs} pairs ({pairs / (kms * 1e-3):.4e} pairs/s), bound "
          f"{bound_ms:.3f} ms ({bound_by}, {flops} FLOPs per pair)")
    check(err <= 1e-5, f"{tag} {name}: scaled error {err:.3e} above 1e-5")
    check(err64[0] <= 1e-5, f"{tag} {name}: scaled error against float64 {err64[0]:.3e} above 1e-5")
    return {"ms": kms, "plain_ms": plain_ms, "max_abs_err": abs_err, "max_scaled_err": err,
            "max_scaled_err_vs_float64": err64[0], "pairs": pairs, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


@contextlib.contextmanager
def recording(module, attrs):
    """Wrap module.<attr> for each attr so that each call's positional
    args are kept (the last call's, by attr) while the call goes through."""
    recorded = {}
    saved = {attr: getattr(module, attr) for attr in attrs}

    def wrap(attr, fn):
        def call(*args):
            recorded[attr] = args
            return fn(*args)
        return call

    for attr in attrs:
        setattr(module, attr, wrap(attr, saved[attr]))
    try:
        yield recorded
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)


def cli_full_size(algorithm: str, dim: int, big: int, tag: str) -> dict:
    """-n big -s 12 --csv-total through the CLI on the card, with the
    launch counts set to 0 just before and read just after."""
    from nbody_torch import cli
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    ca.reset_launch_counts()
    cg.reset_launch_counts()
    argv = ["-n", str(big), "-s", "12", "-d", str(dim), "--algorithm", algorithm,
            "--workload", "galaxy", "--device", "cuda", "--csv-total"]
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    launches = {**cg.launch_counts, "allpairs_block_kernel": ca.launch_counts["allpairs_block_kernel"]}
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 2 and lines[0] == "algorithm,dim,precision,nsteps,nbodies,"
          "total [s]", f"{algorithm} CLI run failed: rc={rc}, output {lines!r}")
    fields = lines[1].split(",")
    check(fields[:5] == [algorithm, str(dim), "32", "2", str(big)], f"CSV row {lines[1]!r}")
    print(f"[{tag}] python -m nbody_torch.cli {' '.join(argv)}")
    print(f"[{tag}]   {lines[1]}  ->  {float(fields[5]) / 2:.4f} s/step; wall {wall:.1f} s with "
          f"model build and warmup; launches {launches}")
    return launches


OCTREE_KERNELS = {  # name -> (wrapper in ops.cuda_group_eval, twin, Pallas function replaced)
    "masked_eval_bits_kernel": ("masked_eval_bits_cuda", "masked_eval_bits_torch",
                                f"{PALLAS_GROUP_EVAL}:310"),
    "window_eval_interval_kernel": ("window_eval_interval_cuda", "window_eval_interval_torch",
                                    f"{PALLAS_GROUP_EVAL}:502"),
    "entries_lohi_kernel": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch",
                            f"{PALLAS_GROUP_EVAL}:963"),
}


def octree_phases(dev, big: int):
    """Phase 5: the octree fast path at 2^20. Returns the JSON entries of
    its three kernels and the all-pairs kernel's fallback launches in the
    CLI runs, by dimension."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.ops import octree
    from nbody_torch.ops import octree_group as og

    eps = eps_of(torch.float32)
    measured = {name: {} for name in OCTREE_KERNELS}
    wrappers = [attr for attr, _, _ in OCTREE_KERNELS.values()]

    # -- (a) one real evaluation per dimension, its kernel inputs recorded
    for dim in (3, 2):
        cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
        depth = octree.max_depth(big, dim)
        lo, hi = octree.robust_quant_box(state.x)
        ms, xs, ks, _ = octree.morton_sort(state.m, state.x, lo, hi, depth)
        del state
        with recording(og, wrappers) as recorded:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            a, info = og.compute_force_grouped_fast(ms, xs, ks, depth, cfg.theta, cfg.G, cfg.eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        counters = {k: int(v) for k, v in info.items()}
        print(f"[5a] {big}-body {dim}-D galaxy, one octree force evaluation: {wall:.3f} s wall "
              f"(first call), peak memory above its inputs {peak:.2f} GiB; {counters}")
        check(bool(torch.isfinite(a).all()), "octree force is not finite")
        check(set(recorded) == set(wrappers), f"kernels called: {sorted(recorded)}")
        for name, (attr, twin_attr, _) in OCTREE_KERNELS.items():
            measured[name][dim] = measure(f"5a {dim}-D", name, getattr(cg, attr),
                                          getattr(cg, twin_attr), recorded[attr], dim, "sqrt3")
        del recorded
        if dim == 3:
            # -- (c) the 3-D force against the exact sqrt3 sum on the same bodies
            ref = cfg.G * ca.allpairs_block_cuda(xs, ms, xs, eps, "sqrt3")
            accuracy("5c", "octree vs sqrt3 all-pairs", big, a, ref)
            del ref
        del a, ms, xs, ks
        torch.cuda.empty_cache()

    # -- (b) the CLI at full size; counts from 0 just before each run ------
    launches = {dim: cli_full_size("octree", dim, big, "5b") for dim in (3, 2)}
    for dim in (3, 2):
        for name in OCTREE_KERNELS:
            check(launches[dim][name] > 0, f"{name} was not launched in the {dim}-D octree run")

    # -- (d) 17,000 bodies, 3-D: the card against the CPU twins -------------
    m, x = clusters(17000, 3)
    depth = octree.max_depth(17000, 3)
    runs = []
    for device in (dev, torch.device("cpu")):
        lo, hi = octree.robust_quant_box(torch.tensor(x, device=device))
        ms, xs, ks, _ = octree.morton_sort(torch.tensor(m, device=device),
                                           torch.tensor(x, device=device), lo, hi, depth)
        a, info = og.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, eps)
        runs.append((a.cpu(), {k: int(v) for k, v in info.items()}))
    card_vs_cpu("5d", "17000-body 3-D clusters", runs)

    entries = []
    for name, (_, _, replaces) in OCTREE_KERNELS.items():
        entries.append({"name": f"{name}<sqrt3>", "route": "cuda", "source": GROUP_EVAL,
                        "replaces": replaces, "launches": launches[3][name],
                        "launches_in": f"phase 5b: {big}-body 3-D octree --csv-total",
                        **measured[name][3], "n": big, "dim": 3, "dtype": "float32",
                        "launches_2d": launches[2][name], "2d": measured[name][2]})
    return entries, {dim: launches[dim]["allpairs_block_kernel"] for dim in (3, 2)}


BVH_KERNELS = {  # name -> (wrapper, twin, Pallas function replaced)
    "masked_eval_bits_kernel": ("masked_eval_bits_cuda", "masked_eval_bits_torch",
                                f"{PALLAS_GROUP_EVAL}:310"),
    "window_eval_nodemask_kernel": ("window_eval_nodemask_cuda", "window_eval_nodemask_torch",
                                    f"{PALLAS_GROUP_EVAL}:614"),
    "entries_lohi_kernel": ("entries_lohi_eval_cuda", "entries_lohi_eval_torch",
                            f"{PALLAS_GROUP_EVAL}:963"),
}
DENSE = ("window_eval_dense_kernel", "window_eval_dense_cuda", "window_eval_dense_torch",
         f"{PALLAS_GROUP_EVAL}:383")


def bvh_phases(dev, big: int):
    """Phase 6: the BVH fast path at 2^20. Returns the JSON entries of its
    four kernels and the all-pairs kernel's fallback launches in the CLI
    runs, by dimension."""
    import torch

    from nbody_torch import cli
    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh
    from nbody_torch.ops import bvh_group as bg
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg
    from nbody_torch.state import SystemState

    eps = eps_of(torch.float32)
    measured = {name: {} for name in (*BVH_KERNELS, DENSE[0])}
    wrappers = [attr for attr, _, _ in BVH_KERNELS.values()]
    dense_kern, dense_twin = getattr(cg, DENSE[1]), getattr(cg, DENSE[2])

    # -- (a) one real evaluation per dimension, its kernel inputs recorded
    for dim in (3, 2):
        cfg, state = build_model("galaxy", big, dim, np.float32, device=dev)
        state = bvh.hilbert_sort(state, cfg.eps)
        tree = bvh.build_tree(state.m, state.x, cfg.eps)
        with recording(bg, [*wrappers, "allpairs_block_cuda"]) as recorded:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            a, info = bg.compute_force_grouped_windowed(tree, state.m, state.x, cfg.theta, cfg.G,
                                                        cfg.eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        counters = {k: int(v) for k, v in info.items()}
        check(bool(torch.isfinite(a).all()), "BVH force is not finite")
        check(set(wrappers) <= set(recorded), f"kernels called: {sorted(recorded)}")
        check(counters["bad_entries"] == 0, "an entry addresses no tile")
        ent_args = recorded["entries_lohi_eval_cuda"]
        first, last = cg.tile_segments(ent_args[3], ent_args[5], ent_args[7])
        per_tile = (last - first - 1).double()  # entries beside each tile's sentinel
        print(f"[6a] {big}-body {dim}-D galaxy, one BVH force evaluation: {wall:.3f} s wall "
              f"(first call), peak memory above its inputs {peak:.2f} GiB; {counters}; residual "
              f"entries per tile: max {int(per_tile.max())}, mean {per_tile.mean().item():.2f} "
              f"over {per_tile.numel()} tiles")
        for name, (attr, twin_attr, _) in BVH_KERNELS.items():
            measured[name][dim] = measure(f"6a {dim}-D", name, getattr(cg, attr),
                                          getattr(cg, twin_attr), recorded[attr], dim, "poly")
        if "allpairs_block_cuda" in recorded:
            xi, mj, xj = recorded["allpairs_block_cuda"][:3]
            print(f"[6a] the exact fallback ran on {xi.shape[0]} rows")
        # the dense-mask window on a synthetic window of this size: the
        # node-mask call's inputs, its slots broadcast over their S bodies
        xi, mj, xj, w0, in_win, _, wt, S, _ = recorded["window_eval_nodemask_cuda"]
        mask = in_win.to(torch.float32).repeat_interleave(S, dim=1).contiguous()
        measured[DENSE[0]][dim] = measure(f"6a {dim}-D synthetic", DENSE[0], dense_kern,
                                          dense_twin, (xi, mj, xj, w0, mask, eps, wt, "poly"),
                                          dim, "poly")
        del recorded, mask, xi, mj, xj, w0, in_win, ent_args
        if dim == 3:
            # -- (c) the 3-D force against the exact poly sum on the same bodies
            ref = cfg.G * ca.allpairs_block_cuda(state.x, state.m, state.x, eps, "poly")
            accuracy("6c", "BVH vs poly all-pairs", big, a, ref)
            del ref
        del a, state, tree
        torch.cuda.empty_cache()

    # the dense-mask window where the BVH takes it: an n = 16 evaluation
    for dim in (3, 2):
        cfg, state = build_model("galaxy", 16, dim, np.float32, device=dev)
        state = bvh.hilbert_sort(state, cfg.eps)
        tree = bvh.build_tree(state.m, state.x, cfg.eps)
        with recording(bg, [DENSE[1]]) as recorded:
            bg.compute_force_grouped_windowed(tree, state.m, state.x, 0.0, cfg.G, cfg.eps)
        check(DENSE[1] in recorded, f"the {dim}-D n = 16 evaluation took no dense-mask window")
        measured[DENSE[0]][f"n16_{dim}d"] = measure(f"6a {dim}-D n=16", DENSE[0], dense_kern,
                                                    dense_twin, recorded[DENSE[1]], dim, "poly")

    # -- (b) the CLI at full size; counts from 0 just before each run ------
    launches = {dim: cli_full_size("bvh", dim, big, "6b") for dim in (3, 2)}
    for dim in (3, 2):
        for name in BVH_KERNELS:
            check(launches[dim][name] > 0, f"{name} was not launched in the {dim}-D BVH run")

    # -- (d) 17,000 bodies, 3-D: residual and fallback, card against CPU ----
    m, x = clusters(17000, 3)
    runs = []
    for device in (dev, torch.device("cpu")):
        st = SystemState.from_numpy(m, x, np.zeros_like(x), device=device)
        st = bvh.hilbert_sort(st, eps)
        tree = bvh.build_tree(st.m, st.x, eps)
        a, info = bg.compute_force_grouped_windowed(tree, st.m, st.x, 0.5, 1.0, eps,
                                                    window_tiles=2, e_chunk=8)
        runs.append((a.cpu(), {k: int(v) for k, v in info.items()}))
    check(runs[1][1]["entries"] > 0 and runs[1][1]["fallback_tiles"] > 0,
          f"6d takes no residual or no fallback: {runs[1][1]}")
    card_vs_cpu("6d", "17000-body 3-D clusters, window_tiles 2, e_chunk 8", runs)

    # -- (e) the small path: the card (dense-mask window) against the CPU ----
    with tempfile.TemporaryDirectory() as tmp:
        finals = {}
        for device in ("cuda", "cpu"):
            path = os.path.join(tmp, f"final_{device}.bin")
            ca.reset_launch_counts()
            cg.reset_launch_counts()
            cli.main(["-n", "10", "-s", "5", "--algorithm", "bvh", "--theta", "0", "--device",
                      device, "--save-state", path], out=io.StringIO())
            if device == "cuda":
                small_launches = dict(cg.launch_counts)
            finals[device] = read_state(path)
    gpu, cpu = finals["cuda"], finals["cpu"]
    check(gpu.shape == (10, 5) and bool(np.isfinite(gpu).all()), "final state malformed")
    diff = float((np.abs(gpu - cpu).max(axis=0) / np.abs(cpu).max(axis=0)).max())
    print(f"[6e] -n 10 -s 5 --algorithm bvh --theta 0: final state on the card vs the CPU "
          f"twins, in the order each run left its bodies, max over columns of max |diff| / "
          f"max |value| = {diff:.3e} (limit 1e-4); launches on the card {small_launches}")
    check(diff <= 1e-4, "card and CPU final states differ (or their body orders do)")
    check(small_launches[DENSE[0]] > 0, "the small run did not launch the dense-mask window")

    run3 = f"phase 6b: {big}-body 3-D bvh --csv-total"
    entries = []
    for name, (_, _, replaces) in BVH_KERNELS.items():
        entries.append({"name": f"{name}<poly>" if "nodemask" not in name else name,
                        "route": "cuda", "source": GROUP_EVAL, "replaces": replaces,
                        "launches": launches[3][name], "launches_in": run3,
                        **measured[name][3], "n": big, "dim": 3, "dtype": "float32",
                        "launches_2d": launches[2][name], "2d": measured[name][2]})
    dense = measured[DENSE[0]]
    entries.append({"name": DENSE[0], "route": "cuda", "source": GROUP_EVAL, "replaces": DENSE[3],
                    "launches": small_launches[DENSE[0]],
                    "launches_in": "phase 6e: -n 10 -s 5 --algorithm bvh --theta 0 on the card",
                    **dense[3], "n": big, "dim": 3, "dtype": "float32",
                    "timed_on": "a synthetic 2^20 window from the node-mask call's slots",
                    "2d": dense[2], "n16_3d": dense["n16_3d"], "n16_2d": dense["n16_2d"]})
    return entries, {dim: launches[dim]["allpairs_block_kernel"] for dim in (3, 2)}


def accuracy(tag: str, what: str, n: int, a, ref) -> None:
    """Per-body relative error of a tree force against an exact sum:
    median 1e-3 and p99 1e-2 at most (sanity bounds)."""
    import torch

    rel = ((a - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).double()
    med, p99 = (torch.quantile(rel, q).item() for q in (0.5, 0.99))
    print(f"[{tag}] {n}-body 3-D {what}, per-body relative error: median {med:.3e}, p99 "
          f"{p99:.3e}, max {rel.max().item():.3e} (limits: median 1e-3, p99 1e-2)")
    check(med <= 1e-3 and p99 <= 1e-2, f"{what}: far from the direct sum")


def clusters(n: int, dim: int):
    """Nine Gaussian clusters from a fixed seed, float32 (m, x)."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


def card_vs_cpu(tag: str, what: str, runs) -> None:
    """Equal counters and forces within 1e-5 of sum |a|, card against CPU."""
    (ga, ginfo), (pa, pinfo) = runs
    rel = ((ga - pa).abs().sum() / pa.abs().sum()).item()
    print(f"[{tag}] {what}, card vs CPU twins: sum|diff| / sum|a| = {rel:.3e} (limit 1e-5); "
          f"counters {'equal' if ginfo == pinfo else 'DIFFER'}: {ginfo}")
    check(ginfo == pinfo, f"counters differ: card {ginfo}, CPU {pinfo}")
    check(rel <= 1e-5, "card and CPU forces differ")


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
