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
        state, in the same body order;
  7. the trees' list paths (float64 runs, --precision double), through
     the list kernel group_eval_kernel and the all-pairs fallback:
     a. one float64 list-path force evaluation of a 2^20-body galaxy per
        tree (octree sqrt3, BVH poly) in 3-D and in 2-D, printing how many
        tiles each overflow cause (frontier, node cap, leaf cap, K_CELL)
        sent to the exact fallback; the 3-D list kernel call is recorded
        and re-run, timed beside its twin (on all tiles when the first 256
        extrapolate to under 20 s, else on those 256); then the float32
        instantiation, driven through octree_step_force / bvh_step_force
        with list_path=True on a 2^20-body 3-D float32 galaxy, its call
        recorded and timed the same way;
     b. the CLI at full size, -n 1048576 -s 12 --precision double with
        --algorithm octree and bvh, in 3-D and in 2-D;
     c. the rows of (a) that went through the lists (their tiles did not
        fall back), 65,536 at most, against the float64 all-pairs kernel
        with the same softening on the same sorted bodies (the sanity
        bounds of 5c), at least 4,096 rows per tree and dimension; where
        every 3-D tile at 2^20 falls back (the octree), the 3-D check runs
        on a 2^18-body galaxy;
     d. a 17,000-body 3-D float64 galaxy with list caps of 1,024, so that
        tiles fall back, on the card and through the CPU twins: equal
        counters, forces within 1e-12 of sum |a|;
     e. -n 64 -s 5 --precision double --print-state for both trees on the
        card and on the CPU: the same printed state, in the same body
        order, values within 1e-12 relative.
Every kernel call that 5a and 6a time prints its pair count, the pairs
its inputs need (all-pairs N(N-1); a window the columns it visits times
the rows; entries sum(hi - lo) times the rows; the far field the set
accept bits times the rows), and the bound: the larger of those pairs
times the FLOPs per pair (5*dim + 3 for a force, one more under sqrt3,
3*dim + 3 for the potential; a square root and a division counted as
one each) over the H100's 67 TFLOP/s in
float32 (34 TFLOP/s in float64), and the bytes (each input read once, the
output written once) over its 3.35 TB/s; the list kernel's pairs are each
tile's rows times the nonzero-mass entries of its live list heads. No
single PyTorch call computes a softened gravity
sum (torch.cdist gives distances, not forces), so library_ms is null.
The kernels' launch counts are set to 0 just before each CLI run that
drives a main path and read just after it: the all-pairs force kernel's
from the 2^20 run of phase 3, the potential kernel's from the run of
phase 4 (the 2^20 --csv-total run computes no energies), the octree
kernels' from the 3-D run of phase 5b, the BVH's far, node-mask and
entries kernels' from the 3-D run of phase 6b, the dense-mask
window's from the small run of phase 6e, the list kernel's float64
instantiations from the 3-D runs of phase 7b (the 2-D runs' counts and
the fallback launches of the all-pairs kernel are reported beside them),
and its float32 instantiations from the float32 list-path steps of 7a
(float32 CLI runs take the fast paths, and --kernel torch the twin). The
list kernel counts each instantiation (dtype, softening) on its own.
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
import re
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 20261016
NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")  # a number of --print-state
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

    t_start = time.perf_counter()
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
    list_kernels, list_fallback = list_phases(dev, big)

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
    entries[0]["float64_list_fallback_launches"] = list_fallback  # 3-D, by tree
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": entries + octree_kernels + bvh_kernels + list_kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# H100 SXM peaks (NVIDIA's data sheet): float32 and float64 outside the
# tensor cores, HBM3
F32_FLOPS = 67e12
F64_FLOPS = 34e12
HBM_BYTES_PER_S = 3.35e12
GROUP_EVAL = "nbody_torch/csrc/group_eval.cu"
PALLAS_GROUP_EVAL = "nbody_tpu/ops/pallas_group_eval.py"


def flops_per_pair(dim: int, softening: str) -> int:
    """dim subtractions, 2*dim - 1 for d2, the square root, the softening
    (poly: a multiply and an add; sqrt3: an add and two multiplies), the
    division, and 2*dim to accumulate the weighted separation."""
    return 5 * dim + 3 + (softening == "sqrt3")


def bound(pairs: int, flops: int, nbytes: int, peak: float = F32_FLOPS):
    """(least milliseconds the card could take, what bounds it)."""
    t_ops, t_bytes = pairs * flops / peak, nbytes / HBM_BYTES_PER_S
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


def cli_full_size(algorithm: str, dim: int, big: int, tag: str,
                  precision: str = "float") -> dict:
    """-n big -s 12 --csv-total through the CLI on the card, with the
    launch counts set to 0 just before and read just after."""
    from nbody_torch import cli
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    ca.reset_launch_counts()
    cg.reset_launch_counts()
    argv = ["-n", str(big), "-s", "12", "-d", str(dim), "--algorithm", algorithm,
            "--workload", "galaxy", "--precision", precision, "--device", "cuda", "--csv-total"]
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = cli.main(argv, out=out)
    wall = time.perf_counter() - t0
    launches = {**cg.launch_counts, "allpairs_block_kernel": ca.launch_counts["allpairs_block_kernel"]}
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 2 and lines[0] == "algorithm,dim,precision,nsteps,nbodies,"
          "total [s]", f"{algorithm} CLI run failed: rc={rc}, output {lines!r}")
    fields = lines[1].split(",")
    bits = "64" if precision == "double" else "32"
    check(fields[:5] == [algorithm, str(dim), bits, "2", str(big)], f"CSV row {lines[1]!r}")
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


LIST_SOFTENING = {"octree": "sqrt3", "bvh": "poly"}
LIST_CAPS = 1024  # 7d: list caps small enough that tiles of a 17,000-body galaxy fall back
MIN_LIST_ROWS = 4096  # 7c: the fewest rows evaluated through the lists that a check takes
LIST_TILE = 512  # the list paths' default tile


def list_evaluation(tree: str, dev, n: int, dim: int, caps=(None, None)):
    """One float64 list-path force evaluation of an n-body galaxy on `dev`:
    (G * accel in the tree's sorted order, its counters as ints, G, the
    sorted (m, x), the group_eval_cuda call's args, the tiles sent to the
    exact fallback ((T,) bool), wall seconds, peak GiB above the inputs)."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.ops.geometry import scalar_bounds

    cfg, state = build_model("galaxy", n, dim, np.float64, device=dev)
    kw = dict(cap_nodes=caps[0], cap_leaves=caps[1])
    if tree == "octree":
        lo, hi = scalar_bounds(state.x)
        levels, _, m, x = octree.build_octree(state.m, state.x, lo, hi, octree.max_depth(n, dim))
        module, args = octree_group, (levels, m, x, hi - lo)
    else:
        st = bvh.hilbert_sort(state, cfg.eps)
        m, x = st.m, st.x
        module, args = bvh_group, (bvh.build_tree(m, x, cfg.eps), m, x)
    del state
    cuda = dev.type == "cuda"
    with recording(module, ["group_eval_cuda", "exact_fallback"]) as recorded:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        a, info = module.compute_force_grouped(*args, cfg.theta, cfg.G, cfg.eps, **kw)
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if cuda else 0.0
    return (a, {k: int(v) for k, v in info.items()}, cfg.G, (m, x), recorded["group_eval_cuda"],
            recorded["exact_fallback"][2], wall, peak)


def list_step_float32(tree: str, dev, n: int):
    """The float32 list path through the step function a user calls,
    octree_step_force / bvh_step_force with list_path=True, on an n-body
    3-D galaxy: the launch counts set to 0 just before and read just after,
    and its group_eval_cuda call's args."""
    import torch

    from nbody_torch.models import build_model
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.ops import cuda_allpairs as ca
    from nbody_torch.ops import cuda_group_eval as cg

    cfg, state = build_model("galaxy", n, 3, np.float32, device=dev)
    ca.reset_launch_counts()
    cg.reset_launch_counts()
    with recording(octree_group if tree == "octree" else bvh_group, ["group_eval_cuda"]) as rec:
        if tree == "octree":
            out, _ = octree.octree_step_force(state, cfg.theta, cfg.G, cfg.eps,
                                              octree.max_depth(n, 3), list_path=True)
        else:
            out, _ = bvh.bvh_step_force(state, cfg.theta, cfg.G, cfg.eps, list_path=True)
        torch.cuda.synchronize()
    launches = {**cg.launch_counts, "allpairs_block_kernel": ca.launch_counts["allpairs_block_kernel"]}
    check(bool(torch.isfinite(out.a).all()), f"float32 {tree} list-path step force is not finite")
    print(f"[7a] {n}-body 3-D float32 galaxy, {tree}_step_force(list_path=True): launches "
          f"{launches}")
    return launches, rec["group_eval_cuda"]


def list_accuracy(tree: str, n: int, dim: int, a, G: float, m, x, tile_over) -> int:
    """7c: the rows of the tiles evaluated through the lists (not sent to
    the exact fallback), 65,536 of them at most, evenly spaced, against
    the float64 all-pairs kernel with the tree's softening (the sanity
    bounds of 5c). Returns the rows checked, 0 when fewer than
    MIN_LIST_ROWS are left."""
    import torch

    from nbody_torch.ops import cuda_allpairs as ca

    rows = (~tile_over).repeat_interleave(LIST_TILE)[:n].nonzero().squeeze(1)
    listed = int((~tile_over).sum())
    if rows.numel() < MIN_LIST_ROWS:
        print(f"[7c] {n}-body {dim}-D float64 {tree}: {rows.numel()} rows in {listed} of "
              f"{tile_over.numel()} tiles went through the lists, under {MIN_LIST_ROWS}")
        return 0
    pick = torch.linspace(0, rows.numel() - 1, min(65536, rows.numel()), device=rows.device)
    rows = rows[pick.round().long()]
    ref = G * ca.allpairs_block_cuda(x[rows].contiguous(), m, x, eps_of(torch.float64),
                                     LIST_SOFTENING[tree])
    accuracy("7c", f"float64 {tree} list path vs {LIST_SOFTENING[tree]} all-pairs "
             f"({rows.numel()} rows of the {listed} of {tile_over.numel()} tiles evaluated "
             f"through the lists)", n, a[rows], ref, dim)
    return rows.numel()


def list_pairs_and_bytes(args, n: int):
    """The pairs a list evaluation needs (each tile's rows that are bodies,
    times the sources of its live heads with a nonzero mass), and its bytes
    (the rows, the live heads' entries and lengths read once, the output
    written once)."""
    import torch

    xi, mj, xj, _, _, split, n0, n1 = args
    ntiles, length = mj.shape
    tb = xi.shape[0] // ntiles
    lane = torch.arange(length, device=mj.device)
    heads = (lane < n0[:, None].long()) | ((lane >= split) & (lane < split + n1[:, None].long()))
    rows = (n - torch.arange(ntiles, device=mj.device) * tb).clamp(0, tb)
    pairs = int(((heads & (mj != 0)).sum(1) * rows).sum())
    size = xi.element_size()
    nbytes = (2 * xi.numel() * size + int(heads.sum()) * (xi.shape[1] + 1) * size
              + (n0.numel() + n1.numel()) * 4)
    return pairs, nbytes


def measure_list(tag: str, args, n: int, twin_budget_ms: float = 20e3) -> dict:
    """Time group_eval_kernel on recorded list args (5 launches after a
    warm-up, CUDA events) and its twin: on all tiles if the first 256
    tiles extrapolate to under twin_budget_ms, else on those 256. Holds the
    kernel against the twin within TOL of each row's sum of |term|, counts
    its pairs and computes its bound."""
    import torch

    from nbody_torch.ops import cuda_group_eval as cg

    xi, mj, xj, eps, softening, split, n0, n1 = args
    dtype = str(xi.dtype).split(".")[-1]
    ntiles, tb = mj.shape[0], xi.shape[0] // mj.shape[0]
    got = cg.group_eval_cuda(*args)  # warm-up launch
    kms = event_ms(lambda: cg.group_eval_cuda(*args), reps=5)

    def twin_args(t1):
        return (xi[:t1 * tb], mj[:t1], xj[:t1], eps, softening, split, n0[:t1], n1[:t1])

    first = min(256, ntiles)
    first_ms, ref = event_ms(lambda: cg.group_eval_torch(*twin_args(first)), reps=1, keep=True)
    tiles, plain_ms = first, first_ms
    if first < ntiles and first_ms * ntiles / first <= twin_budget_ms:
        del ref
        tiles = ntiles
        plain_ms, ref = event_ms(lambda: cg.group_eval_torch(*twin_args(tiles)), reps=1, keep=True)
    scale = cg.group_eval_torch(*twin_args(tiles), absolute=True)
    err, abs_err = scaled(got[:tiles * tb], ref, scale)
    del ref, scale
    pairs, nbytes = list_pairs_and_bytes(args, n)
    flops = flops_per_pair(xi.shape[1], softening)
    bound_ms, bound_by = bound(pairs, flops, nbytes, F64_FLOPS if dtype == "float64" else F32_FLOPS)
    print(f"[{tag}] group_eval_kernel<{dtype}, {softening}>: {ntiles} tiles, L = {mj.shape[1]} "
          f"(split {split}); kernel {kms:.3f} ms, plain {plain_ms:.1f} ms on "
          f"{'all' if tiles == ntiles else 'the first'} {tiles} tiles; max |kernel - plain| / "
          f"sum|term| = {err:.3e} (limit {TOL[dtype]:g}); {pairs} pairs "
          f"({pairs / (kms * 1e-3):.4e} pairs/s), bound {bound_ms:.3f} ms ({bound_by}, {flops} "
          f"FLOPs per pair)")
    check(err <= TOL[dtype],
          f"{tag} group_eval_kernel: scaled error {err:.3e} above {TOL[dtype]:g}")
    return {"ms": kms, "plain_ms": plain_ms, "plain_tiles": tiles, "max_abs_err": abs_err,
            "max_scaled_err": err, "scaled_err_limit": TOL[dtype], "pairs": pairs,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def list_phases(dev, big: int):
    """Phase 7: the trees' list paths at 2^20. Returns the JSON entries of
    group_eval_kernel (float64 and float32, sqrt3 and poly) and the
    all-pairs kernel's fallback launches in the 3-D CLI runs, by tree."""
    import torch

    from nbody_torch import cli
    from nbody_torch.ops import cuda_group_eval as cg

    measured, causes, checked = {}, {}, {}
    # -- (a) one float64 evaluation per tree and dimension, its list kernel
    #    call recorded (3-D) and its tiles' overflow causes printed;
    #    (c) the rows it evaluated through the lists against the exact sum
    for tree in LIST_SOFTENING:
        for dim in (3, 2):
            a, counters, G, (m, x), args, tile_over, wall, peak = list_evaluation(tree, dev, big,
                                                                                  dim)
            print(f"[7a] {big}-body {dim}-D float64 galaxy, one {tree} list-path force evaluation: "
                  f"{wall:.3f} s wall{' (first call)' if dim == 3 else ''}, peak memory above its "
                  f"inputs {peak:.2f} GiB; {counters}")
            check(bool(torch.isfinite(a).all()), f"{tree} {dim}-D list force is not finite")
            causes[f"{tree}_{dim}d"] = {k: v for k, v in counters.items()
                                        if k.startswith("over_") or k == "fallback_tiles"}
            if dim == 3:
                measured[tree] = measure_list(f"7a {tree}", args, big)
            del args
            checked[(tree, dim)] = list_accuracy(tree, big, dim, a, G, m, x, tile_over)
            del a, m, x, tile_over
            torch.cuda.empty_cache()
        if not checked[(tree, 3)]:  # every 3-D tile fell back: check 3-D at 2^18
            n18 = big >> 2
            a, counters, G, (m, x), _, tile_over, *_ = list_evaluation(tree, dev, n18, 3)
            print(f"[7a] {n18}-body 3-D float64 galaxy, {tree} list path: {counters}")
            checked[(tree, 3)] = list_accuracy(tree, n18, 3, a, G, m, x, tile_over)
            del a, m, x, tile_over
            torch.cuda.empty_cache()
        for dim in (3, 2):
            check(checked[(tree, dim)] >= MIN_LIST_ROWS,
                  f"7c {tree} {dim}-D: too few rows went through the lists to check")

    # the float32 instantiation, through the step functions' list branch
    f32 = {}
    for tree in LIST_SOFTENING:
        launches, args = list_step_float32(tree, dev, big)
        f32[tree] = (launches, measure_list(f"7a {tree} float32", args, big))
        del args
        torch.cuda.empty_cache()

    # -- (b) the CLI at full size in double precision; counts from 0 just before
    launches = {tree: cli_full_size(tree, 3, big, "7b", "double") for tree in LIST_SOFTENING}
    launches_2d = {tree: cli_full_size(tree, 2, big, "7b", "double") for tree in LIST_SOFTENING}
    group_keys = [k for k in cg.launch_counts if k.startswith("group_eval_kernel<")]
    for tree, softening in LIST_SOFTENING.items():
        key = cg.group_eval_name(torch.float64, softening)
        for run in (launches[tree], launches_2d[tree]):
            check(run[key] == 12 and sum(run[k] for k in group_keys) == 12,
                  f"the float64 {tree} run launched {({k: run[k] for k in group_keys})}, expected "
                  f"12 of {key} (one per step) and no other instantiation")
        key32 = cg.group_eval_name(torch.float32, softening)
        run = f32[tree][0]
        check(run[key32] == 1 and sum(run[k] for k in group_keys) == 1,
              f"the float32 {tree} list-path step launched {({k: run[k] for k in group_keys})}, "
              f"expected one {key32}")

    # -- (d) 17,000 bodies, 3-D, caps small enough that tiles fall back:
    #    the card against the CPU twins
    for tree in LIST_SOFTENING:
        runs = []
        for device in (dev, torch.device("cpu")):
            a, counters, *_ = list_evaluation(tree, device, 17000, 3, (LIST_CAPS, LIST_CAPS))
            runs.append((a.cpu(), counters))
        check(runs[1][1]["fallback_tiles"] > 0, f"7d {tree}: no tile fell back: {runs[1][1]}")
        card_vs_cpu("7d", f"17000-body 3-D float64 galaxy, {tree} list path, caps {LIST_CAPS}",
                    runs, TOL["float64"])

    # -- (e) the small path on the card and on the CPU: the same printed state
    for tree in LIST_SOFTENING:
        texts = {}
        for device in ("cuda", "cpu"):
            out = io.StringIO()
            cli.main(["-n", "64", "-s", "5", "--algorithm", tree, "--precision", "double",
                      "--print-state", "--device", device], out=out)
            texts[device] = [ln for ln in out.getvalue().splitlines()
                             if not ln.startswith("Total time:")]
        gpu, cpu = texts["cuda"], texts["cpu"]
        same_order = [NUM.sub("#", ln) for ln in gpu] == [NUM.sub("#", ln) for ln in cpu]
        gv, cv = (np.array([float(v) for v in NUM.findall("\n".join(t))]) for t in (gpu, cpu))
        rel = (float((np.abs(gv - cv) / np.maximum(np.abs(cv), 1e-300)).max()) if same_order
               else 1.0)
        print(f"[7e] -n 64 -s 5 --algorithm {tree} --precision double --print-state: card vs CPU "
              f"{len(gv)} printed values, body order {'the same' if same_order else 'DIFFERS'}, "
              f"max relative difference {rel:.3e} (limit 1e-12)")
        check(same_order and len(gv) > 0 and rel <= 1e-12, f"7e {tree}: printed states differ")

    entries = []
    for tree, softening in LIST_SOFTENING.items():
        key = cg.group_eval_name(torch.float64, softening)
        entries.append({"name": key, "route": "cuda", "source": GROUP_EVAL,
                        "replaces": f"{PALLAS_GROUP_EVAL}:83", "launches": launches[tree][key],
                        "launches_in": f"phase 7b: {big}-body 3-D {tree} --precision double "
                                       "--csv-total",
                        **measured[tree], "n": big, "dim": 3, "dtype": "float64",
                        "launches_2d": launches_2d[tree][key],
                        "overflow": {dim: causes[f"{tree}_{dim}d"] for dim in (3, 2)}})
    for tree, softening in LIST_SOFTENING.items():
        key = cg.group_eval_name(torch.float32, softening)
        entries.append({"name": key, "route": "cuda", "source": GROUP_EVAL,
                        "replaces": f"{PALLAS_GROUP_EVAL}:83", "launches": f32[tree][0][key],
                        "launches_in": f"phase 7a: {tree}_step_force(list_path=True) on a "
                                       f"{big}-body 3-D float32 galaxy",
                        **f32[tree][1], "n": big, "dim": 3, "dtype": "float32"})
    fallback = {tree: launches[tree]["allpairs_block_kernel"] for tree in LIST_SOFTENING}
    return entries, fallback


def accuracy(tag: str, what: str, n: int, a, ref, dim: int = 3) -> None:
    """Per-body relative error of a tree force against an exact sum:
    median 1e-3 and p99 1e-2 at most (sanity bounds)."""
    import torch

    rel = ((a - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).double()
    med, p99 = (torch.quantile(rel, q).item() for q in (0.5, 0.99))
    print(f"[{tag}] {n}-body {dim}-D {what}, per-body relative error: median {med:.3e}, p99 "
          f"{p99:.3e}, max {rel.max().item():.3e} (limits: median 1e-3, p99 1e-2)")
    check(med <= 1e-3 and p99 <= 1e-2, f"{what}: far from the direct sum")


def clusters(n: int, dim: int):
    """Nine Gaussian clusters from a fixed seed, float32 (m, x)."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


def card_vs_cpu(tag: str, what: str, runs, limit: float = 1e-5) -> None:
    """Equal counters and forces within `limit` of sum |a|, card against CPU."""
    (ga, ginfo), (pa, pinfo) = runs
    rel = ((ga - pa).abs().sum() / pa.abs().sum()).item()
    print(f"[{tag}] {what}, card vs CPU twins: sum|diff| / sum|a| = {rel:.3e} (limit {limit:g}); "
          f"counters {'equal' if ginfo == pinfo else 'DIFFER'}: {ginfo}")
    check(ginfo == pinfo, f"counters differ: card {ginfo}, CPU {pinfo}")
    check(rel <= limit, "card and CPU forces differ")


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
