"""The accuracy study and its growth probe (python -m nbody_torch.probe
accuracy | acc-growth): the ports of scripts/accuracy_study.py and
scripts/probe_acc_growth.py.

The study puts the float32 fast paths' error beside the float64 list
paths' and the exact sum, on the galaxy at theta 0.5. Its legs:

  fp32fast  the float32 engine with EngineOptions() (kernel auto): the
            fast paths' CUDA kernels on the card, their plain twins on the
            CPU (the script's _make_step(..., fast=True), :71-90)
  f64group  the float64 engine: the list paths, group_eval_kernel and the
            float64 exact fallback on the card (where the script runs
            kernel="jnp")

and two oracles, the float64 all-pairs engine for trajectories and, for
one force evaluation, oracle_force: the float64 all-pairs kernel
(allpairs_block_cuda, row 2's kernel, its twin on the CPU) with the
softening of the leg under test. In the port the dtype picks the path,
so a leg is its dtype.

Modes, as the script's:

  --force-error  one dt = 0 step of each leg (force_at_state), against
                 oracle_force at the positions the leg evaluated at: the
                 relative L1 force_{leg}_vs_apf64 and the per-body
                 relative errors' p50, p99 and max; each leg's forces are
                 dumped to forcedump_{algo}_{dim}d_{leg}[_ev].npz
  (default)      `steps` steps of each leg from one start; the final
                 positions' L1 between the legs (elementwise and in
                 canonical order) and, unless --no-ap-oracle, each leg's
                 against the float64 all-pairs trajectory; normalised by
                 the oracle's sum |x| (or the f64 leg's)

--evolved starts both legs from one state: 50 float32 octree fast-path
steps of the fresh galaxy (preroll_state), cached as
preroll_{n}_{dim}d_50.npz, cast to each leg's dtype. The script writes its
cache and dumps into the repo's results/; the port writes them beside
--out. The reference binary's legs (fresh trajectories only) run where
--reference names the reference's src/main.cpp and g++ can build it
(probes/reference.py); otherwise one line on stderr says why they are
skipped and their keys are left out.

acc-growth steps the float64 and float32 legs side by side from the fresh
galaxy and writes, after each step, {algo, dim, n, step, pos_l1, acc_l1}:
the relative L1 of the positions and of the accelerations between the
legs, appended to --out (JSON lines). Step 1's acc_l1 is the single-step
force error at scale (~1e-3 is healthy, 1e-1 a bug).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from nbody_torch.config import SimConfig
from nbody_torch.models import build_galaxy_model
from nbody_torch.ops.cuda_allpairs import allpairs_block_cuda
from nbody_torch.probes import reference
from nbody_torch.sim.engines import EngineOptions, get_engine
from nbody_torch.state import SystemState

THETA = 0.5
PREROLL = 50
LEGS = {"fp32fast": np.float32, "f64group": np.float64}
ORACLE_ROWS = 65536  # rows of one oracle kernel call
FIELDS = ("m", "x", "v", "a", "ao")


def _canon_l1(xa: np.ndarray, xb: np.ndarray) -> float:
    """L1 between two position frames paired in canonical (lexicographic)
    order instead of array order: immune to the sort permutation. Nearly
    coincident bodies can mispair, but such pairs add almost nothing."""
    def canon(x):
        return x[np.lexsort(tuple(x[:, d] for d in range(x.shape[1] - 1, -1, -1)))]
    return float(np.abs(canon(xa) - canon(xb)).sum())


def _start(n: int, dim: int, dtype, theta: float, device, state0=None, dt=None):
    """(cfg, state): the galaxy, or state0 (host arrays) cast to dtype."""
    cfg, state = build_galaxy_model(n, dim, dtype, device)
    cfg = cfg.replace(theta=theta, **({} if dt is None else {"dt": dt}))
    if state0 is not None:
        state = SystemState(*(torch.tensor(np.asarray(state0[f]), dtype=state.x.dtype,
                                           device=device) for f in FIELDS))
    return cfg, state


def _make_step(algo: str, cfg: SimConfig, device):
    """The engine's step with the default options: a float32 tree takes
    its fast path, a float64 tree its list path, all-pairs its kernel."""
    return get_engine(algo).make_step(cfg, EngineOptions(), device)


def evolve_ours(algo: str, n: int, dim: int, dtype, steps: int, theta: float, device,
                state0=None):
    """`steps` engine steps of the galaxy (or state0): (final x as float64
    numpy, final state)."""
    cfg, state = _start(n, dim, dtype, theta, device, state0)
    step = _make_step(algo, cfg, device)
    for k in range(steps):
        state, _ = step(state, k)
    return state.x.double().cpu().numpy(), state


def force_at_state(algo: str, n: int, dim: int, dtype, theta: float, device, state0=None):
    """One dt = 0 step: the sort, build and force run unchanged but the
    positions do not move, so `a` afterwards is the engine's force at the
    start positions. Returns (a, m, x, cfg), float64 numpy, in the
    engine's own final body order (the BVH keeps its sorted order, the
    octree scatters back)."""
    cfg, state = _start(n, dim, dtype, theta, device, state0, dt=0.0)
    state, _ = _make_step(algo, cfg, device)(state, 0)
    return (state.a.double().cpu().numpy(), state.m.double().cpu().numpy(),
            state.x.double().cpu().numpy(), cfg)


def oracle_force(m64: np.ndarray, x64: np.ndarray, cfg: SimConfig, softening: str = "allpairs",
                 device=None) -> np.ndarray:
    """The float64 all-pairs force at the positions a leg evaluated at, by
    the float64 all-pairs kernel on `device` (its twin on the CPU), in row
    blocks of ORACLE_ROWS. `softening` must match the leg under test: the
    octree divides by (sqrt(d2) + eps)^3 ("octree"), all-pairs and the BVH
    by d2 sqrt(d2) + eps ("allpairs"); the two differ on the closest pairs
    at float32's eps. G and eps are the leg's cfg's."""
    soft = "sqrt3" if softening == "octree" else "poly"
    device = torch.device("cpu") if device is None else device
    mj = torch.tensor(m64, dtype=torch.float64, device=device)
    xj = torch.tensor(x64, dtype=torch.float64, device=device)
    out = np.empty(x64.shape, np.float64)
    for i in range(0, x64.shape[0], ORACLE_ROWS):
        rows = allpairs_block_cuda(xj[i:i + ORACLE_ROWS], mj, xj, cfg.eps, softening=soft)
        out[i:i + ORACLE_ROWS] = (cfg.G * rows).cpu().numpy()
    return out


def preroll_state(n: int, dim: int, steps: int, cache_dir: str, device) -> dict:
    """The common evolved start: `steps` float32 octree fast-path steps of
    the fresh galaxy, as host arrays {m, x, v, a, ao}. Cached in cache_dir
    as preroll_{n}_{dim}d_{steps}.npz (deterministic on one device)."""
    cache = os.path.join(cache_dir, f"preroll_{n}_{dim}d_{steps}.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            return {f: z[f] for f in FIELDS}
    _, state = evolve_ours("octree", n, dim, np.float32, steps, THETA, device)
    arrays = {f: getattr(state, f).cpu().numpy() for f in FIELDS}
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(cache, **arrays)
    return arrays


def ref_final(dim: int, algo: str, prec: str, n: int, steps: int, theta: float, workdir: str,
              src: str) -> np.ndarray:
    """The reference binary's final positions (float64) of the galaxy run."""
    d = os.path.join(workdir, f"{algo}_{prec}_{dim}")
    os.makedirs(d, exist_ok=True)
    reference.run_reference(dim, ["-n", str(n), "-s", str(steps), "--theta", str(theta),
                                  "--algorithm", algo, "--workload", "galaxy", "--precision",
                                  prec, "--save", "pos", "--csv-detailed"],
                            src, os.path.join(workdir, "build"), cwd=d)
    return np.asarray(reference.read_positions(os.path.join(d, "positions.bin"))[-1], np.float64)


def _row(dim: int, algo: str, n: int, steps: int, evolved: bool) -> dict:
    return {"dim": dim, "algo": algo, "n": n, "steps": steps, "theta": THETA,
            "evolved": bool(evolved)}


def force_error_row(algo: str, n: int, dim: int, legs, device, state0=None,
                    dump_dir: str | None = None) -> dict:
    """One --force-error row: each leg against oracle_force."""
    evolved = state0 is not None
    row = _row(dim, algo, n, 0, evolved)
    for label in legs:
        print(f"# force {algo} {dim}-D {label} evolved={evolved} ...", file=sys.stderr,
              flush=True)
        av, mv, xv, cfg = force_at_state(algo, n, dim, LEGS[label], THETA, device, state0)
        ao = oracle_force(mv, xv, cfg, "octree" if algo == "octree" else "allpairs", device)
        row[f"force_{label}_vs_apf64"] = float(np.abs(av - ao).sum()) / float(np.abs(ao).sum())
        # per-body percentiles separate "every body is wrong" from "a few
        # heavily cancelling receivers (the central masses) carry noise"
        rel = np.linalg.norm(av - ao, axis=1) / np.maximum(np.linalg.norm(ao, axis=1), 1e-300)
        for tag, q in (("p50", 50), ("p99", 99)):
            row[f"force_{label}_relerr_{tag}"] = float(np.percentile(rel, q))
        row[f"force_{label}_relerr_max"] = float(rel.max())
        if dump_dir is not None:
            dump = os.path.join(dump_dir, f"forcedump_{algo}_{dim}d_{label}"
                                          f"{'_ev' if evolved else ''}.npz")
            np.savez_compressed(dump, a_leg=av, a_oracle=ao, m=mv)
    return row


def trajectory_row(algo: str, n: int, dim: int, steps: int, device, state0=None,
                   ap_oracle: bool = True, ref_src: str | None = None,
                   workdir: str | None = None) -> dict:
    """One trajectory row: both legs `steps` steps from one start."""
    evolved = state0 is not None
    our_64, _ = evolve_ours(algo, n, dim, np.float64, steps, THETA, device, state0)
    our_32, _ = evolve_ours(algo, n, dim, np.float32, steps, THETA, device, state0)
    row = _row(dim, algo, n, steps, evolved)
    # the reference binary cannot reproduce an evolved start: fresh only
    ref = not evolved and reference.reference_available(ref_src)
    if ref:
        ref_d = ref_final(dim, algo, "double", n, steps, THETA, workdir, ref_src)
        ref_f = ref_final(dim, algo, "float", n, steps, THETA, workdir, ref_src)
    if not ap_oracle:
        scale = float(np.abs(our_64).sum())
        row["ours_fp32fast_vs_f64group"] = float(np.abs(our_32 - our_64).sum()) / scale
        # order-free cross-check: far below the elementwise column means the
        # gap is body order (the sort permutation), not physics
        row["ours_fp32fast_vs_f64group_canon"] = _canon_l1(our_32, our_64) / scale
        if ref:
            row["ref_float_vs_double"] = float(np.abs(ref_f - ref_d).sum()) / scale
            row["ours_f64group_vs_ref_double"] = float(np.abs(our_64 - ref_d).sum()) / scale
        return row
    x_oracle, _ = evolve_ours("all-pairs", n, dim, np.float64, steps, 0.0, device, state0)
    scale = float(np.abs(x_oracle).sum())

    def l1(x, y):
        return float(np.abs(x - y).sum()) / scale

    row["ours_fp32fast_vs_f64group"] = l1(our_32, our_64)
    row["ours_fp32fast_vs_f64group_canon"] = _canon_l1(our_32, our_64) / scale
    row["ours_fp32fast_vs_oracle"] = l1(our_32, x_oracle)
    row["ours_f64group_vs_oracle"] = l1(our_64, x_oracle)
    if ref:
        row["ref_float_vs_double"] = l1(ref_f, ref_d)
        row["ref_double_vs_oracle"] = l1(ref_d, x_oracle)
    return row


def study(n: int, steps: int, dims, algos, device, *, evolved: bool = False,
          force_error: bool = False, ap_oracle: bool = True, legs=tuple(LEGS),
          out: str = "accuracy_torch.json", ref_src: str | None = None) -> list[dict]:
    """The study's rows (see the module docstring), each printed as a JSON
    line; the list written to `out`, its table printed. The pre-roll cache
    and the force dumps go beside `out`."""
    out_dir = os.path.dirname(os.path.abspath(out))
    bad = [leg for leg in legs if leg not in LEGS]
    if bad:
        raise ValueError(f"unknown legs {bad}: expected some of {', '.join(LEGS)}")
    if not force_error:
        why = ("the reference binary cannot start from the evolved state" if evolved
               else reference.reference_problem(ref_src))
        if why:
            print(f"# reference legs skipped: {why}", file=sys.stderr, flush=True)
    rows = []
    with tempfile.TemporaryDirectory(prefix="nbody_accuracy_") as tmp:
        for dim in dims:
            state0 = preroll_state(n, dim, PREROLL, out_dir, device) if evolved else None
            for algo in algos:
                if force_error:
                    row = force_error_row(algo, n, dim, legs, device, state0, out_dir)
                else:
                    print(f"# {algo} {dim}-D n={n} steps={steps} evolved={evolved} ...",
                          file=sys.stderr, flush=True)
                    row = trajectory_row(algo, n, dim, steps, device, state0, ap_oracle,
                                         ref_src, tmp)
                rows.append(row)
                print(json.dumps(row), flush=True)
    with open(out, "w") as fh:
        json.dump(rows, fh, indent=1)
    _print_table(rows)
    return rows


def _print_table(rows: list[dict]) -> None:
    keys = sorted({k for r in rows for k in r
                   if k not in ("dim", "algo", "n", "steps", "theta", "evolved")})
    print("\n| dim | algo | evolved | " + " | ".join(keys) + " |")
    print("|---" * (3 + len(keys)) + "|")
    for r in rows:
        cells = " | ".join(f"{r[k]:.2e}" if k in r else "-" for k in keys)
        print(f"| {r['dim']} | {r['algo']} | {r['evolved']} | {cells} |")


def growth(n: int, steps: int, dim: int, algos, out: str, device) -> list[dict]:
    """acc-growth: the float64 and float32 legs stepped in lockstep from
    the fresh galaxy; one row a step, printed and appended to `out`."""
    rows = []
    with open(out, "a") as fh:
        for algo in algos:
            cfg64, s64 = _start(n, dim, np.float64, THETA, device)
            cfg32, s32 = _start(n, dim, np.float32, THETA, device)
            step64, step32 = _make_step(algo, cfg64, device), _make_step(algo, cfg32, device)
            for k in range(steps):
                s64, _ = step64(s64, k)
                s32, _ = step32(s32, k)
                x64, x32 = s64.x.cpu().numpy(), s32.x.double().cpu().numpy()
                a64, a32 = s64.a.cpu().numpy(), s32.a.double().cpu().numpy()
                row = {"algo": algo, "dim": dim, "n": n, "step": k + 1,
                       "pos_l1": float(np.abs(x32 - x64).sum() / np.abs(x64).sum()),
                       "acc_l1": float(np.abs(a32 - a64).sum() / np.abs(a64).sum())}
                print(json.dumps(row), flush=True)
                fh.write(json.dumps(row) + "\n")
                fh.flush()
                rows.append(row)
    return rows

