"""Run one cell of the benchmark of nbody_torch once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's galaxy from the seed, hands it to the port through
SystemState.from_numpy, makes the step of the configuration's algorithm with
the CLI's default EngineOptions, and runs the mix's warm-up steps. The
window then runs whole chained steps, step(state, k) on the state the
previous step returned, until the host clock passes --seconds, and ends
with torch.cuda.synchronize(). Every `steps_published` steps of the
configuration (the published run's length) the chain starts again from the
galaxy as it was handed over, so the window times whole published runs:
the galaxies' approach makes later steps costlier, and without a restart a
faster program would run into them. step_s is the window's wall time over
its steps; setup_s the time from the start of this module to the first
timed step. With --trace 1 set-up also counts the step's work with the plain
walk, and after the window a stretch of whole steps runs under the
profiler and one step under CUDA's sync debug mode; the result then holds
the per-layer metrics. Last, the output of step 0 and of one window step
drawn from the seed are held against the plain reference (check.py).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from perfbench import check, galaxy, manifest, roofline, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def _snapshot(state) -> dict:
    return {k: getattr(state, k).clone() for k in ("m", "x", "v", "a", "ao")}


def _restart(snap: dict):
    """A state with copies of a snapshot's tensors."""
    from nbody_torch.state import SystemState

    return SystemState(**{k: t.clone() for k, t in snap.items()})


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, device,
             t_start: float = T_START, book: manifest.Manifest | None = None,
             n: int | None = None) -> tuple[dict, list[str]]:
    """Run the cell once on `device`; returns (result, check lines). `n`
    replaces the configuration's body count (the tests' small runs)."""
    import torch

    from nbody_torch.config import SimConfig
    from nbody_torch.sim.engines import EngineOptions, get_engine
    from nbody_torch.state import SystemState

    marks = {"imports": time.perf_counter() - t_start}
    book = book or manifest.Manifest()
    cell = book.cell(workload)
    cfg = book.config(cell["config"])
    mix = book.mix(cell["traffic"])
    limits = book.limits(workload)
    n = n or cfg["n"]
    dtype = np.float64 if mix["precision"] == "double" else np.float32
    sim = SimConfig(n=n, dim=cfg["dim"], dtype=dtype, dt=cfg["dt"], G=cfg["G"],
                    theta=cfg["theta"])
    m, x, v = galaxy.bodies(cfg, seed, n, dtype)
    marks["galaxy"] = time.perf_counter() - t_start
    state = SystemState.from_numpy(m, x, v, device=device)
    start = _snapshot(state)
    episode = cfg["steps_published"]
    marks["state"] = time.perf_counter() - t_start
    step = get_engine(cfg["algorithm"]).make_step(sim, EngineOptions(), device)
    marks["make_step"] = time.perf_counter() - t_start

    state, _ = step(state, 0)
    first = _snapshot(state)
    for k in range(1, mix["warmup_steps"]):
        state, _ = step(state, k)
    k = e = max(1, mix["warmup_steps"])
    _sync(device)
    marks["warmup"] = time.perf_counter() - t_start
    bound = None
    if traced:
        work = roofline.interactions(cfg, m, x, mix["walk_sample"], seed)
        bound = roofline.bound_seconds(work["interactions"], n, cfg["dim"], cfg["softening"],
                                       np.dtype(dtype).name)
    j = int(np.random.default_rng([seed, 1]).integers(mix["check_step_max"]))
    before = after = None

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps = 0
    while time.perf_counter() - t0 < seconds:
        if e >= episode:
            state, e = _restart(start), 0
        if steps == j:
            before = _snapshot(state)
        state, _ = step(state, k)
        if steps == j:
            after = _snapshot(state)
        k += 1
        e += 1
        steps += 1
    _sync(device)
    step_s = (time.perf_counter() - t0) / steps

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = None
    if traced:
        port = trace.port_kernel_names(manifest.ROOT / "nbody_torch")
        state, rec = trace.profile_stretch(step, _restart(start), k, mix["trace_steps"], port)
        k += mix["trace_steps"]
        state, rec["host_syncs"] = trace.host_syncs(step, state, k)
        rec["bound_s"] = bound["seconds"]
    del state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    spec = {"dt": cfg["dt"], "G": cfg["G"], "eps": sim.eps, "softening": cfg["softening"]}
    fresh = {"m": torch.as_tensor(m, device=device), "x": torch.as_tensor(x, device=device),
             "v": torch.as_tensor(v, device=device),
             "ao": torch.zeros(x.shape, dtype=first["x"].dtype, device=device)}
    size = mix["force_sample"]
    readings = [check.compare_step(fresh, first, spec, check.sample_rows(seed, 2, n, size))]
    if after is None:
        readings.append({name: check.NOT_FINITE for name in check.NUMBERS})
    else:
        readings.append(check.compare_step(before, after, spec, check.sample_rows(seed, 3, n, size)))
    failed = sum(not check.verdict(r, limits)[0] for r in readings)
    worst = check.worst(readings)
    ok, lines = check.verdict(worst, limits)

    if traced:
        metrics = {}
        for metric in book.per_layer(workload):
            value = book.reader(metric["name"])(rec)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        values = {"step_s": step_s, "setup_s": setup_s}
        metrics = {m_["name"]: {"value": values[m_["name"]], "unit": m_["unit"]}
                   for m_ in book.end_to_end(workload)}
    result = {"correct": ok, "attempted": steps, "failed": failed, "metrics": metrics,
              "device": _device(device, cell["chips"], peak)}
    if traced:
        result["device"].update(busy_s=rec["busy_s"], window_s=rec["wall_s"])
        result["breakdown"] = trace.breakdown(rec)
        result["work"] = {"interactions": work["interactions"], "per_body": work["per_body"],
                          "bound_s": bound["seconds"], "bound_by": bound["bound_by"]}
    result["checked_steps"] = [0, mix["warmup_steps"] + j]
    result["readings"] = worst
    result["check_s"] = time.perf_counter() - t_check
    result["setup_marks"] = marks
    result["checks"] = {name: {"value": worst[name], "limit": limits[name]}
                        for name in check.NUMBERS if name in limits}
    return result, lines


def _device(device, count: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
           "memory_peak_bytes": peak}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                                f"--id={device.index or 0}"], capture_output=True, text=True,
                               timeout=20).stdout.strip()
        if limit:
            out["power_limit"] = limit
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    book = manifest.Manifest()
    cell = book.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             device=torch.device("cuda", 0), book=book)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
