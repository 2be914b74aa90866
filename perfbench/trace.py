"""Read a stretch of whole steps from torch.profiler into the trace record
that the per-layer metrics (metrics/*.py) read.

The stretch is profiled with CPU and CUDA activities and exported as a
Chrome trace into a temporary directory, which is read and removed. The
record holds each device operation (kernels, copies and fills) with its
interval, whether a kernel is the port's own, the host's operations, the
stretch's wall time (host clock) and steps, the span from the first device
operation's start to the last one's end (trace clock), and the host synchronisations of one step
under CUDA's sync debug mode.

A kernel is the port's when its name is one that the port's own sources
define: a __global__ function of nbody_torch/csrc/*.cu and *.cuh, or a
@triton.jit function of nbody_torch's Python files. Every other kernel is
PyTorch's, the glue. A new kernel of the port falls on its side by its
definition alone.
"""

from __future__ import annotations

import json
import re
import tempfile
import time
import warnings
from pathlib import Path

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+([A-Za-z_]\w*)\s*\(")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")


def port_kernel_names(package: Path) -> set[str]:
    """The kernel names that the package's own sources define."""
    names = set()
    for src in [*package.glob("csrc/*.cu"), *package.glob("csrc/*.cuh")]:
        names.update(_GLOBAL.findall(src.read_text()))
    for src in package.rglob("*.py"):
        text = src.read_text()
        if "triton.jit" in text:
            names.update(_TRITON.findall(text))
    return names


def kernel_base(name: str) -> str:
    """A profiler kernel name without its return type, template arguments
    and parameters; a namespace other than an anonymous one stays on it
    ("void at::native::foo<float>(...)" -> "at::native::foo")."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i >= 0]
    return name[:min(cut)] if cut else name


def union_seconds(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Seconds covered by the union of (start, end) intervals in
    microseconds, and the merged intervals in order."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, [(s, e) for s, e in merged]


def record_from_events(events: list[dict], port_names: set[str], steps: int,
                       wall_s: float) -> dict:
    """The trace record of a stretch from its Chrome-trace events."""
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            device.append({"name": ev.get("name", ""), "cat": cat, "start": span[0],
                           "end": span[1],
                           "port": cat == "kernel" and kernel_base(ev.get("name", "")) in port_names})
        elif cat in HOST_CATS:
            host.append({"name": ev.get("name", ""), "cat": cat, "start": span[0], "end": span[1]})
    busy_s, merged = union_seconds([(d["start"], d["end"]) for d in device])
    span_s = (merged[-1][1] - merged[0][0]) / 1e6 if merged else 0.0
    return {"steps": steps, "wall_s": wall_s, "busy_s": busy_s, "span_s": span_s,
            "device": device, "host": host,
            "gaps": [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]}


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle gaps
    summed by what the host was doing at each gap's middle: the innermost
    PyTorch operation then running, else the innermost runtime call, else
    Python between calls."""
    by_op: dict[str, float] = {}
    for d in rec["device"]:
        key = kernel_base(d["name"]) if d["cat"] == "kernel" else d["name"]
        by_op[key] = by_op.get(key, 0.0) + (d["end"] - d["start"]) / 1e6
    ops = sorted(rec["host"], key=lambda h: h["start"])
    by_gap: dict[str, float] = {}
    live: list[dict] = []   # host operations begun before the gap's middle
    i = 0
    for g0, g1 in sorted(rec["gaps"]):
        mid = 0.5 * (g0 + g1)
        while i < len(ops) and ops[i]["start"] <= mid:
            live.append(ops[i])
            i += 1
        live = [h for h in live if h["end"] >= mid]
        cpu = [h for h in live if h["cat"] == "cpu_op"] or live
        name = min(cpu, key=lambda h: h["end"] - h["start"])["name"] if cpu else "python"
        by_gap[name] = by_gap.get(name, 0.0) + (g1 - g0) / 1e6
    best = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(by_op), "idle_gaps": best(by_gap)}


def profile_stretch(step, state, k0: int, steps: int, port_names: set[str]):
    """Run `steps` whole steps from step index k0 under the profiler; returns
    (state, record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(k0, k0 + steps):
            state, _ = step(state, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return state, record_from_events(events, port_names, steps, wall)


def host_syncs(step, state, k: int):
    """One step under CUDA's sync debug mode: every operation that makes
    the host wait for the device warns once per call. Returns (state,
    count)."""
    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state, _ = step(state, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return state, sum("synchroniz" in str(w.message) for w in caught)
