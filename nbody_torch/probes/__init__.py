"""The ports of the TPU entry-cost probes (scripts/probe_entries_kernel.py,
probe_entry_overhead.py, probe_dma_pipeline.py), run through python -m
nbody_torch.probe entries | entry-overhead | dma-pipeline. Each module
builds its script's workload with the script's numpy draws (workload),
times each mode with the script's chained loop and
utils.measure.scan_seconds_per_step, and appends one JSON line per mode
with the script's keys, plus the device, the kernel and its launches.
entries_plan (python -m nbody_torch.probe entries-plan) is this port's own
one-off sweep of the entries kernel's plan."""

from __future__ import annotations

import json

import torch


def log(out: str, row: dict) -> None:
    """Append row to the JSON-lines file `out` and print it."""
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def chained(fn, scale: float):
    """loop(x, iters): `iters` chained calls, x <- x + scale * fn(x)[:rows],
    the scripts' scan body: each call reads the previous one's rows."""

    def loop(x, iters):
        for _ in range(iters):
            x = x + scale * fn(x)[:x.shape[0]]
        return x

    return loop


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The scripts' equivalence measure max |a - b[:rows]| / max |a|."""
    b = b[:a.shape[0]]
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))
