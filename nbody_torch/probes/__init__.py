"""The ports of the TPU entry-cost probes (scripts/probe_entries_kernel.py,
probe_entry_overhead.py, probe_dma_pipeline.py), run through python -m
nbody_torch.probe entries | entry-overhead | dma-pipeline. Each module
builds its script's workload with the script's numpy draws (workload),
times each mode with the script's chained loop and
utils.measure.scan_seconds_per_step, and appends one JSON line per mode
with the script's keys, plus the device, the kernel and its launches.
entries_plan (python -m nbody_torch.probe entries-plan) is this port's own
one-off sweep of the entries kernel's plan. The entry-cost lines also
carry each mode's computed pairs and their MUFU floor (mufu_floor_ms),
worked out, not measured, and on the card the share of it the call
reached (mufu_share)."""

from __future__ import annotations

import json

import torch


def log(out: str, row: dict) -> None:
    """Append row to the JSON-lines file `out` and print it."""
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


# H100 SXM: SMs, boost clock (NVIDIA's data sheet) and the multi-function
# unit's results a clock on an SM (Hopper: 16, against 128 FP32 lanes)
H100_SMS = 132
MAX_SM_CLOCK_HZ = 1.98e9
MUFU_PER_SM_CLOCK = 16


def mufu_floor_ms(pairs: int, sms: int) -> float:
    """Two MUFU operations a pair (the chain's root and reciprocal) at
    MUFU_PER_SM_CLOCK a clock on each of `sms` SMs at the boost clock:
    worked out, not measured."""
    return pairs * 2 / (sms * MUFU_PER_SM_CLOCK * MAX_SM_CLOCK_HZ) * 1e3


def rate_fields(pairs: int, sec: float, dev: torch.device) -> dict:
    """An entry-cost line's pairs, pairs/s, MUFU floor (on the CPU, for an
    H100's H100_SMS SMs) and, on the card, the share of the floor the call
    reached (None on the CPU)."""
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda"
           else H100_SMS)
    floor = mufu_floor_ms(pairs, sms)
    return {"pairs": pairs, "pairs_per_s": pairs / sec if sec > 0 else 0.0,
            "mufu_floor_ms": floor,
            "mufu_share": floor / (sec * 1e3) if dev.type == "cuda" and sec > 0 else None}


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
