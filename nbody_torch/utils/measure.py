"""Seconds per step of a chained loop (the port of nbody_tpu.utils.measure).

The estimator keeps nbody_tpu's method:
  * time `iters` chained evaluations (each feeds the next, so nothing can
    be skipped);
  * take the MIN over `repeats` runs of a short and of a long loop;
  * report (long - short) / (iters_long - iters_short), which cancels the
    constant per-call cost.
On the card each run is timed with CUDA events around the loop, on the
CPU with the host clock. nbody_tpu chose the method for the latency
spikes of its TPU connection, which a local GPU does not have; the
difference still cancels the per-call cost of launching the loop. One
short run before the timed ones builds the kernels (nothing is compiled
per loop length, so the long loop needs no warm-up of its own).
"""

from __future__ import annotations

import time

import torch

from nbody_torch.utils.timing import sync


def run_seconds(loop, args, iters: int, device: torch.device) -> float:
    """Seconds of one loop(*args, iters) run on `device`, until it is done."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync(device)
        start.record()
        loop(*args, iters)
        end.record()
        sync(device)
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    loop(*args, iters)
    return time.perf_counter() - t0


def scan_seconds_per_step(loop, args, device: torch.device, iters_short: int = 2,
                          iters_long: int = 10, repeats: int = 3) -> float:
    """loop(*args, iters) must run `iters` chained steps on `device`."""
    run_seconds(loop, args, iters_short, device)  # build the kernels, warm the caches

    def timed(iters: int) -> float:
        return min(run_seconds(loop, args, iters, device) for _ in range(repeats))

    t_short = timed(iters_short)
    t_long = timed(iters_long)
    return max((t_long - t_short) / (iters_long - iters_short), 1e-9)
