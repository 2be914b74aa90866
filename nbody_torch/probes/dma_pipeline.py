"""The port of scripts/probe_dma_pipeline.py: the cost of bringing an
entry's block of sources on chip, synchronously per entry against a ring
of asynchronous copies, at the same pair math.

E entries of S sources each, all on one fixed tile of 512 rows, in blocks
of CE = 64 consecutive entries, each split into P parts in the kernel (8
at E = 8,192 on an H100), then parts_sum_kernel:

  blockspec  each entry's sources staged synchronously, 256 rows at a
             time with a block barrier, then their math (the ladder's ideal
             rung on this grid, ops/cuda_entry_probes, built at the ring's
             launch bounds: both at most 64 registers)
  manual2    a ring of 2 shared-memory slots of S rows, each filled by one
  manual4    bulk copy that completes on the slot's mbarrier, 1 copy in
             flight ahead of the math (dma_ring_kernel<2>), or 4 slots, 3
             ahead; a slot is refilled once every warp has released it

The two kernels sum each part's entries in the same order, so their
outputs agree bit for bit. math=0 is the script's PROBE_MATH=0 control:
each entry's sources are only read (every row gets the sum of their
coordinates), which leaves the copies. Each timing line carries P, the
bytes the copies move, and with math its pairs, pairs/s, their MUFU floor
and, on the card, the share of it the call reached; on the card also the
kernel's budget as the CUDA runtime reports it (registers a thread, spill bytes,
shared bytes, resident blocks an SM: cuda_entry_probes.kernel_budget).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.ops import cuda_entry_probes as ce
from nbody_torch.ops import cuda_group_eval as cg
from nbody_torch.probes import chained, device_name, log, rate_fields, rel_err
from nbody_torch.utils.measure import scan_seconds_per_step

TB = 512
NBLK = 977  # the block count of n = 1,000,000 at S = 1,024
MODES = ("blockspec", "manual2", "manual4")


def workload(e_total: int = 8192, S: int = 1024, dim: int = 3) -> dict:
    """The script's numpy inputs, drawn in its order from default_rng(42):
    xm (4, NBLK * S) float32 (coordinate rows, then the masses, a zero row
    in 2-D), xi0 (512, dim), ent (E,) random blocks."""
    rng = np.random.default_rng(42)
    xm = np.zeros((4, NBLK * S), np.float32)
    xm[:dim] = rng.standard_normal((dim, NBLK * S))
    xm[dim] = rng.uniform(0.5, 1.0, NBLK * S)
    xi0 = rng.standard_normal((TB, dim)).astype(np.float32)
    ent = rng.integers(0, NBLK, e_total).astype(np.int32)
    return {"xm": xm, "xi0": xi0, "ent": ent}


def runners(e_total: int, S: int, dim: int, math: bool, dev: torch.device):
    """(mode -> fn(x) -> its (512, dim) output, the rows xi0)."""
    w = {k: torch.tensor(v, device=dev) for k, v in workload(e_total, S, dim).items()}
    xm = cg.pack_sources(w["xm"][dim].contiguous(), w["xm"][:dim].T.contiguous())
    ent, eps = w["ent"], ce.EPS

    def ring(nbuf):
        return lambda x: ce.dma_ring_cuda(x, xm, ent, S, nbuf, eps, math)

    return {"blockspec": lambda x: ce.entry_ladder_cuda("ideal", x, xm, ent, None, S, eps,
                                                        per_block=ce.CE, math=math,
                                                        min_blocks=ce.RING_BLOCKS),
            "manual2": ring(2), "manual4": ring(4)}, w["xi0"]


def kernel_of(mode: str, math: bool) -> str:
    if mode == "blockspec":
        return ce.ladder_name("ideal", math, ce.RING_BLOCKS)
    return ce.ring_name(int(mode.removeprefix("manual")), math)


def budget_of(mode: str, math: bool, dim: int, S: int, dev: torch.device) -> dict | None:
    """The mode's kernel's budget on the card (None on the CPU)."""
    if mode == "blockspec":
        return ce.kernel_budget("ladder", "ideal", math, dim, S, dev, ce.RING_BLOCKS)
    return ce.kernel_budget("ring", int(mode.removeprefix("manual")), math, dim, S, dev)


def run(out: str, modes: list[str], e_total: int, S: int, dim: int, math: bool,
        dev: torch.device) -> None:
    """The equivalence lines (dmapipe_equiv, each mode against the first),
    then one timing line (dmapipe) per mode."""
    run_of, xi0 = runners(e_total, S, dim, math, dev)
    parts = (ce.default_parts(e_total, ce.CE,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
             if dev.type == "cuda" else None)
    ref = None
    for m in modes:
        val = run_of[m](xi0)
        if ref is None:
            ref = val
        else:
            log(out, {"probe": "dmapipe_equiv", "mode": m, "rel_err": rel_err(ref, val)})
    for m in modes:
        ce.reset_launch_counts()
        sec = scan_seconds_per_step(chained(run_of[m], 1e-30), (xi0,), dev, iters_short=1,
                                    iters_long=5, repeats=2)
        log(out, {"probe": "dmapipe", "mode": m, "E": e_total, "S": S, "dim": dim,
                  "math": int(math), "sec_per_call": sec, "us_per_entry": sec / e_total * 1e6,
                  **(rate_fields(e_total * S * TB, sec, dev) if math else {}),
                  "copied_bytes": e_total * S * 16,
                  "device": device_name(dev), "kernel": kernel_of(m, math),
                  "blocks": -(-e_total // ce.CE), "parts": parts,
                  "budget": budget_of(m, math, dim, S, dev),
                  "launches": {k: v for k, v in ce.launch_counts.items() if v}})
