"""The port of scripts/probe_entries_kernel.py: the cost model of the
table-driven entries kernel (entries_tables_kernel, ops/cuda_group_eval).

It splits the cost of an entry into the per-entry overhead and the pair
math by timing synthetic entry lists of n bodies in tiles of 512: E real
entries over whole blocks of S bodies, E pad entries (the tables' pad
row, lo == hi, no math), and the same pairs delivered as half the entries
at twice S. The script's N = 1,000,000 cannot run (its 1,953 tiles do not
divide E = 393,216, and its reshape raises before the first call), so
the default n is 2^20: 2,048 tiles of 192 entries.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.ops import cuda_group_eval as cg
from nbody_torch.probes import chained, device_name, log
from nbody_torch.utils.measure import scan_seconds_per_step

TILE = 512
DIM = 3
E = 393_216  # ~200 entries a tile, a multiple of 49,152 (the script's)
CHUNKS = 8  # the entries go to the kernel as (8, E / 8)
MODES = ((256, "real"), (256, "pad"), (512, "real"), (1024, "real"), (256, "half_real"))


def workload(n: int, e_total: int = E):
    """The script's inputs, drawn in its order from default_rng(0): the
    bodies (x (n, 3), m (n,), float32), then per mode (S, mode, e, entries
    (8, e / 8) int32, blk_tbl, lohi_tbl), a generator (each real mode
    draws its blocks after the previous mode's). Entry (tile << 16 | g),
    e / tiles per tile, g sorted within each tile; row g < n / S of the
    tables is block g, whole; row n / S is the pad row (lo == hi == 0)."""
    ntiles = n // TILE
    for S, mode in MODES:
        e = e_total // 2 if mode == "half_real" else e_total
        if n % S or ntiles == 0 or e % ntiles or e % CHUNKS:
            raise ValueError(f"n {n} and E {e_total}: {e} entries do not split into {ntiles} "
                             f"tiles of 512 and {CHUNKS} chunks, or S {S} does not divide n")
    rng = np.random.default_rng(0)
    x = rng.uniform(-100, 100, (n, DIM)).astype(np.float32)
    m = rng.uniform(0.1, 1.0, n).astype(np.float32)
    yield x, m
    for S, mode in MODES:
        nblocks = n // S
        e = e_total // 2 if mode == "half_real" else e_total
        pt = e // ntiles
        tid = np.repeat(np.arange(ntiles, dtype=np.int32), pt)
        if mode == "pad":
            gbe = np.full(e, nblocks, np.int32)
        else:
            gbe = rng.integers(0, nblocks, e).astype(np.int32)
            gbe = np.sort(gbe.reshape(ntiles, pt), axis=1).reshape(-1)
        entries = ((tid << 16) | gbe).reshape(CHUNKS, -1)
        blk_tbl = np.concatenate([np.arange(nblocks, dtype=np.int32), np.zeros(1, np.int32)])
        lohi = np.concatenate([np.full(nblocks, S << 16, np.int32), np.zeros(1, np.int32)])
        yield S, mode, e, entries, blk_tbl, lohi


def run(out: str, n: int, e_total: int, dev: torch.device) -> None:
    """Time every mode at n bodies; one JSON line each, then entries_done."""
    eps = float(np.finfo(np.float32).eps)
    cases = workload(n, e_total)
    x, m = (torch.tensor(a, device=dev) for a in next(cases))
    for S, mode, e, entries, blk_tbl, lohi in cases:
        entries, blk_tbl, lohi = (torch.tensor(a, device=dev) for a in (entries, blk_tbl, lohi))

        def call(c, S=S, entries=entries, blk_tbl=blk_tbl, lohi=lohi):
            return cg.entries_tables_eval_cuda(c, m, c, entries, blk_tbl, lohi, eps, S, TILE)

        cg.reset_launch_counts()
        dt = scan_seconds_per_step(chained(call, 1e-12), (x,), dev, iters_short=1, iters_long=3,
                                   repeats=2)
        log(out, {"probe": "entries", "S": S, "mode": mode, "E": e, "sec": dt,
                  "us_per_entry": dt / e * 1e6,
                  "pairs_per_s": 0 if mode == "pad" else e * TILE * S / dt, "n": n,
                  "device": device_name(dev), "kernel": "entries_tables_kernel",
                  "launches": {k: v for k, v in cg.launch_counts.items() if v}})
    log(out, {"probe": "entries_done"})
