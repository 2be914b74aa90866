"""The port of scripts/probe_entry_overhead.py: where does the near-field
entry kernel's time go beyond the pair math?

A ladder of kernels adds the production entry kernel's features one at a
time (ops/cuda_entry_probes, csrc/entry_probes.cu):

  ideal    packed (N, 4) sources, every entry full width, one fixed tile
  sepmj    + the sources split into mj (N,) and xj (N, dim)
  sel      ideal + a 0/1 lane weight for the entry's [lo, hi)
  when     sel under a block-uniform hi > lo branch
  switch   sel + tile switching: each entry acts on, and writes, the rows
           of its tile over T tiles
  prod     the production kernel, entries_lohi_eval_cuda
  prod_noskip, prod_packed, prod_packed_noskip
           the production call's variants: the full-width masked pass on
           split sources (the noskip rung), the packed production kernel,
           and the full-width pass on packed sources (the switch rung)

Every rung runs on the production kernel's design (the two-MUFU chain,
16-byte staged sources, kGroup-term sums, 5 blocks an SM): T blocks of E /
T consecutive entries, each split into P parts in the kernel (8 at E =
8,192 on an H100: 1,024 parts), then parts_sum_kernel; the production
kernel runs on its plan's equal-work parts (cuda_group_eval.entries_plan).
The script's grid of E steps ran in order on one TPU core. Each timing
line carries the mode's computed pairs (every lane of each entry a rung
runs; the production kernel's live lanes), pairs/s, their MUFU floor and,
on the card, the share of it the call reached; a rung's line also its P
and, on the card, its kernel's budget as the CUDA runtime reports it (registers,
spill and shared bytes, resident blocks an SM: kernel_budget).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.ops import cuda_entry_probes as ce
from nbody_torch.ops import cuda_group_eval as cg
from nbody_torch.probes import chained, device_name, log, rate_fields, rel_err
from nbody_torch.utils.measure import scan_seconds_per_step

TB = 512
E = 8192
T = 128  # tiles touched by switch and prod, and the rungs' blocks
MODES = ("ideal", "sepmj", "sel", "when", "switch", "prod", "prod_noskip", "prod_packed",
         "prod_packed_noskip")
EQUIV = (("ideal", "sepmj"), ("sel", "when"), ("switch", "prod"))
# mode -> the ladder rung that runs it, or None for the production kernel
RUNG = {"ideal": "ideal", "sepmj": "sepmj", "sel": "sel", "when": "when", "switch": "switch",
        "prod": None, "prod_noskip": "noskip", "prod_packed": None,
        "prod_packed_noskip": "switch"}


def workload(S: int, e_total: int = E, dim: int = 3, tiles: int = T) -> dict:
    """The script's numpy inputs, drawn in its order from default_rng(42):
    xm (4, npad) float32 (coordinate rows, then the masses, a zero row in
    2-D) over nblk = ceil(1e6 / S) blocks; xi_all (tiles * 512, dim);
    ents (E,) random blocks, tile-sorted e / tiles per tile as ent_tiled;
    lohi = lo | hi << 16, mean width ~0.88 S."""
    if e_total <= 0 or e_total % tiles:
        raise ValueError(f"E {e_total} must be a positive multiple of T {tiles}")
    nblk = (1_000_000 + S - 1) // S
    npad = nblk * S
    rng = np.random.default_rng(42)
    xm = np.zeros((4, npad), np.float32)
    xm[:dim] = rng.standard_normal((dim, npad))
    xm[dim] = rng.uniform(0.5, 1.0, npad)
    xi_all = rng.standard_normal((tiles * TB, dim)).astype(np.float32)
    ept = e_total // tiles
    ents = rng.integers(0, nblk, e_total).astype(np.int32)
    tids = np.repeat(np.arange(tiles, dtype=np.int32), ept)[:e_total]
    lo = rng.integers(0, S // 8, e_total).astype(np.int32)
    hi = np.clip(S - rng.integers(0, S // 8, e_total), 1, S).astype(np.int32)
    return {"xm": xm, "xi_all": xi_all, "ents": ents, "ent_tiled": (tids << 16) | ents,
            "lohi": lo | (hi << 16)}


def runners(S: int, e_total: int, dim: int, tiles: int, dev: torch.device) -> dict:
    """mode -> (fn(x) -> its output, the rows x it starts from)."""
    w = {k: torch.tensor(v, device=dev) for k, v in workload(S, e_total, dim, tiles).items()}
    mj, xj = w["xm"][dim].contiguous(), w["xm"][:dim].T.contiguous()
    packed = cg.pack_sources(mj, xj)
    xi_all, xi0 = w["xi_all"], w["xi_all"][:TB].contiguous()
    ent_plain, ent_tiled, lohi = w["ents"], w["ent_tiled"], w["lohi"]
    n_real = torch.tensor(e_total, device=dev)
    eps = ce.EPS

    def rung(name, src, ents, lohis, tb):
        return lambda x: ce.entry_ladder_cuda(name, x, src, ents, lohis, S, eps, tb=tb,
                                              per_block=e_total // tiles)

    def prod(packed_j):
        return lambda x: cg.entries_lohi_eval_cuda(x, mj, xj, ent_tiled, lohi, n_real, S, tiles,
                                                   eps, "sqrt3", packed=packed_j)

    return {"ideal": (rung("ideal", packed, ent_plain, None, TB), xi0),
            "sepmj": (rung("sepmj", (mj, xj), ent_plain, None, TB), xi0),
            "sel": (rung("sel", packed, ent_plain, lohi, TB), xi0),
            "when": (rung("when", packed, ent_plain, lohi, TB), xi0),
            "switch": (rung("switch", packed, ent_tiled, lohi, TB), xi_all),
            "prod": (prod(False), xi_all),
            "prod_noskip": (rung("noskip", (mj, xj), ent_tiled, lohi, TB), xi_all),
            "prod_packed": (prod(True), xi_all),
            "prod_packed_noskip": (rung("switch", packed, ent_tiled, lohi, TB), xi_all)}


def computed_pairs(mode: str, lohi: np.ndarray, S: int) -> int:
    """The pairs `mode` computes on the workload's E entries: a rung every
    lane of each entry it runs (when skips hi <= lo), the production
    kernel the live lanes [lo, min(hi, S)); TB rows each."""
    lo, hi = lohi & 0xFFFF, lohi >> 16
    if RUNG[mode] is None:
        return int(np.maximum(np.minimum(hi, S) - lo, 0).sum()) * TB
    if mode == "when":
        return int((hi > lo).sum()) * S * TB
    return lohi.shape[0] * S * TB


def kernel_of(mode: str) -> str:
    """The launch_counts key of the kernel that runs `mode`."""
    if RUNG[mode] is not None:
        return ce.ladder_name(RUNG[mode])
    return "entries_lohi_kernel<packed>" if mode == "prod_packed" else "entries_lohi_kernel"


def run(out: str, modes: list[str], S: int, tiles: int, e_total: int, dim: int,
        dev: torch.device) -> None:
    """The equivalence lines (entov_equiv), then one timing line (entov) per mode."""
    run_of = runners(S, e_total, dim, tiles, dev)
    lohi = workload(S, e_total, dim, tiles)["lohi"]
    parts = (ce.default_parts(e_total, e_total // tiles,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
             if dev.type == "cuda" else None)
    vals = {m: run_of[m][0](run_of[m][1]) for m in modes}
    for a, b in EQUIV:
        if a in vals and b in vals:
            log(out, {"probe": "entov_equiv", "pair": f"{a}=={b}", "S": S,
                      "rel_err": rel_err(vals[a], vals[b])})
    del vals
    for m in modes:
        fn, arg = run_of[m]
        ce.reset_launch_counts()
        cg.reset_launch_counts()
        sec = scan_seconds_per_step(chained(fn, 1e-30), (arg,), dev, iters_short=1, iters_long=5,
                                    repeats=2)
        launches = {k: v for k, v in {**ce.launch_counts, **cg.launch_counts}.items() if v}
        log(out, {"probe": "entov", "mode": m, "E": e_total, "S": S, "dim": dim, "T": tiles,
                  "sec_per_call": sec, "us_per_entry": sec / e_total * 1e6,
                  **rate_fields(computed_pairs(m, lohi, S), sec, dev),
                  "device": device_name(dev), "kernel": kernel_of(m),
                  "blocks": tiles, "parts": parts if RUNG[m] is not None else None,
                  "budget": (ce.kernel_budget("ladder", RUNG[m], True, dim, S, dev)
                             if RUNG[m] is not None else None),
                  "launches": launches})
