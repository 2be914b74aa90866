"""The comparison that decides `correct`: one step of the program against the
plain reference (reference/direct.py), from the step's own input.

A step's answer is its output state. The program may return the bodies in
another order (the BVH keeps them Hilbert-sorted), so each output row is
matched to the input row whose reference drift it lies nearest to: the
leapfrog's new position depends on the input row alone. The numbers:

  unmatched  output rows not matched one to one with an input row of the
             same mass (exact: limit 0)
  x_gap      largest distance of an output position from its reference
             drift, over the largest reference position (every row)
  v_gap      largest gap of an output velocity from the reference kick with
             the step's own force, over the largest reference velocity
             (every row)
  ao_gap     largest gap between the output's ao and a, over the largest a
             (the leapfrog sets ao = a: exact, limit 0)
  force_gap  largest relative gap |a - a_ref| / |a_ref| over a sample of
             rows drawn from the seed, a_ref the float64 direct sum over
             every body with the tree's softening (a row with no match
             reads 1)
  force_l1   sum |a - a_ref| / sum |a_ref| over the same rows

Each number that limits/<cell>.json names is held to its limit there; a
number a cell leaves out is one whose readings the cell's control does not
separate from the program's (PERF.md says which).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import direct

NUMBERS = ("unmatched", "x_gap", "v_gap", "ao_gap", "force_gap", "force_l1")
# a reading that is not finite (a NaN or an infinity in the answer)
NOT_FINITE = 1e30


def sample_rows(seed: int, salt: int, n: int, size: int) -> np.ndarray:
    """`size` distinct rows of n drawn from the seed (every row if fewer)."""
    if size >= n:
        return np.arange(n)
    return np.sort(np.random.default_rng([seed, salt]).choice(n, size, replace=False))


def _rel_max(num: torch.Tensor, scale: torch.Tensor) -> float:
    """max |num| / max |scale| over rows, as a float."""
    top = float(torch.linalg.vector_norm(scale, dim=-1).max()) if scale.numel() else 0.0
    gap = float(torch.linalg.vector_norm(num, dim=-1).max()) if num.numel() else 0.0
    return gap / top if top > 0 else gap


def compare_step(inp: dict, out: dict, cfg: dict, rows: np.ndarray) -> dict:
    """The readings of one step: `inp` the step's input (m, x, v, ao), `out`
    its output (m, x, v, a, ao), `cfg` the configuration (dt, G, eps,
    softening), `rows` the input rows whose force is compared."""
    from scipy.spatial import cKDTree

    f64 = torch.float64
    n = inp["m"].shape[0]
    if out["x"].shape != inp["x"].shape or out["m"].shape != inp["m"].shape:
        return {k: (float(n) if k == "unmatched" else NOT_FINITE) for k in NUMBERS}
    x_ref = direct.drift(inp["x"], inp["v"], inp["ao"], cfg["dt"], f64)
    x_out = out["x"].to(f64)
    finite = bool(torch.isfinite(x_out).all())
    x_out_h = np.nan_to_num(x_out.cpu().numpy(), nan=NOT_FINITE, posinf=NOT_FINITE,
                            neginf=-NOT_FINITE)
    dist, idx = cKDTree(x_ref.cpu().numpy()).query(x_out_h, k=1)
    idx = np.minimum(idx, n - 1)
    hits = np.bincount(idx, minlength=n)
    same_mass = (out["m"].cpu().numpy() == inp["m"].cpu().numpy()[idx])
    one_to_one = (hits[idx] == 1) & same_mass
    x_scale = float(torch.linalg.vector_norm(x_ref, dim=-1).max())
    readings = {"unmatched": float(n - np.count_nonzero(one_to_one)),
                "x_gap": float(dist.max()) / x_scale if finite else NOT_FINITE}
    src = torch.as_tensor(idx, device=inp["x"].device)
    a_out = out["a"].to(f64)
    v_ref = direct.kick(inp["v"][src], a_out, inp["ao"][src], cfg["dt"], f64)
    readings["v_gap"] = _rel_max(out["v"].to(f64) - v_ref, v_ref)
    readings["ao_gap"] = _rel_max(out["ao"].to(f64) - a_out, a_out)
    # the output row of each input row, where exactly one output row matched it
    where = np.full(n, -1)
    where[idx[one_to_one]] = np.flatnonzero(one_to_one)
    got = where[rows]
    a_ref = direct.accel(inp["x"][torch.as_tensor(rows, device=inp["x"].device)], inp["m"],
                         inp["x"], cfg["G"], cfg["eps"], cfg["softening"], f64)
    ok = torch.as_tensor(got >= 0, device=a_ref.device)
    a_got = a_out[torch.as_tensor(np.maximum(got, 0), device=a_ref.device)]
    gap = torch.linalg.vector_norm(a_got - a_ref, dim=-1)
    size = torch.linalg.vector_norm(a_ref, dim=-1)
    gap = torch.where(ok, gap, size)
    readings["force_gap"] = float((gap / size).max()) if gap.numel() else 0.0
    readings["force_l1"] = float(gap.sum() / size.sum()) if gap.numel() else 0.0
    return {k: (v if math.isfinite(v) else NOT_FINITE) for k, v in readings.items()}


def worst(readings: list[dict]) -> dict:
    """Each number's largest reading over several steps."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def verdict(readings: dict, limits: dict) -> tuple[bool, list[str]]:
    """(every number that `limits` names within its limit, one line per
    number)."""
    lines, ok = [], True
    for k in (k for k in NUMBERS if k in limits):
        good = readings[k] <= limits[k]
        ok &= good
        lines.append(f"check {k} {readings[k]!r} limit {limits[k]!r} {'ok' if good else 'FAILED'}")
    return ok, lines
