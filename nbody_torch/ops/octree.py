"""Barnes-Hut octree, fast path (the port of nbody_tpu.ops.octree).

The tree is rebuilt every step from a sort, as in nbody_tpu: positions are
quantized into a robust box, interleaved into Morton keys, and the bodies
are sorted by key; every level's cells are then contiguous runs of the
sorted bodies (see nbody_tpu/ops/octree.py for the derivation from the
reference's CAS insertion, octree.h:114-181). The force comes from
ops.octree_group.compute_force_grouped_fast and is scattered back to the
caller's body order: the octree never reorders the state.

Keys are int64 with explicit masks: torch has no right shift for uint32,
and a 2-D key at depth 16 fills 32 bits. Only the fast path
(traversal "group" in float32) is ported; the list paths and the
per-body walk are not.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nbody_torch.ops.permutation import unpermute_rows
from nbody_torch.state import SystemState


def max_depth(n: int, dim: int) -> int:
    """Key depth: enough levels for ~16 bodies per deepest cell on average,
    capped by the 32-bit key budget of nbody_tpu (16 levels in 2-D, 10 in
    3-D)."""
    cap = 16 if dim == 2 else 10
    need = 0
    cells = 1
    while cells < 16 * max(n, 2) and need < cap:
        need += 1
        cells <<= dim
    return max(need, 2)


def morton_keys(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, depth: int) -> torch.Tensor:
    """Quantize positions into the box [lo, hi] and interleave the cell
    coordinates into int64 Morton keys, coordinate d of level bit b at
    bit b*dim + d (the reference's child index sum_d 2^d (pos_d > centre_d),
    octree.h:130-137). Out-of-box bodies clamp into the edge cells."""
    n, dim = x.shape
    top = (1 << depth) - 1
    # scalars are filled on the device: a host-made tensor would synchronise
    scale = torch.full((), float(1 << depth), dtype=x.dtype, device=x.device) / (hi - lo)
    # clamping before the integer cast gives nbody_tpu's cast-then-clip
    # for every finite position, without a float -> int overflow
    cell = ((x - lo) * scale).clamp(0, top).to(torch.int64)
    key = torch.zeros(n, dtype=torch.int64, device=x.device)
    for d in range(dim):
        xc = cell[:, d]
        for b in range(depth):
            key |= ((xc >> b) & 1) << (b * dim + d)
    return key


def robust_quant_box(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fast path's quantization box (octree.py:337-379): the 0.5% and
    99.5% quantiles of a strided subsample, widened by 15% of their span,
    never past the true bounds, then by +-1. A cube in 3-D, per dimension
    in 2-D. Returns (lo, hi), each of shape (dim,)."""
    stride = max(1, x.shape[0] // 16384)
    qlo, qhi = _quantiles(x[::stride], (0.005, 0.995))
    margin = torch.full((), 0.15, dtype=x.dtype, device=x.device)
    if x.shape[1] == 3:
        span = (qhi - qlo).max()
        lo_r = torch.maximum(qlo.min() - margin * span, x.min()) - 1.0
        hi_r = torch.minimum(qhi.max() + margin * span, x.max()) + 1.0
        return lo_r.expand(3).clone(), hi_r.expand(3).clone()
    span = qhi - qlo
    lo_r = torch.maximum(qlo - margin * span, x.amin(0)) - 1.0
    hi_r = torch.minimum(qhi + margin * span, x.amax(0)) + 1.0
    return lo_r, hi_r


def _quantiles(a: torch.Tensor, qs: tuple[float, ...]) -> list[torch.Tensor]:
    """Per-column quantiles of a (m, dim) with linear interpolation, in
    jnp.quantile's arithmetic (the q-weighted sum of the two neighbours,
    in float64 as under jax_enable_x64), rounded to a's dtype."""
    v = torch.sort(a, dim=0).values.double()
    out = []
    for q in qs:
        pos = q * (a.shape[0] - 1)
        w = pos - math.floor(pos)
        out.append((v[math.floor(pos)] * (1 - w) + v[math.ceil(pos)] * w).to(a.dtype))
    return out


def morton_sort(m: torch.Tensor, x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                depth: int):
    """Morton keys and a stable sort of the bodies by key. Returns
    (ms, xs, ks, perm), bit-equal to nbody_tpu's lax.sort with an iota
    operand."""
    keys = morton_keys(x, lo, hi, depth)
    ks, perm = torch.sort(keys, stable=True)
    return m[perm], x[perm], ks, perm


def tree_size_from_keys(ks: torch.Tensor, depth: int, dim: int) -> torch.Tensor:
    """Occupied-node count for --print-info (octree.h:313-316): the root
    plus, per level, the number of distinct sorted-key prefixes."""
    size = torch.ones((), dtype=torch.int64, device=ks.device)
    for level in range(1, depth + 1):
        pre = ks >> ((depth - level) * dim)
        size = size + 1 + (pre[1:] != pre[:-1]).sum()
    return size


def octree_step_force(state: SystemState, theta: float, G: float, eps: float, depth: int,
                      group_tile: int = 512, window_tiles: int = 32):
    """One octree force evaluation on the fast path (octree.py:424-447):
    robust box -> Morton sort -> grouped fast force -> scatter back to the
    caller's order. Returns (state with a, aux) with aux holding the
    device scalars "overflow", "tree_size" and "root_mass"."""
    from nbody_torch.ops.octree_group import compute_force_grouped_fast

    lo_r, hi_r = robust_quant_box(state.x)
    ms, xs, ks, perm = morton_sort(state.m, state.x, lo_r, hi_r, depth)
    a_sorted, info = compute_force_grouped_fast(ms, xs, ks, depth, theta, G, eps,
                                                tile=group_tile, window_tiles=window_tiles)
    aux = {
        "overflow": info["node_overflow"],
        "tree_size": tree_size_from_keys(ks, depth, state.dim),
        "root_mass": state.m.sum(dtype=torch.float64).to(state.m.dtype),
    }
    return dataclasses.replace(state, a=unpermute_rows(a_sorted, perm)), aux
