"""Barnes-Hut octree, fast path (the port of nbody_tpu.ops.octree).

The tree is rebuilt every step from a sort, as in nbody_tpu: positions are
quantized into a robust box, interleaved into Morton keys, and the bodies
are sorted by key; every level's cells are then contiguous runs of the
sorted bodies (see nbody_tpu/ops/octree.py for the derivation from the
reference's CAS insertion, octree.h:114-181). The force comes from
ops.octree_group.compute_force_grouped_fast and is scattered back to the
caller's body order: the octree never reorders the state.

The list path (float64 runs, and --kernel torch) builds the level tree
instead (build_octree: per-level node arrays from segmented reductions
over the sorted bodies, in the reference's square box, scalar_bounds) and
takes ops.octree_group.compute_force_grouped.

Keys are int64 with explicit masks: torch has no right shift for uint32,
and a 2-D key at depth 16 fills 32 bits. The per-body walk is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nbody_torch.ops.geometry import scalar_bounds
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


def _level_capacity(level: int, n: int, dim: int) -> int:
    """Static upper bound on the node count at `level`: min(2^(level*dim), n)."""
    if level * dim >= max(n, 1).bit_length() + 1:
        return n
    return min(1 << (level * dim), n)


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


@dataclasses.dataclass
class OctreeLevels:
    """Per-level node arrays, flattened level after level and padded to
    each level's static capacity; the integer arrays are int64."""
    mass: torch.Tensor         # (total_cap,)
    com: torch.Tensor          # (total_cap, dim)
    start: torch.Tensor        # (total_cap,) first sorted-body index
    count: torch.Tensor        # (total_cap,) bodies in the node (0 = padding)
    child_start: torch.Tensor  # (total_cap,) level-local index of the first child
    child_count: torch.Tensor  # (total_cap,)
    parent: torch.Tensor       # (total_cap,) level-local index of the parent
    offsets: tuple             # flat offset of each level
    caps: tuple                # capacity of each level
    depth: int


def build_octree(m: torch.Tensor, x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 depth: int):
    """Sort the bodies by Morton key over the box [lo, hi] (stable) and
    derive every level's nodes by segmented reductions over the sorted
    order, as nbody_tpu.ops.octree.build_octree does (octree.py:111-195):
    level l's nodes are the runs of equal l-level key prefixes. Returns
    (levels, perm, ms, xs): the sort permutation and the sorted bodies.
    On a GPU index_add_ adds atomically, so a node's mass and centre can
    differ from the CPU's in the last bits; the integer arrays cannot."""
    n, dim = x.shape
    dev = x.device
    keys = morton_keys(x, lo, hi, depth)
    perm = torch.sort(keys, stable=True).indices
    ks, ms, xs = keys[perm], m[perm], x[perm]
    mxs = ms[:, None] * xs

    caps = tuple(_level_capacity(level, n, dim) for level in range(depth + 1))
    offsets = tuple(sum(caps[:level]) for level in range(depth + 1))
    i64 = dict(dtype=torch.int64, device=dev)
    body_idx = torch.arange(n, **i64)
    ones = torch.ones(n, **i64)
    mass, com, start, count, child_start, child_count, parent = ([] for _ in range(7))
    node_id_prev = None
    for level in range(depth + 1):
        cap = caps[level]
        pfx = ks >> ((depth - level) * dim)
        newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), pfx[1:] != pfx[:-1]])
        node_id = torch.cumsum(newseg, 0) - 1
        nid = node_id.clamp_max(cap - 1)
        lmass = ms.new_zeros(cap).index_add_(0, nid, ms)
        lmx = xs.new_zeros(cap, dim).index_add_(0, nid, mxs)
        lcount = torch.zeros(cap, **i64).index_add_(0, nid, ones)
        lstart = torch.full((cap,), n, **i64).scatter_reduce_(0, nid, body_idx, "amin")
        start.append(torch.where(lcount > 0, lstart, 0))
        mass.append(lmass)
        com.append(lmx / torch.where(lmass == 0, torch.ones_like(lmass), lmass)[:, None])
        count.append(lcount)
        if level > 0:
            # level l's nodes under a level-(l-1) node are a contiguous run:
            # its first node id (that of a segment head) and how many heads
            pcap = caps[level - 1]
            pid = node_id_prev.clamp_max(pcap - 1)
            cs = torch.full((pcap,), n, **i64).scatter_reduce_(
                0, pid, torch.where(newseg, nid, n), "amin")
            cc = torch.zeros(pcap, **i64).index_add_(0, pid, newseg.long())
            child_start.append(torch.where(cc > 0, cs, 0))
            child_count.append(cc)
            # each node's parent: its head body's level-(l-1) node
            par = torch.full((cap,), -1, **i64).scatter_reduce_(
                0, nid, torch.where(newseg, pid, -1), "amax")
            parent.append(par.clamp_min(0))
        else:
            parent.append(torch.zeros(cap, **i64))
        node_id_prev = node_id
    # the deepest level has no children
    child_start.append(torch.zeros(caps[depth], **i64))
    child_count.append(torch.zeros(caps[depth], **i64))
    levels = OctreeLevels(mass=torch.cat(mass), com=torch.cat(com), start=torch.cat(start),
                          count=torch.cat(count), child_start=torch.cat(child_start),
                          child_count=torch.cat(child_count), parent=torch.cat(parent),
                          offsets=offsets, caps=caps, depth=depth)
    return levels, perm, ms, xs


def tree_size_from_keys(ks: torch.Tensor, depth: int, dim: int) -> torch.Tensor:
    """Occupied-node count for --print-info (octree.h:313-316): the root
    plus, per level, the number of distinct sorted-key prefixes."""
    size = torch.ones((), dtype=torch.int64, device=ks.device)
    for level in range(1, depth + 1):
        pre = ks >> ((depth - level) * dim)
        size = size + 1 + (pre[1:] != pre[:-1]).sum()
    return size


def octree_step_force(state: SystemState, theta: float, G: float, eps: float, depth: int,
                      group_tile: int = 512, window_tiles: int = 32, list_path: bool = False,
                      use_cuda: bool = True):
    """One octree force evaluation, scattered back to the caller's order.
    The fast path (octree.py:424-447): robust box -> Morton sort ->
    grouped fast force. With list_path (octree.py:448-467, float64 runs
    and --kernel torch): scalar box -> build_octree -> grouped list force,
    through the CUDA kernels' wrappers, or their plain twins where not
    use_cuda. Returns (state with a, aux) with aux holding the device
    scalars "overflow", "tree_size" and "root_mass"."""
    from nbody_torch.ops.octree_group import compute_force_grouped, compute_force_grouped_fast

    if list_path:
        lo, hi = scalar_bounds(state.x)
        levels, perm, ms, xs = build_octree(state.m, state.x, lo, hi, depth)
        a_sorted, info = compute_force_grouped(levels, ms, xs, hi - lo, theta, G, eps,
                                               tile=group_tile, use_cuda=use_cuda)
        aux = {"overflow": info["node_overflow"], "tree_size": (levels.count > 0).sum(),
               "root_mass": levels.mass[0]}
        return dataclasses.replace(state, a=unpermute_rows(a_sorted, perm)), aux
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
