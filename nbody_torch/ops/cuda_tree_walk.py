"""The trees' faithful per-body walks: wrappers of csrc/tree_walk.cu's
kernels, their launch counts, and their plain twins.

  bvh_walk_kernel<T, DIM>     the walk of nbody_tpu/ops/bvh.py:129
                              compute_force (a vmapped lax.while_loop, no
                              Pallas kernel): stackless, MAC bw^2 < theta^2
                              d2, the poly softening d2 sqrt(d2) + eps
  octree_walk_kernel<T, DIM>  the walk of nbody_tpu/ops/octree.py:198
                              compute_force (the same): VISIT, the queued
                              direct sums, ADVANCE over the level tree, MAC
                              side_l / (sqrt(d2) + eps) < theta, the sqrt3
                              softening (sqrt(d2) + eps)^3
  octree_pack_kernel<T, DIM>  the octree's packed records and ropes
                              (octree_records_cuda; octree_records_torch
                              is its plain version)

One CUDA thread walks one sorted body (csrc/tree_walk.cu says why), over
packed records built once a call: the BVH's {c, bw, mm} nodes (in 3-D
float32 {c, bw} beside mm: mass_apart) and {x, m} bodies by plain torch
copies (bvh_records, body_records), the octree's int32 {first child,
count, start, rope} nodes, {com, mass} float records (a node of count <=
1 carries its body's x and m) and {x, m} bodies by octree_pack_kernel.
Each record is a whole number of 16-byte vectors (record_width). The rope
is the node that nbody_tpu's ADVANCE loop reaches from a node (-1: the
walk ends).

Each walk wrapper takes float32 or float64 and an optional int64 `rows`:
it then walks only those sorted bodies against the whole tree
(chip_smoke.py holds the kernels against their twins on a sample of a
2^20-body run that way), and returns G * acc of each row. It runs the
plain twin only when its tensors lie on the CPU; on a CUDA tensor it
launches the kernel or raises, and adds one to `launch_counts` (the
octree's wrapper also counts the pack's launch there).

The twins run the same state machine on every lane at once with
torch.where (a frontier loop) until every lane is done, in the walks'
order and arithmetic (IEEE square root and division, the dtype of the
bodies): they are what --kernel torch runs, and what runs on the CPU.
Every call of a twin adds one to `twin_calls`. With detail=True a twin
also returns, per row, G times the sum of |term| by component (the scale
of a tolerance) and its counts: accepted nodes, direct pairs, and the
nodes it opened (BVH: descended into; octree: descended into or queued);
the BVH's also its leaf visits ("leaves": iterations that sum up to two
bodies).
"""

from __future__ import annotations

import ctypes

import torch

from nbody_torch.ops.cuda_allpairs import _DTYPE_CODES, _on_cpu, _raise_on_error, _stream

BVH_WALK = "bvh_walk_kernel"
OCTREE_WALK = "octree_walk_kernel"
OCTREE_PACK = "octree_pack_kernel"
# Kernel launches since the last reset; the twins never count there.
launch_counts = {BVH_WALK: 0, OCTREE_WALK: 0, OCTREE_PACK: 0}
# Calls of the plain twins since the last reset.
twin_calls = {BVH_WALK: 0, OCTREE_WALK: 0, OCTREE_PACK: 0}
# A twin checks whether any lane is still walking every CHECK_EVERY
# iterations (a host read on a GPU); a finished lane's state stays as it is.
CHECK_EVERY = 32


def reset_launch_counts() -> None:
    for counts in (launch_counts, twin_calls):
        for name in counts:
            counts[name] = 0


def _check(x: torch.Tensor, m: torch.Tensor, rows: torch.Tensor | None, *floats) -> None:
    if x.ndim != 2 or x.shape[1] not in (2, 3) or x.shape[0] == 0:
        raise ValueError(f"bodies must be (n, 2) or (n, 3) with n > 0, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype must be float32 or float64, got {x.dtype}")
    if m.shape != (x.shape[0],) or any(t.dtype != x.dtype for t in (m, *floats)):
        raise ValueError(f"masses {tuple(m.shape)} {m.dtype} do not match bodies "
                         f"{tuple(x.shape)} {x.dtype}")
    if rows is not None and (rows.dtype != torch.int64 or rows.ndim != 1):
        raise TypeError("rows must be a 1-D int64 tensor")
    if not all(t.is_contiguous() for t in (x, m, *floats)):
        raise ValueError("the walks take contiguous tensors")


def _row_ids(n: int, rows: torch.Tensor | None, device) -> torch.Tensor:
    return torch.arange(n, device=device) if rows is None else rows


def _pair(xj: torch.Tensor, xi: torch.Tensor):
    """d = xj - xi and d2 = sum_k d_k^2 in component order."""
    d = xj - xi
    d2 = d[:, 0] * d[:, 0]
    for k in range(1, d.shape[1]):
        d2 = d2 + d[:, k] * d[:, k]
    return d, d2


def _done(active: torch.Tensor, it: int) -> bool:
    return it % CHECK_EVERY == 0 and not bool(active.any())


def record_width(dtype: torch.dtype, fields: int) -> int:
    """Values of `dtype` in a record of `fields` values padded to whole
    16-byte vectors (csrc/tree_walk.cu's kRecordWidth)."""
    lanes = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-fields // lanes) * lanes


def _records(*columns: torch.Tensor) -> torch.Tensor:
    """The columns side by side ((rows,) or (rows, k) each), zero-padded to
    record_width: one record a row."""
    cols = [c[:, None] if c.ndim == 1 else c for c in columns]
    fields = sum(c.shape[1] for c in cols)
    pad = record_width(cols[0].dtype, fields) - fields
    return torch.cat([*cols, cols[0].new_zeros(cols[0].shape[0], pad)], 1)


def body_records(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The bodies as the walks read them: (n, W) records {x, m, 0...}."""
    return _records(x, m)


def mass_apart(dim: int, dtype: torch.dtype) -> bool:
    """Whether bvh_walk_kernel reads a node's mass from mm rather than from
    its record (csrc/tree_walk.cu's kApart): in 3-D float32, whose {c, bw}
    record is then one 16-byte vector."""
    return dim == 3 and dtype == torch.float32


def bvh_records(mm: torch.Tensor, mx: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """The BVH's heap as bvh_walk_kernel reads it: (nnodes, W) records
    {c, bw, mm, 0...} (float64 3-D: 6 values, 48 bytes), or where
    mass_apart {c, bw} (the masses read from mm)."""
    return _records(mx, bw) if mass_apart(mx.shape[1], mx.dtype) else _records(mx, bw, mm)


# --------------------------------------------------------------------------
# the BVH walk (nbody_tpu/ops/bvh.py:129-211)


def bvh_walk_torch(mm: torch.Tensor, mx: torch.Tensor, bw: torch.Tensor, nlevels: int,
                   m: torch.Tensor, x: torch.Tensor, theta: float, G: float, eps: float,
                   rows: torch.Tensor | None = None, detail: bool = False):
    """The plain twin of bvh_walk_kernel: every lane runs bvh.py's state
    machine (t, level, acc, covered) until covered >= n. Returns G * acc
    (nrows, dim), or with detail (G * acc, G * sum |term|, counts)."""
    twin_calls[BVH_WALK] += 1
    n, dim = x.shape
    dev, dtype = x.device, x.dtype
    i = _row_ids(n, rows, dev)
    nr = i.shape[0]
    nnodes = (1 << nlevels) - 1
    theta2 = torch.full((), float(theta) ** 2, dtype=dtype, device=dev)
    zero = x.new_zeros(())
    xi = x[i]
    acc = x.new_zeros(nr, dim)
    scale = x.new_zeros(nr, dim)
    counts = {k: torch.zeros(nr, dtype=torch.int64, device=dev) for k in ("nodes", "pairs",
                                                                          "opened", "leaves")}
    t = torch.zeros(nr, dtype=torch.int64, device=dev)
    level = torch.zeros_like(t)
    covered = torch.zeros_like(t)
    active = covered < n if n > 1 else torch.zeros(nr, dtype=torch.bool, device=dev)
    it = 0
    while not _done(active, it):
        it += 1
        leaf = active & (level == nlevels)
        node = active & ~leaf
        parent = torch.div(t - 1, 2, rounding_mode="floor")
        # leaf level: the node's two bodies, directly
        acc_leaf, scale_leaf = acc, scale
        for k in range(2):
            b = t - nnodes + k
            valid = leaf & (b >= 0) & (b < n) & (b != i)
            bc = b.clamp(0, n - 1)
            d, d2 = _pair(x[bc], xi)
            w = torch.where(valid, m[bc] / (d2 * torch.sqrt(d2) + eps), zero)
            acc_leaf = acc_leaf + w[:, None] * d
            if detail:
                scale_leaf = scale_leaf + (w[:, None] * d).abs()
                counts["pairs"] += valid
        # internal node: the MAC
        tc = t.clamp(0, nnodes - 1)
        d, d2 = _pair(mx[tc], xi)
        approx = node & (bw[tc] * bw[tc] < theta2 * d2)
        w = torch.where(approx, mm[tc] / (d2 * torch.sqrt(d2) + eps), zero)
        acc_node = acc + w[:, None] * d
        if detail:
            scale = torch.where(leaf[:, None], scale_leaf, scale + (w[:, None] * d).abs())
            counts["nodes"] += approx
            counts["opened"] += node & ~approx
            counts["leaves"] += leaf
        acc = torch.where(leaf[:, None], acc_leaf, torch.where(node[:, None], acc_node, acc))
        right = torch.remainder(t - 1, 2) == 1
        up = leaf | (approx & right)
        covered = covered + torch.where(leaf, 2, torch.where(approx, 1 << (nlevels - level), 0))
        t_next = torch.where(up, parent + 1, torch.where(approx, t + 1, 2 * t + 1))
        t = torch.where(active, t_next, t)
        level = level + torch.where(up, -1, torch.where(node & ~approx, 1, 0))
        active = covered < n
    out = G * acc
    return (out, G * scale, counts) if detail else out


def bvh_walk_cuda(mm: torch.Tensor, mx: torch.Tensor, bw: torch.Tensor, nlevels: int,
                  m: torch.Tensor, x: torch.Tensor, theta: float, G: float, eps: float,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """bvh_walk_kernel over the heap (mm, mx, bw) of ops/bvh.build_tree
    and its Hilbert-sorted bodies (m, x), packed first (bvh_records,
    body_records): G * acc of each body, or of the bodies `rows`."""
    _check(x, m, rows, mm, mx, bw)
    if mm.shape != ((1 << nlevels) - 1,) or mx.shape != (mm.shape[0], x.shape[1]):
        raise ValueError(f"a heap of {nlevels} levels is not mm {tuple(mm.shape)}, "
                         f"mx {tuple(mx.shape)}")
    tensors = (mm, mx, bw, m, x) + (() if rows is None else (rows,))
    if _on_cpu(*tensors):
        return bvh_walk_torch(mm, mx, bw, nlevels, m, x, theta, G, eps, rows)
    from nbody_torch._build import load_library

    nrows = x.shape[0] if rows is None else rows.shape[0]
    out = torch.empty(nrows, x.shape[1], dtype=x.dtype, device=x.device)
    if nrows == 0:
        return out
    nodes, bodies = bvh_records(mm, mx, bw), body_records(m, x)
    err = load_library().nbody_bvh_walk(
        x.device.index, _DTYPE_CODES[x.dtype], x.shape[1], nodes.data_ptr(), mm.data_ptr(),
        nlevels, bodies.data_ptr(), x.shape[0], None if rows is None else rows.data_ptr(), nrows,
        float(theta) ** 2, float(eps), float(G), out.data_ptr(), _stream(x))
    _raise_on_error(BVH_WALK, err)
    launch_counts[BVH_WALK] += 1
    return out


# --------------------------------------------------------------------------
# the octree walk (nbody_tpu/ops/octree.py:198-334)

VISIT, ADVANCE, DONE = 0, 1, 2


def octree_walk_torch(levels, ms: torch.Tensor, xs: torch.Tensor, root_side: torch.Tensor,
                      theta: float, G: float, eps: float, rows: torch.Tensor | None = None,
                      detail: bool = False):
    """The plain twin of octree_walk_kernel over ops/octree.OctreeLevels:
    every lane runs octree.py's state machine (lvl, idx, mode, ds_pos,
    ds_rem, acc) until its mode is DONE and its queue empty. Returns G *
    acc (nrows, dim), or with detail (G * acc, G * sum |term|, counts)."""
    twin_calls[OCTREE_WALK] += 1
    n, dim = xs.shape
    dev, dtype = xs.device, xs.dtype
    depth = levels.depth
    i = _row_ids(n, rows, dev)
    nr = i.shape[0]
    offsets = torch.tensor(levels.offsets, dtype=torch.int64).to(dev)
    side_tbl = root_side / torch.tensor([float(1 << lv) for lv in range(depth + 1)],
                                        dtype=dtype).to(dev)
    epsv = torch.full((), float(eps), dtype=dtype, device=dev)
    thetav = torch.full((), float(theta), dtype=dtype, device=dev)
    zero = xs.new_zeros(())
    xi = xs[i]
    acc = xs.new_zeros(nr, dim)
    scale = xs.new_zeros(nr, dim)
    counts = {k: torch.zeros(nr, dtype=torch.int64, device=dev) for k in ("nodes", "pairs",
                                                                          "opened")}
    lvl, idx, ds_pos, ds_rem = (torch.zeros(nr, dtype=torch.int64, device=dev) for _ in range(4))
    mode = torch.full((nr,), VISIT, dtype=torch.int64, device=dev)
    active = (mode != DONE) | (ds_rem > 0)
    it = 0
    while not _done(active, it):
        it += 1
        flat = offsets[lvl.clamp(0, depth)] + idx
        draining = active & (ds_rem > 0)
        # drain one queued body
        b = ds_pos.clamp(0, n - 1)
        d_b, d2_b = _pair(xs[b], xi)
        dx_b = torch.sqrt(d2_b) + epsv
        den_b = dx_b * dx_b * dx_b
        w_b = torch.where(den_b > 0, ms[b] / den_b, zero)
        # VISIT: the node
        visiting = active & ~draining & (mode == VISIT)
        cnt = levels.count[flat]
        single = cnt <= 1
        bfirst = levels.start[flat].clamp(0, n - 1)
        mj = torch.where(single, ms[bfirst], levels.mass[flat])
        d, d2 = _pair(torch.where(single[:, None], xs[bfirst], levels.com[flat]), xi)
        dx = torch.sqrt(d2) + epsv
        accept = single | (side_tbl[lvl.clamp(0, depth)] / dx < thetav)
        at_max = lvl >= depth
        direct = visiting & ~accept & at_max
        descend = visiting & ~accept & ~at_max
        den = dx * dx * dx
        w = torch.where(den > 0, mj / den, zero)
        # ADVANCE: the next sibling, or up
        advancing = active & ~draining & (mode == ADVANCE)
        par = levels.parent[flat]
        par_flat = offsets[(lvl - 1).clamp(0, depth)] + par
        has_sib = (idx + 1) < levels.child_start[par_flat] + levels.child_count[par_flat]
        at_root = lvl <= 0
        # the transitions
        term = torch.where(draining[:, None], w_b[:, None] * d_b,
                           torch.where((visiting & accept)[:, None], w[:, None] * d, zero))
        acc = acc + term
        if detail:
            scale = scale + term.abs()
            counts["pairs"] += draining
            counts["nodes"] += visiting & accept
            counts["opened"] += direct | descend
        ds_pos = torch.where(draining, ds_pos + 1,
                             torch.where(direct, levels.start[flat], ds_pos))
        ds_rem = torch.where(draining, ds_rem - 1, torch.where(direct, cnt, ds_rem))
        move = advancing & ~at_root
        lvl = torch.where(descend, lvl + 1, torch.where(move & ~has_sib, lvl - 1, lvl))
        idx = torch.where(descend, levels.child_start[flat],
                          torch.where(move, torch.where(has_sib, idx + 1, par), idx))
        mode = torch.where(visiting & ~descend, ADVANCE,
                           torch.where(advancing, torch.where(at_root, DONE,
                                                              torch.where(has_sib, VISIT,
                                                                          ADVANCE)), mode))
        active = (mode != DONE) | (ds_rem > 0)
    out = G * acc
    return (out, G * scale, counts) if detail else out


def _total(levels) -> int:
    return levels.offsets[-1] + levels.caps[-1]


def octree_records_torch(levels, ms: torch.Tensor, xs: torch.Tensor):
    """The plain version of octree_pack_kernel: (nodes (total, 4) int32
    {first child's flat index (-1 at the deepest level), count, start,
    rope (-1: done)}, fnodes (total, W) {com, mass, 0...}, or for a node
    of count <= 1 {x, m, 0...} of the body at its clamped start, bodies
    (n, W) {x, m, 0...}). A node's rope is its next sibling if its
    parent's children run on past it, else its parent's rope; the root's
    is -1: where octree.py's ADVANCE loop goes from the node."""
    twin_calls[OCTREE_PACK] += 1
    n = xs.shape[0]
    off, depth = levels.offsets, levels.depth
    dev = xs.device
    total = _total(levels)
    rope = torch.full((total,), -1, dtype=torch.int64, device=dev)
    child = torch.full((total,), -1, dtype=torch.int64, device=dev)
    for lv in range(1, depth + 1):
        seg = slice(off[lv], off[lv] + levels.caps[lv])
        idx = torch.arange(levels.caps[lv], device=dev)
        pf = off[lv - 1] + levels.parent[seg]
        has_sib = idx + 1 < levels.child_start[pf] + levels.child_count[pf]
        rope[seg] = torch.where(has_sib, off[lv] + idx + 1, rope[pf])
        up = slice(off[lv - 1], off[lv - 1] + levels.caps[lv - 1])
        child[up] = off[lv] + levels.child_start[up]
    nodes = torch.stack([child, levels.count, levels.start, rope], 1).to(torch.int32)
    single = levels.count <= 1
    b = levels.start.clamp(0, n - 1)
    fnodes = _records(torch.where(single[:, None], xs[b], levels.com),
                      torch.where(single, ms[b], levels.mass))
    return nodes, fnodes, body_records(ms, xs)


def _check_levels(levels, ms, xs, root_side=None, rows=None):
    ints = (levels.start, levels.count, levels.child_start, levels.child_count, levels.parent)
    _check(xs, ms, rows, levels.mass, levels.com, *(() if root_side is None else (root_side,)))
    if any(a.dtype != torch.int64 or not a.is_contiguous() for a in ints):
        raise TypeError("the level tree's index arrays must be contiguous int64")
    if root_side is not None and root_side.shape != ():
        raise ValueError(f"root_side must be a 0-dim tensor, got {tuple(root_side.shape)}")
    if len(levels.offsets) != levels.depth + 1 or levels.depth > 16:
        raise ValueError(f"depth {levels.depth} with {len(levels.offsets)} offsets")
    if _total(levels) >= 2 ** 31:
        raise ValueError(f"{_total(levels)} nodes do not fit the records' int32 indices")
    return ints


def _offsets(levels):
    return (ctypes.c_longlong * len(levels.offsets))(*levels.offsets)  # read on the host


def octree_records_cuda(levels, ms: torch.Tensor, xs: torch.Tensor):
    """octree_pack_kernel over ops/octree.build_octree's levels and its
    Morton-sorted bodies (ms, xs): octree_records_torch's three arrays."""
    ints = _check_levels(levels, ms, xs)
    if _on_cpu(levels.mass, levels.com, *ints, ms, xs):
        return octree_records_torch(levels, ms, xs)
    from nbody_torch._build import load_library

    n, dim = xs.shape
    total, width = _total(levels), record_width(xs.dtype, dim + 1)
    nodes = torch.empty(total, 4, dtype=torch.int32, device=xs.device)
    fnodes = torch.empty(total, width, dtype=xs.dtype, device=xs.device)
    bodies = torch.empty(n, width, dtype=xs.dtype, device=xs.device)
    offsets = _offsets(levels)
    err = load_library().nbody_octree_pack(
        xs.device.index, _DTYPE_CODES[xs.dtype], dim, levels.mass.data_ptr(),
        levels.com.data_ptr(), *(a.data_ptr() for a in ints), ctypes.addressof(offsets),
        levels.depth, total, ms.data_ptr(), xs.data_ptr(), n, nodes.data_ptr(),
        fnodes.data_ptr(), bodies.data_ptr(), _stream(xs))
    _raise_on_error(OCTREE_PACK, err)
    launch_counts[OCTREE_PACK] += 1
    return nodes, fnodes, bodies


def octree_walk_cuda(levels, ms: torch.Tensor, xs: torch.Tensor, root_side: torch.Tensor,
                     theta: float, G: float, eps: float,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """octree_walk_kernel over ops/octree.build_octree's levels and its
    Morton-sorted bodies (ms, xs), packed first (octree_records_cuda);
    root_side is the root box's side, a 0-dim tensor of their dtype: G *
    acc of each body, or of the bodies `rows`."""
    ints = _check_levels(levels, ms, xs, root_side, rows)
    tensors = (levels.mass, levels.com, *ints, ms, xs, root_side) + (
        () if rows is None else (rows,))
    if _on_cpu(*tensors):
        return octree_walk_torch(levels, ms, xs, root_side, theta, G, eps, rows)
    from nbody_torch._build import load_library

    nrows = xs.shape[0] if rows is None else rows.shape[0]
    out = torch.empty(nrows, xs.shape[1], dtype=xs.dtype, device=xs.device)
    if nrows == 0:
        return out
    nodes, fnodes, bodies = octree_records_cuda(levels, ms, xs)
    offsets = _offsets(levels)
    err = load_library().nbody_octree_walk(
        xs.device.index, _DTYPE_CODES[xs.dtype], xs.shape[1], nodes.data_ptr(), fnodes.data_ptr(),
        ctypes.addressof(offsets), levels.depth, _total(levels), bodies.data_ptr(),
        xs.shape[0], root_side.data_ptr(), None if rows is None else rows.data_ptr(), nrows,
        float(theta), float(eps), float(G), out.data_ptr(), _stream(xs))
    _raise_on_error(OCTREE_WALK, err)
    launch_counts[OCTREE_WALK] += 1
    return out
