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

One CUDA thread walks one sorted body (csrc/tree_walk.cu says why). Each
wrapper takes float32 or float64 and an optional int64 `rows`: it then
walks only those sorted bodies against the whole tree (chip_smoke.py holds
the kernels against their twins on a sample of a 2^20-body run that way),
and returns G * acc of each row. It runs the plain twin only when its
tensors lie on the CPU; on a CUDA tensor it launches the kernel or raises,
and adds one to `launch_counts`.

The twins run the same state machine on every lane at once with
torch.where (a frontier loop) until every lane is done, in the walks'
order and arithmetic (IEEE square root and division, the dtype of the
bodies): they are what --kernel torch runs, and what runs on the CPU.
Every call of a twin adds one to `twin_calls`. With detail=True a twin
also returns, per row, G times the sum of |term| by component (the scale
of a tolerance) and its counts: accepted nodes, direct pairs, and the
nodes it opened (BVH: descended into; octree: descended into or queued).
"""

from __future__ import annotations

import ctypes

import torch

from nbody_torch.ops.cuda_allpairs import _DTYPE_CODES, _on_cpu, _raise_on_error, _stream

BVH_WALK = "bvh_walk_kernel"
OCTREE_WALK = "octree_walk_kernel"
# Kernel launches since the last reset; the twins never count there.
launch_counts = {BVH_WALK: 0, OCTREE_WALK: 0}
# Calls of the plain twins since the last reset.
twin_calls = {BVH_WALK: 0, OCTREE_WALK: 0}

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
                                                                          "opened")}
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
    and its Hilbert-sorted bodies (m, x): G * acc of each body, or of the
    bodies `rows`."""
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
    err = load_library().nbody_bvh_walk(
        x.device.index, _DTYPE_CODES[x.dtype], x.shape[1], mm.data_ptr(), mx.data_ptr(),
        bw.data_ptr(), nlevels, m.data_ptr(), x.data_ptr(), x.shape[0],
        None if rows is None else rows.data_ptr(), nrows, float(theta) ** 2, float(eps),
        float(G), out.data_ptr(), _stream(x))
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


def octree_walk_cuda(levels, ms: torch.Tensor, xs: torch.Tensor, root_side: torch.Tensor,
                     theta: float, G: float, eps: float,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """octree_walk_kernel over ops/octree.build_octree's levels and its
    Morton-sorted bodies (ms, xs); root_side is the root box's side, a
    0-dim tensor of their dtype: G * acc of each body, or of the bodies
    `rows`."""
    ints = (levels.start, levels.count, levels.child_start, levels.child_count, levels.parent)
    _check(xs, ms, rows, levels.mass, levels.com, root_side)
    if any(a.dtype != torch.int64 or not a.is_contiguous() for a in ints):
        raise TypeError("the level tree's index arrays must be contiguous int64")
    if root_side.shape != () or len(levels.offsets) != levels.depth + 1 or levels.depth > 16:
        raise ValueError(f"root_side {tuple(root_side.shape)} or depth {levels.depth} / "
                         f"{len(levels.offsets)} offsets")
    tensors = (levels.mass, levels.com, *ints, ms, xs, root_side) + (
        () if rows is None else (rows,))
    if _on_cpu(*tensors):
        return octree_walk_torch(levels, ms, xs, root_side, theta, G, eps, rows)
    from nbody_torch._build import load_library

    nrows = xs.shape[0] if rows is None else rows.shape[0]
    out = torch.empty(nrows, xs.shape[1], dtype=xs.dtype, device=xs.device)
    if nrows == 0:
        return out
    offsets = (ctypes.c_longlong * len(levels.offsets))(*levels.offsets)  # read on the host
    err = load_library().nbody_octree_walk(
        xs.device.index, _DTYPE_CODES[xs.dtype], xs.shape[1], levels.mass.data_ptr(),
        levels.com.data_ptr(), *(a.data_ptr() for a in ints), ctypes.addressof(offsets),
        levels.depth, ms.data_ptr(), xs.data_ptr(), xs.shape[0], root_side.data_ptr(),
        None if rows is None else rows.data_ptr(), nrows, float(theta), float(eps), float(G),
        out.data_ptr(), _stream(xs))
    _raise_on_error(OCTREE_WALK, err)
    launch_counts[OCTREE_WALK] += 1
    return out
