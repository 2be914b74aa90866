"""The per-body walks' packed records and the octree's rope, on the CPU.

csrc/tree_walk.cu's kernels read packed records (ops/cuda_tree_walk:
bvh_records, body_records, and octree_pack_kernel's plain version
octree_records_torch) instead of the trees' separate arrays, and the
octree walk jumps along each node's rope instead of running nbody_tpu's
ADVANCE loop. Small trees are built by nbody_tpu from the per-body tests'
inputs (n = 1, 2, 7, 300; 2-D and 3-D; float32 and float64; a zero-mass
body at the origin, which makes dead BVH nodes, and a duplicate position,
whose deepest octree cell drains). Checked here:

  * the records carry each walk's fields bit for bit, the body x and m of
    an octree node of count <= 1 included, and the pack's wrapper takes
    its twin on CPU tensors;
  * each node's rope is the node that a step-by-step run of the ADVANCE
    rule (nbody_tpu/ops/octree.py:302-334) reaches from it;
  * a scalar walk over the records, step for step as the kernels take it,
    accepts, opens and queues what the twins count, row by row, and sums
    to the twins' forces within 1e-5 (float32) / 1e-12 (float64) of each
    row's sum of |term|;
  * along each of those walks the node's pre-order key, (first leaf slot,
    level) in the BVH and (first body, level) in the octree (a queued
    body's (its index, depth + 1)), strictly grows: a warp that steps only
    its lanes at its least key each iteration would give every lane its
    own steps, in its order.
"""

import jax
import numpy as np
import pytest
import torch

from nbody_torch.ops import bvh as tb
from nbody_torch.ops import cuda_tree_walk as tw
from nbody_torch.ops import octree as to
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jo

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
CASES = [(n, dim, dtype) for n in (1, 2, 7, 300) for dim in (2, 3)
         for dtype in (np.float32, np.float64)]
THETA = 0.5
_jax_octree = jax.jit(jo.build_octree, static_argnums=4)


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _bodies(n, dim, dtype, seed=11):
    """Gaussian bodies, with body 1 on body 0 and the last body massless at
    the origin (n >= 3)."""
    rng = np.random.default_rng(seed + n + dim)
    x = rng.normal(0, 2, (n, dim))
    m = rng.uniform(0.1, 1, n)
    if n >= 3:
        x[1] = x[0]
        x[-1], m[-1] = 0, 0
    return m.astype(dtype), x.astype(dtype)


_cache = {}


def _octree(n, dim, dtype):
    """nbody_tpu's level tree of _bodies as the port's OctreeLevels, its
    Morton-sorted bodies and the root box's side."""
    key = ("octree", n, dim, dtype)
    if key not in _cache:
        m, x = _bodies(n, dim, dtype)
        lo, hi = jgeo.scalar_bounds(x)
        lv, _, ms, xs = _jax_octree(m, x, lo, hi, jo.max_depth(n, dim))
        levels = to.OctreeLevels.from_numpy(lv.mass, lv.com, lv.start, lv.count, lv.child_start,
                                            lv.child_count, lv.parent, lv.offsets, lv.caps,
                                            lv.depth)
        _cache[key] = (levels, torch.tensor(np.asarray(ms)), torch.tensor(np.asarray(xs)),
                       torch.tensor(np.asarray(hi - lo)))
    return _cache[key]


def _bvh(n, dim, dtype):
    """nbody_tpu's heap over _bodies (in their own order) as the port's
    BVHTree, and the bodies."""
    key = ("bvh", n, dim, dtype)
    if key not in _cache:
        m, x = _bodies(n, dim, dtype)
        t = jb.build_tree(m, x, _eps(dtype))
        _cache[key] = (tb.BVHTree.from_numpy(t.mm, t.mx, t.bw, t.nlevels), torch.tensor(m),
                       torch.tensor(x))
    return _cache[key]


def _sep(rec, xi, dim):
    """d = xj - xi and d2 summed in component order, in the dtype."""
    d = rec[:dim] - xi
    d2 = d[0] * d[0]
    for k in range(1, dim):
        d2 = d2 + d[k] * d[k]
    return d, d2


def _bvh_lane(nodes, mm, bodies, dim, nlevels, n, i, theta, eps):
    """Row i's walk as bvh_walk_kernel takes it over the records (a node's
    mass from mm where mass_apart), a leaf's two bodies as two steps (each
    a body slot taken like an accepted node that covers 1), with no clamp
    of t or of the slot (covered, the node's first slot, stays below n):
    (acc, each step's pre-order key, counts as the twin's detail, a leaf
    visit counted at its first slot)."""
    apart = tw.mass_apart(dim, torch.from_numpy(bodies).dtype)
    T = bodies.dtype.type
    theta2, eps = T(theta ** 2), T(eps)
    nnodes = (1 << nlevels) - 1
    xi = bodies[i, :dim]
    acc = np.zeros(dim, bodies.dtype)
    counts = dict(nodes=0, pairs=0, opened=0, leaves=0)
    keys = []
    t = level = covered = 0
    while n > 1 and covered < n:
        keys.append(((t - ((1 << level) - 1)) << (nlevels - level), level))
        parent = (t - 1) >> 1
        leaf = level == nlevels
        b = t - nnodes
        # covered is the node's first slot, so the kernel needs no clamp
        assert covered == keys[-1][0] and (b < n if leaf else 0 <= t < nnodes)
        rec = bodies[b] if leaf else nodes[t]
        d, d2 = _sep(rec, xi, dim)
        take = b != i if leaf else rec[dim] * rec[dim] < theta2 * d2
        if take:
            mass = rec[dim] if leaf else mm[t] if apart else rec[dim + 1]
            acc = acc + mass / (d2 * np.sqrt(d2) + eps) * d
        counts["leaves"] += leaf and b % 2 == 0
        counts["pairs" if leaf else "nodes"] += take
        if leaf or take:
            covered += 1 << (nlevels - level)
            t, level = (parent + 1, level - 1) if (t - 1) & 1 else (t + 1, level)
        else:
            counts["opened"] += 1
            t, level = 2 * t + 1, level + 1
    return acc, keys, counts


def _octree_lane(nodes, fnodes, bodies, dim, levels, side, n, i, theta, eps):
    """Row i's walk as octree_walk_kernel takes it over the records and
    ropes, a queued body a step: (acc, each step's pre-order key (a queued
    body's (its index, depth + 1)), counts as the twin's detail)."""
    T = bodies.dtype.type
    theta, eps = T(theta), T(eps)
    off, depth = levels.offsets, levels.depth
    xi = bodies[i, :dim]
    acc = np.zeros(dim, bodies.dtype)
    counts = dict(nodes=0, pairs=0, opened=0)
    keys = []
    node = lvl = first = ds_pos = ds_rem = 0
    while node >= 0 or ds_rem > 0:
        drain = ds_rem > 0
        keys.append((ds_pos, depth + 1) if drain else (first, lvl))
        child, cnt, start, rope = (0, 0, 0, 0) if drain else (int(v) for v in nodes[node])
        rec = bodies[min(max(ds_pos, 0), n - 1)] if drain else fnodes[node]
        d, d2 = _sep(rec, xi, dim)
        dx = np.sqrt(d2) + eps
        take = drain or cnt <= 1 or side[lvl] / dx < theta
        if take:
            den = dx * dx * dx
            acc = acc + (rec[dim] / den if den > 0 else T(0)) * d
        if drain:
            counts["pairs"] += 1
            ds_pos, ds_rem = ds_pos + 1, ds_rem - 1
            continue
        counts["nodes" if take else "opened"] += 1
        if not take:
            if lvl < depth:
                node, lvl = child, lvl + 1
                continue
            ds_pos, ds_rem = start, cnt
        node, first = rope, start + cnt
        while node >= 0 and node < off[lvl]:
            lvl -= 1
    return acc, keys, counts


def _advance(levels, flat, lvl):
    """The flat index nbody_tpu's ADVANCE loop reaches from node (lvl,
    flat), one step at a time (octree.py:302-334), or -1 at the root."""
    off = levels.offsets
    parent, cs, cc = (a.numpy() for a in (levels.parent, levels.child_start, levels.child_count))
    idx = flat - off[lvl]
    while lvl > 0:
        pf = off[lvl - 1] + int(parent[off[lvl] + idx])
        if idx + 1 < cs[pf] + cc[pf]:
            return off[lvl] + idx + 1
        lvl, idx = lvl - 1, pf - off[lvl - 1]
    return -1


def _total(levels):
    return levels.offsets[-1] + levels.caps[-1]


@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_bvh_records_carry_the_heap_bit_for_bit(n, dim, dtype):
    """{c, bw, mm} a node ({c, bw} in 3-D float32, whose walk reads the
    masses from mm) and {x, m} a body, zero-padded to whole 16-byte
    vectors: nodes 16 bytes in float32, 32 (2-D) or 48 (3-D) in float64,
    every body 16 (float32) or 32."""
    tree, m, x = _bvh(n, dim, dtype)
    nodes, bodies = tw.bvh_records(tree.mm, tree.mx, tree.bw), tw.body_records(m, x)
    apart = tw.mass_apart(dim, x.dtype)
    assert apart == ((dim, dtype) == (3, np.float32))
    fields = dim + 1 if apart else dim + 2
    width = tw.record_width(x.dtype, fields)
    assert nodes.shape == (tree.mm.shape[0], width) and nodes.dtype == x.dtype
    assert (width * nodes.element_size()) % 16 == 0 and bodies.shape[1] * x.element_size() in (
        16, 32)
    assert width * nodes.element_size() == {(3, np.float32): 16, (3, np.float64): 48,
                                            (2, np.float32): 16, (2, np.float64): 32}[dim, dtype]
    assert torch.equal(nodes[:, :dim], tree.mx) and torch.equal(nodes[:, dim], tree.bw)
    if not apart:
        assert torch.equal(nodes[:, dim + 1], tree.mm)
    assert not nodes[:, fields:].any()
    assert torch.equal(bodies[:, :dim], x) and torch.equal(bodies[:, dim], m)
    assert not bodies[:, dim + 1:].any()


@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_octree_records_carry_the_levels_bit_for_bit(n, dim, dtype):
    """octree_records_cuda on CPU tensors runs its twin (no launch): int32
    {first child's flat index, count, start, rope}, {com, mass} or, for a
    node of count <= 1, the body at its clamped start; {x, m} bodies."""
    levels, ms, xs, _ = _octree(n, dim, dtype)
    tw.reset_launch_counts()
    nodes, fnodes, bodies = tw.octree_records_cuda(levels, ms, xs)
    assert tw.twin_calls[tw.OCTREE_PACK] == 1 and not any(tw.launch_counts.values())
    total, off, depth = _total(levels), levels.offsets, levels.depth
    assert nodes.shape == (total, 4) and nodes.dtype == torch.int32
    assert fnodes.shape == (total, 4) and bodies.shape == (n, 4)
    assert torch.equal(nodes[:, 1].long(), levels.count)
    assert torch.equal(nodes[:, 2].long(), levels.start)
    for lv in range(depth + 1):
        seg = slice(off[lv], off[lv] + levels.caps[lv])
        want = (off[lv + 1] + levels.child_start[seg] if lv < depth
                else torch.full_like(levels.child_start[seg], -1))
        assert torch.equal(nodes[seg, 0].long(), want), lv
    single = levels.count <= 1
    b = levels.start.clamp(0, n - 1)
    assert torch.equal(fnodes[~single, :dim], levels.com[~single])
    assert torch.equal(fnodes[~single, dim], levels.mass[~single])
    assert torch.equal(fnodes[single, :dim], xs[b[single]])
    assert torch.equal(fnodes[single, dim], ms[b[single]])
    assert not fnodes[:, dim + 1:].any() and not bodies[:, dim + 1:].any()
    assert torch.equal(bodies[:, :dim], xs) and torch.equal(bodies[:, dim], ms)
    with pytest.raises(TypeError):
        bad = to.OctreeLevels(**{**levels.__dict__, "parent": levels.parent.int()})
        tw.octree_records_cuda(bad, ms, xs)


@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_octree_rope_is_where_advance_goes(n, dim, dtype):
    """Every node's rope, padding nodes too, equals the node that the
    ADVANCE rule reaches from it step by step (-1 from the root)."""
    levels, ms, xs, _ = _octree(n, dim, dtype)
    rope = tw.octree_records_torch(levels, ms, xs)[0][:, 3].tolist()
    off = levels.offsets
    for lv in range(levels.depth + 1):
        for flat in range(off[lv], off[lv] + levels.caps[lv]):
            assert rope[flat] == _advance(levels, flat, lv), (lv, flat)
    assert rope[0] == -1


def _preorder_checks(keys):
    """Each walk's keys strictly grow."""
    for row, k in enumerate(keys):
        assert all(a < b for a, b in zip(k, k[1:])), row


def _within(got, ref, scale, dtype):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= TOL[dtype] * np.asarray(scale, np.float64)), (err / scale).max()


def _record_walks_vs_twin(walk, ref, scale, counts, dtype):
    """The scalar walks against the twin's detail: counts row by row,
    forces within the tolerance; returns their keys."""
    accs, keys = [], []
    for i, (acc, k, c) in enumerate(walk):
        for name, v in c.items():
            assert v == int(counts[name][i]), (i, name)
        accs.append(acc)
        keys.append(k)
    _within(np.stack(accs), ref.numpy(), scale.numpy(), dtype)
    return keys


@pytest.mark.parametrize("theta", [THETA, 0.0])
@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_bvh_record_walk_matches_twin_in_preorder(n, dim, dtype, theta):
    """The BVH walk over bvh_records / body_records, step for step as
    bvh_walk_kernel takes it: the twin's accepted nodes, direct pairs,
    opened nodes and leaf visits, its forces; keys in strict pre-order,
    the heap's parent + 1 step included."""
    tree, m, x = _bvh(n, dim, dtype)
    nodes, bodies = (tw.bvh_records(tree.mm, tree.mx, tree.bw).numpy(),
                     tw.body_records(m, x).numpy())
    ref, scale, counts = tw.bvh_walk_torch(tree.mm, tree.mx, tree.bw, tree.nlevels, m, x, theta,
                                           1.0, _eps(dtype), detail=True)
    walk = (_bvh_lane(nodes, tree.mm.numpy(), bodies, dim, tree.nlevels, n, i, theta,
                      _eps(dtype)) for i in range(n))
    _preorder_checks(_record_walks_vs_twin(walk, ref, scale, counts, dtype))


@pytest.mark.parametrize("theta", [THETA, 0.0])
@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_octree_record_walk_matches_twin_in_preorder(n, dim, dtype, theta):
    """The octree walk over octree_records_torch's records and ropes, step
    for step as octree_walk_kernel takes it (no ADVANCE iteration; a
    rope's level found by stepping down the offsets): the twin's accepted
    nodes, direct pairs (the duplicate pair's cell drained) and opened
    nodes, its forces; keys (first body, level) in strict pre-order."""
    levels, ms, xs, side = _octree(n, dim, dtype)
    nodes, fnodes, bodies = (a.numpy() for a in tw.octree_records_torch(levels, ms, xs))
    ref, scale, counts = tw.octree_walk_torch(levels, ms, xs, side, theta, 1.0, _eps(dtype),
                                              detail=True)
    T = xs.numpy().dtype.type
    sides = [side.numpy() / T(1 << lv) for lv in range(levels.depth + 1)]
    walk = (_octree_lane(nodes, fnodes, bodies, dim, levels, sides, n, i, theta, _eps(dtype))
            for i in range(n))
    _preorder_checks(_record_walks_vs_twin(walk, ref, scale, counts, dtype))
    if n == 300 and theta == 0.0:
        assert int(counts["pairs"].sum()) > 0  # a deepest shared cell drained
