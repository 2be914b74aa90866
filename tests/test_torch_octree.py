"""The octree fast path of nbody_torch against nbody_tpu, on the CPU.

The same numpy-made inputs go through both packages. Exact where
nbody_tpu is exact: bounds, depths, Morton keys and the sort, tree sizes,
permutations, entry merging and the integer counters of the grouped
force. The robust box is compared within 1 ulp, and the packages then get
the same box, so that everything after it can be compared bit for bit.

Forces. Each kernel's plain twin is held within 1e-5 of each row's sum of
|term| of a float64 evaluation of the same pairs, and the Pallas function
(run in interpret mode) within 1e-4 of it: in interpret mode Pallas
refines a reciprocal of about 8 bits with one Newton step, so a row that
one close pair dominates carries ~1e-5 of its sum of |term| in the Pallas
result itself (measured 1.1e-5, against 3.8e-7 for the twin). The whole
fast path is held within 1e-5 of sum |a| of nbody_tpu's result, the bound
of nbody_tpu's own tests (tests/test_trees.py:1008).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_group_eval as tge
from nbody_torch.ops import geometry as tgeo
from nbody_torch.ops import octree as tot
from nbody_torch.ops import octree_group as tog
from nbody_torch.ops.permutation import unpermute_rows
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jot
from nbody_tpu.ops import octree_group as jog
from nbody_tpu.ops import pallas_group_eval as jpg
from nbody_tpu.ops.permutation import unpermute_rows as j_unpermute_rows

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5


def _clusters(n, dim, seed=11, uniform=False):
    """Nine Gaussian clusters (the workload tests/test_trees.py:968-973
    pins), or a uniform box."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    m = rng.uniform(0.1, 1, n).astype(np.float32)
    if uniform:
        x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    return m, x


def _t(a):
    return torch.tensor(np.asarray(a))


def _f64_sums(xi, mj, xj, sel, tb):
    """float64 force sum_j m_j (x_j - x_i) / t and its scale sum_j |term|,
    per row and component, over the bodies sel[t] (T, nj) bool of each
    row tile t."""
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for t in range(sel.shape[0]):
        cols = np.flatnonzero(sel[t])
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[cols][None, :, :] - xi[rows][:, None, :]
        r = np.sqrt(np.sum(d * d, axis=-1))
        w = mj[cols][None, :] / (r + EPS) ** 3
        force[rows] = np.einsum("kn,knd->kd", w, d)
        scale[rows] = np.einsum("kn,knd->kd", w, np.abs(d))
    return force, scale


def _assert_twin_and_pallas(got, pallas, sums):
    """The twin within TOL and the Pallas result within 10 TOL of the
    float64 sums, per row and component, as a fraction of sum |term|."""
    exact, scale = sums
    for arr, tol in ((got, TOL), (pallas, 10 * TOL)):
        arr = np.asarray(arr, np.float64)
        assert arr.shape == exact.shape and np.all(np.isfinite(arr))
        err = np.abs(arr - exact)
        assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))


def _assert_scale(got, sums):
    """A twin's absolute=True mode gives the float64 sum of |term|."""
    np.testing.assert_allclose(got.numpy(), sums[1], rtol=1e-5, atol=1e-30)


# ---------------------------------------------------------------- tree build


@pytest.mark.parametrize("dim", [2, 3])
def test_scalar_bounds(dim):
    _, x = _clusters(1000, dim, seed=3)
    for xx in (x, np.abs(x) + 5, -np.abs(x) - 5):  # bounds include 0 either way
        lo, hi = jgeo.scalar_bounds(jnp.asarray(xx))
        tlo, thi = tgeo.scalar_bounds(_t(xx))
        assert (tlo.item(), thi.item()) == (float(lo), float(hi))


def test_max_depth():
    for n in (1, 2, 7, 100, 1000, 17000, 1 << 20, 1 << 26):
        for dim in (2, 3):
            assert tot.max_depth(n, dim) == jot.max_depth(n, dim)


@pytest.mark.parametrize("dim,depth", [(2, 16), (3, 10), (2, 9), (3, 7)])
def test_morton_keys_bit_equal(dim, depth):
    """Full-width keys (2-D depth 16 fills all 32 bits), with bodies
    outside the box clamped into the edge cells."""
    _, x = _clusters(5000, dim, seed=4)
    lo = np.percentile(x, 2, axis=0).astype(np.float32)
    hi = np.percentile(x, 98, axis=0).astype(np.float32)
    jk = np.asarray(jot.morton_keys(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), depth))
    tk = tot.morton_keys(_t(x), _t(lo), _t(hi), depth)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), jk.astype(np.int64))
    assert int(jk.max()) >= 1 << (dim * depth - 1)  # the top key bit is used


@pytest.mark.parametrize("dim", [2, 3])
def test_robust_quant_box_within_one_ulp(dim):
    for n in (3000, 40000):  # 40000 takes the strided subsample
        m, x = _clusters(n, dim, seed=5)
        x[:7] *= 30  # escapers outside the quantile box
        lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
        jlo, jhi = (np.asarray(a) for a in jot.robust_quant_box(jnp.asarray(x), lo, hi))
        tlo, thi = tot.robust_quant_box(_t(x))
        for j, t in ((jlo, tlo.numpy()), (jhi, thi.numpy())):
            assert t.shape == j.shape == (dim,) and t.dtype == np.float32
            assert np.all(np.abs(t - j) <= np.spacing(np.abs(j))), (t, j)


@pytest.mark.parametrize("dim", [2, 3])
def test_morton_sort_and_tree_size_bit_equal(dim):
    n = 6000
    m, x = _clusters(n, dim, seed=6)
    x[100:140] = x[7]  # duplicate keys: the sort must be stable
    depth = jot.max_depth(n, dim)
    lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
    lo_r, hi_r = jot.robust_quant_box(jnp.asarray(x), lo, hi)
    jms, jxs, jks, jperm = jot.morton_sort(jnp.asarray(m), jnp.asarray(x), lo_r, hi_r, depth)
    tms, txs, tks, tperm = tot.morton_sort(_t(m), _t(x), _t(lo_r), _t(hi_r), depth)
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks).astype(np.int64))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tms.numpy(), np.asarray(jms))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert int(tot.tree_size_from_keys(tks, depth, dim)) == \
        int(jot.tree_size_from_keys(jks, depth, dim))


def test_unpermute_rows_bit_equal():
    rng = np.random.default_rng(7)
    perm = rng.permutation(1000).astype(np.int32)
    a = rng.normal(size=(1000, 3)).astype(np.float32)
    got = unpermute_rows(_t(a), _t(perm).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_unpermute_rows(jnp.asarray(a),
                                                                           jnp.asarray(perm))))


def test_merge_contiguous_entries_bit_equal():
    """A tile-sorted stream with sentinels, touching and non-touching
    same-block runs, block changes and pad entries past n_raw."""
    rng = np.random.default_rng(8)
    ents, lohis = [], []
    for tile in range(40):
        ents.append(tile << 16)
        lohis.append(0)  # the lo == hi sentinel leading each tile
        pos = {}
        for _ in range(rng.integers(0, 12)):
            blk = int(rng.integers(0, 4))
            lo = pos.get(blk, int(rng.integers(0, 50)))
            hi = lo + int(rng.integers(1, 40))
            if rng.random() < 0.3:
                lo, hi = hi + 3, hi + 20  # a gap: must not merge
            pos[blk] = hi
            ents.append((tile << 16) | blk)
            lohis.append(lo | (hi << 16))
    order = np.lexsort((np.array(lohis) & 0xFFFF, np.array(ents)))  # per tile by (blk, lo)
    ents, lohis = np.array(ents, np.int32)[order], np.array(lohis, np.int32)[order]
    n_raw = len(ents)
    e_cap = n_raw + 50
    pad = (39 << 16) | 0
    ents = np.concatenate([ents, np.full(50, pad, np.int32)])
    lohis = np.concatenate([lohis, np.zeros(50, np.int32)])
    je, jl, jn, _ = jog.merge_contiguous_entries(jnp.asarray(ents), jnp.asarray(lohis),
                                                 jnp.asarray(n_raw, jnp.int32), pad)
    te, tl, tn = tog.merge_contiguous_entries(_t(ents), _t(lohis), torch.tensor(n_raw), pad)
    assert te.dtype == tl.dtype == torch.int32 and te.shape == (e_cap,)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tn) == int(jn) < n_raw


def test_pack_unpack_mask_bits_round_trip():
    rng = np.random.default_rng(9)
    for w in (1, 31, 32, 33, 100, 1024):
        mask = torch.tensor(rng.random((5, w)) < 0.4)
        mask[0] = True  # bit 31 of every word: the int32 sign bit
        words = tge.pack_mask_bits(mask)
        assert words.dtype == torch.int32 and words.shape == (5, -(-w // 32))
        assert torch.equal(tge.unpack_mask_bits(words, w), mask)
        # node l sits in word l // 32, bit l % 32
        l = w - 1
        assert bool((words[0, l // 32] >> (l % 32)) & 1)
    assert int(tge.pack_mask_bits(torch.ones(1, 32, dtype=torch.bool))[0, 0]) == -1


# ------------------------------------------------ kernel twins vs Pallas


def _kernel_inputs(n, dim, seed):
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.1, 1.0, n).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32)
    return rng, m, x


@pytest.mark.parametrize("dim", [2, 3])
def test_far_twin_vs_masked_eval_bits_pallas(dim):
    """A random accept mask through each package's own pack; W = 1500 is
    not a multiple of 32 nor of the Pallas j-block, and one tile accepts
    nothing."""
    ntiles, tb, w = 6, 128, 1500
    rng, mj, xj = _kernel_inputs(w, dim, seed=10 + dim)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tb, dim)).astype(np.float32)
    xi[5:9] = xj[:4]  # coincident pairs: m / eps^3 terms
    mask = rng.random((ntiles, w)) < 0.3
    mask[2] = False
    ref = jpg.masked_eval_bits_pallas(jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T),
                                      jpg.pack_mask_bits(jnp.asarray(mask)), EPS,
                                      interpret=True, softening="sqrt3")
    words = tge.pack_mask_bits(_t(mask))
    got = tge.masked_eval_bits_cuda(_t(xi), _t(mj), _t(xj), words, EPS, "sqrt3")
    sums = _f64_sums(xi, mj, xj, mask, tb)
    _assert_twin_and_pallas(got, ref, sums)
    _assert_scale(tge.masked_eval_bits_torch(_t(xi), _t(mj), _t(xj), words, EPS, "sqrt3",
                                             absolute=True), sums)
    assert not got[2 * tb:3 * tb].any()


@pytest.mark.parametrize("dim", [2, 3])
def test_window_twin_vs_window_eval_interval_pallas(dim):
    """Random w0 / lo / hi, with intervals that start before the window,
    end past it, and are empty."""
    ntiles, tb, wt = 8, 128, 4
    rng, mj, xj = _kernel_inputs(ntiles * tb, dim, seed=20 + dim)
    mj[-37:] = 0  # padding bodies
    w0 = rng.integers(0, ntiles - wt + 1, ntiles).astype(np.int32)
    lo = (w0 * tb + rng.integers(-100, 300, ntiles)).clip(0).astype(np.int32)
    hi = (lo + rng.integers(0, wt * tb + 200, ntiles)).astype(np.int32)
    hi[3] = lo[3]
    ref = jpg.window_eval_interval_pallas(jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T),
                                          jnp.asarray(w0), jnp.asarray(lo), jnp.asarray(hi), EPS,
                                          window_tiles=wt, interpret=True, softening="sqrt3",
                                          skip_outside=True)
    args = (_t(xj), _t(mj), _t(xj), _t(w0), _t(lo), _t(hi), EPS, wt)
    got = tge.window_eval_interval_cuda(*args)
    cols = np.arange(ntiles * tb)[None, :]
    sel = ((cols >= np.maximum(lo, w0 * tb)[:, None])
           & (cols < np.minimum(hi, (w0 + wt) * tb)[:, None]))
    sums = _f64_sums(xj, mj, xj, sel, tb)
    _assert_twin_and_pallas(got, ref, sums)
    _assert_scale(tge.window_eval_interval_torch(*args, absolute=True), sums)
    assert not got[3 * tb:4 * tb].any()


@pytest.mark.parametrize("dim", [2, 3])
def test_entries_twin_vs_entries_lohi_eval_pallas(dim):
    """A hand-built tile-sorted list: empty tiles, lo == hi sentinels, a
    tile whose entries span whole blocks, and pads past n_real."""
    ntiles, tb, S = 6, 128, 256
    n = ntiles * tb
    rng, mj, xj = _kernel_inputs(n, dim, seed=30 + dim)
    nblocks = n // S
    ents, lohis = [], []
    sel = np.zeros((ntiles, n), bool)
    for tile in (0, 2, 3, 5):  # tiles 1 and 4 have no entries at all
        ents.append(tile << 16)
        lohis.append(0)
        for blk in range(nblocks):
            if tile == 3:
                lo, hi = 0, S  # whole blocks
            else:
                lo = int(rng.integers(0, S))
                hi = int(rng.integers(lo, S + 1))
            ents.append((tile << 16) | blk)
            lohis.append(lo | (hi << 16))
            sel[tile, blk * S + lo:blk * S + hi] = True
    n_real = len(ents)
    ents += [(ntiles - 1) << 16] * 9
    lohis += [0] * 9
    ents, lohis = np.array(ents, np.int32), np.array(lohis, np.int32)
    ref = jpg.entries_lohi_eval_pallas(jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T),
                                       jnp.asarray(ents), jnp.asarray(lohis), EPS, S=S, tb=tb,
                                       interpret=True, softening="sqrt3",
                                       n_real=jnp.asarray(n_real, jnp.int32))
    args = (_t(xj), _t(mj), _t(xj), _t(ents), _t(lohis), torch.tensor(n_real), S, ntiles, EPS,
            "sqrt3")
    got = tge.entries_lohi_eval_cuda(*args)
    sums = _f64_sums(xj, mj, xj, sel, tb)
    _assert_twin_and_pallas(got, ref, sums)
    _assert_scale(tge.entries_lohi_eval_torch(*args, absolute=True), sums)
    assert not got[tb:2 * tb].any() and not got[4 * tb:5 * tb].any()
    first, last = tge.tile_segments(_t(ents), torch.tensor(n_real), ntiles)
    assert first.tolist() == [0, 4, 4, 8, 12, 12] and last.tolist() == [4, 4, 8, 12, 12, 16]


# ------------------------------------------------- the whole fast path

# (name, n, dim, workload kwargs, compute_force_grouped_fast kwargs); the
# first three are the configurations of tests/test_trees.py:968 and its
# small-tile variants, the fourth overflows entries into the exact
# fallback, the fifth the far heap into its dense fallback
CONFIGS = {
    "17k-3d-defaults": (17000, 3, {}, {}),
    "8k-2d-tile128": (8192, 2, {}, dict(tile=128, window_tiles=4)),
    "17k-3d-tile128": (17000, 3, {}, dict(tile=128, s_block=256, window_tiles=2)),
    "17k-3d-uniform-fallback": (17000, 3, dict(uniform=True), dict(window_tiles=1, e_chunk=1024)),
    "8k-2d-farheap-overflow": (8192, 2, {}, dict(tile=128, window_tiles=4, far_heap_cap=64)),
}
COUNTERS = ("entries", "fallback_tiles", "open_cells", "near_width_sum", "window_span_sum",
            "far_heap_nonempty", "open_mass")


@pytest.fixture(scope="module")
def fast_runs():
    """Both packages' compute_force_grouped_fast on every configuration,
    the JAX one in interpret mode; cached for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            n, dim, wkw, kw = CONFIGS[name]
            m, x = _clusters(n, dim, **wkw)
            depth = jot.max_depth(n, dim)
            lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
            lo_r, hi_r = jot.robust_quant_box(jnp.asarray(x), lo, hi)
            ms, xs, ks, _ = jot.morton_sort(jnp.asarray(m), jnp.asarray(x), lo_r, hi_r, depth)
            ja, jinfo = jog.compute_force_grouped_fast(ms, xs, ks, lo_r, hi_r, depth, 0.5, 1.0,
                                                       EPS, interpret=True, **kw)
            tms, txs, tks, _ = tot.morton_sort(_t(m), _t(x), _t(lo_r), _t(hi_r), depth)
            ta, tinfo = tog.compute_force_grouped_fast(tms, txs, tks, depth, 0.5, 1.0, EPS, **kw)
            cache[name] = (np.asarray(ms), np.asarray(xs), np.asarray(ja), jinfo, ta.numpy(),
                           tinfo)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fast_path_vs_nbody_tpu(name, fast_runs):
    ms, xs, ja, jinfo, ta, tinfo = fast_runs(name)
    assert ta.shape == ja.shape == xs.shape and ta.dtype == np.float32
    for key in COUNTERS:
        assert (key in tinfo) == (key in jinfo), key
        if key in jinfo:
            assert int(tinfo[key]) == int(jinfo[key]), key
    assert int(jinfo["entries"]) > 0
    rel = np.abs(ta - ja).sum() / np.abs(ja).sum()
    assert rel < TOL, rel


def test_fast_path_configurations_reach_their_branches(fast_runs):
    """The fallback and far-heap configurations do what they are for."""
    assert int(fast_runs("17k-3d-uniform-fallback")[5]["fallback_tiles"]) > 0
    info = fast_runs("8k-2d-farheap-overflow")[5]
    assert int(info["far_heap_nonempty"]) > 64
    assert "far_heap_nonempty" not in fast_runs("8k-2d-tile128")[5]  # heap narrower than the cap


def test_fast_path_with_fallback_vs_direct_sum(fast_runs):
    """Forces of the configuration with fallback tiles against a float64
    direct sum with the octree softening, on a sample of bodies, within
    the sanity bounds chip_smoke.py holds the card to (a uniform box at
    theta 0.5: median 1.1e-4, p99 2.7e-3 measured on the CPU)."""
    ms, xs, _, _, ta, _ = fast_runs("17k-3d-uniform-fallback")
    rows = np.random.default_rng(12).choice(xs.shape[0], 1500, replace=False)
    x64, m64 = xs.astype(np.float64), ms.astype(np.float64)
    ref = np.zeros((rows.size, 3))
    for a in range(0, rows.size, 250):
        d = x64[None, :, :] - x64[rows[a:a + 250]][:, None, :]
        r = np.sqrt(np.sum(d * d, axis=-1))
        ref[a:a + 250] = np.einsum("kn,knd->kd", m64[None, :] / (r + EPS) ** 3, d)
    err = np.linalg.norm(ta[rows] - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert np.median(err) < 1e-3 and np.percentile(err, 99) < 1e-2, (np.median(err), err.max())


@pytest.mark.parametrize("dim", [2, 3])
def test_octree_step_force_vs_nbody_tpu(dim):
    """One step through both packages' octree_step_force (the fast path,
    JAX in interpret mode): forces in the caller's order, tree size, and
    root mass within one float32 ulp (the port sums the masses in float64
    and rounds once; XLA's float32 reduction order is its own)."""
    from nbody_torch.state import SystemState
    from nbody_tpu.state import SystemState as JState

    n = 3000
    m, x = _clusters(n, dim, seed=13)
    v = np.zeros_like(x)
    depth = jot.max_depth(n, dim)
    jstate = JState(m=jnp.asarray(m), x=jnp.asarray(x), v=jnp.asarray(v), a=jnp.asarray(v),
                    ao=jnp.asarray(v))
    jout, _, jaux = jot.octree_step_force(jstate, 0.5, 1.0, EPS, depth, use_pallas="interpret")
    tstate = SystemState.from_numpy(m, x, v, device=torch.device("cpu"))
    tout, taux = tot.octree_step_force(tstate, 0.5, 1.0, EPS, depth)
    ja = np.asarray(jout.a)
    assert np.abs(tout.a.numpy() - ja).sum() / np.abs(ja).sum() < TOL
    assert int(taux["tree_size"]) == int(jaux["tree_size"])
    assert int(taux["overflow"]) == int(jaux["overflow"]) == 0
    jmass = np.float32(jaux["root_mass"])
    assert abs(np.float32(taux["root_mass"]) - jmass) <= np.spacing(jmass)
