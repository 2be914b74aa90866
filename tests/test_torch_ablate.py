"""The ablation path of the trees' fast paths (the `ablate=` tokens
densemask, farcompact, packedj, desc1 / desc2), its three kernels'
plain twins, the supertile descent and the knob probe, against nbody_tpu
on the CPU (the other tokens: tests/test_torch_knobs_octree.py and
test_torch_knobs_bvh.py).

The same numpy-made inputs go through both packages; the Pallas
functions run in interpret mode, as nbody_tpu's own tests run them.

Tolerances. Each kernel's twin is held within 1e-5 of each row's sum of
|term| of a float64 evaluation of the same pairs, and the Pallas function
within 1e-4 of it: its interpret-mode reciprocal is about 1e-5 off by
itself (tests/test_torch_octree.py). The descent's ids, bits, counts,
survivors and overflow flags are exactly nbody_tpu's. The whole fast
path with each token is held within 1e-5 of sum |a| of nbody_tpu's
result with the same token (the bound of tests/test_trees.py:1008), with
every integer counter equal, descend_* included. Within the port, a
token's forces equal the default path's bit for bit where the twins sum
the same terms in the same order (packedj, fheap); else within 1e-6 of
sum |a| (see each test).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import probe
from nbody_torch.experimental import tree_descend as ttd
from nbody_torch.ops import bvh as tbvh
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import cuda_group_eval as tge
from nbody_torch.ops import octree as tot
from nbody_torch.ops import octree_group as tog
from nbody_tpu.experimental import tree_descend as jtd
from nbody_tpu.ops import bvh as jbvh
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import hilbert as jh
from nbody_tpu.ops import octree as jot
from nbody_tpu.ops import octree_group as jog
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _f64_sums(xi, mj, xj, weight, tb, softening):
    """float64 force sum_j w_tj m_j (x_j - x_i) / t and its scale sum_j
    |term| per row and component, row tile t against the sources of
    list[t] (mj (L, c), xj (L, c, dim); a shared (c,) / (c, dim) list for
    every tile) weighted by weight (T, c)."""
    xi, mj, xj, weight = (np.asarray(a, np.float64) for a in (xi, mj, xj, weight))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for t in range(weight.shape[0]):
        m, x = (mj, xj) if mj.ndim == 1 else (mj[t], xj[t])
        rows = slice(t * tb, (t + 1) * tb)
        d = x[None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        r = np.sqrt(d2)
        den = (r + EPS) ** 3 if softening == "sqrt3" else d2 * r + EPS
        w = (weight[t] * m)[None, :] / den
        force[rows] = np.einsum("kn,knd->kd", w, d)
        scale[rows] = np.einsum("kn,knd->kd", w, np.abs(d))
    return force, scale


def _assert_twin_and_pallas(got, pallas, sums):
    exact, scale = sums
    for arr, tol in ((got, TOL), (pallas, 10 * TOL)):
        arr = np.asarray(arr, np.float64)
        assert arr.shape == exact.shape and np.all(np.isfinite(arr))
        err = np.abs(arr - exact)
        assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))


def _rows_and_sources(ntiles, tb, w, dim, seed):
    rng = np.random.default_rng(seed)
    mj = rng.uniform(0.1, 1.0, w).astype(np.float32)
    xj = rng.uniform(-1.0, 1.0, (w, dim)).astype(np.float32)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tb, dim)).astype(np.float32)
    xi[5:9] = xj[:4]  # coincident pairs: m / eps^3 (sqrt3) or m / eps (poly) terms
    return rng, mj, xj, xi


# ---------------------------------------------------- kernel twins vs Pallas


@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_masked_eval_twin_vs_pallas(dim, softening):
    """masked_eval_pallas (row 10): W = 1500 is not a multiple of the
    Pallas j-block, dead nodes of mass 0, a tile that accepts nothing."""
    ntiles, tb, w = 6, 128, 1500
    rng, mj, xj, xi = _rows_and_sources(ntiles, tb, w, dim, seed=200 + dim)
    mj[::19] = 0
    mask = (rng.random((ntiles, w)) < 0.3).astype(np.float32)
    mask[2] = 0
    ref = jpg.masked_eval_pallas(jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T),
                                 jnp.asarray(mask), EPS, interpret=True, softening=softening)
    got = tge.masked_eval_cuda(_t(xi), _t(mj), _t(xj), _t(mask), EPS, softening)
    sums = _f64_sums(xi, mj, xj, mask, tb, softening)
    _assert_twin_and_pallas(got, ref, sums)
    np.testing.assert_allclose(tge.masked_eval_torch(_t(xi), _t(mj), _t(xj), _t(mask), EPS,
                                                     softening, absolute=True).numpy(),
                               sums[1], rtol=1e-5, atol=1e-30)
    assert not got[2 * tb:3 * tb].any()


@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_group_shared_masked_twin_vs_pallas(dim, softening):
    """group_shared_masked_eval_pallas (row 11): G = 8 over 11 tiles (not a
    multiple of G), a ragged M = 1100 with a padded tail of mass 0, a tile
    with an empty mask."""
    ntiles, tb, width, G = 11, 128, 1100, 8
    nsuper = -(-ntiles // G)
    rng, mj, xj, xi = _rows_and_sources(ntiles, tb, nsuper * width, dim, seed=210 + dim)
    mj, xj = mj.reshape(nsuper, width), xj.reshape(nsuper, width, dim)
    mj[:, -70:] = 0
    mask = (rng.random((ntiles, width)) < 0.4).astype(np.float32)
    mask[9] = 0
    ref = jpg.group_shared_masked_eval_pallas(
        jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(np.swapaxes(xj, 1, 2)), jnp.asarray(mask),
        EPS, G, interpret=True, softening=softening)
    got = tge.group_shared_masked_eval_cuda(_t(xi), _t(mj), _t(xj), _t(mask), EPS, G, softening)
    lists = np.arange(ntiles) // G
    _assert_twin_and_pallas(got, ref, _f64_sums(xi, mj[lists], xj[lists], mask, tb, softening))
    assert not got[9 * tb:10 * tb].any()


def _float_weights(rng, shape, density):
    """Weights that are not 0/1: 0.5, 3.0, 0.25 or -0.0 where drawn, else 0."""
    drawn = rng.random(shape) < density
    return np.where(drawn, rng.choice([0.5, 3.0, 0.25, -0.0], shape), 0.0).astype(np.float32)


@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_masked_eval_twin_vs_pallas_float_weights(dim, softening):
    """masked_eval_pallas (row 10) with weights that are not 0/1, folded as
    (mask * m): W = 1501 (not a multiple of 4 or 32), dead nodes, a tile
    whose weights are all zero or -0.0."""
    ntiles, tb, w = 5, 128, 1501
    rng, mj, xj, xi = _rows_and_sources(ntiles, tb, w, dim, seed=230 + dim)
    mj[::23] = 0
    mask = _float_weights(rng, (ntiles, w), 0.3)
    mask[3] = 0
    mask[3, ::5] = -0.0
    ref = jpg.masked_eval_pallas(jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T),
                                 jnp.asarray(mask), EPS, interpret=True, softening=softening)
    got = tge.masked_eval_cuda(_t(xi), _t(mj), _t(xj), _t(mask), EPS, softening)
    _assert_twin_and_pallas(got, ref, _f64_sums(xi, mj, xj, mask, tb, softening))
    assert not got[3 * tb:4 * tb].any()


@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_group_shared_masked_twin_vs_pallas_float_weights(dim, softening):
    """group_shared_masked_eval_pallas (row 11) with weights that are not
    0/1: G = 8 over 11 tiles, M = 1100 with a padded tail of mass 0."""
    ntiles, tb, width, G = 11, 128, 1100, 8
    nsuper = -(-ntiles // G)
    rng, mj, xj, xi = _rows_and_sources(ntiles, tb, nsuper * width, dim, seed=240 + dim)
    mj, xj = mj.reshape(nsuper, width), xj.reshape(nsuper, width, dim)
    mj[:, -70:] = 0
    mask = _float_weights(rng, (ntiles, width), 0.4)
    mask[6] = 0
    ref = jpg.group_shared_masked_eval_pallas(
        jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(np.swapaxes(xj, 1, 2)), jnp.asarray(mask),
        EPS, G, interpret=True, softening=softening)
    got = tge.group_shared_masked_eval_cuda(_t(xi), _t(mj), _t(xj), _t(mask), EPS, G, softening)
    lists = np.arange(ntiles) // G
    _assert_twin_and_pallas(got, ref, _f64_sums(xi, mj[lists], xj[lists], mask, tb, softening))
    assert not got[6 * tb:7 * tb].any()


@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_packed_entries_twin_vs_pallas(dim, softening):
    """entries_lohi_eval_pallas(packed_j=True) (row 6p): a hand-built
    tile-sorted list with empty tiles, sentinels, whole blocks and pads
    past n_real; the packed twin equals the unpacked one bit for bit."""
    ntiles, tb, S = 6, 128, 256
    n = ntiles * tb
    rng, mj, xj, _ = _rows_and_sources(1, tb, n, dim, seed=220 + dim)  # rows: the sources
    ents, lohis = [], []
    sel = np.zeros((ntiles, n), np.float32)
    for tile in (0, 2, 3, 5):
        ents.append(tile << 16)
        lohis.append(0)
        for blk in range(n // S):
            lo, hi = (0, S) if tile == 3 else sorted(int(v) for v in rng.integers(0, S + 1, 2))
            ents.append((tile << 16) | blk)
            lohis.append(lo | (hi << 16))
            sel[tile, blk * S + lo:blk * S + hi] = 1
    n_real = len(ents)
    ents, lohis = np.array(ents + [(ntiles - 1) << 16] * 5, np.int32), np.array(lohis + [0] * 5,
                                                                                 np.int32)
    ref = jpg.entries_lohi_eval_pallas(jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T),
                                       jnp.asarray(ents), jnp.asarray(lohis), EPS, S=S, tb=tb,
                                       interpret=True, softening=softening,
                                       n_real=jnp.asarray(n_real, jnp.int32), packed_j=True)
    args = (_t(xj), _t(mj), _t(xj), _t(ents), _t(lohis), torch.tensor(n_real), S, ntiles, EPS,
            softening)
    got = tge.entries_lohi_eval_cuda(*args, packed=True)
    _assert_twin_and_pallas(got, ref, _f64_sums(xj, mj, xj, sel, tb, softening))
    assert torch.equal(got, tge.entries_lohi_eval_cuda(*args))
    xm = tge.pack_sources(_t(mj), _t(xj))
    assert xm.shape == (n, 4) and torch.equal(xm[:, 3], _t(mj))
    assert torch.equal(xm[:, :dim], _t(xj)) and not xm[:, dim:3].any()


# ------------------------------------------------------ the supertile descent


def _descend_case(T, C0, nbranch, levels, seed):
    """Seeded open mask (T, C0) and, per level, node liveness and a
    per-tile MAC outcome over all Kc = C0 * nbranch^r nodes."""
    rng = np.random.default_rng(seed)
    open0 = rng.random((T, C0)) < 0.35
    open0[T // 2:] &= rng.random((T - T // 2, C0)) < 0.2  # sparser tiles: not every cap trips
    alive = {r: rng.random(C0 * nbranch ** r) < 0.8 for r in range(1, levels + 1)}
    accept = {r: rng.random((T, C0 * nbranch ** r)) < 0.45 for r in range(1, levels + 1)}
    return open0, alive, accept


def _run_descend(pkg, case, nbranch, levels, G, caps):
    """supertile_descend of nbody_tpu (pkg "jax") or the port, with mac_fn
    and mono_fn looking the seeded tables up; outputs as numpy."""
    open0, alive, accept = case
    T = open0.shape[0]
    Ts = -(-T // G)

    def mac_fn(r, ids):
        idc = np.clip(np.asarray(ids), 0, alive[r].shape[0] - 1)
        acc = np.zeros((Ts * G, idc.shape[1]), bool)
        full = np.zeros((Ts * G, accept[r].shape[1]), bool)
        full[:T] = accept[r]
        for s in range(Ts):
            acc[s * G:(s + 1) * G] = full[s * G:(s + 1) * G][:, idc[s]]
        out = {"accept": acc.reshape(Ts, G, -1), "alive": alive[r][idc]}
        return {k: (jnp.asarray(v) if pkg == "jax" else torch.tensor(v)) for k, v in out.items()}

    def mono_fn(r, ids):
        idn = np.asarray(ids).astype(np.float32)
        mass = 1.0 + idn + 100.0 * r
        com = np.stack([mass * 2.0, mass * 3.0], axis=-1)
        wrap = jnp.asarray if pkg == "jax" else torch.tensor
        return wrap(mass), wrap(com)

    k0, k, m = caps
    mod = jtd if pkg == "jax" else ttd
    res = mod.supertile_descend(jnp.asarray(open0) if pkg == "jax" else torch.tensor(open0),
                                nbranch, levels, G, k0=k0, k_caps=[k] * levels,
                                m_caps=[m] * levels, mac_fn=mac_fn, mono_fn=mono_fn)
    arrays = {f: np.asarray(getattr(res, f)) for f in res._fields if f != "diag"}
    return arrays, {key: int(v) for key, v in res.diag.items()}


@pytest.mark.parametrize("nbranch,levels,G,T,C0,caps", [
    (4, 2, 8, 11, 64, (256, 256, 256)),   # 2-D, ntiles not a multiple of G
    (8, 2, 8, 16, 64, (32, 600, 600)),    # 3-D, k0 overflowing one supertile of two
    (8, 1, 3, 7, 512, (64, 512, 128)),    # desc1, k0 below the opens of a supertile
])
def test_supertile_descend_matches_jax(nbranch, levels, G, T, C0, caps):
    case = _descend_case(T, C0, nbranch, levels, seed=nbranch * 10 + levels + T)
    ja, jdiag = _run_descend("jax", case, nbranch, levels, G, caps)
    ta, tdiag = _run_descend("torch", case, nbranch, levels, G, caps)
    assert tdiag == jdiag
    for field, want in ja.items():
        got = ta[field]
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=field)
    if caps == (32, 600, 600):
        assert ta["overflow"].any() and not ta["overflow"].all()


@pytest.mark.parametrize("cap", [5, 64, 300])
def test_compact_matches_jax(cap):
    """_compact: rows of unique ids with sparse member bits, a cap below,
    at and above the widest row."""
    rng = np.random.default_rng(cap)
    ids = np.stack([rng.permutation(256) for _ in range(9)]).astype(np.int32)
    bits = np.where(rng.random((9, 256)) < 0.2, rng.integers(1, 256, (9, 256)), 0).astype(np.int32)
    bits[3] = 0
    want = [np.asarray(a) for a in jtd._compact(jnp.asarray(ids), jnp.asarray(bits), cap)]
    got = [a.numpy() for a in ttd._compact(_t(ids).long(), _t(bits).long(), cap)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ the octree fast path


def _two_gaussians(n, dim, seed):
    """tests/test_trees.py's farcompact / densemask system: two Gaussian
    blobs."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, (n // 2, dim)),
                        rng.normal(3, 1, (n - n // 2, dim))]).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


def _clustered(n, dim, seed):
    """tests/test_trees.py's _system(n, dim, seed=seed, clustered=True):
    four Gaussian clusters."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.1, 1.0, n).astype(np.float32)
    centers = rng.uniform(-50, 50, (4, dim))
    return m, (centers[rng.integers(0, 4, n)] + rng.normal(0, 1.0, (n, dim))).astype(np.float32)


# name -> (system, n, dim, seed, theta, compute_force_grouped_fast kwargs)
OCTREE_CASES = {
    "packedj-2d": (_clustered, 900, 2, 27, 0.5, dict(tile=128, s_block=256)),
    "packedj-3d": (_clustered, 900, 3, 27, 0.5, dict(tile=128, s_block=256)),
    "farcompact": (_two_gaussians, 4096, 3, 7, 0.5, {}),
    "densemask": (_two_gaussians, 4096, 3, 11, 0.5, {}),
    "desc2-theta0": (_clustered, 1500, 2, 11, 0.0, dict(tile=512, window_tiles=1)),
    "desc2-theta0.5": (_clustered, 1500, 2, 11, 0.5, dict(tile=512, window_tiles=1)),
}


@pytest.fixture(scope="module")
def octree_runs():
    """(sorted ms, xs, keys as torch; JAX's result and info with the token)
    per case, cached for the module: JAX's interpret-mode runs take most
    of this file's time."""
    cache = {}

    def get(name):
        if name not in cache:
            system, n, dim, seed, theta, kw = OCTREE_CASES[name]
            m, x = system(n, dim, seed)
            depth = jot.max_depth(n, dim)
            lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
            lo_r, hi_r = jot.robust_quant_box(jnp.asarray(x), lo, hi)
            ms, xs, ks, _ = jot.morton_sort(jnp.asarray(m), jnp.asarray(x), lo_r, hi_r, depth)
            token = name.split("-")[0]
            ja, jinfo = jog.compute_force_grouped_fast(ms, xs, ks, lo_r, hi_r, depth, theta, 1.0,
                                                       EPS, interpret=True, ablate=token, **kw)
            t = tot.morton_sort(_t(m), _t(x), _t(lo_r), _t(hi_r), depth)[:3]
            cache[name] = (t, depth, theta, kw, token, np.asarray(ja),
                           {k: int(v) for k, v in jinfo.items()})
        return cache[name]

    return get


def _assert_counters_equal(tinfo, jinfo):
    """Every key of nbody_tpu's info is in the port's (but descend__dbg, a
    dict of tensors compared on its own), with the same count."""
    keys = set(jinfo) - {"descend__dbg"}
    assert not keys - set(tinfo), keys - set(tinfo)
    assert {k: int(tinfo[k]) for k in keys} == {k: jinfo[k] for k in keys}


@pytest.mark.parametrize("name", list(OCTREE_CASES))
def test_octree_token_vs_nbody_tpu(name, octree_runs):
    (ms, xs, ks), depth, theta, kw, token, ja, jinfo = octree_runs(name)
    ta, tinfo = tog.compute_force_grouped_fast(ms, xs, ks, depth, theta, 1.0, EPS, ablate=token,
                                               **kw)
    _assert_counters_equal(tinfo, jinfo)
    assert jinfo["entries"] > 0
    if token == "desc2":
        assert tinfo["descend_mono_1"] + tinfo["descend_mono_2"] > 0
        assert tinfo["descend_open_2"] > 0
    rel = np.abs(ta.numpy() - ja).sum() / np.abs(ja).sum()
    assert rel < TOL, rel


@pytest.mark.parametrize("name", ["packedj-2d", "packedj-3d", "farcompact", "densemask",
                                  "desc2-theta0"])
def test_octree_token_vs_default_path(name, octree_runs):
    """packedj: the packed twin reads the same values in the same order,
    so the forces are bit-equal (JAX's test_fast_paths_packed_j_bitexact).
    farcompact, densemask: the same accepted sources, but the twins sum
    them over other column sets (per supertile list, the full heap and
    the dense window instead of the compacted heap and the interval) in
    float64 and round once: within 1e-6 of sum |a|. desc2 at theta 0
    accepts only one-body cells, each its own body, so it evaluates the
    default path's exact pairs: within 1e-6 of sum |a|."""
    (ms, xs, ks), depth, theta, kw, token, *_ = octree_runs(name)
    a0, _ = tog.compute_force_grouped_fast(ms, xs, ks, depth, theta, 1.0, EPS, **kw)
    a1, info = tog.compute_force_grouped_fast(ms, xs, ks, depth, theta, 1.0, EPS, ablate=token,
                                              **kw)
    assert float(a0.abs().max()) > 0
    if token == "packedj":
        assert torch.equal(a0, a1)
    else:
        assert ((a1 - a0).abs().sum() / a0.abs().sum()).item() < 1e-6
    if token == "densemask":
        assert "far_heap_nonempty" not in info


def test_octree_desc1_and_noop_tokens():
    """desc1 sets descend_levels = 1 (desc2 wins over it, as in nbody_tpu);
    fheap and sortunperm change nothing, bit for bit."""
    m, x = _clustered(1500, 2, 11)
    depth = tot.max_depth(1500, 2)
    lo, hi = tot.robust_quant_box(_t(x))
    ms, xs, ks, _ = tot.morton_sort(_t(m), _t(x), lo, hi, depth)
    kw = dict(tile=512, window_tiles=1)
    a0, i0 = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, **kw)
    for noop in ("fheap", "sortunperm", "fheap,sortunperm", ","):
        a, info = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate=noop,
                                                 **kw)
        assert torch.equal(a, a0) and info.keys() == i0.keys()
    _, i1 = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate="desc1", **kw)
    _, i1b = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, descend_levels=1,
                                            **kw)
    _, i2 = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate="desc2,desc1",
                                           **kw)
    assert "descend_mono_1" in i1 and "descend_mono_2" not in i1
    assert {k: int(v) for k, v in i1.items()} == {k: int(v) for k, v in i1b.items()}
    assert "descend_mono_2" in i2


# --------------------------------------------------------- the BVH fast path


@pytest.fixture(scope="module")
def bvh_system():
    """tests/test_trees.py:813-834's BVH system, Hilbert-sorted by
    nbody_tpu, its tree in both packages."""
    m, x = _two_gaussians(4096, 3, 11)
    jx = jnp.asarray(x)
    perm = np.asarray(jh.hilbert_sort_perm(jx, *jgeo.aabb_of_points(jx, EPS)))
    ms, xs = m[perm], x[perm]
    jtree = jbvh.build_tree(jnp.asarray(ms), jnp.asarray(xs), EPS)
    return ms, xs, jtree, tbvh.build_tree(_t(ms), _t(xs), EPS)


@pytest.mark.parametrize("token,kw", [("densemask", {}), ("packedj", {}),
                                      ("densemask,packedj", dict(tile=256, s_target=256))])
def test_bvh_token_vs_nbody_tpu(token, kw, bvh_system):
    """Each token, and both with s_target (the L* node size) 256, against
    nbody_tpu's windowed path with the same arguments."""
    ms, xs, jtree, ttree = bvh_system
    ja, jinfo = jbg.compute_force_grouped_windowed(jtree, jnp.asarray(ms), jnp.asarray(xs), 0.5,
                                                   1.0, EPS, interpret=True, ablate=token, **kw)
    ta, tinfo = tbg.compute_force_grouped_windowed(ttree, _t(ms), _t(xs), 0.5, 1.0, EPS,
                                                   ablate=token, **kw)
    _assert_counters_equal(tinfo, {k: int(v) for k, v in jinfo.items()})
    assert int(jinfo["entries"]) > 0
    ja = np.asarray(ja)
    rel = np.abs(ta.numpy() - ja).sum() / np.abs(ja).sum()
    assert rel < TOL, rel
    # within the port: packedj alone is bit-equal to the default path; the
    # dense far mask and dense window sum over the full heap and every
    # window column (float64, rounded once): within 1e-6 of sum |a|
    a0, _ = tbg.compute_force_grouped_windowed(ttree, _t(ms), _t(xs), 0.5, 1.0, EPS, **kw)
    if token == "packedj":
        assert torch.equal(ta, a0)
    else:
        assert ((ta - a0).abs().sum() / a0.abs().sum()).item() < 1e-6


# ------------------------------------------------------------------ errors


@pytest.mark.parametrize("tree,token", [("octree", "forceover0"), ("octree", "farcompactt"),
                                        ("bvh", "farcompact"), ("bvh", "desc2")])
def test_unported_tokens_raise(tree, token):
    """A token that nbody_tpu's fast path of the tree reads nowhere raises;
    none is ignored (tests/test_torch_knobs_*.py run every token it
    reads). forceover0 is the BVH's regression knob, farcompact and desc2
    the octree's; farcompactt is misspelt."""
    m, x = _clustered(300, 2, 3)
    depth = tot.max_depth(300, 2)
    ms, xs, ks, _ = tot.morton_sort(_t(m), _t(x), *tot.robust_quant_box(_t(x)), depth)
    with pytest.raises(ValueError, match="read by no nbody_tpu fast path"):
        if tree == "octree":
            tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS,
                                           ablate=f"packedj,{token}")
        else:
            tbg.compute_force_grouped_windowed(tbvh.build_tree(ms, xs, EPS), ms, xs, 0.5, 1.0,
                                               EPS, ablate=f"packedj,{token}")


# --------------------------------------------------------------- the probe

OCT_KEYS = {"entries", "fallback_tiles", "open_cells", "near_width_sum", "near_unique_blocks",
            "window_span_sum", "window_capacity"}
BVH_KEYS = {"entries", "fallback_tiles", "res_width_sum", "res_pairs", "res_unique_blocks"}


def test_probe_knobs_on_the_cpu(tmp_path):
    """python -m nbody_torch.probe knobs with the scripts' SPEC strings
    (dot-joined tokens, none, the BVH's optional dim, an evolved case):
    one JSON line per SPEC with the scripts' keys and descend_*."""
    out = tmp_path / "knobs.jsonl"
    oct_specs = ["512,2048,2,none,2,0", "256,1024,2,desc2.packedj,3,0",
                 "512,2048,2,farcompact,2,0", "512,1024,4,densemask,3,0"]
    bvh_specs = ["512,512,2,densemask,0", "256,256,2,packedj.sortunperm,1,2"]
    assert probe.main(["knobs", "oct", str(out), *oct_specs, "--n", "2048", "--device",
                       "cpu"]) == 0
    assert probe.main(["knobs", "bvh", str(out), *bvh_specs, "--n", "2048", "--device",
                       "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["spec"] for r in rows] == oct_specs + bvh_specs
    for r in rows:
        assert r["n"] == 2048 and r["sec"] > 0 and r["device"] == "cpu" and r["launches"] == {}
        if r["probe"] == "octknobs":
            assert OCT_KEYS <= set(r) and "descend_entries_raw" in r
        else:
            assert r["probe"] == "bvhknobs" and BVH_KEYS <= set(r) and "res_pass_0" in r
        assert r["entries"] > 0
    assert rows[1]["descend_open_2"] >= 0 and "descend_mono_2" in rows[1]


@pytest.mark.parametrize("argv", [["oct", "512,2048,2,none,2"], ["bvh", "512,512,2,none"],
                                  ["oct", "512,2048,2,forceover0,2,0"]])
def test_probe_knobs_rejects_bad_specs(argv, tmp_path):
    """A malformed SPEC or a token the tree reads nowhere ends the run with
    an error."""
    with pytest.raises(ValueError):
        probe.main(["knobs", argv[0], str(tmp_path / "o.jsonl"), argv[1], "--n", "1024",
                    "--device", "cpu"])
    assert not (tmp_path / "o.jsonl").exists()


def test_probe_knobs_runs_on_the_card_by_default(tmp_path, capsys):
    """Without --device the probe takes the GPU; without one it exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is taken")
    with pytest.raises(SystemExit) as e:
        probe.main(["knobs", "oct", str(tmp_path / "o.jsonl"), "512,2048,2,none,2,0"])
    assert e.value.code == 1 and "--device cpu" in capsys.readouterr().err
