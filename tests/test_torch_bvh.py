"""The BVH fast path of nbody_torch against nbody_tpu, on the CPU.

The same numpy-made inputs go through both packages. Exact where
nbody_tpu is exact: the box, the quantized cells, the Hilbert keys, the
sort order, the refit's masses and widths (its centres within 4 ulps, see
test_build_tree_bit_equal), and every integer counter of the grouped
force. The Pallas functions run in interpret mode,
as nbody_tpu's own tests run them.

Forces. The whole fast path is held within 1e-5 of sum |a| of nbody_tpu's
result (the bound of tests/test_trees.py:1008); each kernel call it makes
is held, through its plain twin, within 1e-5 of each row's sum of |term|
of the same call evaluated in float64; and each twin is held against its
Pallas kernel within 1e-4 of that sum (the interpret-mode reciprocal is
about 1e-5 off by itself; see tests/test_torch_octree.py). At theta = 0
the port's BVH equals the poly direct sum within 1e-5 of each row's sum
of |term|.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import cuda_allpairs as tca
from nbody_torch.ops import cuda_group_eval as tge
from nbody_torch.ops import geometry as tgeo
from nbody_torch.ops import hilbert as th
from nbody_torch.ops.permutation import sort_rows_by_key
from nbody_torch.state import SystemState
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import hilbert as jh
from nbody_tpu.ops import pallas_group_eval as jpg
from nbody_tpu.ops.permutation import sort_arrays_by_u32pair
from nbody_tpu.state import SystemState as JState

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5


def _clusters(n, dim, seed=11):
    """Nine Gaussian clusters (the workload tests/test_trees.py:968-973
    pins)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


def _t(a):
    return torch.tensor(np.asarray(a))


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _jax_sorted(m, x):
    """nbody_tpu's Hilbert sort of (m, x): the sorted arrays as numpy."""
    xmin, xmax = jgeo.aabb_of_points(jnp.asarray(x), EPS)
    cell = jh.quantize(jnp.asarray(x), xmin, xmax - xmin, x.shape[1])
    hi, lo = jh.hilbert_key_u32pair(cell, x.shape[1])
    return (np.asarray(a) for a in sort_arrays_by_u32pair(hi, lo, jnp.asarray(m), jnp.asarray(x)))


# ---------------------------------------------------- box, keys, sort, tree


@pytest.mark.parametrize("dim", [2, 3])
def test_aabb_and_quantize_bit_equal(dim):
    """The box of the bodies and the origin, and the cells, with bodies
    on the box's far corner, where float32 rounds to 2^32 in 2-D and XLA's
    convert saturates."""
    _, x = _clusters(3000, dim, seed=1)
    for xx in (x, np.abs(x) + 5, -np.abs(x) - 5):  # the box includes 0 either way
        jlo, jhi = jgeo.aabb_of_points(jnp.asarray(xx), EPS)
        tlo, thi = tgeo.aabb_of_points(_t(xx), EPS)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        jc = jh.quantize(jnp.asarray(xx), jlo, jhi - jlo, dim)
        tc = th.quantize(_t(xx), tlo, thi - tlo)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    lo = np.full(dim, -3.0, np.float32)
    length = np.full(dim, 7.0, np.float32)
    corner = np.stack([lo, lo + length, lo + length * np.float32(0.999999)]).astype(np.float32)
    jc = np.asarray(jh.quantize(jnp.asarray(corner), jnp.asarray(lo), jnp.asarray(length), dim))
    tc = th.quantize(_t(corner), _t(lo), _t(length)).numpy()
    np.testing.assert_array_equal(tc, jc.astype(np.int64))
    if dim == 2:
        assert tc[1, 0] == th.HILBERT_CELLS[2]  # 2^32 in float32, saturated


@pytest.mark.parametrize("true_curve", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_hilbert_keys_bit_equal(dim, true_curve):
    """Random and extreme cells (0 and 2^bits - 1) against
    hilbert_key_u32pair as hi << 32 | lo, and a sample against the
    scalar transcription of vec.h."""
    top = th.HILBERT_CELLS[dim]
    rng = np.random.default_rng(2 + dim)
    cell = rng.integers(0, top + 1, (4000, dim), dtype=np.int64)
    cell[:3] = [[0] * dim, [top] * dim, [top, 0, top][:dim]]
    jhi, jlo = jh.hilbert_key_u32pair(jnp.asarray(cell.astype(np.uint32)), dim,
                                      true_curve=true_curve)
    key = th.hilbert_keys(_t(cell), n_active=dim if true_curve else 2)
    assert key.dtype == torch.int64
    got = key.numpy().view(np.uint64)
    np.testing.assert_array_equal(got, _u64(jhi, jlo))
    for i in range(0, 4000, 97):
        assert int(got[i]) == jh.hilbert_key_scalar(cell[i].astype(np.uint32), dim,
                                                    true_curve=true_curve)
    if dim == 2:
        assert (got >= np.uint64(1 << 63)).any()  # keys with the top bit set


@pytest.mark.parametrize("dim", [2, 3])
def test_sort_order_bit_equal(dim):
    """A stable unsigned sort: duplicate keys keep their order, and 2-D
    keys with the top bit set sort after the others."""
    m, x = _clusters(3000, dim, seed=4)
    x[100:140] = x[7]  # duplicate keys
    x[200:260] = x[200:260] * -3 + 17  # spread, so that the keys span the top bit
    iota = np.arange(3000, dtype=np.int32)
    xmin, xmax = jgeo.aabb_of_points(jnp.asarray(x), EPS)
    hi, lo = jh.hilbert_key_u32pair(jh.quantize(jnp.asarray(x), xmin, xmax - xmin, dim), dim)
    jperm, jm, jx = sort_arrays_by_u32pair(hi, lo, jnp.asarray(iota), jnp.asarray(m),
                                           jnp.asarray(x))
    tmin, tmax = tgeo.aabb_of_points(_t(x), EPS)
    keys = th.hilbert_keys(th.quantize(_t(x), tmin, tmax - tmin))
    tperm, tm, tx = sort_rows_by_key(keys, _t(iota), _t(m), _t(x))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert (np.diff(tperm.numpy()[np.isin(tperm.numpy(), np.arange(100, 140))]) > 0).all()
    if dim == 2:
        u = keys.numpy().view(np.uint64)
        assert (u >= np.uint64(1 << 63)).any() and (u < np.uint64(1 << 63)).any()


# jitted, as bvh_step_force runs it (and 3-5x faster here than op by op)
_jax_build_tree = jax.jit(jb.build_tree, static_argnums=2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 17, 512, 513, 3000])
def test_build_tree_bit_equal(n, dtype):
    """mm and bw of the level-synchronous refit bit for bit, with a
    zero-mass body (a dead pair node) and the pow2 padding's dead nodes.
    XLA contracts ml*xl + mr*xr into a fused multiply-add, on one product
    or the other depending on the shape, which torch's separate multiplies
    cannot follow; so mx is held within 4 ulps of the largest |coordinate|
    (float32: 1 ulp measured up to 3000 bodies, 2 at 100,000)."""
    dim = 2 + n % 2
    m, x = _clusters(n, dim, seed=n)
    m, x = m.astype(dtype), x.astype(dtype)
    if n > 4:
        m[4:6] = 0
    jt = _jax_build_tree(jnp.asarray(m), jnp.asarray(x), EPS)
    tt = tb.build_tree(_t(m), _t(x), EPS)
    assert tt.nlevels == jt.nlevels
    for name in ("mm", "bw"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert tt.mx.dtype == torch.from_numpy(x).dtype
    ulp = np.spacing(np.abs(x).max())
    np.testing.assert_array_less(np.abs(tt.mx.numpy() - np.asarray(jt.mx)), 4 * ulp + 1e-300)


EPS64 = float(np.finfo(np.float64).eps)


@pytest.mark.parametrize("dim", [2, 3])
def test_float64_box_cells_keys_and_order_bit_equal(dim):
    """The list path's float64 inputs at float64's own epsilon: the box of
    the bodies and the origin, the cells (with bodies on the box's far
    corner), the Hilbert keys and the stable row order, bit for bit."""
    rng = np.random.default_rng(40 + dim)
    centers = rng.uniform(-40, 40, (9, dim))
    x = centers[rng.integers(0, 9, 3000)] + rng.normal(0, 1.2, (3000, dim))
    x[100:140] = x[7]  # duplicate keys keep their order
    x[200:260] = x[200:260] * -3 + 17
    m = rng.uniform(0.1, 1, 3000)
    jlo, jhi = jgeo.aabb_of_points(jnp.asarray(x), EPS64)
    tlo, thi = tgeo.aabb_of_points(_t(x), EPS64)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert tlo.dtype == torch.float64
    x[0], x[1] = np.asarray(jhi), np.asarray(jlo)  # the far and near corners
    jc = jh.quantize(jnp.asarray(x), jlo, jhi - jlo, dim)
    tc = th.quantize(_t(x), tlo, thi - tlo)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    assert tc[0].tolist() == [th.HILBERT_CELLS[dim]] * dim and tc[1].tolist() == [0] * dim
    jhi_k, jlo_k = jh.hilbert_key_u32pair(jc, dim)
    keys = th.hilbert_keys(tc)
    np.testing.assert_array_equal(keys.numpy().view(np.uint64), _u64(jhi_k, jlo_k))
    iota = np.arange(3000, dtype=np.int32)
    jperm, jm, jx = sort_arrays_by_u32pair(jhi_k, jlo_k, jnp.asarray(iota), jnp.asarray(m),
                                           jnp.asarray(x))
    tperm, tm, tx = sort_rows_by_key(keys, _t(iota), _t(m), _t(x))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("n", [3, 17, 513, 3000])
def test_build_tree_float64_eps_bit_equal(n):
    """The float64 refit at float64's own epsilon (the boxes' 10 eps
    tolerance): mm and bw bit for bit, mx within 4 ulps (see
    test_build_tree_bit_equal)."""
    dim = 2 + n % 2
    m, x = _clusters(n, dim, seed=50 + n)
    m, x = m.astype(np.float64), x.astype(np.float64) * (1 + 1e-9)
    if n > 4:
        m[4:6] = 0
    jt = _jax_build_tree(jnp.asarray(m), jnp.asarray(x), EPS64)
    tt = tb.build_tree(_t(m), _t(x), EPS64)
    assert tt.nlevels == jt.nlevels
    for name in ("mm", "bw"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    ulp = np.spacing(np.abs(x).max())
    np.testing.assert_array_less(np.abs(tt.mx.numpy() - np.asarray(jt.mx)), 4 * ulp + 1e-300)


def test_residual_ids_word_limit():
    """The word-compacted extraction's limit: with 16,384 residual nodes
    (512 words) a tile keeps the nodes of its first RW = 256 nonzero words
    and is flagged when it has more; checked against a numpy transcription
    of nbody_tpu's word path (bvh_group.py:823-842), which its own tests
    reach only through an ablation token. At the defaults it takes more
    than 2^22 bodies to have more than 8,192 nodes."""
    rng = np.random.default_rng(6)
    ntiles, nodes, r_slice = 5, 16384, 1024
    out_open = rng.random((ntiles, nodes)) < 0.002
    out_open[1, ::40] = True          # 410 nonzero words: flagged
    out_open[2] = False               # nothing open
    out_open[3, 32 * 300:32 * 300 + 5] = True
    words = out_open.reshape(ntiles, nodes // 32, 32)
    ow = (words.astype(np.int64) << np.arange(32)).sum(2)
    rw = 256
    sw = np.sort(np.where(ow != 0, np.arange(nodes // 32), 1 << 30), axis=1)[:, :rw]
    swc = np.minimum(sw, nodes // 32 - 1)
    wv = np.where(sw < 1 << 30, np.take_along_axis(ow, swc, axis=1), 0)
    bits = ((wv[:, :, None] >> np.arange(32)) & 1) > 0
    nkey = np.where(bits, swc[:, :, None] * 32 + np.arange(32), 1 << 30).reshape(ntiles, -1)
    want_ids = np.sort(nkey, axis=1)[:, :r_slice]
    want_over = (ow != 0).sum(1) > rw
    ids, over = tbg.residual_ids(_t(out_open), r_slice)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(over.numpy(), want_over)
    assert over.tolist() == [False, True, False, False, False]
    # no word limit below 256 words: the wide extraction
    ids, over = tbg.residual_ids(_t(out_open[:, :4096]), r_slice)
    wide = np.sort(np.where(out_open[:, :4096], np.arange(4096), 1 << 30), axis=1)[:, :r_slice]
    np.testing.assert_array_equal(ids.numpy(), wide)
    assert not over.any()


# ------------------------------------------------ kernel twins vs Pallas


def _f64_sums(xi, mj, xj, sel, tbr, weight=None):
    """float64 poly force sum_j w_j m_j (x_j - x_i) / t and its scale
    sum_j |term|, per row and component, over the bodies sel[t] (T, nj)
    bool of each row tile t; weight (T, nj) scales the masses."""
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for t in range(sel.shape[0]):
        cols = np.flatnonzero(sel[t])
        rows = slice(t * tbr, (t + 1) * tbr)
        d = xj[cols][None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        mm = mj[cols] if weight is None else mj[cols] * weight[t, cols]
        w = mm[None, :] / (d2 * np.sqrt(d2) + EPS)
        force[rows] = np.einsum("kn,knd->kd", w, d)
        scale[rows] = np.einsum("kn,knd->kd", np.abs(w), np.abs(d))
    return force, scale


def _assert_close(got, ref, sums, pallas_tol=10 * TOL):
    """The twin within TOL and the Pallas result within pallas_tol of the
    float64 sums, per row and component, as a fraction of sum |term|."""
    exact, scale = sums
    for arr, tol in ((got, TOL), (ref, pallas_tol)):
        arr = np.asarray(arr, np.float64)
        assert arr.shape == exact.shape and np.all(np.isfinite(arr))
        err = np.abs(arr - exact)
        assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))


def _inputs(n, dim, seed):
    rng = np.random.default_rng(seed)
    return (rng, rng.uniform(0.1, 1.0, n).astype(np.float32),
            rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32))


def _window_sel(w0, open_cols, nj, tbr):
    """(T, nj) bool: tile t sees window column c (body w0[t]*tb + c) where
    open_cols[t, c]."""
    sel = np.zeros((w0.shape[0], nj), bool)
    for t in range(w0.shape[0]):
        cols = w0[t] * tbr + np.flatnonzero(open_cols[t])
        sel[t, cols[cols < nj]] = True
    return sel


@pytest.mark.parametrize("dim", [2, 3])
def test_nodemask_twin_vs_window_eval_nodemask_pallas(dim):
    """Random per-slot openness over 16-body slots, a tile with every slot
    closed (which skip_outside skips) and padding bodies."""
    ntiles, tbr, wt, S = 8, 128, 4, 16
    rng, mj, xj = _inputs(ntiles * tbr, dim, seed=20 + dim)
    mj[-37:] = 0  # padding bodies
    w0 = rng.integers(0, ntiles - wt + 1, ntiles).astype(np.int32)
    in_win = rng.random((ntiles, wt * tbr // S)) < 0.4
    in_win[3] = False
    ref = jpg.window_eval_nodemask_pallas(jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T),
                                          jnp.asarray(in_win), jnp.asarray(w0), EPS,
                                          window_tiles=wt, S=S, interpret=True,
                                          softening="poly", skip_outside=True)
    args = (_t(xj), _t(mj), _t(xj), _t(w0), _t(in_win), EPS, wt, S, "poly")
    got = tge.window_eval_nodemask_cuda(*args)
    sums = _f64_sums(xj, mj, xj, _window_sel(w0, np.repeat(in_win, S, axis=1), ntiles * tbr, tbr),
                     tbr)
    _assert_close(got, ref, sums)
    np.testing.assert_allclose(tge.window_eval_nodemask_torch(*args, absolute=True).numpy(),
                               sums[1], rtol=1e-5, atol=1e-30)
    assert not got[3 * tbr:4 * tbr].any()


@pytest.mark.parametrize("dim", [2, 3])
def test_dense_twin_vs_window_eval_pallas(dim):
    """A dense float weight per (tile, window column), zeros included."""
    ntiles, tbr, wt = 6, 128, 2
    rng, mj, xj = _inputs(ntiles * tbr, dim, seed=25 + dim)
    w0 = rng.integers(0, ntiles - wt + 1, ntiles).astype(np.int32)
    mask = (rng.random((ntiles, wt * tbr)) * (rng.random((ntiles, wt * tbr)) < 0.7)).astype(np.float32)
    ref = jpg.window_eval_pallas(jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T),
                                 jnp.asarray(mask), jnp.asarray(w0), EPS, window_tiles=wt,
                                 interpret=True, softening="poly")
    got = tge.window_eval_dense_cuda(_t(xj), _t(mj), _t(xj), _t(w0), _t(mask), EPS, wt,
                                    "poly")
    weight = np.zeros((ntiles, ntiles * tbr), np.float32)
    for t in range(ntiles):
        weight[t, w0[t] * tbr:(w0[t] + wt) * tbr] = mask[t]
    sums = _f64_sums(xj, mj, xj, weight > 0, tbr, weight)
    _assert_close(got, ref, sums)


@pytest.mark.parametrize("dim", [2, 3])
def test_poly_far_and_entries_twins_vs_pallas(dim):
    """masked_eval_bits and entries_lohi with the BVH's poly softening,
    through each package's own mask packing and entry list."""
    ntiles, tbr, w, S = 6, 128, 1500, 256
    rng, mj, xj = _inputs(w, dim, seed=30 + dim)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tbr, dim)).astype(np.float32)
    mask = rng.random((ntiles, w)) < 0.3
    mask[2] = False
    ref = jpg.masked_eval_bits_pallas(jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T),
                                      jpg.pack_mask_bits(jnp.asarray(mask)), EPS,
                                      interpret=True, softening="poly")
    words = tge.pack_mask_bits(_t(mask))
    got = tge.masked_eval_bits_cuda(_t(xi), _t(mj), _t(xj), words, EPS, "poly")
    _assert_close(got, ref, _f64_sums(xi, mj, xj, mask, tbr))

    n = ntiles * tbr
    mj, xj = mj[:n], rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32)
    ents, lohis = [], []
    sel = np.zeros((ntiles, n), bool)
    for tile in (0, 2, 3, 5):  # tiles 1 and 4 have no entries
        ents.append(tile << 16)
        lohis.append(0)
        for blk in range(n // S):
            lo = int(rng.integers(0, S))
            hi = int(rng.integers(lo, S + 1))
            ents.append((tile << 16) | blk)
            lohis.append(lo | (hi << 16))
            sel[tile, blk * S + lo:blk * S + hi] = True
    n_real = len(ents)
    ents, lohis = np.array(ents + [(ntiles - 1) << 16] * 5, np.int32), np.array(lohis + [0] * 5,
                                                                                np.int32)
    ref = jpg.entries_lohi_eval_pallas(jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T),
                                       jnp.asarray(ents), jnp.asarray(lohis), EPS, S=S, tb=tbr,
                                       interpret=True, softening="poly",
                                       n_real=jnp.asarray(n_real, jnp.int32))
    got = tge.entries_lohi_eval_cuda(_t(xj), _t(mj), _t(xj), _t(ents), _t(lohis),
                                     torch.tensor(n_real), S, ntiles, EPS, "poly")
    _assert_close(got, ref, _f64_sums(xj, mj, xj, sel, tbr))
    assert not got[tbr:2 * tbr].any() and not got[4 * tbr:5 * tbr].any()


# ------------------------------------------------- the whole fast path

# (n, dim, compute_force_grouped_windowed kwargs): windows of 1 and 2
# tiles so that a system of a few thousand bodies leaves its window (the
# residual), an e_chunk of 1 that sends tiles to the exact fallback,
# n <= 16 on the dense-mask window, and 128-row tiles
CONFIGS = {
    "3000-2d-window1-fallback": (3000, 2, dict(window_tiles=1, e_chunk=1)),
    "5000-3d-window2": (5000, 3, dict(window_tiles=2)),
    "10-3d-dense": (10, 3, {}),
    "16-2d-dense": (16, 2, {}),
    "3000-3d-tile128": (3000, 3, dict(tile=128, window_tiles=2)),
}
KERNEL_WRAPPERS = {  # bvh_group's name -> the twin the CPU call runs
    "masked_eval_bits_cuda": tge.masked_eval_bits_torch,
    "window_eval_nodemask_cuda": tge.window_eval_nodemask_torch,
    "window_eval_dense_cuda": tge.window_eval_dense_torch,
    "entries_lohi_eval_cuda": tge.entries_lohi_eval_torch,
    "allpairs_block_cuda": tca.allpairs_block_torch,
}


@contextlib.contextmanager
def _recording():
    """Keep the args of each kernel-wrapper call compute_force_grouped_windowed makes."""
    calls = {}
    saved = {name: getattr(tbg, name) for name in KERNEL_WRAPPERS}

    def wrap(name, fn):
        def call(*args):
            calls[name] = args
            return fn(*args)
        return call

    for name, fn in saved.items():
        setattr(tbg, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(tbg, name, fn)


@pytest.fixture(scope="module")
def windowed_runs():
    """Both packages' compute_force_grouped_windowed on every
    configuration (JAX in interpret mode) on the same sorted bodies and
    tree, with the port's kernel calls; cached for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            n, dim, kw = CONFIGS[name]
            ms, xs = _jax_sorted(*_clusters(n, dim))
            tree = jb.build_tree(jnp.asarray(ms), jnp.asarray(xs), EPS)
            ja, jinfo = jbg.compute_force_grouped_windowed(tree, jnp.asarray(ms), jnp.asarray(xs),
                                                           0.5, 1.0, EPS, interpret=True, **kw)
            ttree = tb.build_tree(_t(ms), _t(xs), EPS)
            with _recording() as calls:
                ta, tinfo = tbg.compute_force_grouped_windowed(ttree, _t(ms), _t(xs), 0.5, 1.0,
                                                               EPS, **kw)
            cache[name] = (np.asarray(ja), {k: int(v) for k, v in jinfo.items()}, ta.numpy(),
                           {k: int(v) for k, v in tinfo.items()}, calls)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CONFIGS))
def test_windowed_vs_nbody_tpu(name, windowed_runs):
    """Every counter equal, forces within 1e-5 of sum |a| of nbody_tpu's."""
    ja, jinfo, ta, tinfo, _ = windowed_runs(name)
    assert ta.shape == ja.shape and ta.dtype == np.float32
    assert tinfo == jinfo
    assert tinfo["bad_entries"] == 0
    rel = np.abs(ta - ja).sum() / np.abs(ja).sum()
    assert rel < TOL, rel


@pytest.mark.parametrize("name", list(CONFIGS))
def test_windowed_kernel_calls_vs_float64(name, windowed_runs):
    """Each kernel call of the port's fast path, through its twin, within
    1e-5 of each row's sum of |term| of the same call in float64."""
    *_, calls = windowed_runs(name)
    for wrapper, args in calls.items():
        twin = KERNEL_WRAPPERS[wrapper]
        got = twin(*args)
        ref = twin(*(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                     for a in args))
        if wrapper == "allpairs_block_cuda":
            scale = tca.allpairs_block_abs_torch(*(a.double() for a in args[:3]), *args[3:])
        else:
            scale = twin(*(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
                           else a for a in args), absolute=True)
        err = (got.double() - ref).abs()
        assert bool((err <= TOL * scale).all()), (wrapper, (err / scale.clamp_min(1e-300)).max())


def test_windowed_configurations_reach_their_branches(windowed_runs):
    """The residual, the fallback and the two window kernels each run."""
    for name in CONFIGS:
        _, _, _, info, calls = windowed_runs(name)
        dense = name.split("-")[2] == "dense"
        assert ("window_eval_dense_cuda" in calls) == dense, name
        assert ("window_eval_nodemask_cuda" in calls) != dense, name
        assert ("allpairs_block_cuda" in calls) == (info["fallback_tiles"] > 0), name
        assert {"masked_eval_bits_cuda", "entries_lohi_eval_cuda"} <= set(calls)
    assert windowed_runs("3000-2d-window1-fallback")[3]["fallback_tiles"] > 0
    for name in ("5000-3d-window2", "3000-3d-tile128"):
        assert windowed_runs(name)[3]["res_pairs"] > 0
    # the far field's packed mask of a real run unpacks to itself
    words = windowed_runs("5000-3d-window2")[4]["masked_eval_bits_cuda"][3]
    w = windowed_runs("5000-3d-window2")[4]["masked_eval_bits_cuda"][1].shape[0]
    assert w == (1 << (w.bit_length())) - 1  # heap levels 0..L*
    assert torch.equal(tge.pack_mask_bits(tge.unpack_mask_bits(words, w)), words)


@pytest.mark.parametrize("dim", [2, 3])
def test_theta0_equals_poly_direct_sum(dim):
    """theta = 0 opens every node: with a 1-tile window the residual and
    the window must still give the poly direct sum, within 1e-5 of each
    row's sum of |term| (float64 reference and scale)."""
    m, x = _clusters(3000, dim, seed=14)
    state = SystemState.from_numpy(m, x, np.zeros_like(x), device=torch.device("cpu"))
    for window_tiles in (1, 32):
        out, _ = tb.bvh_step_force(state, 0.0, 1.0, EPS, window_tiles=window_tiles)
        x64, m64 = out.x.double(), out.m.double()
        ref = tca.allpairs_block_torch(x64, m64, x64, EPS)
        scale = tca.allpairs_block_abs_torch(x64, m64, x64, EPS)
        err = (out.a.double() - ref).abs()
        assert bool((err <= TOL * scale).all()), (err / scale).max().item()


@pytest.mark.parametrize("dim", [2, 3])
def test_bvh_step_force_vs_nbody_tpu(dim):
    """One step through both packages' bvh_step_force (JAX's windowed path
    in interpret mode): the same permuted state, bit for bit, the same
    root mass, forces within 1e-5 of sum |a|."""
    n = 2000
    m, x = _clusters(n, dim, seed=15)
    v = np.random.default_rng(16).normal(size=x.shape).astype(np.float32)
    js = JState(m=jnp.asarray(m), x=jnp.asarray(x), v=jnp.asarray(v), a=jnp.asarray(v * 0),
                ao=jnp.asarray(v * 2))
    jout, jtree, jaux = jb.bvh_step_force(js, 0.5, 1.0, EPS, traversal="group",
                                          use_pallas="interpret")
    ts = SystemState.from_numpy(m, x, v, v * 0, v * 2, device=torch.device("cpu"))
    tout, taux = tb.bvh_step_force(ts, 0.5, 1.0, EPS)
    for name in ("m", "x", "v", "ao"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)))
    assert not np.array_equal(tout.x.numpy(), x)  # the state was permuted
    assert np.float32(taux["root_mass"]) == np.float32(jaux["root_mass"]) == np.asarray(jtree.mm)[0]
    assert int(taux["overflow"]) == int(jaux["overflow"]) == 0
    ja = np.asarray(jout.a)
    assert np.abs(tout.a.numpy() - ja).sum() / np.abs(ja).sum() < TOL
