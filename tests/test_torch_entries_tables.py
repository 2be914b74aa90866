"""The table-driven entries (entries_tables_eval_cuda and its twin, row 12
of PERF.md's kernel table) against nbody_tpu's entries_tables_eval_pallas
in interpret mode, on the CPU, where the wrapper runs its twin.

The same numpy-made inputs go through both packages. Tolerances, as in
tests/test_torch_ablate.py: the twin within 1e-5 and the Pallas function
within 1e-4 of each row's float64 sum of |term| of a float64 evaluation
of the same pairs (its interpret-mode reciprocal is ~1e-5 off by itself).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_group_eval as tge
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _case(dim, seed, ntiles=5, tb=128, S=256, nblocks=6):
    """Rows, sources, the tables (a permuted block per row, one lo == hi
    row, one hi past S, the pad row nblocks) and 30 tile-sorted entries
    over tiles 0, 1, 3 (2 and 4 get none), pad entries among them."""
    rng = np.random.default_rng(seed)
    n = nblocks * S
    mj = rng.uniform(0.1, 1.0, n).astype(np.float32)
    xj = rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tb, dim)).astype(np.float32)
    xi[5:9] = xj[:4]  # coincident pairs: m / eps^3 (sqrt3) or m / eps (poly) terms
    lo = rng.integers(0, S // 2, nblocks)
    hi = lo + rng.integers(S // 4, S, nblocks)
    lo[1], hi[1] = 70, 70
    hi[4] = S + 200  # the lane mask stops at S
    blk = np.r_[rng.permutation(nblocks), 0].astype(np.int32)
    lohi = np.r_[lo | (hi << 16), 0].astype(np.int32)
    tid = np.repeat([0, 1, 3], [12, 9, 9])
    ents = ((tid << 16) | rng.integers(0, nblocks + 1, tid.size)).astype(np.int32)
    return xi, mj, xj, ents, blk, lohi, tb, S


def _f64_sums(xi, mj, xj, ents, blk, lohi, tb, S, softening):
    """float64 sum over the given entries of m_j (x_j - x_i) / t per row,
    and its scale sum |term|; each entry counts its bodies once."""
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for e in ents:
        t, g = int(e) >> 16, int(e) & 0xFFFF
        lo, hi = int(lohi[g]) & 0xFFFF, min(int(lohi[g]) >> 16, S)
        cols = blk[g] * S + np.arange(lo, max(lo, hi))
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[cols][None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        r = np.sqrt(d2)
        den = (r + EPS) ** 3 if softening == "sqrt3" else d2 * r + EPS
        w = mj[cols][None, :] / den
        force[rows] += np.einsum("kn,knd->kd", w, d)
        scale[rows] += np.einsum("kn,knd->kd", w, np.abs(d))
    return force, scale


def _assert_twin_and_pallas(got, pallas, sums):
    exact, scale = sums
    for arr, tol in ((got, TOL), (pallas, 10 * TOL)):
        arr = np.asarray(arr, np.float64)
        assert arr.shape == exact.shape and np.all(np.isfinite(arr))
        err = np.abs(arr - exact)
        assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))


def _pallas(xi, mj, xj, ents, blk, lohi, tb, S, softening, n_real=None):
    return jpg.entries_tables_eval_pallas(
        jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T), jnp.asarray(ents), jnp.asarray(blk),
        jnp.asarray(lohi), EPS, S=S, tb=tb, interpret=True, softening=softening,
        n_real=None if n_real is None else jnp.asarray(n_real, jnp.int32))


@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_entries_tables_twin_vs_pallas_one_chunk(dim, softening):
    """A 1-D entry list: empty tiles, pad entries, a lo == hi row and hi
    past S; n_real is not read for one chunk, in either package."""
    xi, mj, xj, ents, blk, lohi, tb, S = _case(dim, seed=400 + dim)
    ref = _pallas(xi, mj, xj, ents, blk, lohi, tb, S, softening, n_real=3)
    got = tge.entries_tables_eval_cuda(_t(xi), _t(mj), _t(xj), _t(ents), _t(blk), _t(lohi), EPS,
                                       S, tb, softening, n_real=torch.tensor(3))
    _assert_twin_and_pallas(got, ref, _f64_sums(xi, mj, xj, ents, blk, lohi, tb, S, softening))
    assert not got.view(5, tb, dim)[[2, 4]].any()


@pytest.mark.parametrize("n_real", [None, 0, 11, 14])
@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_entries_tables_twin_vs_pallas_chunks(dim, softening, n_real):
    """(3, 10) chunks. n_real 11 and 14 fall in chunk 1: chunks 0 and 1 run
    whole, the entries of chunk 1 past n_real included (they count), and
    chunk 2 does not; n_real 0 runs chunk 0 only, None every chunk."""
    xi, mj, xj, ents, blk, lohi, tb, S = _case(dim, seed=410 + dim)
    chunks = ents.reshape(3, 10)
    ref = _pallas(xi, mj, xj, chunks, blk, lohi, tb, S, softening, n_real)
    got = tge.entries_tables_eval_cuda(_t(xi), _t(mj), _t(xj), _t(chunks), _t(blk), _t(lohi),
                                       EPS, S, tb, softening,
                                       n_real=None if n_real is None else torch.tensor(n_real))
    live = {None: 30, 0: 10, 11: 20, 14: 20}[n_real]
    sums = _f64_sums(xi, mj, xj, ents[:live], blk, lohi, tb, S, softening)
    _assert_twin_and_pallas(got, ref, sums)
    if n_real in (11, 14):  # entries 14..19 lie past n_real in a live chunk and count
        assert np.any(_f64_sums(xi, mj, xj, ents[14:20], blk, lohi, tb, S, softening)[1])


@pytest.mark.parametrize("n_real,live", [(None, 40), (0, 10), (1, 10), (10, 10), (11, 20),
                                         (39, 40), (400, 40)])
def test_live_entries_are_whole_chunks(n_real, live):
    """Chunk 0 always runs; chunk c > 0 when c * E < n_real."""
    ents = torch.arange(40, dtype=torch.int32).view(4, 10)
    n_real = None if n_real is None else torch.tensor(n_real)
    flat, n = tge.live_entries(ents, n_real)
    assert flat.shape == (40,) and int(n) == live
    assert tge.live_entries(ents[0], n_real)[1] == 10  # one chunk: all of it


def test_entries_tables_twin_rejects_unsorted_tiles():
    """The kernel relies on tile-sorted live entries; the twin checks it,
    across chunks too, and ignores what lies past the live chunks."""
    xi, mj, xj, ents, blk, lohi, tb, S = _case(3, seed=420)
    args = (_t(xi), _t(mj), _t(xj))
    bad = ents.copy()
    bad[[0, -1]] = bad[[-1, 0]]
    with pytest.raises(ValueError, match="sorted by tile"):
        tge.entries_tables_eval_cuda(*args, _t(bad), _t(blk), _t(lohi), EPS, S, tb)
    tail = ents.copy()
    tail[25] = 0  # in chunk 2, which n_real = 5 leaves out
    tge.entries_tables_eval_cuda(*args, _t(tail.reshape(3, 10)), _t(blk), _t(lohi), EPS, S, tb,
                                 n_real=torch.tensor(5))
    with pytest.raises(ValueError, match="sorted by tile"):
        tge.entries_tables_eval_cuda(*args, _t(tail.reshape(3, 10)), _t(blk), _t(lohi), EPS, S,
                                     tb)


@pytest.mark.parametrize("what", ["tables", "table_dtype", "S", "softening", "tiles"])
def test_entries_tables_wrapper_rejects_bad_inputs(what):
    xi, mj, xj, ents, blk, lohi, tb, S = _case(2, seed=430)
    args = {"xi": _t(xi), "mj": _t(mj), "xj": _t(xj), "entries": _t(ents), "blk_tbl": _t(blk),
            "lohi_tbl": _t(lohi), "eps": EPS, "S": S, "tb": tb, "softening": "sqrt3"}
    args.update({"tables": {"lohi_tbl": _t(lohi[:-1])},
                 "table_dtype": {"blk_tbl": _t(blk).long()},
                 "S": {"S": 0}, "softening": {"softening": "plummer"},
                 "tiles": {"tb": 100}}[what])
    with pytest.raises((ValueError, TypeError)):
        tge.entries_tables_eval_cuda(**args)
