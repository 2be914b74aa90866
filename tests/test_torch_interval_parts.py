"""The octree's interval window split into parts, and the second pass that
adds them, on the CPU: interval_parts, the Python mirror of the split that
window_eval_interval_kernel computes in the kernel (csrc/group_eval.cu),
the twin evaluated part by part and against nbody_tpu, and the plain
versions of the sum pass on slices whose length is not a multiple of 4.

Tile t's interval is [a_t, b_t) = [max(lo[t], w0[t]*tb), min(hi[t],
(w0[t] + window_tiles)*tb, nj)), empty where b_t <= a_t. interval_parts
gives each tile tile_parts(b_t - a_t, P) parts: equal shares of it in
order. The twin evaluated over each part's range, the parts added in
float64, equals the whole twin within 1e-5 (float32) or 1e-12 (float64)
of each row's sum of |term| (the same terms summed in other groupings).
Against window_eval_interval_pallas in interpret mode the bounds of
tests/test_torch_octree.py hold, under both softenings: the twin within
1e-5 and the Pallas result within 1e-4 of each row's sum of |term| of a
float64 evaluation of the same pairs (interpret mode refines a reciprocal
of about 8 bits with one Newton step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_group_eval as tge
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
EPS = float(np.finfo(np.float32).eps)

# (ntiles, tb, window_tiles, nj, P): tiles of 512 as at 2^20, small tiles,
# bodies that end inside the last window, and a part count above any
# tile's interval
CASES = {
    "2^20-tiles": (6, 512, 4, 6 * 512, 4),
    "small-tiles": (8, 128, 4, 8 * 128, 3),
    "ragged-nj": (7, 96, 3, 7 * 96 - 45, 5),
    "parts-above-bodies": (5, 64, 2, 5 * 64, 1000),
}


def _case(name, seed=0):
    """Seeded (w0, lo, hi (T,) int32, tb, window_tiles, nj, P): intervals
    that start before their window and end past it (or past nj), tile 1's
    empty (lo == hi), tile 2's reversed (hi < lo), tile 3's the whole
    window."""
    ntiles, tb, wt, nj, P = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    w0 = rng.integers(0, ntiles - wt + 1, ntiles)
    lo = (w0 * tb + rng.integers(-tb, 2 * tb, ntiles)).clip(0)
    hi = lo + rng.integers(0, (wt + 1) * tb, ntiles)
    hi[1] = lo[1]
    hi[2] = lo[2] - 5
    lo[3], hi[3] = 0, ntiles * tb + 50
    return (*(torch.tensor(a, dtype=torch.int32) for a in (w0, lo, hi)), tb, wt, nj, P)


def _interval_bodies(w0, lo, hi, tb, wt, nj):
    """Each tile's interval, body by body."""
    return [[j for j in range(int(w0[t]) * tb, (int(w0[t]) + wt) * tb)
             if int(lo[t]) <= j < int(hi[t]) and j < nj] for t in range(w0.shape[0])]


@pytest.mark.parametrize("name", list(CASES))
def test_parts_partition_the_interval_in_order(name):
    w0, lo, hi, tb, wt, nj, P = _case(name)
    parts = tge.interval_parts(w0, lo, hi, tb, wt, nj, P)
    for t, bodies in enumerate(_interval_bodies(w0, lo, hi, tb, wt, nj)):
        assert [j for a, b in parts[t] for j in range(a, b)] == bodies
        assert len(parts[t]) == tge.tile_parts(len(bodies), P) <= P
        assert all(a < b for a, b in parts[t])
    assert parts[1] == [] and parts[2] == []


@pytest.mark.parametrize("name", list(CASES))
def test_parts_differ_by_at_most_one_body(name):
    w0, lo, hi, tb, wt, nj, P = _case(name)
    for tile in tge.interval_parts(w0, lo, hi, tb, wt, nj, P):
        sizes = [b - a for a, b in tile]
        assert not sizes or max(sizes) - min(sizes) <= 1


def test_interval_parts_edge_cases():
    """Cuts where the kernel cuts: at the window's start and end, at nj;
    no part for an empty or reversed interval; one part a 256 bodies
    begun, in equal shares."""
    i32 = dict(dtype=torch.int32)
    tb, wt = 100, 3  # windows of 300 bodies
    w0 = torch.tensor([1, 1, 1, 0, 2, 2], **i32)
    lo = torch.tensor([50, 120, 200, 0, 260, 400], **i32)
    hi = torch.tensor([1000, 150, 200, 40, 900, 300], **i32)
    nj = 480
    parts = tge.interval_parts(w0, lo, hi, tb, wt, nj, 8)
    assert parts[0] == [(100, 250), (250, 400)]  # cut at the window's start and end
    assert parts[1] == [(120, 150)]
    assert parts[2] == [] and parts[5] == []     # empty, reversed
    assert parts[3] == [(0, 40)]
    assert parts[4] == [(260, 480)]              # cut at nj
    assert tge.interval_parts(w0, lo, hi, tb, wt, nj, 1)[0] == [(100, 400)]
    a, b = tge.tile_intervals(w0, lo, hi, tb, wt, nj)
    assert a.tolist() == [100, 120, 200, 0, 260, 400] and b.tolist() == [400, 150, 200, 40, 480, 300]


def _bodies(n, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dtype),
            torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=dtype))


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["small-tiles", "ragged-nj", "2^20-tiles"])
def test_twin_by_parts_equals_the_whole_twin(name, dtype, dim, softening):
    """Each part's range evaluated through the twin (lo, hi set to it),
    the parts added in float64 in order, against the whole twin."""
    w0, lo, hi, tb, wt, nj, P = _case(name, seed=5)
    ntiles = w0.shape[0]
    mj, xj = _bodies(nj, dim, dtype, seed=7 + dim)
    _, xi = _bodies(ntiles * tb, dim, dtype, seed=8 + dim)
    eps = float(torch.finfo(dtype).eps)
    whole = tge.window_eval_interval_torch(xi, mj, xj, w0, lo, hi, eps, wt, softening)
    scale = tge.window_eval_interval_torch(xi, mj, xj, w0, lo, hi, eps, wt, softening,
                                           absolute=True)
    parts = tge.interval_parts(w0, lo, hi, tb, wt, nj, P)
    summed = torch.zeros(whole.shape, dtype=torch.float64)
    for p in range(max(len(tile) for tile in parts)):
        ranges = [tile[p] if p < len(tile) else (0, 0) for tile in parts]
        plo, phi = (torch.tensor(v, dtype=torch.int32) for v in zip(*ranges))
        summed += tge.window_eval_interval_torch(xi, mj, xj, w0, plo, phi, eps, wt,
                                                 softening).double()
    summed = summed.to(dtype)
    assert bool(((summed - whole).abs() <= TOL[dtype] * scale).all()), \
        ((summed - whole).abs() / scale.clamp_min(1e-300)).max().item()
    assert not whole[tb:3 * tb].any() and not summed[tb:3 * tb].any()


def _f64_sums(xi, mj, xj, w0, lo, hi, tb, wt, softening):
    """float64 force sum_j m_j (x_j - x_i) / t over each tile's interval,
    and its scale sum_j |term|, per row and component."""
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for t, cols in enumerate(_interval_bodies(w0, lo, hi, tb, wt, mj.shape[0])):
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[cols][None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        r = np.sqrt(d2)
        w = mj[cols][None, :] / ((r + EPS) ** 3 if softening == "sqrt3" else d2 * r + EPS)
        force[rows] = np.einsum("kn,knd->kd", w, d)
        scale[rows] = np.einsum("kn,knd->kd", w, np.abs(d))
    return force, scale


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_twin_equals_interval_pallas_interpret(dim, softening):
    """The twin against window_eval_interval_pallas(interpret=True,
    skip_outside=True) on the same seeded numpy inputs (the sources are the
    rows themselves, as the octree passes them, with padding bodies of
    mass 0), both held to the float64 sums; the wrapper on CPU tensors is
    the twin."""
    w0, lo, hi, tb, wt, _, _ = _case("small-tiles", seed=11)
    ntiles = w0.shape[0]
    rng = np.random.default_rng(40 + dim)
    xj = rng.uniform(-1.0, 1.0, (ntiles * tb, dim)).astype(np.float32)
    mj = rng.uniform(0.1, 1.0, ntiles * tb).astype(np.float32)
    mj[-37:] = 0
    ref = np.asarray(jpg.window_eval_interval_pallas(
        jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T), jnp.asarray(w0.numpy()),
        jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()), EPS, window_tiles=wt, interpret=True,
        softening=softening, skip_outside=True))
    args = (torch.tensor(xj), torch.tensor(mj), torch.tensor(xj), w0, lo, hi, EPS, wt, softening)
    got = tge.window_eval_interval_torch(*args)
    exact, scale = _f64_sums(xj, mj, xj, w0, lo, hi, tb, wt, softening)
    for arr, tol in ((got.numpy(), 1e-5), (ref, 1e-4)):
        arr = np.asarray(arr, np.float64)
        assert arr.shape == exact.shape and np.all(np.isfinite(arr))
        err = np.abs(arr - exact)
        assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))
    np.testing.assert_allclose(tge.window_eval_interval_torch(*args, absolute=True).numpy(),
                               scale, rtol=1e-5, atol=1e-30)
    assert not got[tb:3 * tb].any()
    assert torch.equal(tge.window_eval_interval_cuda(*args), got)


def test_wrapper_rejects_bad_inputs():
    w0, lo, hi, tb, wt, nj, _ = _case("small-tiles")
    mj, xj = _bodies(nj, 3, torch.float32, seed=1)
    _, xi = _bodies(w0.shape[0] * tb, 3, torch.float32, seed=2)
    with pytest.raises(ValueError, match="softening"):
        tge.window_eval_interval_cuda(xi, mj, xj, w0, lo, hi, EPS, wt, "cubic")
    with pytest.raises(ValueError, match="must be"):
        tge.window_eval_interval_cuda(xi, mj, xj, w0, lo[:-1], hi, EPS, wt, "sqrt3")
    with pytest.raises(TypeError, match="int32"):
        tge.window_eval_interval_cuda(xi, mj, xj, w0, lo.long(), hi, EPS, wt, "sqrt3")


# ------------------------------------------------ the second pass's plain versions


def _bits(a):
    return a.contiguous().view(torch.int32 if a.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [4, 8])
def test_parts_sum_at_ragged_slices(P, dtype):
    """tb * dim = 129 * 3, not a multiple of 4 (the kernel's one element a
    thread): parts_sum_torch (and the wrapper on CPU tensors) is each
    tile's first nparts[t] slices added in order, bit for bit, -0 kept
    where a tile has one part, zero without parts."""
    tb, dim = 129, 3
    rng = np.random.default_rng(65)
    nparts = torch.tensor([0, 1, P, 2, P - 1], dtype=torch.int32)
    parts = torch.tensor(rng.standard_normal((5 * P, tb, dim)), dtype=dtype)
    parts[P, :5] = -0.0
    got = tge.parts_sum_cuda(parts, nparts, P)
    assert torch.equal(_bits(got), _bits(tge.parts_sum_torch(parts, nparts, P)))
    assert got.shape == (5 * tb, dim) and not got[:tb].any()
    for t, n in enumerate(nparts.tolist()):
        if n:
            want = parts[t * P]
            for k in range(1, n):
                want = want + parts[t * P + k]
            assert torch.equal(_bits(got[t * tb:(t + 1) * tb]), _bits(want))
    assert torch.signbit(got[tb:tb + 5]).all()


def test_entries_sum_at_ragged_slices():
    """The entries plan's second pass at tb * dim = 129 * 3: tiles of 1, 11
    (more than the 8 parts a thread loads before adding) and 2 parts added
    in part order, bit for bit."""
    tb, dim = 129, 3
    rng = np.random.default_rng(66)
    parts = torch.tensor(rng.standard_normal((14, tb, dim)), dtype=torch.float32)
    start = torch.tensor([0, 1, 12, 14], dtype=torch.int32)
    got = tge.entries_sum_cuda(parts, start)
    assert torch.equal(_bits(got), _bits(tge.entries_sum_torch(parts, start)))
    for t, (a, b) in enumerate(zip(start[:-1].tolist(), start[1:].tolist())):
        want = parts[a]
        for k in range(a + 1, b):
            want = want + parts[k]
        assert torch.equal(_bits(got[t * tb:(t + 1) * tb]), _bits(want))
