"""The all-pairs variants' decision table (nbody_torch.ops.cuda_variant_decide)
on the CPU: its plain version against the exact per-tile-pair decision,
computed here in numpy as nbody_tpu's kernels decide (pallas_allpairs.py:96,
the fast variant's least d2 against far_thresh; pallas_allpairs_mxu.py:
106-133, the MXU kernel's quadratic form in the midpoint frame against
near_coef (max zi + max zj), and far-fast against far_thresh), and the
kernel's box tests (box_table_torch, their operation-for-operation mirror)
against both: wherever the boxes settle a tile pair, the exact pass must give
the same branch. The table must equal the exact decision bit for bit, so
every comparison here is exact; the table's row sums must equal the plain
twins' branch counts.

The layouts: uniform unsorted, uniform and clustered Hilbert-sorted, a
ragged n (JAX's padding at the origin in every minimum); two-tile layouts a
few ulps either side of each threshold (cuda_variant_decide.straddle_layouts,
which chip_smoke.py also runs through the kernel); and a hypothesis
property over random boxes whose threshold sits at the tile pair's own least
d2, a few ulps either way. The MXU box margin is needed: with none, the
boxes settle some of those tile pairs wrongly (checked below).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nbody_torch.ops import cuda_allpairs as ca
from nbody_torch.ops import cuda_allpairs_mxu as cm
from nbody_torch.ops import cuda_variant_decide as vd
from nbody_torch.ops.geometry import aabb_of_points
from nbody_torch.ops.hilbert import hilbert_sort_perm

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
NEAR_COEF = float(np.float32(1e5 * EPS))   # allpairs_accel_mxu's near_factor * eps
FAST_THRESH = ca.far_threshold(EPS)        # (eps / 1e-6)^(2/3)
MXU_FAST_THRESH = 1e-2                     # kernel_bench's far_thresh
TILE_I, TILE_J = 64, 128
F32 = np.float32


# -- the exact decision in numpy ------------------------------------------


def _sq(v):
    """(v0^2 + v1^2) + v2^2 over the last axis."""
    s = v[..., 0] * v[..., 0]
    for d in range(1, v.shape[-1]):
        s = s + v[..., d] * v[..., d]
    return s


def _tree_mean(t):
    """(tiles, T, dim) -> (tiles, dim): the tiles' means, a pairwise tree sum
    over the tile padded with zeros to a power of two, times 1 / T."""
    T = t.shape[1]
    P = 1 << (T - 1).bit_length()
    v = np.concatenate([t, np.zeros((t.shape[0], P - T, t.shape[2]), F32)], axis=1)
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0] * F32(1.0 / T)


def _tiles(x, npad, ti, tj):
    xp = np.zeros((npad, x.shape[1]), F32)
    xp[:len(x)] = x
    return xp.reshape(npad // ti, ti, -1), xp.reshape(npad // tj, tj, -1)


def _mxu_terms(xi, xj, ci, cj):
    """(min d2, max zi + max zj) of one tile pair: the quadratic form in the
    frame 0.5 (ci + cj), as pallas_allpairs_mxu.py:103-133 computes it."""
    c = F32(0.5) * (ci + cj)
    yi, yj = xi - c, xj - c
    zi, zj = _sq(yi), _sq(yj)
    d2 = zi[:, None] + zj[None, :]
    for d in range(xi.shape[1]):
        d2 = d2 + yi[:, None, d] * (F32(-2.0) * yj[None, :, d])
    return d2.min(), zi.max() + zj.max()


def _fast_min(xi, xj):
    """min d2 of one tile pair, dx = xj - xi, as pallas_allpairs.py:96."""
    return _sq(xj[None, :, :] - xi[:, None, :]).min()


def _exact(x, mode, npad, ti, tj, near_coef=0.0, thresh=0.0):
    """The (ni, nj) int8 branches, tile pair by tile pair."""
    xi_t, xj_t = _tiles(np.asarray(x, F32), npad, ti, tj)
    nc, th = F32(near_coef), F32(thresh)
    out = np.empty((len(xi_t), len(xj_t)), np.int8)
    if mode != "fast":
        mi, mj = _tree_mean(xi_t), _tree_mean(xj_t)
    for I in range(len(xi_t)):
        for J in range(len(xj_t)):
            if mode == "fast":
                out[I, J] = 1 if _fast_min(xi_t[I], xj_t[J]) > th else 0
                continue
            dmin, zsum = _mxu_terms(xi_t[I], xj_t[J], mi[I], mj[J])
            if dmin <= nc * zsum:
                out[I, J] = 0
            else:
                out[I, J] = 2 if mode == "mxu-fast" and dmin > th else 1
    return out


def _settled_agree(x, mode, npad, ti, tj, near_coef, thresh, table):
    """The box tests' settled tile pairs against the table: (agree, their count)."""
    boxes = vd.box_table_torch(vd.tile_stats_torch(x, npad, ti, tj, means=mode != "fast"),
                               npad // ti, npad // tj, mode, near_coef, thresh)
    settled = boxes >= 0
    return bool(torch.equal(boxes[settled], table[settled])), int(settled.sum())


# -- the layouts ------------------------------------------------------------


def _sorted(x):
    tx = torch.tensor(x)
    return x[hilbert_sort_perm(tx, *aabb_of_points(tx, EPS)).numpy()]


def _layout(name, dim):
    rng = np.random.default_rng(17 + dim)
    n = 700 if name == "ragged" else 768
    if name in ("clusters", "ragged"):
        centers = rng.uniform(-40, 40, (9, dim))
        x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(F32)
        return _sorted(x)
    x = rng.uniform(-1.0, 1.0, (n, dim)).astype(F32)
    return x if name == "unsorted" else _sorted(4 * x)


MODES = {"fast": FAST_THRESH, "mxu": 0.0, "mxu-fast": MXU_FAST_THRESH}


@pytest.mark.parametrize("layout", ["unsorted", "sorted", "clusters", "ragged"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_table_is_the_exact_decision(mode, dim, layout):
    """decide_torch == the numpy decision; the settled box tests agree with
    it; its row sums are the plain twin's counts."""
    x = _layout(layout, dim)
    n, thresh = len(x), MODES[mode]
    npad = (ca.fast_tiling(n, dim, TILE_I, TILE_J)[0] if mode == "fast"
            else cm.mxu_padding(n, TILE_I, TILE_J))
    table = vd.decide_torch(torch.tensor(x), mode, npad, TILE_I, TILE_J, NEAR_COEF, thresh)
    assert table.dtype == torch.int8 and table.shape == (npad // TILE_I, npad // TILE_J)
    np.testing.assert_array_equal(table.numpy(), _exact(x, mode, npad, TILE_I, TILE_J,
                                                        NEAR_COEF, thresh))
    agree, settled = _settled_agree(torch.tensor(x), mode, npad, TILE_I, TILE_J, NEAR_COEF,
                                    thresh, table)
    assert agree
    m = torch.ones(n)
    if mode == "fast":
        _, twin = ca.allpairs_fast_torch(m, torch.tensor(x), 1.0, EPS, tile_i=TILE_I,
                                         tile_j=TILE_J)
    else:
        _, twin = cm.allpairs_accel_mxu_torch(m, torch.tensor(x), 1.0, EPS, TILE_I, TILE_J,
                                              fast=mode == "mxu-fast", far_thresh=thresh)
    branches = 2 if mode == "fast" else 3
    assert vd.branch_counts(table, branches).tolist() == twin.tolist()
    if layout in ("clusters", "ragged"):  # the boxes settle most tile pairs, both branches occur
        assert settled > table.numel() // 4
        assert len(torch.unique(table)) >= 2


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", list(vd.STRADDLES))
def test_straddling_layouts(kind, dim):
    """Two tiles a few ulps either side of the threshold: the table is the
    exact decision, both branches occur, and no box test settles a pair the
    other way."""
    mode = "fast" if kind.startswith("fast") else kind
    thresh = MODES[mode]
    seen = set()
    for v, x in vd.straddle_layouts(kind, dim, NEAR_COEF, thresh):
        table = vd.decide_torch(x, mode, 128, 64, 64, NEAR_COEF, thresh)
        np.testing.assert_array_equal(table.numpy(),
                                      _exact(x.numpy(), mode, 128, 64, 64, NEAR_COEF, thresh))
        assert _settled_agree(x, mode, 128, 64, 64, NEAR_COEF, thresh, table)[0], v
        seen.add(int(table[0, 1]))
    assert len(seen) == 2, seen


def _knife_edge(seed, dim, which, k, jitter=True):
    """Two tiles of 32 bodies in random boxes (tile A around P, with one
    body far behind P, which raises max zi; tile B around R) and a
    threshold within k ulps of the tile pair's own least d2 (`which`: the
    near limit's coefficient, far_thresh of mxu-fast, or of fast).
    Returns (x, mode, near_coef, thresh)."""
    rng = np.random.default_rng(seed)
    T = 32
    R = rng.uniform(-4, 4, dim)
    u = rng.normal(size=dim)
    P = R + u / np.linalg.norm(u) * rng.uniform(0.1, 1.0)
    ext = rng.uniform(0, 0.05, 2) if jitter else np.zeros(2)
    a = P + rng.uniform(-1, 1, (T, dim)) * ext[0]
    a[-1] = P + (P - R) * rng.uniform(2, 20)
    b = R + rng.uniform(-1, 1, (T, dim)) * ext[1]
    x = np.concatenate([a, b]).astype(F32)
    xi_t, xj_t = _tiles(x, 2 * T, T, T)
    nudge = lambda v: np.nextafter(F32(v), F32(np.inf) if k > 0 else F32(-np.inf))  # noqa: E731

    def ulps(v):
        v = F32(v)
        for _ in range(abs(k)):
            v = nudge(v)
        return float(v)

    if which == "fast":
        return x, "fast", NEAR_COEF, ulps(_fast_min(xi_t[0], xj_t[1]))
    dmin, zsum = _mxu_terms(xi_t[0], xj_t[1], *(_tree_mean(t)[i] for t, i in ((xi_t, 0),
                                                                              (xj_t, 1))))
    if which == "near":
        return x, "mxu", ulps(dmin / zsum), 0.0
    return x, "mxu-fast", float(dmin / zsum) * 1e-3, ulps(dmin)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), dim=st.sampled_from([2, 3]),
       which=st.sampled_from(["near", "far-fast", "fast"]), k=st.integers(-3, 3))
def test_boxes_never_settle_a_branch_the_exact_pass_would_not(seed, dim, which, k):
    x, mode, nc, thresh = _knife_edge(seed, dim, which, k)
    table = vd.decide_torch(torch.tensor(x), mode, 64, 32, 32, nc, thresh)
    np.testing.assert_array_equal(table.numpy(), _exact(x, mode, 64, 32, 32, nc, thresh))
    assert _settled_agree(torch.tensor(x), mode, 64, 32, 32, nc, thresh, table)[0]


def test_the_mxu_box_margin_is_needed(monkeypatch):
    """With no margin the boxes settle some knife-edge tile pairs as not
    near where the rounded quadratic form makes them near; with it, none."""
    cases = [_knife_edge(seed, 3, "near", k, jitter=False) for seed in range(150)
             for k in (-1, 1)]

    def wrong():
        bad = 0
        for x, mode, nc, thresh in cases:
            table = vd.decide_torch(torch.tensor(x), mode, 64, 32, 32, nc, thresh)
            bad += not _settled_agree(torch.tensor(x), mode, 64, 32, 32, nc, thresh, table)[0]
        return bad

    assert wrong() == 0
    monkeypatch.setattr(vd, "MARGIN", 0.0)
    assert wrong() > 0


@pytest.mark.parametrize("tiles", [(64, 128), (64, 64), (96, 192), (128, 64)])
def test_tile_stats(tiles):
    """Boxes and tree means against numpy, JAX's padding at the origin, and
    the 16-body sub-tiles' boxes after the tiles; on dyadic positions
    (every sum exact) and power-of-two tiles (JAX's), the tree mean is
    np.mean: the sum times 1 / T, exact."""
    ti, tj = tiles
    rng = np.random.default_rng(5)
    x = rng.uniform(-3, 3, (500, 3)).astype(F32)
    npad = -(-500 // max(ti, tj)) * max(ti, tj)
    stats = vd.tile_stats_torch(torch.tensor(x), npad, ti, tj).numpy()
    ni, nj = npad // ti, npad // tj
    assert stats.shape == (ni + nj + npad // vd.SUB, 3, 3)
    xi_t, xj_t = _tiles(x, npad, ti, tj)
    subs = _tiles(x, npad, vd.SUB, vd.SUB)[0]
    for s, t, mean in ((stats[:ni], xi_t, True), (stats[ni:ni + nj], xj_t, True),
                       (stats[ni + nj:], subs, False)):
        np.testing.assert_array_equal(s[:, 0], t.min(1))
        np.testing.assert_array_equal(s[:, 1], t.max(1))
        np.testing.assert_array_equal(s[:, 2], _tree_mean(t) if mean else 0.0)
    dy = (np.round(x * 64) / 64).astype(F32)
    stats = vd.tile_stats_torch(torch.tensor(dy), npad, ti, tj).numpy()
    if ti & (ti - 1) == 0:
        np.testing.assert_array_equal(stats[:npad // ti, 2], _tiles(dy, npad, ti, tj)[0].mean(1))
    assert not vd.tile_stats_torch(torch.tensor(x), npad, ti, tj, means=False)[:, 2].any()


def test_decide_on_cpu_runs_the_plain_versions():
    """decide_cuda on CPU tensors: decide_torch's table, tile_stats_torch's
    statistics, no work counts and no launch counted; bad tiles raise."""
    vd.reset_launch_counts()
    x = torch.tensor(_layout("clusters", 3))
    table, stats, work = vd.decide_cuda(x, "mxu-fast", 768, TILE_I, TILE_J, NEAR_COEF,
                                        MXU_FAST_THRESH, work=True)
    assert work is None
    assert torch.equal(table, vd.decide_torch(x, "mxu-fast", 768, TILE_I, TILE_J, NEAR_COEF,
                                              MXU_FAST_THRESH))
    assert torch.equal(stats, vd.tile_stats_torch(x, 768, TILE_I, TILE_J))
    assert set(vd.launch_counts.values()) == {0}
    with pytest.raises(ValueError):
        vd.decide_cuda(x, "mxu", 800, 40, 160)  # tile_i not a multiple of 16
    with pytest.raises(ValueError):
        vd.decide_cuda(x, "slow", 768, TILE_I, TILE_J)


def test_branch_counts():
    table = torch.tensor([[0, 1, 2, 1], [2, 2, 0, 0]], dtype=torch.int8)
    assert vd.branch_counts(table, 3).tolist() == [[1, 2, 1], [2, 0, 2]]
    assert vd.branch_counts(table, 3).dtype == torch.int32
