"""The far field's compaction and the dense-mask window's split, on the CPU:
far_ids and dense_parts, the Python mirrors of what
masked_eval_bits_kernel and window_eval_dense_kernel compute in the
kernel (csrc/group_eval.cu), the twins evaluated the way the kernels walk
their work, and the dense twin against nbody_tpu under sqrt3.

The far field. Each tile's packed accept bits (node l in word l // 32, bit
l % 32, the words int32) are compacted batch by batch, FAR_WORDS words a
batch, into the accepted node ids in node order; the kernel then stages
only those nodes. far_ids must equal unpack_mask_bits(words, W).nonzero()
in node order, and the twin evaluated over its ids, stage by stage
(ENTRY_CHUNK ids a stage, the stages added in float64), must equal the
whole twin within 1e-5 (float32) or 1e-12 (float64) of each row's sum of
|term|: the same terms summed in other groupings.

The dense-mask window. Tile t's columns [w0[t]*tb, min(w0[t]*tb + wb, nj))
are cut into tile_parts equal shares; each part is staged ENTRY_CHUNK
bodies at a time with mask[t, c] * m_j as the mass, and a stage whose
weights are all zero is skipped. The twin evaluated part by part over
dense_parts with those stages dropped, the parts added in order, must
equal the whole twin within the same bounds. Against window_eval_pallas in
interpret mode the twin is held within 1e-5, and the Pallas result within
1e-4, of each row's sum of |term| of a float64 evaluation (the bounds of
tests/test_torch_bvh.py, whose dense test covers poly; this file adds
sqrt3; the far field's twins against masked_eval_bits_pallas are in
tests/test_torch_octree.py and tests/test_torch_bvh.py under both
softenings).
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
STAGE = tge.ENTRY_CHUNK  # bodies a stage of the staged loop


def _bodies(n, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dtype),
            torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=dtype))


def _assert_within(got, want, scale, dtype):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= TOL[dtype] * scale).all()), \
        (err / scale.clamp_min(torch.finfo(dtype).tiny)).max().item()


# ------------------------------------------------ the far field's compaction

# (ntiles, W, density): W a multiple of 32, W not one, W above one batch of
# FAR_WORDS words (8,192 nodes), one node, and every bit set
FAR_CASES = {
    "w-1024": (4, 1024, 0.3),
    "w-1500": (5, 1500, 0.2),
    "w-above-a-batch": (3, 9001, 0.05),
    "w-1": (3, 1, 0.5),
    "all-set": (2, 700, 1.0),
}


def _far_case(name, seed=0):
    """A seeded accept mask (T, W) bool: tile 1 accepts nothing, tile 0
    accepts node 31 (bit 31 of word 0, the int32 sign bit) and the last
    node."""
    ntiles, w, density = FAR_CASES[name]
    rng = np.random.default_rng(seed + w)
    mask = torch.tensor(rng.random((ntiles, w)) < density)
    if density < 1:
        mask[1] = False
    mask[0, min(31, w - 1)] = True
    mask[0, w - 1] = True
    return mask


@pytest.mark.parametrize("name", list(FAR_CASES))
def test_far_ids_are_the_set_bits_in_node_order(name):
    mask = _far_case(name)
    w = mask.shape[1]
    words = tge.pack_mask_bits(mask)
    batches = tge.far_ids(words, w)
    nbatches = -(-words.shape[1] // tge.FAR_WORDS)
    for t, tile in enumerate(batches):
        assert len(tile) == nbatches
        assert torch.equal(torch.cat(tile), mask[t].nonzero().flatten())
        for b, ids in enumerate(tile):  # a batch's ids lie in its words' nodes
            span = tge.FAR_WORDS * 32
            assert ids.numel() <= span and bool(((ids >= b * span) & (ids < (b + 1) * span)).all())
    if FAR_CASES[name][2] < 1:
        assert all(ids.numel() == 0 for ids in batches[1])


def test_far_ids_sign_bit_and_bits_past_w():
    """Bit 31 of an int32 word (its sign) is node 31; bits past node W - 1
    in the last word are not read, as the kernel masks them."""
    w = 40
    words = torch.tensor([[-1, 0x7FFFFFFF], [-(1 << 31), 0xFF]], dtype=torch.int32)
    ids = tge.far_ids(words, w)
    assert ids[0][0].tolist() == list(range(40))
    assert ids[1][0].tolist() == [31, 32, 33, 34, 35, 36, 37, 38, 39]
    with pytest.raises(ValueError, match="words"):
        tge.far_ids(words, 70)


def _far_over_ids(xi, mj, xj, ids, tb, eps, softening):
    """The far field the way the kernel walks it: each tile's compacted ids,
    ENTRY_CHUNK a stage, each stage through the twin (every bit set), the
    stages added in float64 in order."""
    out = torch.zeros(xi.shape, dtype=torch.float64)
    for t, tile in enumerate(ids):
        rows = slice(t * tb, (t + 1) * tb)
        order = torch.cat(tile)
        for s0 in range(0, order.numel(), STAGE):
            stage = order[s0:s0 + STAGE]
            words = tge.pack_mask_bits(torch.ones(1, stage.numel(), dtype=torch.bool))
            out[rows] += tge.masked_eval_bits_torch(xi[rows], mj[stage], xj[stage].contiguous(),
                                                    words, eps, softening).double()
    return out.to(xi.dtype)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["w-1500", "w-above-a-batch", "w-1", "all-set"])
def test_far_twin_over_ids_equals_the_whole_twin(name, dtype, dim, softening):
    mask = _far_case(name, seed=3)
    ntiles, w = mask.shape
    tb = 64
    mj, xj = _bodies(w, dim, dtype, seed=7 + dim)
    _, xi = _bodies(ntiles * tb, dim, dtype, seed=8 + dim)
    xi[3] = xj[w - 1]  # a row on an accepted node: d2 = 0, a zero term
    eps = float(torch.finfo(dtype).eps)
    words = tge.pack_mask_bits(mask)
    whole = tge.masked_eval_bits_torch(xi, mj, xj, words, eps, softening)
    scale = tge.masked_eval_bits_torch(xi, mj, xj, words, eps, softening, absolute=True)
    got = _far_over_ids(xi, mj, xj, tge.far_ids(words, w), tb, eps, softening)
    _assert_within(got, whole, scale, dtype)
    if FAR_CASES[name][2] < 1:
        assert not whole[tb:2 * tb].any() and not got[tb:2 * tb].any()
    assert torch.equal(tge.masked_eval_bits_cuda(xi, mj, xj, words, eps, softening), whole)


# ------------------------------------------------ the dense window's split

# (ntiles, tb, window_tiles, nj, real, P): a ragged nj, a part count above
# the columns, the n = 16 evaluation's shape (8 tiles of 512, a window of
# 8 tiles, 16 real bodies and mass-0 padding), and more parts than a tile's
# stages
DENSE_CASES = {
    "ragged-nj": (7, 96, 3, 7 * 96 - 45, None, 3),
    "parts-above-columns": (5, 64, 2, 5 * 64, None, 1000),
    "n16-padding": (8, 512, 8, 8 * 512, 16, 8),
    "small-tiles": (6, 128, 4, 6 * 128, None, 4),
}


def _dense_case(name, dtype, dim, seed=0):
    """Seeded rows, sources, w0 (T,) int32 and a float mask (T,
    window_tiles*tb) with zeros: tile 2's mask all zero, tile 0's zero on
    its second stage of columns."""
    ntiles, tb, wt, nj, real, P = DENSE_CASES[name]
    rng = np.random.default_rng(seed + nj)
    mj, xj = _bodies(nj, dim, dtype, seed=seed + 1)
    if real is not None:
        mj[real:] = 0  # padding bodies
    w0 = torch.tensor(rng.integers(0, ntiles - wt + 1, ntiles), dtype=torch.int32)
    weights = rng.random((ntiles, wt * tb)) * (rng.random((ntiles, wt * tb)) < 0.7)
    mask = torch.tensor(weights, dtype=dtype)
    mask[2] = 0
    mask[0, STAGE:2 * STAGE] = 0
    _, xi = _bodies(ntiles * tb, dim, dtype, seed=seed + 2)
    return xi, mj, xj, w0, mask.contiguous(), tb, wt, nj, P


def _columns(w0, tb, wb, nj):
    return [list(range(a, min(a + wb, nj))) for a in (w0.long() * tb).tolist()]


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_parts_partition_the_columns_in_order(name):
    _, _, _, w0, mask, tb, wt, nj, P = _dense_case(name, torch.float32, 3)
    parts = tge.dense_parts(w0, tb, wt * tb, nj, P)
    for t, cols in enumerate(_columns(w0, tb, wt * tb, nj)):
        assert [j for a, b in parts[t] for j in range(a, b)] == cols
        assert len(parts[t]) == tge.tile_parts(len(cols), P) <= P
        sizes = [b - a for a, b in parts[t]]
        assert all(s > 0 for s in sizes) and (not sizes or max(sizes) - min(sizes) <= 1)


def test_dense_parts_edge_cases():
    """Cuts at nj; no part for a window that starts at or past nj; one part
    a 256 columns begun, in equal shares."""
    w0 = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    parts = tge.dense_parts(w0, 100, 300, 350, 8)
    assert parts == [[(0, 150), (150, 300)], [(100, 350)], [(200, 350)], [(300, 350)]]
    assert tge.dense_parts(w0, 100, 300, 300, 8)[3] == []
    assert tge.dense_parts(w0, 100, 300, 350, 1)[0] == [(0, 300)]


def _live_stages(a, b, a0, weight, mj):
    """The stages [s, min(s + STAGE, b)) of a part [a, b) of bodies that
    the kernel runs: those with a nonzero weight weight[j - a0] * m_j (the
    tile's mask row, its columns from body a0)."""
    return [(s, min(s + STAGE, b)) for s in range(a, b, STAGE)
            if bool((weight[s - a0:min(s + STAGE, b) - a0] * mj[s:min(s + STAGE, b)] != 0).any())]


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_twin_by_parts_equals_the_whole_twin(name, dtype, dim, softening):
    """Each part's live stages evaluated through the twin (the mask kept on
    their columns alone), the parts added in order in float64, against the
    whole twin; the all-zero tile has no live stage and gets zeros."""
    xi, mj, xj, w0, mask, tb, wt, nj, P = _dense_case(name, dtype, dim, seed=5)
    eps = float(torch.finfo(dtype).eps)
    args = (xi, mj, xj, w0)
    whole = tge.window_eval_dense_torch(*args, mask, eps, wt, softening)
    scale = tge.window_eval_dense_torch(*args, mask, eps, wt, softening, absolute=True)
    parts = tge.dense_parts(w0, tb, wt * tb, nj, P)
    a0 = (w0.long() * tb).tolist()
    live = [[_live_stages(a, b, a0[t], mask[t], mj) for a, b in tile]
            for t, tile in enumerate(parts)]
    summed = torch.zeros(whole.shape, dtype=torch.float64)
    for p in range(max(len(tile) for tile in parts)):
        keep = torch.zeros_like(mask)
        for t, tile in enumerate(live):
            for s, e in tile[p] if p < len(tile) else []:
                keep[t, s - a0[t]:e - a0[t]] = mask[t, s - a0[t]:e - a0[t]]
        summed += tge.window_eval_dense_torch(*args, keep, eps, wt, softening).double()
    got = summed.to(dtype)
    _assert_within(got, whole, scale, dtype)
    assert not whole[2 * tb:3 * tb].any() and not got[2 * tb:3 * tb].any()
    assert parts[2] and not any(live[2])
    if DENSE_CASES[name][4] is not None:  # padding: only the stage of the real bodies
        assert all(sum(map(len, tile)) <= 1 for tile in live)
    assert torch.equal(tge.window_eval_dense_cuda(*args, mask, eps, wt, softening, parts=P),
                       whole)


def _f64_sums(xj, mj, w0, weight, tb, wt, softening):
    """float64 force sum_c w_tc m_j (x_j - x_i) / t over the window columns
    c (j = w0[t]*tb + c < nj), and its scale sum |term|, per row and
    component; the rows are the sources."""
    xj, mj, weight = (np.asarray(a, np.float64) for a in (xj, mj, weight))
    force, scale = np.zeros_like(xj), np.zeros_like(xj)
    for t in range(w0.shape[0]):
        cols = w0[t] * tb + np.arange(wt * tb)
        inside = cols < mj.shape[0]
        cols, wgt = cols[inside], weight[t][inside]
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[cols][None, :, :] - xj[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        r = np.sqrt(d2)
        t3 = (r + EPS) ** 3 if softening == "sqrt3" else d2 * r + EPS
        w = (wgt * mj[cols])[None, :] / t3
        force[rows] = np.einsum("kn,knd->kd", w, d)
        scale[rows] = np.einsum("kn,knd->kd", np.abs(w), np.abs(d))
    return force, scale


@pytest.mark.parametrize("dim", [2, 3])
def test_dense_twin_vs_window_eval_pallas_sqrt3(dim):
    """window_eval_pallas(interpret=True, softening="sqrt3"), the octree's
    densemask window, on seeded numpy inputs: weights with zeros, a tile of
    all-zero weights, padding bodies of mass 0; the twin and the wrapper on
    CPU tensors within 1e-5, the Pallas result within 1e-4, of the float64
    sums' sum |term|."""
    ntiles, tb, wt = 6, 128, 2
    rng = np.random.default_rng(70 + dim)
    xj = rng.uniform(-1.0, 1.0, (ntiles * tb, dim)).astype(np.float32)
    mj = rng.uniform(0.1, 1.0, ntiles * tb).astype(np.float32)
    mj[-29:] = 0
    w0 = rng.integers(0, ntiles - wt + 1, ntiles).astype(np.int32)
    mask = rng.random((ntiles, wt * tb)) * (rng.random((ntiles, wt * tb)) < 0.6)
    mask = mask.astype(np.float32)
    mask[4] = 0
    ref = np.asarray(jpg.window_eval_pallas(jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T),
                                            jnp.asarray(mask), jnp.asarray(w0), EPS,
                                            window_tiles=wt, interpret=True, softening="sqrt3"))
    args = (torch.tensor(xj), torch.tensor(mj), torch.tensor(xj), torch.tensor(w0),
            torch.tensor(mask), EPS, wt, "sqrt3")
    got = tge.window_eval_dense_torch(*args)
    exact, scale = _f64_sums(xj, mj, w0, mask, tb, wt, "sqrt3")
    for arr, tol in ((got.numpy(), 1e-5), (ref, 1e-4)):
        arr = np.asarray(arr, np.float64)
        assert arr.shape == exact.shape and np.all(np.isfinite(arr))
        err = np.abs(arr - exact)
        assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))
    np.testing.assert_allclose(tge.window_eval_dense_torch(*args, absolute=True).numpy(), scale,
                               rtol=1e-5, atol=1e-30)
    assert not got[4 * tb:5 * tb].any()
    assert torch.equal(tge.window_eval_dense_cuda(*args), got)


def test_dense_wrapper_rejects_bad_inputs():
    xi, mj, xj, w0, mask, tb, wt, nj, _ = _dense_case("small-tiles", torch.float32, 3)
    with pytest.raises(ValueError, match="softening"):
        tge.window_eval_dense_cuda(xi, mj, xj, w0, mask, EPS, wt, "cubic")
    with pytest.raises(ValueError, match="bodies wide"):
        tge.window_eval_dense_cuda(xi, mj, xj, w0, mask, EPS, wt + 1, "poly")
    with pytest.raises(ValueError, match="mask"):
        tge.window_eval_dense_cuda(xi, mj, xj, w0, mask.double(), EPS, wt, "poly")
    with pytest.raises(TypeError, match="int32"):
        tge.window_eval_dense_cuda(xi, mj, xj, w0.long(), mask, EPS, wt, "poly")
