"""The compaction of the dense-mask far field and the supertile-shared
monopoles, on the CPU: dense_ids, the Python mirror of what
masked_eval_kernel and group_shared_masked_kernel compute in the kernel
(csrc/group_eval.cu), and the two plain versions evaluated the way the
kernels walk their work.

Each tile's float weights (mask (T, W)) are turned, 32 at a time, into one
word by a ballot of w != 0 (node l in word l // 32, bit l % 32) and
compacted batch by batch, FAR_WORDS words a batch, into the ids of the
nonzero weights in node order. A NaN weight counts as nonzero; -0.0 does
not. dense_ids must equal (mask != 0).nonzero() in node order, batch by
batch. The kernels then stage each kept node as (x | 0, mask * m), the
product rounded once; the plain version evaluated over the ids,
ENTRY_CHUNK ids a stage, with those folded masses and unit weights, the
stages added in float64, must equal the whole plain version within 1e-5
(float32) or 1e-12 (float64) of each row's sum of |term| (the far field's
bound, tests/test_torch_far_dense.py): the same terms in other groupings,
the dropped ones exact zeros. Against masked_eval_pallas and
group_shared_masked_eval_pallas in interpret mode, with weights that are
not 0/1, see tests/test_torch_ablate.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_group_eval as tge
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
STAGE = tge.ENTRY_CHUNK  # ids a stage of the staged loop
SPAN = tge.FAR_WORDS * 32  # nodes a batch
WEIGHTS = (0.5, 3.0, 1.0, 0.25, -0.0)  # a kept weight; -0.0 is dropped

# (ntiles, W, density): W not a multiple of 32 or of 4, W above one batch
# (two and three batches), one node, and every weight drawn
MASK_CASES = {
    "w-1501": (5, 1501, 0.3),
    "w-above-a-batch": (3, 9001, 0.05),
    "w-three-batches": (2, 20001, 0.02),
    "w-1": (3, 1, 0.5),
    "all-drawn": (2, 700, 1.0),
}


def _weights(ntiles, w, density, dtype, seed):
    """A seeded (T, W) weight mask: drawn entries from WEIGHTS, the rest 0;
    tile 1 has no nonzero weight (-0.0 in a few places), tile 0 a weight
    on node 31 (bit 31 of word 0) and on the last node."""
    rng = np.random.default_rng(seed + w)
    drawn = rng.random((ntiles, w)) < density
    mask = np.where(drawn, rng.choice(WEIGHTS, (ntiles, w)), 0.0)
    mask[1] = 0.0
    mask[1, ::7] = -0.0
    mask[0, min(31, w - 1)] = 3.0
    mask[0, w - 1] = 0.5
    return torch.tensor(mask, dtype=dtype)


def _bodies(n, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dtype),
            torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=dtype))


def _assert_within(got, want, scale, dtype):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= TOL[dtype] * scale).all()), \
        (err / scale.clamp_min(torch.finfo(dtype).tiny)).max().item()


# ------------------------------------------------------------ dense_ids


def _assert_ids(batches, mask):
    """batches (dense_ids of mask): per tile, one batch a SPAN nodes begun,
    each the nonzero weights' ids inside its span, in node order."""
    ntiles, w = mask.shape
    assert len(batches) == ntiles
    for t, tile in enumerate(batches):
        assert len(tile) == -(-w // SPAN)
        for b, ids in enumerate(tile):
            span = mask[t, b * SPAN:(b + 1) * SPAN]
            assert ids.dtype == torch.int64
            assert torch.equal(ids, (span != 0).nonzero().flatten() + b * SPAN)
        assert torch.equal(torch.cat(tile), (mask[t] != 0).nonzero().flatten())


@pytest.mark.parametrize("name", list(MASK_CASES))
def test_dense_ids_are_the_nonzero_weights_in_node_order(name):
    mask = _weights(*MASK_CASES[name], torch.float32, seed=0)
    batches = tge.dense_ids(mask)
    _assert_ids(batches, mask)
    assert all(ids.numel() == 0 for ids in batches[1])  # only zeros and -0.0
    if mask.shape[1] > 31:
        assert 31 in batches[0][0].tolist()


def test_dense_ids_keep_nan_and_drop_negative_zero():
    """A NaN weight is kept (the Pallas sum carries it), -0.0 and +0.0 are
    dropped, any other float is kept; bits past node W - 1 do not exist."""
    w = 40
    mask = torch.zeros(2, w)
    mask[0, [0, 5, 31, 32, 39]] = torch.tensor([float("nan"), -0.0, 0.5, -3.0, float("inf")])
    mask[1, :] = -0.0
    ids = tge.dense_ids(mask)
    assert ids[0][0].tolist() == [0, 31, 32, 39]
    assert ids[1][0].tolist() == []
    _assert_ids(ids, mask)


def test_dense_ids_of_no_nodes():
    """W = 0: no batch, as the kernel's walk runs none and writes zeros."""
    assert tge.dense_ids(torch.zeros(3, 0)) == [[], [], []]


# ------------------------------------------------ the plain versions over the ids


def _over_ids(xi, mj, xj, mask, tb, eps, softening, lists=None):
    """The far field the way the kernels walk it: tile t's ids (dense_ids),
    ENTRY_CHUNK a stage, each stage through the plain version with the
    masses folded as mask[t, id] * m_id and unit weights, the stages added
    in float64 in order. lists: the supertile list of each tile (mj, xj
    then (nsuper, M) and (nsuper, M, dim)), None for one shared list."""
    out = torch.zeros(xi.shape, dtype=torch.float64)
    for t, tile in enumerate(tge.dense_ids(mask)):
        rows = slice(t * tb, (t + 1) * tb)
        m, x = (mj, xj) if lists is None else (mj[lists[t]], xj[lists[t]])
        order = torch.cat(tile) if tile else torch.zeros(0, dtype=torch.int64)
        for s0 in range(0, order.numel(), STAGE):
            stage = order[s0:s0 + STAGE]
            folded = mask[t, stage] * m[stage]  # (mask * m), rounded once
            ones = torch.ones(1, stage.numel(), dtype=xi.dtype)
            out[rows] += tge.masked_eval_torch(xi[rows], folded, x[stage].contiguous(), ones, eps,
                                               softening).double()
    return out.to(xi.dtype)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["w-1501", "w-three-batches", "w-1", "all-drawn"])
def test_masked_eval_over_ids_equals_the_whole_plain_version(name, dtype, dim, softening):
    mask = _weights(*MASK_CASES[name], dtype, seed=3)
    ntiles, w = mask.shape
    tb = 64
    mj, xj = _bodies(w, dim, dtype, seed=7 + dim)
    mj[::13] = 0  # dead nodes: a nonzero weight on them adds a zero term
    _, xi = _bodies(ntiles * tb, dim, dtype, seed=8 + dim)
    xi[3] = xj[w - 1]  # a row on a kept node: d2 = 0, a zero term
    eps = float(torch.finfo(dtype).eps)
    whole = tge.masked_eval_torch(xi, mj, xj, mask, eps, softening)
    scale = tge.masked_eval_torch(xi, mj, xj, mask, eps, softening, absolute=True)
    got = _over_ids(xi, mj, xj, mask, tb, eps, softening)
    _assert_within(got, whole, scale, dtype)
    assert not whole[tb:2 * tb].any() and not got[tb:2 * tb].any()
    assert torch.equal(tge.masked_eval_cuda(xi, mj, xj, mask.contiguous(), eps, softening), whole)


# (ntiles, tb, M, G): G = 8 over 11 tiles (not a multiple of G) with tb =
# 1,024 (two row blocks of 512 on the card), M above a batch, and G = 3
SHARED_CASES = {
    "g8-two-row-blocks": (11, 1024, 1100, 8),
    "g8-above-a-batch": (11, 32, 9001, 8),
    "g3-ragged": (7, 96, 333, 3),
}


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(SHARED_CASES))
def test_shared_masked_over_ids_equals_the_whole_plain_version(name, dtype, dim, softening):
    """Tile t against list t // G over its own weight row's ids; each list's
    tail padded with mass 0; tile 1 without a nonzero weight gets zeros."""
    ntiles, tb, width, G = SHARED_CASES[name]
    nsuper = -(-ntiles // G)
    mask = _weights(ntiles, width, 0.3, dtype, seed=11)
    mj, xj = _bodies(nsuper * width, dim, dtype, seed=12 + dim)
    mj, xj = mj.view(nsuper, width), xj.view(nsuper, width, dim)
    mj[:, -min(70, width // 4):] = 0
    _, xi = _bodies(ntiles * tb, dim, dtype, seed=13 + dim)
    xi[2] = xj[0, 0]  # a row on a list entry
    eps = float(torch.finfo(dtype).eps)
    args = (xi, mj, xj, mask, eps, G, softening)
    whole = tge.group_shared_masked_eval_torch(*args)
    scale = tge.group_shared_masked_eval_torch(*args, absolute=True)
    got = _over_ids(xi, mj, xj, mask, tb, eps, softening, lists=torch.arange(ntiles) // G)
    _assert_within(got, whole, scale, dtype)
    assert not whole[tb:2 * tb].any() and not got[tb:2 * tb].any()
    assert torch.equal(tge.group_shared_masked_eval_cuda(*args), whole)


# ------------------------------------------------ a NaN weight, as nbody_tpu carries it


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
def test_nan_weight_reaches_its_tile_alone(softening):
    """A NaN weight is kept by the compaction and makes its tile's rows NaN,
    in the plain version as in masked_eval_pallas (interpret mode); the
    other tiles stay finite and agree."""
    ntiles, tb, w, dim = 3, 128, 300, 3
    mj, xj = _bodies(w, dim, torch.float32, seed=21)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, seed=22)
    mask = _weights(ntiles, w, 0.4, torch.float32, seed=23)
    mask[2, 17] = float("nan")
    assert 17 in tge.dense_ids(mask)[2][0].tolist()
    got = tge.masked_eval_cuda(xi, mj, xj, mask, np.finfo(np.float32).eps, softening)
    ref = np.asarray(jpg.masked_eval_pallas(
        jnp.asarray(xi.numpy()), jnp.asarray(mj.numpy()), jnp.asarray(xj.numpy().T),
        jnp.asarray(mask.numpy()), float(np.finfo(np.float32).eps), interpret=True,
        softening=softening))
    assert bool(torch.isnan(got[2 * tb:]).all()) and np.isnan(ref[2 * tb:]).all()
    assert bool(torch.isfinite(got[:2 * tb]).all()) and np.isfinite(ref[:2 * tb]).all()
    assert not got[tb:2 * tb].any() and not ref[tb:2 * tb].any()
