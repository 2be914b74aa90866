"""The hybrid all-pairs kernel's plain twin (nbody_torch.ops.cuda_allpairs_mxu,
reached through its CUDA wrapper on CPU tensors) against nbody_tpu's
allpairs_accel_mxu in interpret mode and against a float64 oracle.

The oracle bounds are tests/test_mxu_kernel.py's, on its inputs: per-row
error norm over (|a64| + 1e-3 max |a64|) at most max(4 err32, 6e-5), where
err32 is the same measure of plain float32 all-pairs math, and 5e-3 with
fast=True. Against nbody_tpu, per row and component, 1e-4 of the row's
float64 sum of |term|: the twin divides where JAX's interpret mode refines
a reciprocal of about 8 bits (~1e-5 of that sum by itself,
tests/test_torch_octree.py), and the twin splits both operands of the far
contraction into bf16 halves where JAX's interpret mode multiplies the
float32 [m yj, m] (~2^-16 of each product). On Hilbert-sorted clusters,
where far tile pairs carry most of the force, the twin without fast is
also held within 1e-5 of that sum of a float64 numpy evaluation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import allpairs as tap
from nbody_torch.ops import cuda_allpairs_mxu as cm
from nbody_torch.ops.geometry import aabb_of_points
from nbody_torch.ops.hilbert import hilbert_sort_perm
from nbody_tpu.ops.pallas_allpairs_mxu import _split_f32, allpairs_accel_mxu

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)


def _oracle(m, x):
    """float64 force, the oracle scale of test_mxu_kernel.py, the float32
    error there, and the float64 sum |term| per row and component."""
    m64, x64 = m.astype(np.float64), x.astype(np.float64)
    d = x64[None, :, :] - x64[:, None, :]
    d2 = np.sum(d * d, axis=-1)
    w = m64[None, :] / (d2 * np.sqrt(d2) + EPS)
    a64 = np.einsum("kn,knd->kd", w, d)
    term = np.einsum("kn,knd->kd", np.abs(w), np.abs(d))
    a32 = tap.allpairs_accel(torch.tensor(m), torch.tensor(x), 1.0, EPS).numpy().astype(np.float64)
    scale = np.linalg.norm(a64, axis=1) + np.abs(a64).max() * 1e-3
    err32 = (np.linalg.norm(a32 - a64, axis=1) / scale).max()
    return a64, scale, err32, term


def _twin(m, x, **kw):
    a, counts = cm.allpairs_accel_mxu_cuda(torch.tensor(m), torch.tensor(x), 1.0, EPS,
                                           tile_i=128, tile_j=128, return_counts=True, **kw)
    return a.numpy().astype(np.float64), dict(zip(cm.BRANCHES, counts.sum(0).tolist()))


def _jax(m, x, **kw):
    return np.asarray(allpairs_accel_mxu(jnp.asarray(m), jnp.asarray(x), 1.0, EPS, tile_i=128,
                                         tile_j=128, interpret=True, **kw)).astype(np.float64)


def _oracle_err(a, a64, scale):
    return (np.linalg.norm(a - a64, axis=1) / scale).max()


def _case(name, dim):
    """test_mxu_kernel.py's inputs: (m, x, kwargs)."""
    if name in ("uniform", "clustered"):
        rng = np.random.default_rng(3)
        n = 300
        m = rng.uniform(0.1, 1.0, n).astype(np.float32)
        if name == "uniform":
            x = rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32)
        else:
            centers = rng.uniform(-100.0, 100.0, (5, dim))
            x = (centers[rng.integers(0, 5, n)]
                 + rng.normal(0.0, 1e-2, (n, dim))).astype(np.float32)
        return m, x, {}
    if name == "unsorted":
        rng = np.random.default_rng(11)
        m = rng.uniform(0.1, 1.0, 256).astype(np.float32)
        x = rng.uniform(-1.0, 1.0, (256, 2)).astype(np.float32)
        perm = rng.permutation(256)
        return m[perm], x[perm], {}
    rng = np.random.default_rng(7)  # fast
    m = rng.uniform(0.1, 1.0, 256).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (256, 3)).astype(np.float32)
    return m, x, {"fast": True, "far_thresh": 1e-2}


def _sorted_clusters(n, dim, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    m = rng.uniform(0.1, 1, n).astype(np.float32)
    tx = torch.tensor(x)
    perm = hilbert_sort_perm(tx, *aabb_of_points(tx, EPS)).numpy()
    return m[perm], x[perm]


CASES = [("uniform", 2), ("uniform", 3), ("clustered", 2), ("clustered", 3), ("unsorted", 2),
         ("fast", 3)]


@pytest.mark.parametrize("name,dim", CASES)
def test_mxu_twin_meets_the_oracle_bounds(name, dim):
    m, x, kw = _case(name, dim)
    a64, scale, err32, _ = _oracle(m, x)
    a, counts = _twin(m, x, **kw)
    err = _oracle_err(a, a64, scale)
    if kw.get("fast"):
        assert err <= 5e-3, err
    else:
        assert err <= max(4.0 * err32, 6e-5), (err, err32)
    assert sum(counts.values()) == (len(m) + 127) // 128 * ((len(m) + 127) // 128)


@pytest.mark.parametrize("name,dim", CASES)
def test_mxu_twin_matches_jax(name, dim):
    m, x, kw = _case(name, dim)
    *_, term = _oracle(m, x)
    a, _ = _twin(m, x, **kw)
    assert (np.abs(a - _jax(m, x, **kw)) / term).max() <= 1e-4


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_mxu_sorted_clusters_take_far_branches(dim, fast):
    """Sorted clusters: the far branch (or under fast the far-fast one)
    carries most tile pairs, which is where the contraction's split and the
    finalize in the midpoint frame are exercised."""
    m, x = _sorted_clusters(1024, dim)
    kw = {"fast": True, "far_thresh": 1e-2} if fast else {}
    a, counts = _twin(m, x, **kw)
    far = counts["far_fast"] if fast else counts["far"]
    assert counts["near"] > 0 and far > counts["near"]
    if not fast:
        assert counts["far_fast"] == 0
    a64, scale, err32, term = _oracle(m, x)
    if fast:
        assert _oracle_err(a, a64, scale) <= 5e-3
    else:
        assert (np.abs(a - a64) / term).max() <= 1e-5
        assert _oracle_err(a, a64, scale) <= max(4.0 * err32, 6e-5)
    assert (np.abs(a - _jax(m, x, **kw)) / term).max() <= 1e-4


def test_split_matches_jax():
    """Bit-equal on normal floats, ties of the bf16 rounding included
    (XLA on the CPU flushes subnormals, which a weight never is)."""
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
                        [0.0, 1.0, -1.0, 3.0e38, 1.00390625, 1.005859375, -1.01171875]])
    w = w.astype(np.float32)
    hi, lo = cm.split_f32(torch.tensor(w))
    jhi, jlo = _split_f32(jnp.asarray(w))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_mxu_padding_is_jax():
    assert cm.mxu_padding(300, 128, 128) == 384
    assert cm.mxu_padding(1000, 512, 1024) == 1024
    assert cm.mxu_padding(1 << 20, 512, 1024) == 1 << 20
    assert cm.mxu_padding(5000, 512, 1024) == 5120


def test_mxu_rejects_float64_and_bad_tiles():
    m, x = torch.ones(8), torch.zeros(8, 3)
    with pytest.raises(ValueError):
        cm.allpairs_accel_mxu_cuda(m.double(), x.double(), 1.0, EPS)
    with pytest.raises(ValueError):
        cm.allpairs_accel_mxu_cuda(m, x, 1.0, EPS, tile_i=96)
    with pytest.raises(ValueError):
        cm.allpairs_accel_mxu_cuda(m, x, 1.0, EPS, tile_j=100)


def test_cpu_mxu_does_not_count_launches():
    cm.reset_launch_counts()
    m, x, _ = _case("unsorted", 2)
    cm.allpairs_accel_mxu_cuda(torch.tensor(m), torch.tensor(x), 1.0, EPS, tile_i=128,
                               tile_j=128)
    assert cm.launch_counts == {cm.PLAIN: 0, cm.FAST: 0}
