"""nbody_torch all-pairs forces (plain torch, and the CUDA kernel's wrapper
on CPU tensors, which runs its plain twin) against nbody_tpu: the Pallas
kernels in interpret mode, the jnp oracle and the naive per-pair loop.

Tolerance, per row and component: |torch - reference| <= TOL * sum_j |term|,
where term = m_j * (x_j - x_i) / t. Both sides sum the same terms in
different orders, so they differ by a few ulps of that sum:
TOL = 1e-5 in float32, 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import allpairs as tap
from nbody_torch.ops import cuda_allpairs as ca
from nbody_torch.ops import geometry as tgeo
from nbody_tpu.ops import allpairs as jap
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops.pallas_allpairs import allpairs_accel_pallas, allpairs_block_pallas
from tests.conftest import naive_allpairs

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _bodies(n, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, n).astype(dtype),
            rng.uniform(-1.0, 1.0, (n, dim)).astype(dtype))


def _term_scale(xi, mj, xj, eps, softening="poly"):
    """sum_j |m_j (x_j - x_i) / t| in float64, per row and component."""
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    d = xj[None, :, :] - xi[:, None, :]
    d2 = np.sum(d * d, axis=-1)
    t = (np.sqrt(d2) + eps) ** 3 if softening == "sqrt3" else d2 * np.sqrt(d2) + eps
    return np.einsum("kn,knd->kd", np.abs(mj)[None, :] / t, np.abs(d))


def _assert_rows_close(got, ref, scale, dtype):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    bad = np.abs(got - ref) > TOL[dtype] * scale
    assert not bad.any(), float(np.max(np.abs(got - ref) / np.maximum(scale, 1e-300)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [100, 300])
@pytest.mark.parametrize("dim", [2, 3])
def test_block_torch_vs_pallas_accel(dim, n):
    """allpairs_accel_cuda on CPU tensors (its plain twin) == the square
    Pallas kernel in interpret mode, as tests/test_allpairs.py runs it."""
    m, x = _bodies(n, dim, np.float32, seed=dim + n)
    eps, G = float(np.finfo(np.float32).eps), 2.5
    ref = allpairs_accel_pallas(jnp.asarray(m), jnp.asarray(x), G, eps,
                                tile_i=128, tile_j=128, interpret=True)
    got = ca.allpairs_accel_cuda(_t(m), _t(x), G, eps)
    assert got.dtype == torch.float32
    _assert_rows_close(got, ref, G * _term_scale(x, m, x, eps), np.float32)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_block_torch_vs_pallas_block(dim, softening):
    """Rectangular ni != nj blocks, both softenings, against
    allpairs_block_pallas in interpret mode."""
    _, xi = _bodies(70, dim, np.float32, seed=11)
    mj, xj = _bodies(200, dim, np.float32, seed=12)
    eps = float(np.finfo(np.float32).eps)
    ref = allpairs_block_pallas(jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj), eps,
                                tile_i=128, tile_j=128, interpret=True, softening=softening)
    scale = _term_scale(xi, mj, xj, eps, softening)
    got = ca.allpairs_block_torch(_t(xi), _t(mj), _t(xj), eps, softening)
    _assert_rows_close(got, ref, scale, np.float32)
    wrapped = ca.allpairs_block_cuda(_t(xi), _t(mj), _t(xj), eps, softening)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("chunk", [64, 1024])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_allpairs_vs_jax(dim, dtype, chunk, monkeypatch):
    """Both packages in row chunks of `chunk` rows (the port sizes its
    chunks from n, so the test sets its pair budget to chunk * n); the
    port's chunking changes no value against one unchunked pass."""
    n = 150
    m, x = _bodies(n, dim, dtype, seed=5)
    eps, G = float(np.finfo(dtype).eps), 0.7
    ref = jap.allpairs_accel(jnp.asarray(m), jnp.asarray(x), G, eps, chunk=chunk)
    monkeypatch.setattr(tap, "PAIRS_PER_CHUNK", chunk * n)
    assert len(tap.row_chunks(n, n)) == -(-n // chunk)
    got = tap.allpairs_accel(_t(m), _t(x), G, eps)
    assert got.dtype == _t(x).dtype
    _assert_rows_close(got, ref, G * _term_scale(x, m, x, eps), dtype)
    monkeypatch.setattr(tap, "PAIRS_PER_CHUNK", n * n)
    whole = tap.allpairs_accel(_t(m), _t(x), G, eps)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_allpairs_vs_naive(dtype):
    m, x = _bodies(40, 3, dtype, seed=9)
    eps = float(np.finfo(dtype).eps)
    ref = naive_allpairs(m, x, 1.0, dtype(eps))
    for got in (tap.allpairs_accel(_t(m), _t(x), 1.0, eps),
                ca.allpairs_accel_cuda(_t(m), _t(x), 1.0, eps)):
        _assert_rows_close(got, ref, _term_scale(x, m, x, eps), dtype)


def test_abs_scale_matches_numpy():
    _, xi = _bodies(30, 3, np.float64, seed=1)
    mj, xj = _bodies(50, 3, np.float64, seed=2)
    for soft in ("poly", "sqrt3"):
        got = ca.allpairs_block_abs_torch(_t(xi), _t(mj), _t(xj), 1e-9, soft).numpy()
        np.testing.assert_allclose(got, _term_scale(xi, mj, xj, 1e-9, soft), rtol=1e-13)


def test_self_and_coincident_terms_vanish():
    eps = float(np.finfo(np.float32).eps)
    m = torch.tensor([5.0])
    x = torch.tensor([[0.3, -0.2]])
    assert torch.all(ca.allpairs_accel_cuda(m, x, 1.0, eps) == 0)
    m2 = torch.tensor([1.0, 2.0])
    x2 = torch.tensor([[0.5, 0.5], [0.5, 0.5]])
    a = ca.allpairs_accel_cuda(m2, x2, 1.0, eps)
    assert torch.isfinite(a).all() and torch.all(a == 0)


def test_collapsed_freezes_z_and_fix_z():
    m, x = _bodies(32, 3, np.float32, seed=4)
    eps = float(np.finfo(np.float32).eps)
    a_old = np.full((32, 3), 7.0, np.float32)
    got = tap.allpairs_collapsed_accel(_t(m), _t(x), _t(a_old), 1.0, eps)
    ref = jap.allpairs_collapsed_accel(jnp.asarray(m), jnp.asarray(x), jnp.asarray(a_old),
                                       1.0, eps)
    np.testing.assert_array_equal(got[:, 2].numpy(), a_old[:, 2])
    np.testing.assert_array_equal(np.asarray(ref)[:, 2], a_old[:, 2])
    full = tap.allpairs_accel(_t(m), _t(x), 1.0, eps)
    np.testing.assert_array_equal(got[:, :2].numpy(), full[:, :2].numpy())
    fixed = tap.allpairs_collapsed_accel(_t(m), _t(x), _t(a_old), 1.0, eps, fix_z=True)
    np.testing.assert_array_equal(fixed.numpy(), full.numpy())
    m2, x2 = _bodies(32, 2, np.float32, seed=4)
    flat = tap.allpairs_collapsed_accel(_t(m2), _t(x2), torch.zeros(32, 2), 1.0, eps)
    np.testing.assert_array_equal(flat.numpy(), tap.allpairs_accel(_t(m2), _t(x2), 1.0, eps).numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_geometry_vs_jax(dtype):
    rng = np.random.default_rng(2)
    a, b = rng.uniform(-2, 2, (2, 9, 3)).astype(dtype)
    eps = float(np.finfo(dtype).eps)
    np.testing.assert_array_equal(tgeo.dist2(_t(a), _t(b)).numpy(),
                                  np.asarray(jgeo.dist2(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(tgeo.dist(_t(a), _t(b), eps).numpy(),
                                  np.asarray(jgeo.dist(jnp.asarray(a), jnp.asarray(b), eps)))
    d2 = np.sum((a - b) ** 2, axis=-1).astype(dtype)
    np.testing.assert_array_equal(tgeo.dist3_from_d2(_t(d2), eps).numpy(),
                                  np.asarray(jgeo.dist3_from_d2(jnp.asarray(d2), eps)))


def test_cpu_wrappers_do_not_count_launches():
    ca.reset_launch_counts()
    m, x = _bodies(20, 2, np.float32, seed=0)
    ca.allpairs_accel_cuda(_t(m), _t(x), 1.0, 1e-7)
    ca.allpairs_block_cuda(_t(x), _t(m), _t(x), 1e-7)
    ca.potential_rowsums_cuda(_t(m), _t(x), 1e-7)
    ca.allpairs_block_cuda(_t(x), _t(m), _t(x), 1e-7, exact=True)
    ca.split_sum_cuda(_t(np.ones((2, 20, 2), np.float32)))
    assert ca.launch_counts == {ca.EXACT: 0, ca.NEWTON: 0, ca.NEWTON64: 0, ca.FAST: 0,
                                ca.POTENTIAL: 0, ca.SPLIT_SUM: 0}


@pytest.mark.parametrize("case", ["dtype", "mixed", "dim", "mass", "stride", "int", "softening"])
def test_wrapper_rejects_bad_inputs(case):
    m, x = _t(np.ones(6, np.float32)), _t(np.zeros((6, 3), np.float32))
    if case == "dtype":
        args = (x.half(), m.half(), x.half())
    elif case == "mixed":
        args = (x, m.double(), x)
    elif case == "dim":
        args = (torch.zeros(6, 4), torch.ones(6), torch.zeros(6, 4))
    elif case == "mass":
        args = (x, m[:5], x)
    elif case == "stride":
        args = (torch.zeros(3, 6).t(), m, x)
    elif case == "int":
        args = (x.int(), m.int(), x.int())
    else:
        with pytest.raises(ValueError):
            ca.allpairs_block_cuda(x, m, x, 1e-7, "cubic")
        return
    with pytest.raises((TypeError, ValueError)):
        ca.allpairs_block_cuda(*args, 1e-7)


def test_wrapper_rejects_other_devices():
    m, x = torch.ones(4, device="meta"), torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError):
        ca.allpairs_accel_cuda(m, x, 1.0, 1e-7)
