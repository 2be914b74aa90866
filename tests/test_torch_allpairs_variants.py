"""The all-pairs kernel's float32 variants in nbody_torch (the Newton form
and the fast per-tile split), through the CUDA wrappers on CPU tensors,
which run their plain twins, against nbody_tpu's allpairs_accel_pallas and
allpairs_block_pallas in interpret mode and against a float64 numpy sum.

Tolerance, per row and component, as a fraction of the row's float64 sum
of |term|: 1e-5 against float64 (the twins sum in float64; the fast
branch's dropped softening is below 1e-6 of each far term), and 1e-4
against the Pallas functions, whose interpret-mode reciprocal (about 8
bits refined by one Newton step) leaves ~1e-5 of that sum by itself in a
row that one close pair dominates (measured 1.07e-5 here, as in
tests/test_torch_octree.py). The fast branch also meets nbody_tpu's own
bound, 1e-5 of max |a| (tests/test_allpairs.py:129-145).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_allpairs as ca
from nbody_torch.ops.geometry import aabb_of_points
from nbody_torch.ops.hilbert import hilbert_sort_perm
from nbody_tpu.ops.pallas_allpairs import allpairs_accel_pallas

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)


def _random_system(n, dim, seed=0):
    """tests/test_allpairs.py's _random_system."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, n).astype(np.float32),
            rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32))


def _sorted_clusters(n, dim, seed=11):
    """Nine Gaussian clusters, Hilbert-sorted: tiles inside one cluster
    see the others from far away, so both branches run."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    m = rng.uniform(0.1, 1, n).astype(np.float32)
    tx = torch.tensor(x)
    perm = hilbert_sort_perm(tx, *aabb_of_points(tx, EPS)).numpy()
    return m[perm], x[perm]


def _f64(xi, mj, xj):
    """float64 force sum and sum |term| of the rows xi against (mj, xj)."""
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    d = xj[None, :, :] - xi[:, None, :]
    d2 = np.sum(d * d, axis=-1)
    w = mj[None, :] / (d2 * np.sqrt(d2) + EPS)
    return np.einsum("kn,knd->kd", w, d), np.einsum("kn,knd->kd", np.abs(w), np.abs(d))


def _scaled(got, ref, scale):
    return float((np.abs(np.asarray(got, np.float64) - ref) / scale).max())


def _fast_twin(m, x, tile_i=256, tile_j=512, **kw):
    """The fast twin's sums and its per-i-tile [softened, far] j-tiles."""
    a, counts = ca.allpairs_accel_cuda(torch.tensor(m), torch.tensor(x), 1.0, EPS, exact=False,
                                       fast=True, tile_i=tile_i, tile_j=tile_j,
                                       return_counts=True, **kw)
    return a.numpy(), counts.numpy()


def _fast_pallas(m, x, tile_i=256, tile_j=512, **kw):
    return np.asarray(allpairs_accel_pallas(jnp.asarray(m), jnp.asarray(x), 1.0, EPS,
                                            tile_i=tile_i, tile_j=tile_j, interpret=True,
                                            fast=True, **kw))


@pytest.mark.parametrize("dim", [2, 3])
def test_fast_twin_matches_pallas(dim):
    """test_allpairs.py's n = 1500 system (its fast test is 2-D), unsorted:
    every tile holds close pairs and takes the softened chain."""
    m, x = _random_system(1500, dim)
    a, counts = _fast_twin(m, x)
    ref, scale = _f64(x, m, x)
    assert _scaled(a, ref, scale) <= 1e-5
    assert _scaled(a, _fast_pallas(m, x), scale) <= 1e-4
    assert np.abs(a - ref).max() / np.abs(ref).max() < 1e-5
    npad = 1536  # round_up(1500, 512); tile_j 512 stays under the 3-D clamp
    assert counts.shape == (npad // 256, 2) and (counts.sum(1) == npad // 512).all()
    assert counts[:, 1].sum() == 0


@pytest.mark.parametrize("dim", [2, 3])
def test_fast_clustered_takes_both_branches(dim):
    m, x = _sorted_clusters(2000, dim)
    a, counts = _fast_twin(m, x)
    softened, far = counts.sum(0)
    assert softened > 0 and far > 0
    ref, scale = _f64(x, m, x)
    assert _scaled(a, ref, scale) <= 1e-5
    assert _scaled(a, _fast_pallas(m, x), scale) <= 1e-4
    assert np.abs(a - ref).max() / np.abs(ref).max() < 1e-5


def test_far_tile_count_is_the_per_tile_minimum():
    """The twin's far tiles are those whose least float32 d2 over JAX's
    padded tile exceeds (eps / 1e-6)^(2/3), counted here per i-tile by
    brute force."""
    m, x = _sorted_clusters(1000, 2)
    _, counts = _fast_twin(m, x, tile_i=128, tile_j=256)
    npad = 1024
    xp = np.zeros((npad, 2), np.float32)
    xp[:1000] = x
    thresh = (EPS / 1e-6) ** (2.0 / 3.0)
    expect = np.zeros(npad // 128, np.int64)
    for i0 in range(0, npad, 128):
        for j0 in range(0, npad, 256):
            d = xp[None, j0:j0 + 256] - xp[i0:i0 + 128, None]
            expect[i0 // 128] += int(np.min(np.sum(d * d, axis=-1)) > np.float32(thresh))
    assert (counts[:, 1] == expect).all() and (counts[:, 0] == npad // 256 - expect).all()
    assert expect.sum() > 0
    assert ca.far_threshold(EPS) == thresh


@pytest.mark.parametrize("dim", [2, 3])
def test_newton_form_matches_pallas(dim):
    """exact=False: the twin divides (IEEE), within 1 ulp of the Newton step."""
    m, x = _random_system(700, dim, seed=dim)
    a = ca.allpairs_accel_cuda(torch.tensor(m), torch.tensor(x), 1.0, EPS, exact=False).numpy()
    ref, scale = _f64(x, m, x)
    assert _scaled(a, ref, scale) <= 1e-5
    jax_newton = np.asarray(allpairs_accel_pallas(jnp.asarray(m), jnp.asarray(x), 1.0, EPS,
                                                  tile_i=128, tile_j=256, interpret=True,
                                                  exact=False))
    assert _scaled(a, jax_newton, scale) <= 1e-4


def test_fast_tol_matches_pallas():
    """A looser fast_tol lowers the far threshold, so more tiles drop the
    softening; twin and JAX take it alike."""
    m, x = _sorted_clusters(1500, 3)
    a, counts = _fast_twin(m, x, tile_i=128, tile_j=512, fast_tol=1e-3)
    _, default = _fast_twin(m, x, tile_i=128, tile_j=512)
    assert counts[:, 1].sum() > default[:, 1].sum()
    ref, scale = _f64(x, m, x)
    assert _scaled(a, _fast_pallas(m, x, tile_i=128, tile_j=512, fast_tol=1e-3), scale) <= 1e-4
    assert np.abs(a - ref).max() / np.abs(ref).max() < 1e-3  # each far weight within 1e-3


@pytest.mark.parametrize("n,dim,tile_i,tile_j,expect", [
    (1500, 2, 256, 512, (1536, 512)),
    (1500, 3, 512, 2048, (2048, 1024)),   # tile_j clamped to 1024 in 3-D
    (100, 2, 512, 2048, (2048, 2048)),
    (4097, 3, 512, 2048, (5120, 1024)),
    (333, 3, 128, 512, (512, 512)),
])
def test_fast_tiling_matches_jax(n, dim, tile_i, tile_j, expect):
    """pallas_allpairs.py:138-144."""
    assert ca.fast_tiling(n, dim, tile_i, tile_j) == expect


@pytest.mark.parametrize("case", ["float64-newton", "float64-fast", "fast-exact",
                                  "counts-without-fast"])
def test_variants_reject_what_the_kernel_does_not_take(case):
    m, x = _random_system(8, 3)
    m, x = torch.tensor(m), torch.tensor(x)
    if case == "float64-newton":  # taken since the float64 chain: the twin, on the CPU
        got = ca.allpairs_accel_cuda(m.double(), x.double(), 1.0, EPS, exact=False)
        assert torch.equal(got, ca.allpairs_accel_cuda(m.double(), x.double(), 1.0, EPS,
                                                       exact=True))
    elif case == "float64-fast":
        with pytest.raises(TypeError):
            ca.allpairs_accel_cuda(m.double(), x.double(), 1.0, EPS, exact=False, fast=True)
    elif case == "fast-exact":
        with pytest.raises(ValueError):
            ca.allpairs_accel_cuda(m, x, 1.0, EPS, exact=True, fast=True)
    else:
        with pytest.raises(ValueError):
            ca.allpairs_accel_cuda(m, x, 1.0, EPS, exact=False, return_counts=True)


def test_cpu_variants_do_not_count_launches():
    ca.reset_launch_counts()
    m, x = (torch.tensor(a) for a in _random_system(64, 2))
    ca.allpairs_accel_cuda(m, x, 1.0, EPS, exact=False)
    ca.allpairs_accel_cuda(m, x, 1.0, EPS, exact=False, fast=True, tile_i=64, tile_j=64)
    assert set(ca.launch_counts.values()) == {0}


@pytest.mark.parametrize("twin", ["fast", "mxu"])
def test_twin_rows_sample_is_the_head_of_the_full_run(twin):
    """The twins' `rows` sample, which chip_smoke.py holds the 2^20 kernels
    against, gives the first rows and the first i-tiles' counts of the full
    evaluation exactly."""
    from nbody_torch.ops import cuda_allpairs_mxu as cm

    m, x = (torch.tensor(a) for a in _sorted_clusters(1300, 3))
    fn = ca.allpairs_fast_torch if twin == "fast" else cm.allpairs_accel_mxu_torch
    a, counts = fn(m, x, 1.0, EPS, tile_i=128, tile_j=256)
    head, head_counts = fn(m, x, 1.0, EPS, tile_i=128, tile_j=256, rows=300)
    assert torch.equal(head, a[:300]) and torch.equal(head_counts, counts[:3])
    assert counts.shape[0] == 1536 // 128 and counts[:, 1:].sum() > 0
