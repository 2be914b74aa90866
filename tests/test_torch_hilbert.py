"""nbody_torch.ops.hilbert.hilbert_sort_perm against nbody_tpu's
hilbert_sort_perm (the reference's quirk curve, a stable sort): the same
permutation, bit for bit, in 2-D and 3-D, with ties (duplicate bodies and
bodies that share a Hilbert cell keep their order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops.geometry import aabb_of_points as t_aabb
from nbody_torch.ops.hilbert import hilbert_sort_perm as t_perm
from nbody_tpu.ops.geometry import aabb_of_points as j_aabb
from nbody_tpu.ops.hilbert import hilbert_sort_perm as j_perm

EPS = float(np.finfo(np.float32).eps)


def _positions(layout, n, dim):
    rng = np.random.default_rng(n + dim)
    if layout == "uniform":
        return rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32)
    if layout == "ties":  # duplicates, and few distinct cells on a coarse grid
        x = np.round(rng.uniform(-1.0, 1.0, (n, dim)) * 4) / 4
        x[n // 2:] = x[: n - n // 2]
        return x.astype(np.float32)
    centers = rng.uniform(-40, 40, (9, dim))  # clusters
    return (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)


@pytest.mark.parametrize("layout", ["uniform", "ties", "clusters"])
@pytest.mark.parametrize("dim", [2, 3])
def test_hilbert_sort_perm_matches_jax(dim, layout):
    x = _positions(layout, 3000, dim)
    jx = jnp.asarray(x)
    want = np.asarray(j_perm(jx, *j_aabb(jx, EPS)))
    tx = torch.tensor(x)
    got = t_perm(tx, *t_aabb(tx, EPS)).numpy()
    np.testing.assert_array_equal(got, want)
    if layout == "ties":
        assert len(np.unique(x, axis=0)) < len(x)


def test_hilbert_sort_perm_float64():
    x = _positions("clusters", 2000, 3).astype(np.float64)
    jx = jnp.asarray(x)
    want = np.asarray(j_perm(jx, *j_aabb(jx, 2.0 ** -52)))
    tx = torch.tensor(x)
    np.testing.assert_array_equal(t_perm(tx, *t_aabb(tx, 2.0 ** -52)).numpy(), want)


@pytest.mark.parametrize("layout", ["uniform", "clusters"])
@pytest.mark.parametrize("dim", [2, 3])
def test_hilbert_sort_perm_true_curve_matches_jax(dim, layout):
    """true_curve=True, the order of the BVH knob probe's sort: the same
    permutation as nbody_tpu's; in 3-D it differs from the quirk curve's."""
    x = _positions(layout, 3000, dim)
    jx = jnp.asarray(x)
    want = np.asarray(j_perm(jx, *j_aabb(jx, EPS), true_curve=True))
    tx = torch.tensor(x)
    got = t_perm(tx, *t_aabb(tx, EPS), true_curve=True).numpy()
    np.testing.assert_array_equal(got, want)
    quirk = t_perm(tx, *t_aabb(tx, EPS)).numpy()
    assert np.array_equal(got, quirk) == (dim == 2)
