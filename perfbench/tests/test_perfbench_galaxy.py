"""The galaxy generator: the published constants, shapes, and the seed."""

import numpy as np
import pytest

from perfbench import galaxy, manifest

SPEC = manifest.Manifest().config("octree-galaxy3d-1M")["galaxy"]
BIG_SEED = 2**40 + 12345


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_shapes_and_dtype(dim, dtype):
    m, x, v = galaxy.make(BIG_SEED, 1000, dim, dtype, SPEC)
    assert m.shape == (1000,) and x.shape == (1000, dim) and v.shape == (1000, dim)
    assert m.dtype == x.dtype == v.dtype == dtype


def test_published_constants():
    n = 2000
    m, x, v = galaxy.make(7, n, 3, np.float64, SPEC)
    count = n // 2 - 1
    assert m[0] == 1e4 and m[count + 1] == 1e3
    np.testing.assert_array_equal(x[0], [-100.0, 50.0, 0.0])
    np.testing.assert_array_equal(x[count + 1], [100.0, -50.0, 0.0])
    assert not v[0].any() and not v[count + 1].any()
    for first, centre in ((1, x[0]), (count + 2, x[count + 1])):
        orb = slice(first, first + count)
        assert m[orb].sum() == pytest.approx(1.0)
        rot = np.asarray(SPEC["rotation"])
        local = np.linalg.solve(rot, (x[orb] - centre).T).T   # undo the turn
        r = np.hypot(local[:, 0], local[:, 1])
        assert r.min() >= 30.0 - 1e-9 and r.max() <= 50.0 + 1e-9
        assert np.abs(local[:, 2]).max() <= 10.0 + 1e-9
        vloc = np.linalg.solve(rot, v[orb].T).T
        speed = np.hypot(vloc[:, 0], vloc[:, 1])
        M = (1e4 if first == 1 else 1e3) + 1.0
        np.testing.assert_allclose(speed, np.sqrt(1e-4 * M / (r + np.finfo(float).eps)), rtol=1e-12)
        assert np.abs(vloc[:, 2]).max() <= 1e-5
        # circular: the velocity is perpendicular to the radius in the disc's plane
        np.testing.assert_allclose(local[:, 0] * vloc[:, 0] + local[:, 1] * vloc[:, 1], 0, atol=1e-12)


def test_odd_n_leaves_the_last_body_empty():
    m, x, v = galaxy.make(3, 11, 2, np.float64, SPEC)
    assert m[-1] == 0 and not x[-1].any() and not v[-1].any()


def test_same_seed_same_bodies_other_seed_other_bodies():
    a = galaxy.make(BIG_SEED, 4096, 3, np.float32, SPEC)
    b = galaxy.make(BIG_SEED, 4096, 3, np.float32, SPEC)
    c = galaxy.make(BIG_SEED + 1, 4096, 3, np.float32, SPEC)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(a[0], c[0])          # masses are fixed
    assert not np.array_equal(a[1], c[1])


def test_a_run_seed_orders_one_galaxy():
    cfg = dict(manifest.Manifest().config("bvh-galaxy3d-1M"), n=4096)
    a = galaxy.bodies(cfg, BIG_SEED, 4096, np.float32)
    b = galaxy.bodies(cfg, BIG_SEED, 4096, np.float32)
    c = galaxy.bodies(cfg, BIG_SEED + 1, 4096, np.float32)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p, q)
    assert not np.array_equal(a[1], c[1])
    key = lambda x: x[np.lexsort(x.T[::-1])]
    np.testing.assert_array_equal(key(a[1]), key(c[1]))           # the same bodies
    fixed = galaxy.make(cfg["galaxy_seed"], 4096, 3, np.float32, cfg["galaxy"])
    np.testing.assert_array_equal(key(a[1]), key(fixed[1]))


def test_float32_is_the_float64_galaxy_rounded():
    lo = galaxy.make(5, 512, 3, np.float32, SPEC)
    hi = galaxy.make(5, 512, 3, np.float64, SPEC)
    np.testing.assert_array_equal(lo[1], hi[1].astype(np.float32))
