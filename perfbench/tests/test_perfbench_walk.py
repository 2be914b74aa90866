"""The plain walk's interaction count against a recursive octree walk."""

import numpy as np
import pytest

from perfbench import galaxy, manifest, roofline
from perfbench.reference import walk


def brute_count(m, x, theta, sample):
    """Build the octree by recursive subdivision (child by the bit of each
    axis's cell index) and walk it per body, recursively."""
    dim = x.shape[1]
    depth = walk.MAX_DEPTH[dim]
    lo, hi = x.min(), x.max()
    side = hi - lo + 2.0
    q = np.clip(np.floor((x - (lo - 1.0)) / side * 2.0**depth), 0, 2**depth - 1).astype(np.int64)

    def build(idx, level):
        node = {"idx": idx, "side": side / 2**level, "level": level, "kids": []}
        mass = m[idx].sum()
        node["com"] = (m[idx, None] * x[idx]).sum(0) / mass
        if len(idx) > 1 and level < depth:
            bit = depth - level - 1
            octant = sum(((q[idx, c] >> bit) & 1) << c for c in range(dim))
            for o in range(2**dim):
                sub = idx[octant == o]
                if len(sub):
                    node["kids"].append(build(sub, level + 1))
        return node

    def visit(node, b):
        if len(node["idx"]) == 1:
            return int(node["idx"][0] != b)
        if node["side"] < theta * np.linalg.norm(x[b] - node["com"]):
            return 1
        if node["level"] == depth:
            return len(node["idx"]) - int(b in node["idx"])
        return sum(visit(k, b) for k in node["kids"])

    root = build(np.arange(len(m)), 0)
    return sum(visit(root, b) for b in sample)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("theta", [0.0, 0.5, 1.0])
def test_count_matches_recursive_walk(dim, theta):
    rng = np.random.default_rng(dim)
    n = 300
    x = rng.normal(size=(n, dim)) * rng.uniform(0.1, 10, size=(n, 1))
    x[7] = x[3]                                # a coincident pair: a max-depth cell
    m = rng.uniform(0.5, 2.0, size=n)
    sample = np.array([0, 3, 7, 50, 299])
    out = walk.count_interactions(m, x, theta, sample)
    assert out["accepted"] + out["direct"] == brute_count(m, x, theta, sample)
    if theta == 0.0:
        assert out["accepted"] == 0 and out["direct"] == len(sample) * (n - 1)


def test_galaxy_count_is_a_barnes_hut_count():
    spec = manifest.Manifest().config("octree-galaxy3d-1M")
    m, x, _ = galaxy.make(11, 4096, 3, np.float64, spec["galaxy"])
    a = roofline.interactions(spec, m, x, 512, 11)
    b = roofline.interactions(spec, m, x, 512, 11)
    assert a == b                                  # the same count for a seed
    assert 30 < a["per_body"] < 4095               # far fewer than all pairs
    full = roofline.interactions(spec, m, x, 10**6, 11)
    assert full["sampled"] == 4096


def test_bound_arithmetic():
    assert roofline.flops_per_interaction(3, "sqrt3") == 19
    assert roofline.flops_per_interaction(3, "poly") == 18
    b = roofline.bound_seconds(1e9, 10**6, 3, "sqrt3", "float64")
    assert b["bound_by"] == "operations"
    assert b["seconds"] == pytest.approx(1e9 * 19 / 34e12)
    b = roofline.bound_seconds(1.0, 10**6, 3, "poly", "float32")
    assert b["bound_by"] == "bytes" and b["seconds"] == pytest.approx(10**6 * 7 * 4 / 3.35e12)
    spec = {"algorithm": "all-pairs", "theta": 0.5}
    assert roofline.interactions(spec, np.ones(10), np.zeros((10, 3)), 4, 0)["interactions"] == 90
