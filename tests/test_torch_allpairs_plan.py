"""The all-pairs kernels' launch plan and the form of the pair weight the
port's paths request, on the CPU (nbody_torch/ops/cuda_allpairs.py).

block_plan splits a call of ni rows against nj bodies into row blocks and
body splits. Each (row, body) pair must fall in exactly one (block, split),
a call with few rows must still give the card's 132 SMs a few blocks each,
and the CLI's square 2^20 call must not split. The splits' partial sums,
added in split order as split_sum_kernel adds them, are held against the
unsplit twin and against nbody_tpu's allpairs_block_pallas in interpret
mode, per row and component as a fraction of the row's float64 sum of
|term|: 1e-5 against the twin and JAX's exact=True (both divide exactly),
1e-4 against JAX's default exact=False, whose interpret-mode reciprocal
leaves ~1e-5 of that sum by itself (tests/test_torch_allpairs_variants.py).

The routing tests hold the port to nbody_tpu's numerics: its all-pairs
engine calls allpairs_accel_pallas without `exact` (nbody_tpu/sim/
engines.py:98) and its octree fallback allpairs_block_pallas without it
(nbody_tpu/ops/octree_group.py:442), so both take exact=False, the Newton
form. The port's engine and fallbacks must request the Newton form in
float32 and the float64 chain in float64.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import cuda_allpairs as ca
from nbody_torch.ops import octree_group as tog
from nbody_torch.ops.geometry import aabb_of_points
from nbody_torch.ops.hilbert import hilbert_sort_perm
from nbody_torch.sim import engines
from nbody_tpu.ops.pallas_allpairs import allpairs_accel_pallas, allpairs_block_pallas

torch.set_num_threads(1)

H100_SMS = 132
SIZES = [(1, 1), (1, 300), (31, 4099), (300, 20000), (4099, 65573), (9216, 1 << 20),
         (65536, 65536), (70001, 70001), (1 << 18, 1 << 20), (1 << 20, 1), (1 << 20, 1 << 20)]


def _cover(n: int, step: int, parts: int) -> np.ndarray:
    """How often each index of [0, n) falls in the ranges [k * step,
    (k + 1) * step), k < parts, cut at n."""
    count = np.zeros(n + 1, np.int64)
    for k in range(parts):
        count[min(k * step, n)] += 1
        count[min((k + 1) * step, n)] -= 1
    return np.cumsum(count)[:n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ni,nj", SIZES)
def test_block_plan_covers_each_pair_once(ni, nj, dtype):
    """Row blocks cover each row once and splits each body once, so
    (block, split) covers each pair once; no split is empty, and every
    split but the last is whole tiles, as nbody_allpairs_rows requires."""
    plan = ca.block_plan(ni, nj, dtype, H100_SMS)
    assert plan.rows_per_block == ca.ROWS[dtype] * ca.THREADS
    assert plan.blocks == -(-ni // plan.rows_per_block)
    assert np.all(_cover(ni, plan.rows_per_block, plan.blocks) == 1)
    assert np.all(_cover(nj, plan.split_len, plan.splits) == 1)
    assert plan.split_len % ca.TILE == 0 and plan.split_len >= ca.TILE
    assert plan.splits == 1 or (plan.splits - 1) * plan.split_len < nj
    assert 1 <= plan.splits <= 65535


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nj", [1 << 16, 1 << 20])
@pytest.mark.parametrize("ni", [9216, 20000, 65536, 1 << 18, 1 << 20])
def test_block_plan_fills_the_card(ni, nj, dtype):
    """A fallback of 18 tiles (9,216 rows) and up gives at least two
    blocks per SM."""
    plan = ca.block_plan(ni, nj, dtype, H100_SMS)
    assert plan.blocks * plan.splits >= 2 * H100_SMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_plan_does_not_split_the_square_2p20_call(dtype):
    plan = ca.block_plan(1 << 20, 1 << 20, dtype, H100_SMS)
    assert plan.splits == 1 and plan.split_len >= 1 << 20


def _bodies(n, dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, n).astype(np.float32),
            rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32))


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
def test_plan_split_sum_matches_twin_and_jax(softening):
    """ni = 40 rows against nj = 3,000 bodies: the plan splits the bodies;
    each split's rows summed by the twin over its body range, the splits
    added in order (split_sum_torch), match the unsplit twin and JAX."""
    _, xi = _bodies(40, 3, seed=1)
    mj, xj = _bodies(3000, 3, seed=2)
    eps = float(np.finfo(np.float32).eps)
    plan = ca.block_plan(40, 3000, torch.float32, H100_SMS)
    assert plan.splits > 1
    ti, tm, tx = (torch.from_numpy(a) for a in (xi, mj, xj))
    parts = torch.stack([ca.allpairs_block_torch(ti, tm[a:a + plan.split_len],
                                                 tx[a:a + plan.split_len], eps, softening)
                         for a in range(0, 3000, plan.split_len)])
    assert parts.shape == (plan.splits, 40, 3)
    got = ca.split_sum_torch(parts).double().numpy()
    scale = ca.allpairs_block_abs_torch(ti.double(), tm.double(), tx.double(), eps,
                                        softening).numpy()
    twin = ca.allpairs_block_torch(ti, tm, tx, eps, softening).double().numpy()
    assert np.all(np.abs(got - twin) <= 1e-5 * scale)
    for exact, tol in ((True, 1e-5), (False, 1e-4)):
        ref = np.asarray(allpairs_block_pallas(jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj),
                                               eps, tile_i=128, tile_j=512, interpret=True,
                                               exact=exact, softening=softening), np.float64)
        assert np.all(np.abs(got - ref) <= tol * scale), (exact, np.max(np.abs(got - ref) / scale))


def test_split_sum_adds_in_split_order():
    """split_sum_torch (and the wrapper on CPU tensors) adds the splits
    one after another, then scales, or multiplies by mi."""
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.standard_normal((5, 7, 3)).astype(np.float32))
    acc = parts[0]
    for k in range(1, 5):
        acc = acc + parts[k]
    assert torch.equal(ca.split_sum_cuda(parts, 2.5), 2.5 * acc)
    mi = torch.from_numpy(rng.uniform(0.1, 1, 7).astype(np.float32))
    one = parts[:, :, :1].contiguous()
    assert torch.equal(ca.split_sum_cuda(one, mi=mi)[:, 0], mi * acc[:, 0])
    with pytest.raises(ValueError):
        ca.split_sum_cuda(parts, mi=mi[:3])


def _record(monkeypatch, module, attr, wrapper, rows_arg):
    """Wrap module.<attr> (a call of `wrapper`): each call appends the
    launch_counts name of the instantiation it requests and goes through."""
    seen = []
    sig = inspect.signature(wrapper)

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        seen.append(ca.block_name(bound.arguments[rows_arg].dtype, bound.arguments["exact"]))
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(module, attr, call)
    return seen


EXPECTED = {torch.float32: ca.NEWTON, torch.float64: ca.NEWTON64}


def test_nbody_tpu_defaults_to_the_newton_form():
    for fn in (allpairs_accel_pallas, allpairs_block_pallas, ca.allpairs_accel_cuda,
               ca.allpairs_block_cuda):
        assert inspect.signature(fn).parameters["exact"].default is False, fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_allpairs_engine_requests_the_newton_form(dtype, monkeypatch):
    seen = _record(monkeypatch, engines, "allpairs_accel_cuda", ca.allpairs_accel_cuda, "x")
    cfg = SimConfig(n=64, dim=3, dtype=np.float64 if dtype == torch.float64 else np.float32)
    m, x = (torch.from_numpy(a).to(dtype) for a in _bodies(64, 3, seed=4))
    accel = engines.AllPairsEngine()._accel_fn(cfg, engines.EngineOptions(), torch.device("cpu"))
    a = accel(type("S", (), {"m": m, "x": x})())
    assert a.dtype == dtype and seen == [EXPECTED[dtype]]


@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tree_exact_fallback_requests_the_newton_form(dtype, softening, monkeypatch):
    """octree_group.exact_fallback: the octree's fast and list paths and
    the BVH's list path send their overflowed tiles through it."""
    seen = _record(monkeypatch, tog, "allpairs_block_cuda", ca.allpairs_block_cuda, "xi")
    m, x = (torch.from_numpy(a).to(dtype) for a in _bodies(64, 3, seed=5))
    xt = x.view(4, 16, 3)
    acc = torch.zeros(64, 3, dtype=dtype)
    over = torch.tensor([False, True, False, True])
    eps = float(torch.finfo(dtype).eps)
    tog.exact_fallback(acc, xt, over, 2, m, x, eps, softening)
    assert seen == [EXPECTED[dtype]]
    ref = ca.allpairs_block_torch(x, m, x, eps, softening).view(4, 16, 3)
    assert torch.equal(acc.view(4, 16, 3)[over], ref[over])


def test_bvh_fast_path_fallback_requests_the_newton_form(monkeypatch):
    """The BVH fast path's own fallback (float32): 3,000 2-D clustered
    bodies with a 1-tile window and e_chunk 1 send tiles to it."""
    seen = _record(monkeypatch, tbg, "allpairs_block_cuda", ca.allpairs_block_cuda, "xi")
    rng = np.random.default_rng(11)
    centers = rng.uniform(-40, 40, (9, 2))
    x = torch.from_numpy((centers[rng.integers(0, 9, 3000)]
                          + rng.normal(0, 1.2, (3000, 2))).astype(np.float32))
    m = torch.from_numpy(rng.uniform(0.1, 1, 3000).astype(np.float32))
    eps = float(np.finfo(np.float32).eps)
    perm = hilbert_sort_perm(x, *aabb_of_points(x, eps))
    m, x = m[perm].contiguous(), x[perm].contiguous()
    _, info = tbg.compute_force_grouped_windowed(tb.build_tree(m, x, eps), m, x, 0.5, 1.0, eps,
                                                 window_tiles=1, e_chunk=1)
    assert int(info["fallback_tiles"]) > 0
    assert seen == [ca.NEWTON]
