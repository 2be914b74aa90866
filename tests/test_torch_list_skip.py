"""The trees' list paths skip the tiles that the exact fallback overwrites,
on the CPU: nbody_torch passes heads of zero (live_heads) for every tile
that overflows a cap, so the list kernel does no work on them, and
nothing that compute_force_grouped returns changes.

Configurations: small caps, so that some tiles of each fall back and some
do not, in float32 and float64, 2-D and 3-D, for both trees. The same
numpy-made bodies go through nbody_tpu's compute_force_grouped (its jnp
evaluation, which evaluates every tile before its fallback) and the
port's. Exact where nbody_tpu is exact: the counters max_nodes,
max_leaves and fallback_tiles. Forces within 1e-12 (float64) or 1e-5
(float32) of sum |a| of nbody_tpu's, the tolerance of
tests/test_torch_lists.py: both sum the same terms in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import cuda_group_eval as tge
from nbody_torch.ops import geometry as tgeo
from nbody_torch.ops import octree as to
from nbody_torch.ops import octree_group as tog
from nbody_torch.state import SystemState
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jo
from nbody_tpu.ops import octree_group as jog

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
CPU = torch.device("cpu")
N, TILE, CAPS, THETA = 2000, 128, 256, 0.5
CONFIGS = [(tree, dtype, dim) for tree in ("octree", "bvh")
           for dtype in (np.float32, np.float64) for dim in (2, 3)]
IDS = [f"{tree}-{np.dtype(dtype).name}-{dim}d" for tree, dtype, dim in CONFIGS]


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _clusters(dim, dtype, seed=23):
    """Nine Gaussian clusters, dense enough that small caps overflow."""
    rng = np.random.default_rng(seed + dim)
    centers = rng.uniform(-40, 40, (9, dim))
    x = centers[rng.integers(0, 9, N)] + rng.normal(0, 3.0, (N, dim))
    return rng.uniform(0.1, 1, N).astype(dtype), x.astype(dtype)


def _counters(info):
    return {k: int(info[k]) for k in ("max_nodes", "max_leaves", "fallback_tiles")}


def _port(tree, dtype, dim):
    """The port's compute_force_grouped args, kwargs and module for one
    configuration."""
    m, x = _clusters(dim, dtype)
    eps = _eps(dtype)
    kw = dict(tile=TILE, cap_nodes=CAPS, cap_leaves=CAPS)
    if tree == "octree":
        lo, hi = tgeo.scalar_bounds(torch.tensor(x))
        levels, _, ms, xs = to.build_octree(torch.tensor(m), torch.tensor(x), lo, hi,
                                            to.max_depth(N, dim))
        return tog, (levels, ms, xs, hi - lo, THETA, 1.0, eps), kw
    st = tb.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=CPU), eps)
    return tbg, (tb.build_tree(st.m, st.x, eps), st.m, st.x, THETA, 1.0, eps), kw


def _jax(tree, dtype, dim):
    """nbody_tpu's forces and counters on the same bodies (the BVH on the
    port's Hilbert order, as tests/test_torch_lists.py)."""
    m, x = _clusters(dim, dtype)
    eps = _eps(dtype)
    kw = dict(tile=TILE, cap_nodes=CAPS, cap_leaves=CAPS, use_pallas=False)
    if tree == "octree":
        lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
        jl, _, jms, jxs = jax.jit(jo.build_octree, static_argnums=4)(
            jnp.asarray(m), jnp.asarray(x), lo, hi, jo.max_depth(N, dim))
        a, info = jog.compute_force_grouped(jl, jms, jxs, hi - lo, THETA, 1.0, eps, **kw)
    else:
        st = tb.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=CPU), eps)
        ms, xs = jnp.asarray(st.m.numpy()), jnp.asarray(st.x.numpy())
        jtree = jax.jit(jb.build_tree, static_argnums=2)(ms, xs, eps)
        a, info = jbg.compute_force_grouped(jtree, ms, xs, THETA, 1.0, eps, **kw)
    return np.asarray(a), _counters(info)


@pytest.fixture
def recorded(monkeypatch):
    """The heads each list evaluation received and the tiles each exact
    fallback was given (both calls go through)."""
    seen = {}

    def wrap(module, name):
        fn = getattr(module, name)

        def call(*args, **kwargs):
            seen.setdefault(name, []).append(args)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, call)

    for module in (tog, tbg):
        wrap(module, "group_eval_cuda")
        wrap(module, "exact_fallback")
    return seen


@pytest.mark.parametrize("tree,dtype,dim", CONFIGS, ids=IDS)
def test_fallback_tiles_get_zero_heads(tree, dtype, dim, recorded):
    """The evaluation's heads are zero exactly on the tiles that the
    fallback is given, and those tiles' rows are what the fallback wrote."""
    module, args, kw = _port(tree, dtype, dim)
    a, info = module.compute_force_grouped(*args, **kw)
    (evaluation,), (fallback,) = recorded["group_eval_cuda"], recorded["exact_fallback"]
    n0, n1 = evaluation[6], evaluation[7]
    tile_over = fallback[2]
    assert 0 < int(tile_over.sum()) == int(info["fallback_tiles"]) < tile_over.numel()
    assert n0.dtype == n1.dtype == torch.int32
    assert not n0[tile_over].any() and not n1[tile_over].any()
    assert bool(((n0 + n1)[~tile_over] > 0).all())
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("tree,dtype,dim", CONFIGS, ids=IDS)
def test_skipping_changes_no_value(tree, dtype, dim, monkeypatch, recorded):
    """Evaluating every tile's heads, as nbody_tpu does, returns the same
    info and the same rows of the fallback's tiles bit for bit (the
    fallback writes them), and the other rows within TOL of sum |a|: the
    twin sums a chunk of tiles over the columns of its longest heads, so
    in float64 a row's last bits follow the other tiles' heads (the card's
    kernel sums each tile on its own)."""
    module, args, kw = _port(tree, dtype, dim)
    a, info = module.compute_force_grouped(*args, **kw)
    monkeypatch.setattr(module, "live_heads",
                        lambda ncnt, lcnt, tile_over: (ncnt.to(torch.int32), lcnt.to(torch.int32)))
    every, every_info = module.compute_force_grouped(*args, **kw)
    assert {k: int(v) for k, v in info.items()} == {k: int(v) for k, v in every_info.items()}
    over = recorded["exact_fallback"][0][2].repeat_interleave(TILE)[:N]
    assert torch.equal(a[over], every[over])
    assert ((a - every).abs().sum() / every.abs().sum()).item() < TOL[dtype]


@pytest.mark.parametrize("tree,dtype,dim", CONFIGS, ids=IDS)
def test_forces_and_counters_equal_nbody_tpu(tree, dtype, dim):
    module, args, kw = _port(tree, dtype, dim)
    ta, tinfo = module.compute_force_grouped(*args, **kw)
    ja, jinfo = _jax(tree, dtype, dim)
    assert _counters(tinfo) == jinfo and jinfo["fallback_tiles"] > 0
    ta = ta.numpy()
    assert ta.shape == ja.shape and ta.dtype == ja.dtype == dtype
    rel = np.abs(ta.astype(np.float64) - ja).sum() / np.abs(ja).sum()
    assert rel < TOL[dtype], rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_twin_gives_zeros_for_empty_heads(dtype):
    """A tile whose heads are both empty gets zeros from the twin, whatever
    its list holds; the other tiles' rows are those of their own lists."""
    rng = np.random.default_rng(31)
    ntiles, tb_, length, split = 4, 64, 300, 120
    xi = torch.tensor(rng.uniform(-1, 1, (ntiles * tb_, 3)), dtype=dtype)
    mj = torch.tensor(rng.uniform(0.1, 1, (ntiles, length)), dtype=dtype)
    xj = torch.tensor(rng.uniform(-2, 2, (ntiles, length, 3)), dtype=dtype)
    n0 = torch.tensor([50, 0, 120, 0], dtype=torch.int32)
    n1 = torch.tensor([30, 0, 0, 180], dtype=torch.int32)
    eps = float(torch.finfo(dtype).eps)
    out = tge.group_eval_torch(xi, mj, xj, eps, "poly", split, n0, n1)
    assert out.dtype == dtype and not out[tb_:2 * tb_].any()
    assert bool((out[:tb_] != 0).any(1).all()) and bool((out[3 * tb_:] != 0).any(1).all())
    alone = tge.group_eval_torch(xi[:tb_], mj[:1], xj[:1], eps, "poly", split, n0[:1], n1[:1])
    scale = tge.group_eval_torch(xi[:tb_], mj[:1], xj[:1], eps, "poly", split, n0[:1], n1[:1],
                                 absolute=True)
    tol = TOL[np.float32 if dtype == torch.float32 else np.float64]
    assert bool(((out[:tb_] - alone).abs() <= tol * scale).all())
    assert torch.equal(tge.group_eval_cuda(xi, mj, xj, eps, "poly", split, n0, n1), out)
