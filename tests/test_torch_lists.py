"""The trees' list paths of nbody_torch against nbody_tpu, on the CPU: the
octree's level tree, the group-eval twin, both trees' compute_force_grouped,
whole steps and the CLI in double precision.

The same numpy-made inputs go through both packages; nbody_tpu runs as
tests/conftest.py sets it up (float64 enabled): its jnp evaluation in
float64, and in float32 both the jnp evaluation and use_pallas="interpret".
Exact where nbody_tpu is exact: the level arrays of build_octree (every
integer array, and the masses and centres, which the CPU sums in the same
order), the counters max_nodes, max_leaves and fallback_tiles, and body
orders. Forces within 1e-12 (float64) or 1e-5 (float32) of sum |a| of
nbody_tpu's: both sum the same terms in other orders. The twin of the list
kernel is held within 1e-4 of each row's sum of |term| of
group_eval_pallas in interpret mode (whose approximate reciprocal is about
1e-5 off by itself, tests/test_torch_octree.py) and within 1e-5 (float32)
or 1e-12 (float64) of a float64 numpy evaluation.
"""

import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import cli as tcli
from nbody_torch.models import build_galaxy_model
from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import cuda_group_eval as tge
from nbody_torch.ops import geometry as tgeo
from nbody_torch.ops import octree as to
from nbody_torch.ops import octree_group as tog
from nbody_torch.state import SystemState
from nbody_tpu import cli as jcli
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jo
from nbody_tpu.ops import octree_group as jog
from nbody_tpu.ops import pallas_group_eval as jpg
from nbody_tpu.state import SystemState as JState

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
CPU = torch.device("cpu")


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _clusters(n, dim, dtype, seed=11):
    """Nine Gaussian clusters (the workload tests/test_trees.py:968-973 pins)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (9, dim))
    x = centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))
    return rng.uniform(0.1, 1, n).astype(dtype), x.astype(dtype)


def _galaxy(n, dim, dtype):
    _, s = build_galaxy_model(n, dim, dtype, CPU)
    return s.m.numpy(), s.x.numpy()


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------ build_octree

_jax_build_octree = jax.jit(jo.build_octree, static_argnums=4)


@pytest.mark.parametrize("n", [1, 2, 17, 513, 3000])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_octree_bit_equal(dtype, dim, n):
    """Every level array, caps and offsets bit for bit over the scalar
    box, with duplicated positions (bodies sharing a deepest cell) and a
    zero-mass body."""
    m, x = _clusters(n, dim, dtype, seed=n + dim)
    if n > 8:
        x[3:8] = x[2]
        m[1] = 0
    depth = jo.max_depth(n, dim)
    lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
    jl, jperm, jms, jxs = _jax_build_octree(jnp.asarray(m), jnp.asarray(x), lo, hi, depth)
    tlo, thi = tgeo.scalar_bounds(_t(x))
    tl, tperm, tms, txs = to.build_octree(_t(m), _t(x), tlo, thi, depth)
    assert (tl.caps, tl.offsets, tl.depth) == (jl.caps, jl.offsets, jl.depth)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    for name in ("start", "count", "child_start", "child_count", "parent", "mass", "com"):
        got, want = getattr(tl, name).numpy(), np.asarray(getattr(jl, name))
        assert got.dtype.kind == want.dtype.kind and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tms.numpy(), np.asarray(jms))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))


# ------------------------------------------------------- the group-eval twin


def _list_case(dim, dtype, seed, ntiles=5, tb=128, cap_nodes=600, length=1000):
    """Rows, and per-tile lists of `length` entries in two segments (nodes
    [0, cap_nodes), leaf bodies after) whose live heads n0, n1 are random,
    with mass-0 padding after them, a tile whose lists are empty and one
    whose node segment is full."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(-1, 1, (ntiles * tb, dim)).astype(dtype)
    xj = rng.uniform(-1.5, 1.5, (ntiles, length, dim)).astype(dtype)
    mj = rng.uniform(0.1, 1, (ntiles, length)).astype(dtype)
    n0 = rng.integers(0, cap_nodes + 1, ntiles).astype(np.int32)
    n1 = rng.integers(0, length - cap_nodes + 1, ntiles).astype(np.int32)
    n0[1], n1[1] = 0, 0
    n0[2] = cap_nodes
    lane = np.arange(length)[None, :]
    live = (lane < n0[:, None]) | ((lane >= cap_nodes) & (lane < cap_nodes + n1[:, None]))
    mj = np.where(live, mj, 0).astype(dtype)
    return xi, mj, xj, n0, n1, live


def _numpy_sums(xi, mj, xj, live, eps, softening):
    """float64 force sum_j m_j (x_j - x_i) / t over each tile's live list
    entries, and its scale sum_j |term|."""
    ntiles = mj.shape[0]
    tb = xi.shape[0] // ntiles
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for t in range(ntiles):
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[t][live[t]][None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        r = np.sqrt(d2)
        w = mj[t][live[t]][None, :] / ((r + eps) ** 3 if softening == "sqrt3" else d2 * r + eps)
        force[rows] = np.einsum("kn,knd->kd", w, d)
        scale[rows] = np.einsum("kn,knd->kd", np.abs(w), np.abs(d))
    return force, scale


def _within(got, ref, scale, tol):
    err = np.abs(np.asarray(got, np.float64) - ref)
    assert np.all(np.isfinite(got)) and np.all(err <= tol * scale), \
        float(np.max(err / np.maximum(scale, 1e-300)))


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
def test_group_eval_twin_vs_pallas(softening):
    """L = 1,000 (not a multiple of the TPU's 1,024) with mass-0 padding:
    the twin over the live heads against group_eval_pallas in interpret
    mode over the whole padded list, and both against float64 numpy."""
    eps = _eps(np.float32)
    xi, mj, xj, n0, n1, live = _list_case(3, np.float32, seed=3 + len(softening))
    ref = np.asarray(jpg.group_eval_pallas(jnp.asarray(xi), jnp.asarray(mj),
                                           jnp.asarray(np.swapaxes(xj, 1, 2)), eps,
                                           interpret=True, softening=softening))
    got = tge.group_eval_cuda(_t(xi), _t(mj), _t(xj), eps, softening, 600, _t(n0),
                              _t(n1)).numpy()
    exact, scale = _numpy_sums(xi, mj, xj, live, eps, softening)
    _within(got, exact, scale, TOL[np.float32])
    _within(ref, exact, scale, 1e-4)
    _within(got, ref.astype(np.float64), scale, 1e-4)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_group_eval_live_heads(dtype, dim):
    """Visiting only the live heads [0, n0) and [split, split + n1) gives
    the result of the whole padded segments (the twin's float64 sums round
    the same terms in other groupings, so within TOL of sum |term|, as is
    each against float64 numpy); an empty tile gets zeros; the wrapper
    runs the twin on CPU tensors."""
    eps = _eps(dtype)
    for softening in ("poly", "sqrt3"):
        xi, mj, xj, n0, n1, live = _list_case(dim, dtype, seed=7 * dim)
        exact, scale = _numpy_sums(xi, mj, xj, live, eps, softening)
        args = (_t(xi), _t(mj), _t(xj), eps, softening)
        heads = tge.group_eval_cuda(*args, 600, _t(n0), _t(n1))
        whole = tge.group_eval_torch(*args, 600, torch.full((5,), 600, dtype=torch.int32),
                                     torch.full((5,), 400, dtype=torch.int32))
        assert heads.dtype == torch.from_numpy(xi).dtype
        assert torch.equal(heads, tge.group_eval_torch(*args, 600, _t(n0), _t(n1)))
        _within(heads.numpy(), whole.numpy().astype(np.float64), scale, TOL[dtype])
        assert not heads[128:256].any()
        for got in (heads, whole):
            _within(got.numpy(), exact, scale, TOL[dtype])
        absolute = tge.group_eval_torch(*args, 600, _t(n0), _t(n1), absolute=True)
        np.testing.assert_allclose(absolute.numpy(), scale, rtol=1e-5)


def test_group_eval_checks_its_inputs():
    xi, mj, xj, n0, n1, _ = _list_case(3, np.float32, seed=1)
    args = (_t(xi), _t(mj), _t(xj), 1e-7, "poly")
    with pytest.raises(ValueError):
        tge.group_eval_cuda(_t(xi), _t(mj), _t(xj[:, :, :2]), 1e-7, "poly", 600, _t(n0), _t(n1))
    with pytest.raises(ValueError):
        tge.group_eval_cuda(*args, 1001, _t(n0), _t(n1))
    with pytest.raises(TypeError):
        tge.group_eval_cuda(*args, 600, _t(n0).long(), _t(n1))
    with pytest.raises(ValueError):
        tge.group_eval_cuda(_t(xi), _t(mj), _t(xj), 1e-7, "cubic", 600, _t(n0), _t(n1))


# ------------------------------------------------- the two list paths


def _inputs(workload, n, dim, dtype):
    return (_galaxy if workload == "galaxy" else _clusters)(n, dim, dtype)


# name -> (workload, n, dim, dtype, tile, caps, theta, nbody_tpu's evaluation):
# default caps, small caps that send tiles to the exact fallback, 128- and
# 512-row tiles, float32 through the jnp evaluation and the Pallas kernel in
# interpret mode, and theta = 0 (every node opened, caps max(n, 64))
CONFIGS = {
    "galaxy-20000-3d-f64": ("galaxy", 20000, 3, np.float64, 512, (None, None), 0.5, False),
    "clusters-3000-2d-f64-caps256": ("clusters", 3000, 2, np.float64, 128, (256, 256), 0.5,
                                     False),
    "clusters-5000-3d-f32-jnp": ("clusters", 5000, 3, np.float32, 512, (None, None), 0.5, False),
    "clusters-5000-3d-f32-interpret": ("clusters", 5000, 3, np.float32, 512, (None, None), 0.5,
                                       "interpret"),
    "galaxy-700-3d-f64-theta0": ("galaxy", 700, 3, np.float64, 128, (None, None), 0.0, False),
}


def _counters(info):
    return {k: int(info[k]) for k in ("max_nodes", "max_leaves", "fallback_tiles")}


@pytest.fixture(scope="module")
def octree_runs():
    """Both packages' octree compute_force_grouped on each configuration,
    on the same levels; cached for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            workload, n, dim, dtype, tile, (cn, cl), theta, pallas = CONFIGS[name]
            m, x = _inputs(workload, n, dim, dtype)
            depth = jo.max_depth(n, dim)
            lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
            jl, _, jms, jxs = _jax_build_octree(jnp.asarray(m), jnp.asarray(x), lo, hi, depth)
            ja, jinfo = jog.compute_force_grouped(jl, jms, jxs, hi - lo, theta, 1.0, _eps(dtype),
                                                  tile=tile, cap_nodes=cn, cap_leaves=cl,
                                                  use_pallas=pallas)
            tlo, thi = tgeo.scalar_bounds(_t(x))
            tl, _, tms, txs = to.build_octree(_t(m), _t(x), tlo, thi, depth)
            args = (tl, tms, txs, thi - tlo, theta, 1.0, _eps(dtype))
            ta, tinfo = tog.compute_force_grouped(*args, tile=tile, cap_nodes=cn, cap_leaves=cl)
            cache[name] = (np.asarray(ja), _counters(jinfo), ta.numpy(), _counters(tinfo),
                           (args, dict(tile=tile, cap_nodes=cn, cap_leaves=cl)))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def bvh_runs():
    """Both packages' BVH compute_force_grouped on each configuration, on
    the same Hilbert-sorted bodies; cached for the module."""
    cache = {}

    def get(name):
        if name not in cache:
            workload, n, dim, dtype, tile, (cn, cl), theta, pallas = CONFIGS[name]
            m, x = _inputs(workload, n, dim, dtype)
            st = tb.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=CPU),
                                 _eps(dtype))
            ms, xs = st.m.numpy(), st.x.numpy()
            jtree = jax.jit(jb.build_tree, static_argnums=2)(jnp.asarray(ms), jnp.asarray(xs),
                                                             _eps(dtype))
            ja, jinfo = jbg.compute_force_grouped(jtree, jnp.asarray(ms), jnp.asarray(xs), theta,
                                                  1.0, _eps(dtype), tile=tile, cap_nodes=cn,
                                                  cap_leaves=cl, use_pallas=pallas)
            ttree = tb.build_tree(st.m, st.x, _eps(dtype))
            ta, tinfo = tbg.compute_force_grouped(ttree, st.m, st.x, theta, 1.0, _eps(dtype),
                                                  tile=tile, cap_nodes=cn, cap_leaves=cl)
            cache[name] = (np.asarray(ja), _counters(jinfo), ta.numpy(), _counters(tinfo))
        return cache[name]

    return get


def _assert_forces(ta, ja, dtype):
    assert ta.shape == ja.shape and ta.dtype == ja.dtype == dtype
    rel = np.abs(ta.astype(np.float64) - ja).sum() / np.abs(ja).sum()
    assert rel < TOL[dtype], rel


@pytest.mark.parametrize("name", list(CONFIGS))
def test_octree_lists_vs_nbody_tpu(name, octree_runs):
    """max_nodes, max_leaves and fallback_tiles equal; forces within TOL of
    sum |a|."""
    ja, jinfo, ta, tinfo, _ = octree_runs(name)
    assert tinfo == jinfo
    _assert_forces(ta, ja, CONFIGS[name][3])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bvh_lists_vs_nbody_tpu(name, bvh_runs):
    ja, jinfo, ta, tinfo = bvh_runs(name)
    assert tinfo == jinfo
    _assert_forces(ta, ja, CONFIGS[name][3])


def test_list_configurations_reach_the_fallback(octree_runs, bvh_runs):
    """Small caps send tiles to the exact fallback in both trees, and the
    20,000-body galaxy's lists stay within the default caps for most tiles."""
    for runs in (octree_runs, bvh_runs):
        assert runs("clusters-3000-2d-f64-caps256")[3]["fallback_tiles"] > 0
        info = runs("galaxy-20000-3d-f64")[3]
        assert info["max_nodes"] > 0 and info["fallback_tiles"] < 20000 // 512


@pytest.mark.parametrize("name", ["galaxy-20000-3d-f64", "clusters-3000-2d-f64-caps256"])
def test_octree_chunked_traversal_equals_unchunked(name, octree_runs):
    """The traversal over chunks of 3 tiles gives the result of one pass
    over all tiles (the default chunk of 256 holds these 40 and 24 tiles)
    bit for bit."""
    *_, ta, tinfo, (args, kw) = octree_runs(name)
    assert -(-args[1].shape[0] // kw["tile"]) <= tog.TILE_CHUNK
    a, info = tog.compute_force_grouped(*args, **kw, tile_chunk=3)
    assert _counters(info) == tinfo
    assert np.array_equal(a.numpy(), ta)


@pytest.mark.parametrize("tree", ["octree", "bvh"])
def test_plain_evaluation_equals_the_wrappers_on_cpu(tree, octree_runs, bvh_runs):
    """use_cuda=False (--kernel torch) calls the twins directly: on CPU
    tensors, where the wrappers run the same twins, the results are equal."""
    name = "clusters-3000-2d-f64-caps256"
    if tree == "octree":
        *_, ta, _, (args, kw) = octree_runs(name)
        a, _ = tog.compute_force_grouped(*args, **kw, use_cuda=False)
    else:
        _, _, ta, _ = bvh_runs(name)
        workload, n, dim, dtype, tile, (cn, cl), theta, _ = CONFIGS[name]
        m, x = _inputs(workload, n, dim, dtype)
        st = tb.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=CPU),
                             _eps(dtype))
        a, _ = tbg.compute_force_grouped(tb.build_tree(st.m, st.x, _eps(dtype)), st.m, st.x,
                                         theta, 1.0, _eps(dtype), tile=tile, cap_nodes=cn,
                                         cap_leaves=cl, use_cuda=False)
    assert np.array_equal(a.numpy(), ta)


# ---------------------------------------------------------- whole steps


@pytest.mark.parametrize("dim", [2, 3])
def test_octree_step_force_list_branch(dim):
    """One float64 step through both octree_step_force list branches: the
    caller's body order kept, the same tree size and root mass, forces
    within 1e-12 of sum |a|."""
    n = 3000
    m, x = _galaxy(n, dim, np.float64)
    v = np.random.default_rng(dim).normal(size=x.shape)
    eps = _eps(np.float64)
    depth = jo.max_depth(n, dim)
    js = JState(m=jnp.asarray(m), x=jnp.asarray(x), v=jnp.asarray(v), a=jnp.asarray(v * 0),
                ao=jnp.asarray(v * 2))
    jout, _, jaux = jo.octree_step_force(js, 0.5, 1.0, eps, depth, traversal="group")
    ts = SystemState.from_numpy(m, x, v, v * 0, v * 2, device=CPU)
    tout, taux = to.octree_step_force(ts, 0.5, 1.0, eps, depth, list_path=True)
    for name in ("m", "x", "v", "ao"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)))
    assert int(taux["tree_size"]) == int(jaux["tree_size"])
    assert float(taux["root_mass"]) == float(jaux["root_mass"])
    assert int(taux["overflow"]) == int(jaux["overflow"]) == 0
    _assert_forces(tout.a.numpy(), np.asarray(jout.a), np.float64)


@pytest.mark.parametrize("dim", [2, 3])
def test_bvh_step_force_list_branch(dim):
    """One float64 step through both bvh_step_force list branches: the
    same permuted state bit for bit, the same root mass, forces within
    1e-12 of sum |a|."""
    n = 3000
    m, x = _galaxy(n, dim, np.float64)
    v = np.random.default_rng(dim).normal(size=x.shape)
    eps = _eps(np.float64)
    js = JState(m=jnp.asarray(m), x=jnp.asarray(x), v=jnp.asarray(v), a=jnp.asarray(v * 0),
                ao=jnp.asarray(v * 2))
    jout, jtree, jaux = jb.bvh_step_force(js, 0.5, 1.0, eps, traversal="group")
    ts = SystemState.from_numpy(m, x, v, v * 0, v * 2, device=CPU)
    tout, taux = tb.bvh_step_force(ts, 0.5, 1.0, eps, list_path=True)
    for name in ("m", "x", "v", "ao"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)))
    assert float(taux["root_mass"]) == float(jaux["root_mass"]) == float(np.asarray(jtree.mm)[0])
    _assert_forces(tout.a.numpy(), np.asarray(jout.a), np.float64)


# ----------------------------------------------------------------- the CLI

NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")


def _cli(main, argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    assert main(list(argv), out=out) == 0
    return out.getvalue()


@pytest.mark.parametrize("algorithm", ["octree", "bvh"])
def test_cli_double_precision_like_jax(algorithm, tmp_path, monkeypatch):
    """--precision double with --print-state, --print-info and
    --csv-detailed: nbody_tpu.cli takes the same list path on the CPU. The
    same header and tree sizes, the same body order (the bvh's Hilbert
    order), values within 1e-12 relative."""
    argv = ["-n", "64", "-s", "3", "-d", "3", "--workload", "galaxy", "--algorithm", algorithm,
            "--precision", "double", "--print-state", "--print-info", "--csv-detailed"]
    j = _cli(jcli.main, argv, tmp_path, monkeypatch).splitlines()
    t = _cli(tcli.main, [*argv, "--device", "cpu"], tmp_path, monkeypatch).splitlines()
    timing = f"{algorithm},3,64,3,64,"
    assert [ln for ln in t if ln.startswith(timing)] and len(t) == len(j)
    jl = [ln for ln in j if not ln.startswith(timing)]
    tl = [ln for ln in t if not ln.startswith(timing)]
    assert [NUM.sub("#", ln) for ln in tl] == [NUM.sub("#", ln) for ln in jl]
    assert [ln for ln in tl if ln.startswith(("Tree", "Total", "algorithm"))] == \
        [ln for ln in jl if ln.startswith(("Tree", "Total", "algorithm"))]
    tn = np.array([float(v) for v in NUM.findall("\n".join(tl))])
    jn = np.array([float(v) for v in NUM.findall("\n".join(jl))])
    np.testing.assert_allclose(tn, jn, rtol=1e-12, atol=0)
    if algorithm == "octree":
        assert "Tree init complete" in tl and any(ln.startswith("Tree size: ") for ln in tl)
