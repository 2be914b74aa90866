"""The octree's per-body walk of nbody_torch against nbody_tpu, on the CPU.

nbody_tpu's jitted octree_step_force(traversal="per-body") and its level
build run once per case (a module-scoped cache). The port's plain twin
walks nbody_tpu's Morton-sorted bodies over nbody_tpu's levels
(OctreeLevels.from_numpy); the port's whole octree_step_force(traversal=
"per-body") starts from the same state. Each row's force is held within
1e-5 (float32) or 1e-12 (float64) of its sum of |term| (the twin's
detail); the aux's tree size and root mass are nbody_tpu's.

The inputs hold a zero-mass body at the exact origin and a duplicate
position (two bodies that share every cell down to the deepest level,
whose queue the walk drains, the self-pair included); theta = 0 accepts
only one-body nodes, and then the walk equals the direct sum with the
octree's softening (sqrt(d2) + eps)^3.
"""

import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import cli as tcli
from nbody_torch.models import build_model as tbuild
from nbody_torch.ops import allpairs as tap
from nbody_torch.ops import cuda_tree_walk as tw
from nbody_torch.ops import octree as to
from nbody_torch.ops.geometry import scalar_bounds
from nbody_torch.ops.permutation import unpermute_rows
from nbody_torch.sim import engines as te
from nbody_torch.state import SystemState
from nbody_tpu import cli as jcli
from nbody_tpu.models import build_model as jbuild
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jo
from nbody_tpu.sim import engines as je
from nbody_tpu.state import SystemState as JState

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")
CASES = [(n, dim, dtype) for n in (1, 2, 7, 300) for dim in (2, 3)
         for dtype in (np.float32, np.float64)]
_jax_build = jax.jit(jo.build_octree, static_argnums=4)


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _bodies(n, dim, dtype, seed=7):
    """Gaussian bodies, with body 1 on body 0 and the last body massless at
    the origin (n >= 3)."""
    rng = np.random.default_rng(seed + n + dim)
    x = rng.normal(0, 2, (n, dim))
    m = rng.uniform(0.1, 1, n)
    v = rng.normal(0, 0.1, (n, dim))
    if n >= 3:
        x[1] = x[0]
        x[-1], m[-1] = 0, 0
    return m.astype(dtype), x.astype(dtype), v.astype(dtype)


_cache = {}


def _jax_per_body(js, theta, G, eps):
    """nbody_tpu's per-body octree_step_force on its state js: (its a, its
    aux, and the port's levels, sorted bodies, perm and root side made
    from nbody_tpu's build)."""
    m, x = js.m, js.x
    depth = jo.max_depth(*x.shape)
    out, _, aux = jo.octree_step_force(js, theta, G, eps, depth, traversal="per-body")
    lo, hi = jgeo.scalar_bounds(x)
    lv, perm, ms, xs = _jax_build(m, x, lo, hi, depth)
    levels = to.OctreeLevels.from_numpy(lv.mass, lv.com, lv.start, lv.count, lv.child_start,
                                        lv.child_count, lv.parent, lv.offsets, lv.caps, lv.depth)
    return (np.asarray(out.a), {k: np.asarray(a) for k, a in aux.items()},
            (levels, torch.tensor(np.asarray(ms)), torch.tensor(np.asarray(xs)),
             torch.tensor(np.asarray(perm)).long(), torch.tensor(np.asarray(hi - lo))))


def _jax_case(n, dim, dtype, theta):
    """(inputs, nbody_tpu's step output a, its aux, and the port's levels,
    sorted bodies, perm and root side made from nbody_tpu's build)."""
    key = (n, dim, dtype, theta)
    if key not in _cache:
        m, x, v = _bodies(n, dim, dtype)
        js = JState(m=jnp.asarray(m), x=jnp.asarray(x), v=jnp.asarray(v),
                    a=jnp.zeros_like(jnp.asarray(x)), ao=jnp.zeros_like(jnp.asarray(x)))
        _cache[key] = ((m, x, v), *_jax_per_body(js, theta, 1.0, _eps(dtype)))
    return _cache[key]


def _walk(tree, dtype, theta, rows=None, G=1.0):
    """The twin over the case's tree: (a, scale, counts) in the caller's
    order (unpermuted)."""
    levels, ms, xs, perm, side = tree
    a, scale, counts = tw.octree_walk_torch(levels, ms, xs, side, theta, G, _eps(dtype), rows,
                                            detail=True)
    return unpermute_rows(a, perm), unpermute_rows(scale, perm), counts


def _uniform_run(dim, steps=10):
    """The CLI's default model (the uniform box, -n 200, float32) stepped
    `steps` times by nbody_tpu's per-body octree engine and, from the same
    start, by the port's. Per step k, from nbody_tpu's state at k: the
    port's whole octree_step_force (its own level build) and its twin over
    nbody_tpu's levels, each one's max over rows of |a - nbody_tpu's a| /
    sum |term| ("step_err", "walk_err"); whether the port's Morton sort
    kept nbody_tpu's order; the max |com| difference of the two builds;
    the rows whose accepted nodes or direct pairs differ between the walks
    over the two trees ("flipped_rows"); and the free runs' max |x -
    nbody_tpu's x| / max |x| after step k ("free_x")."""
    key = ("uniform", dim, steps)
    if key in _cache:
        return _cache[key]
    cpu = torch.device("cpu")
    jcfg, js = jbuild("uniform", 200, dim, np.float32)
    tcfg, ts = tbuild("uniform", 200, dim, np.float32, device=cpu)
    theta, G, eps = float(jcfg.theta), float(jcfg.G), jcfg.eps
    depth = to.max_depth(200, dim)
    jstep = je.get_engine("octree").make_step(jcfg, je.EngineOptions(traversal="per-body"))
    tstep = te.get_engine("octree").make_step(tcfg, te.EngineOptions(traversal="per-body"), cpu)
    rows = []
    for k in range(steps):
        ja, _, tree = _jax_per_body(js, theta, G, eps)
        start = SystemState.from_numpy(*(np.asarray(getattr(js, f)) for f in "mxv"), device=cpu)
        out, _ = to.octree_step_force(start, theta, G, eps, depth, traversal="per-body")
        a_walk, scale, counts = _walk(tree, np.float32, theta, G=G)
        own, perm, ms, xs = to.build_octree(start.m, start.x, *scalar_bounds(start.x), depth)
        _, _, own_counts = tw.octree_walk_torch(own, ms, xs, tree[4], theta, G, eps, detail=True)
        flipped = ((counts["nodes"] != own_counts["nodes"])
                   | (counts["pairs"] != own_counts["pairs"]))
        js, _ = jstep(js, k)
        ts, _ = tstep(ts, k)
        jx = np.asarray(js.x)
        rows.append({
            "step_err": float((np.abs(out.a.numpy() - ja) / scale.numpy()).max()),
            "walk_err": float((np.abs(a_walk.numpy() - ja) / scale.numpy()).max()),
            "order_equal": bool(torch.equal(perm, tree[3])),
            "com_diff": float((own.com - tree[0].com).abs().max()),
            "flipped_rows": torch.nonzero(flipped).flatten().tolist(),
            "free_x": float(np.abs(ts.x.numpy() - jx).max() / np.abs(jx).max())})
    _cache[key] = rows
    return rows


def _within(got, ref, scale, dtype):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= TOL[dtype] * np.asarray(scale, np.float64)), (err / scale).max()


@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_twin_vs_nbody_tpu_walk(n, dim, dtype):
    """The twin over nbody_tpu's levels and sorted bodies: nbody_tpu's
    forces within the tolerance of each row's sum of |term|."""
    _, ja, _, tree = _jax_case(n, dim, dtype, 0.5)
    a, scale, counts = _walk(tree, dtype, 0.5)
    assert a.shape == (n, dim) and a.dtype == tree[2].dtype
    _within(a.numpy(), ja, scale.numpy(), dtype)
    assert bool((counts["nodes"] + counts["pairs"] > 0).all())  # the root at least


@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_step_force_per_body_vs_nbody_tpu(n, dim, dtype):
    """The whole octree_step_force(traversal="per-body"): the caller's
    order kept, forces within the tolerance, tree size, root mass and
    overflow as nbody_tpu's."""
    (m, x, v), ja, jaux, tree = _jax_case(n, dim, dtype, 0.5)
    ts = SystemState.from_numpy(m, x, v, device=torch.device("cpu"))
    depth = to.max_depth(n, dim)
    out, aux = to.octree_step_force(ts, 0.5, 1.0, _eps(dtype), depth, traversal="per-body")
    np.testing.assert_array_equal(out.x.numpy(), x)
    _, scale, _ = _walk(tree, dtype, 0.5)
    _within(out.a.numpy(), ja, scale.numpy(), dtype)
    assert int(aux["tree_size"]) == int(jaux["tree_size"])
    assert float(aux["root_mass"]) == float(jaux["root_mass"])
    assert int(aux["overflow"]) == int(jaux["overflow"]) == 0


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_theta0_walk_is_the_direct_sum(dim, dtype):
    """theta = 0: only one-body nodes are accepted and the deepest shared
    cells drain, so every body meets every other once: the sqrt3 direct
    sum within the tolerance, and nbody_tpu's theta = 0 walk too."""
    (m, x, _), ja, _, tree = _jax_case(300, dim, dtype, 0.0)
    a, scale, counts = _walk(tree, dtype, 0.0)
    assert bool((counts["nodes"] + counts["pairs"] == 300).all())
    assert int(counts["pairs"].sum()) > 0  # the duplicate pair's cell drains
    x = torch.tensor(x)
    w, d = tap.pair_terms(x, torch.tensor(m), x, _eps(dtype), "sqrt3")
    _within(a.numpy(), tap.sum_terms(w, d).numpy(), scale.numpy(), dtype)
    _within(a.numpy(), ja, scale.numpy(), dtype)


def test_rows_walk_those_bodies_and_the_wrapper_routes_cpu_to_the_twin():
    """rows: the same rows of the full walk, bit for bit; the wrapper on
    CPU tensors runs the twin (a twin call, no launch); bad inputs raise."""
    _, _, _, (levels, ms, xs, _, side) = _jax_case(300, 3, np.float32, 0.5)
    tw.reset_launch_counts()
    full = tw.octree_walk_cuda(levels, ms, xs, side, 0.5, 2.0, 1e-7)
    rows = torch.tensor([299, 0, 17, 17, 150])
    assert torch.equal(tw.octree_walk_cuda(levels, ms, xs, side, 0.5, 2.0, 1e-7, rows),
                       full[rows])
    assert tw.launch_counts == {tw.BVH_WALK: 0, tw.OCTREE_WALK: 0, tw.OCTREE_PACK: 0}
    assert tw.twin_calls == {tw.BVH_WALK: 0, tw.OCTREE_WALK: 2, tw.OCTREE_PACK: 0}
    with pytest.raises(ValueError):
        tw.octree_walk_cuda(levels, ms, xs, side[None], 0.5, 1.0, 1e-7)
    with pytest.raises(ValueError):
        tw.octree_walk_cuda(levels, ms.double(), xs, side, 0.5, 1.0, 1e-7)
    bad = to.OctreeLevels(**{**levels.__dict__, "count": levels.count.int()})
    with pytest.raises(TypeError):
        tw.octree_walk_cuda(bad, ms, xs, side, 0.5, 1.0, 1e-7)


def _cli_outputs(argv):
    """The lines the port's CLI (--device cpu) and nbody_tpu's print for
    argv, but the total time."""
    outs = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        out = io.StringIO()
        assert main([*argv, *extra], out=out) == 0
        outs.append([ln for ln in out.getvalue().splitlines() if not ln.startswith("Total time")])
    return outs


@pytest.mark.parametrize("dim", [2, 3])
def test_uniform_box_one_step_float32(dim):
    """One per-body step on the uniform box (-n 200, float32): the port's
    whole octree_step_force from nbody_tpu's start state sorts as it does,
    and its forces are within 1e-5 of each row's sum of |term|."""
    first = _uniform_run(dim)[0]
    assert first["order_equal"]
    assert first["step_err"] <= TOL[np.float32] and first["walk_err"] <= TOL[np.float32]


@pytest.mark.parametrize("dim", [2, 3])
def test_uniform_box_walk_every_step_float32(dim):
    """Along nbody_tpu's 10 uniform-box steps (the CLI's warmup), the twin
    over nbody_tpu's levels stays within 1e-5 of each row's sum of |term|
    at every step, and the port's whole step (its own level build) leaves
    that tolerance only on a step where a row's accepted nodes or direct
    pairs differ between the two trees (a MAC test flipped by a centre of
    mass a float32 ulp apart)."""
    for k, r in enumerate(_uniform_run(dim)):
        assert r["order_equal"] and r["walk_err"] <= TOL[np.float32], (k, r)
        assert r["step_err"] <= TOL[np.float32] or r["flipped_rows"], (k, r)


@pytest.mark.parametrize("dim", ["2", "3"])
def test_cli_per_body_float_vs_nbody_tpu(dim, tmp_path, monkeypatch):
    """python -m nbody_torch.cli --algorithm octree --traversal per-body in
    float32 against nbody_tpu's CLI (-n 200 -s 2, --print-state
    --print-info, the galaxy; see tests/test_torch_perbody_bvh.py for why
    not the uniform box, and python tests/test_torch_perbody_octree.py
    for this tree's reading there): the same lines, the printed values (4
    significant digits) within 1e-3 relative."""
    monkeypatch.chdir(tmp_path)
    argv = ["-n", "200", "-s", "2", "-d", dim, "--algorithm", "octree", "--traversal",
            "per-body", "--workload", "galaxy", "--print-state", "--print-info"]
    t, j = _cli_outputs(argv)
    assert [NUM.sub("#", ln) for ln in t] == [NUM.sub("#", ln) for ln in j]
    nums = [np.array([float(v) for v in NUM.findall("\n".join(lines))]) for lines in (t, j)]
    np.testing.assert_allclose(nums[0], nums[1], rtol=1e-3, atol=1e-6)
    assert sum("Tree size" in ln for ln in t) == 10


if __name__ == "__main__":
    # the uniform-box reading: PYTHONPATH=. python tests/test_torch_perbody_octree.py
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
    for dim in (3, 2):
        for k, r in enumerate(_uniform_run(dim, steps=12)):
            print(f"octree {dim}-D step {k}: whole step {r['step_err']:.3e}, walk over "
                  f"nbody_tpu's levels {r['walk_err']:.3e} (of sum |term|), order equal "
                  f"{r['order_equal']}, max |com diff| {r['com_diff']:.3e}, flipped rows "
                  f"{r['flipped_rows']}; free runs max |x diff| / max |x| {r['free_x']:.3e}")
        t, j = _cli_outputs(["-n", "200", "-s", "2", "-d", str(dim), "--algorithm", "octree",
                             "--traversal", "per-body", "--print-state", "--print-info"])
        got, ref = (np.array([float(v) for v in NUM.findall("\n".join(lines))])
                    for lines in (t, j))
        diff = np.abs(got - ref)
        print(f"octree {dim}-D uniform box, the float CLI after its 10 steps: text equal "
              f"{[NUM.sub('#', ln) for ln in t] == [NUM.sub('#', ln) for ln in j]}, "
              f"{int((diff > 1e-3 * np.abs(ref) + 1e-6).sum())} of {got.size} printed values "
              f"outside 1e-3 relative (+1e-6), max relative difference "
              f"{(diff / np.maximum(np.abs(ref), 1e-6)).max():.3e}")
