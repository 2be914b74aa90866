"""The BVH's per-body walk of nbody_torch against nbody_tpu, on the CPU.

nbody_tpu's jitted bvh_step_force(traversal="per-body") runs once per
case (a module-scoped cache): its sorted state, its tree and its forces.
The port's plain twin walks the same sorted bodies over the same tree
(BVHTree.from_numpy); the port's whole bvh_step_force(traversal=
"per-body") starts from the same unsorted state. Each row's force is held
within 1e-5 (float32) or 1e-12 (float64) of its sum of |term| (the twin's
detail): both sum the same terms in the same order, but XLA and torch may
round a product into a sum differently. The sorted state is bit-equal.

The inputs hold a zero-mass body at the exact origin (as the galaxy model
leaves an odd n's last body: it makes dead heap nodes) and a duplicate
position; theta = 0 opens every node, and then the walk equals the direct
sum with the BVH's softening d2 sqrt(d2) + eps.
"""

import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import cli as tcli
from nbody_torch.models import build_model as tbuild
from nbody_torch.ops import allpairs as tap
from nbody_torch.ops import bvh as tb
from nbody_torch.ops import cuda_tree_walk as tw
from nbody_torch.sim import engines as te
from nbody_torch.state import SystemState
from nbody_tpu import cli as jcli
from nbody_tpu.models import build_model as jbuild
from nbody_tpu.ops import bvh as jb
from nbody_tpu.sim import engines as je
from nbody_tpu.state import SystemState as JState

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")
CASES = [(n, dim, dtype) for n in (1, 2, 7, 300) for dim in (2, 3)
         for dtype in (np.float32, np.float64)]


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _bodies(n, dim, dtype, seed=5):
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
    """nbody_tpu's per-body bvh_step_force on its state js: (its sorted
    state as numpy, its tree, its aux)."""
    out, tree, aux = jb.bvh_step_force(js, theta, G, eps, traversal="per-body")
    return ({k: np.asarray(getattr(out, k)) for k in ("m", "x", "v", "a")}, tree,
            {k: np.asarray(val) for k, val in aux.items()})


def _jax_step(n, dim, dtype, theta):
    """nbody_tpu's per-body step on _bodies: (inputs, its sorted state as
    numpy, its tree, its aux)."""
    key = (n, dim, dtype, theta)
    if key not in _cache:
        m, x, v = _bodies(n, dim, dtype)
        js = JState(m=jnp.asarray(m), x=jnp.asarray(x), v=jnp.asarray(v),
                    a=jnp.zeros_like(jnp.asarray(x)), ao=jnp.zeros_like(jnp.asarray(x)))
        _cache[key] = ((m, x, v), *_jax_per_body(js, theta, 1.0, _eps(dtype)))
    return _cache[key]


def _walk(tree, ms, xs, dtype, theta, rows=None, G=1.0):
    t = tb.BVHTree.from_numpy(tree.mm, tree.mx, tree.bw, tree.nlevels)
    return tw.bvh_walk_torch(t.mm, t.mx, t.bw, t.nlevels, torch.tensor(ms), torch.tensor(xs),
                             theta, G, _eps(dtype), rows=rows, detail=True)


def _uniform_run(dim, steps=10):
    """The CLI's default model (the uniform box, -n 200, float32) stepped
    `steps` times by nbody_tpu's per-body BVH engine and, from the same
    start, by the port's. Per step k, from nbody_tpu's state at k: the
    port's whole bvh_step_force (its own sort and refit) and its twin over
    nbody_tpu's tree, each one's max over rows of |a - nbody_tpu's a| / sum
    |term| ("step_err", "walk_err"); whether the port's sort kept
    nbody_tpu's order; the max |com| difference of the two refits; the
    rows whose accepted nodes or direct pairs differ between the walks
    over the two trees ("flipped_rows"); and the free runs' max |x -
    nbody_tpu's x| / max |x| after step k ("free_x")."""
    key = ("uniform", dim, steps)
    if key in _cache:
        return _cache[key]
    cpu = torch.device("cpu")
    jcfg, js = jbuild("uniform", 200, dim, np.float32)
    tcfg, ts = tbuild("uniform", 200, dim, np.float32, device=cpu)
    theta, G, eps = float(jcfg.theta), float(jcfg.G), jcfg.eps
    jstep = je.get_engine("bvh").make_step(jcfg, je.EngineOptions(traversal="per-body"))
    tstep = te.get_engine("bvh").make_step(tcfg, te.EngineOptions(traversal="per-body"), cpu)
    rows = []
    for k in range(steps):
        jout, jtree, _ = _jax_per_body(js, theta, G, eps)
        start = SystemState.from_numpy(*(np.asarray(getattr(js, f)) for f in "mxv"), device=cpu)
        out, _ = tb.bvh_step_force(start, theta, G, eps, traversal="per-body")
        a_walk, scale, counts = _walk(jtree, jout["m"], jout["x"], np.float32, theta, G=G)
        own = tb.build_tree(out.m, out.x, eps)
        _, _, own_counts = tw.bvh_walk_torch(own.mm, own.mx, own.bw, own.nlevels, out.m, out.x,
                                             theta, G, eps, detail=True)
        flipped = ((counts["nodes"] != own_counts["nodes"])
                   | (counts["pairs"] != own_counts["pairs"]))
        js, _ = jstep(js, k)
        ts, _ = tstep(ts, k)
        jx = np.asarray(js.x)
        rows.append({
            "step_err": float((np.abs(out.a.numpy() - jout["a"]) / scale.numpy()).max()),
            "walk_err": float((np.abs(a_walk.numpy() - jout["a"]) / scale.numpy()).max()),
            "order_equal": bool(np.array_equal(out.x.numpy(), jout["x"])),
            "com_diff": float(np.abs(own.mx.numpy() - np.asarray(jtree.mx)).max()),
            "flipped_rows": torch.nonzero(flipped).flatten().tolist(),
            "free_x": float(np.abs(ts.x.numpy() - jx).max() / np.abs(jx).max())})
    _cache[key] = rows
    return rows


def _within(got, ref, scale, dtype):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= TOL[dtype] * np.asarray(scale, np.float64)), (err / scale).max()


@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_twin_vs_nbody_tpu_walk(n, dim, dtype):
    """The twin over nbody_tpu's tree and sorted bodies: nbody_tpu's
    forces within the tolerance of each row's sum of |term|."""
    _, js, tree, _ = _jax_step(n, dim, dtype, 0.5)
    a, scale, counts = _walk(tree, js["m"], js["x"], dtype, 0.5)
    assert a.numpy().dtype == js["x"].dtype and a.shape == (n, dim)
    _within(a.numpy(), js["a"], scale.numpy(), dtype)
    if n == 1:
        assert not a.any() and not counts["pairs"].any()
    else:  # every other body is in some accepted node or direct pair
        assert bool((counts["nodes"] + counts["pairs"] > 0).all())


@pytest.mark.parametrize("n,dim,dtype", CASES)
def test_step_force_per_body_vs_nbody_tpu(n, dim, dtype):
    """The whole bvh_step_force(traversal="per-body"): the permuted state
    bit-equal, the forces within the tolerance, root mass and overflow as
    nbody_tpu's."""
    (m, x, v), js, tree, jaux = _jax_step(n, dim, dtype, 0.5)
    ts = SystemState.from_numpy(m, x, v, device=torch.device("cpu"))
    out, aux = tb.bvh_step_force(ts, 0.5, 1.0, _eps(dtype), traversal="per-body")
    for k in ("m", "x", "v"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), js[k])
    _, scale, _ = _walk(tree, js["m"], js["x"], dtype, 0.5)
    _within(out.a.numpy(), js["a"], scale.numpy(), dtype)
    assert int(aux["overflow"]) == int(jaux["overflow"]) == 0
    assert float(aux["root_mass"]) == float(jaux["root_mass"])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_theta0_walk_is_the_direct_sum(dim, dtype):
    """theta = 0 accepts no node: the walk sums every other body directly,
    the poly direct sum (allpairs_accel) within the tolerance, and
    nbody_tpu's theta = 0 walk too."""
    _, js, tree, _ = _jax_step(300, dim, dtype, 0.0)
    a, scale, counts = _walk(tree, js["m"], js["x"], dtype, 0.0)
    assert not counts["nodes"].any() and bool((counts["pairs"] == 299).all())
    direct = tap.allpairs_accel(torch.tensor(js["m"]), torch.tensor(js["x"]), 1.0, _eps(dtype))
    _within(a.numpy(), direct.numpy(), scale.numpy(), dtype)
    _within(a.numpy(), js["a"], scale.numpy(), dtype)


def test_rows_walk_those_bodies_and_the_wrapper_routes_cpu_to_the_twin():
    """rows: the same rows of the full walk, bit for bit; the wrapper on
    CPU tensors runs the twin (a twin call, no launch); bad inputs raise."""
    _, js, tree, _ = _jax_step(300, 3, np.float32, 0.5)
    t = tb.BVHTree.from_numpy(tree.mm, tree.mx, tree.bw, tree.nlevels)
    m, x = torch.tensor(js["m"]), torch.tensor(js["x"])
    tw.reset_launch_counts()
    full = tw.bvh_walk_cuda(t.mm, t.mx, t.bw, t.nlevels, m, x, 0.5, 2.0, 1e-7)
    rows = torch.tensor([299, 0, 17, 17, 150])
    part = tw.bvh_walk_cuda(t.mm, t.mx, t.bw, t.nlevels, m, x, 0.5, 2.0, 1e-7, rows)
    assert torch.equal(part, full[rows])
    assert tw.launch_counts == {tw.BVH_WALK: 0, tw.OCTREE_WALK: 0, tw.OCTREE_PACK: 0}
    assert tw.twin_calls == {tw.BVH_WALK: 2, tw.OCTREE_WALK: 0, tw.OCTREE_PACK: 0}
    with pytest.raises(TypeError):
        tw.bvh_walk_cuda(t.mm, t.mx, t.bw, t.nlevels, m, x, 0.5, 1.0, 1e-7, rows.int())
    with pytest.raises(ValueError):
        tw.bvh_walk_cuda(t.mm, t.mx, t.bw, t.nlevels + 1, m, x, 0.5, 1.0, 1e-7)
    with pytest.raises(ValueError):
        tw.bvh_walk_cuda(t.mm, t.mx, t.bw, t.nlevels, m.double(), x, 0.5, 1.0, 1e-7)


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
    whole bvh_step_force from nbody_tpu's start state keeps its sorted
    order, and its forces are within 1e-5 of each row's sum of |term|."""
    first = _uniform_run(dim)[0]
    assert first["order_equal"]
    assert first["step_err"] <= TOL[np.float32] and first["walk_err"] <= TOL[np.float32]


@pytest.mark.parametrize("dim", [2, 3])
def test_uniform_box_walk_every_step_float32(dim):
    """Along nbody_tpu's 10 uniform-box steps (the CLI's warmup), the twin
    over nbody_tpu's tree stays within 1e-5 of each row's sum of |term|
    at every step, and the port's whole step (its own refit) leaves that
    tolerance only on a step where a row's accepted nodes or direct pairs
    differ between the two trees: a MAC test flipped by a centre of mass
    one float32 ulp apart, not a walk that differs."""
    for k, r in enumerate(_uniform_run(dim)):
        assert r["order_equal"] and r["walk_err"] <= TOL[np.float32], (k, r)
        assert r["step_err"] <= TOL[np.float32] or r["flipped_rows"], (k, r)


@pytest.mark.parametrize("dim", ["2", "3"])
def test_cli_per_body_float_vs_nbody_tpu(dim, tmp_path, monkeypatch):
    """python -m nbody_torch.cli --algorithm bvh --traversal per-body in
    float32 against nbody_tpu's CLI (-n 200 -s 2, the 10 warmup steps,
    --print-state --print-info, the galaxy): the same lines, the printed
    values (4 significant digits) within 1e-3 relative. The galaxy, not
    the default uniform box: there the two runs part where a MAC test
    flips on a one-ulp difference of the two refits, and the gap grows
    step by step (PYTHONPATH=. python tests/test_torch_perbody_bvh.py
    prints the reading; test_uniform_box_* hold each step); float64 runs print the
    same text on the uniform box (tests/test_torch_cli.py)."""
    monkeypatch.chdir(tmp_path)
    argv = ["-n", "200", "-s", "2", "-d", dim, "--algorithm", "bvh", "--traversal", "per-body",
            "--workload", "galaxy", "--print-state", "--print-info"]
    t, j = _cli_outputs(argv)
    assert [NUM.sub("#", ln) for ln in t] == [NUM.sub("#", ln) for ln in j]
    nums = [np.array([float(v) for v in NUM.findall("\n".join(lines))]) for lines in (t, j)]
    np.testing.assert_allclose(nums[0], nums[1], rtol=1e-3, atol=1e-6)
    assert sum("Total mass" in ln for ln in t) == 10


if __name__ == "__main__":
    # the uniform-box reading: PYTHONPATH=. python tests/test_torch_perbody_bvh.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
    for dim in (3, 2):
        for k, r in enumerate(_uniform_run(dim, steps=12)):
            print(f"bvh {dim}-D step {k}: whole step {r['step_err']:.3e}, walk over nbody_tpu's "
                  f"tree {r['walk_err']:.3e} (of sum |term|), order equal {r['order_equal']}, "
                  f"max |com diff| {r['com_diff']:.3e}, flipped rows {r['flipped_rows']}; free "
                  f"runs max |x diff| / max |x| {r['free_x']:.3e}")
        t, j = _cli_outputs(["-n", "200", "-s", "2", "-d", str(dim), "--algorithm", "bvh",
                             "--traversal", "per-body", "--print-state", "--print-info"])
        got, ref = (np.array([float(v) for v in NUM.findall("\n".join(lines))])
                    for lines in (t, j))
        diff = np.abs(got - ref)
        print(f"bvh {dim}-D uniform box, the float CLI after its 10 steps: text equal "
              f"{[NUM.sub('#', ln) for ln in t] == [NUM.sub('#', ln) for ln in j]}, "
              f"{int((diff > 1e-3 * np.abs(ref) + 1e-6).sum())} of {got.size} printed values "
              f"outside 1e-3 relative (+1e-6), max relative difference "
              f"{(diff / np.maximum(np.abs(ref), 1e-6)).max():.3e}")
