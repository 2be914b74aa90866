"""The partitioned trees (nbody_torch.parallel.tree_partitioned and
distributed_sort) on 4 gloo ranks on the CPU, against nbody_tpu's on the
8-device CPU mesh that tests/conftest.py sets up.

One spawn of 4 ranks serves the module (the fixture `ranks` runs every job
in one group, parallel.launch.run_jobs); every job's result must be the
same, bit for bit, on every rank of its grid. Held:

* the distributed sort against nbody_tpu's distributed_sort_rows on 2, 3
  and 4 ranks, static and adaptive, one and two uint32 key words, on
  heavily tied keys (the canonical-concat regression of
  tests/test_sharding.py:503), all-equal keys and an almost sorted stream:
  keys and payload equal bit for bit;
* one step of each partitioned maker from the same numpy-seeded state
  (octree and BVH, 2-D and 3-D, float32 and float64, uniform and
  clustered, in 8 of the 16 combinations that cross every pair of them;
  n that 4 ranks * the tile do not divide, tile 64): the
  sorted order and the masses equal, beyond_halo_cells, beyond_used_ring
  and the comm dict equal, x, v and a within 1e-5 (float32, the kernels'
  plain twins) or 1e-12 (float64) of the largest |x|, |v| and |a|; three
  steps in a row (the pad rows made again before each) the same way;
* theta = 0 against the direct sum (1e-4 of max |a|, as
  tests/test_sharding.py:370 holds nbody_tpu's);
* beyond_budget=1: the ring runs, and agrees with the exchange within
  1e-4 of max |a| (tests/test_sharding.py:562) and with nbody_tpu's ring;
* the 2-D (body x tile) mesh: 2 x 2 against the 1-D step on 2 ranks (the
  same positions, beyond cells, a within 1e-5 of max |a|) and against
  nbody_tpu's 2 x 2 step, at halo 0 so that beyond cells exist;
* comm_only: the accounting equal to nbody_tpu's, n = 2^20 over 256 shards
  included.

nbody_tpu's root mass is its fused XLA reduction of the level-1 masses;
the port adds the children in order, so root_mass is held within a few
float ulps (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nbody_torch.config import SimConfig
from nbody_torch.parallel import dryrun, launch
from nbody_torch.parallel import tree_partitioned as tp
from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.parallel import tree_partitioned as jtp
from nbody_tpu.parallel.distributed_sort import distributed_sort_rows as jsort
from nbody_tpu.parallel.mesh import BODY_AXIS, body_mesh
from nbody_tpu.state import SystemState as JState

torch.set_num_threads(1)

WORLD = 4
TILE = 64
TOL = {np.float32: 1e-5, np.float64: 1e-12}
EXACT_KEYS = ("beyond_halo_cells", "beyond_used_ring", "comm", "comm_bytes_per_shard")

# (ranks, adaptive, key words, data): the distributed sort's cases
SORTS = {f"{s}r-{'adaptive' if a else 'static'}-{w}w-{d}": (s, a, w, d)
         for s in (2, 3, 4) for a in (False, True) for w, d in ((1, "tied"), (2, "tied"))}
SORTS.update({f"4r-{'adaptive' if a else 'static'}-{w}w-{d}": (4, a, w, d)
              for a in (False, True) for w, d in ((1, "equal"), (2, "nearly"))})
SORT_ROWS = 64  # rows a rank

# (algorithm, dim, dtype, clustered, n): one step of each maker, the half of
# the 16 combinations where clustered = (bvh) xor (3-D) xor (float64): each
# factor's two values appear four times, and every pair of factors crosses
STEPS = {f"{algo}-{dim}d-{np.dtype(dt).name}-{'clustered' if cl else 'uniform'}":
         (algo, dim, dt, cl, n)
         for (algo, n), ia in ((("octree", 1000), 0), (("bvh", 900), 1))
         for dim, ib in ((2, 0), (3, 1)) for dt, ic in ((np.float32, 0), (np.float64, 1))
         for cl in (bool(ia ^ ib ^ ic),)}
# three steps in a row, in float64: in float32 the leapfrogs' last-ulp
# differences (XLA contracts x + dt*v + ... into FMAs) flip MAC decisions
MULTI = {"octree-2d-float64": ("octree", 2, np.float64, False, 1000),
         "bvh-3d-float64": ("bvh", 3, np.float64, True, 900)}
THETA0 = {"octree": 1500, "bvh": 1200}
BUDGET = {"octree": 1200, "bvh": 1100}  # clustered 3-D float32, beyond_budget=1
# clustered 3-D float32, 2 x 2 against 1-D on 2 ranks; halo 0, as with 2 body
# ranks a halo of 1 covers every body and leaves no beyond cells
MESH2D = {"octree": 1200, "bvh": 1000}
COMM_ONLY = [("octree", 4096, 2, 8, 1), ("bvh", 4096, 2, 8, 1), ("octree", 8192, 3, 4, 2),
             ("bvh", 3000, 3, 2, 4), ("octree", 1 << 20, 3, 256, 1),
             ("bvh", 1 << 20, 3, 256, 1)]


def _bodies(n, dim, dtype, clustered, seed=5):
    rng = np.random.default_rng(seed)
    if clustered:
        x = rng.normal(0, 1, (4, dim))[rng.integers(0, 4, n)] * 30 + rng.normal(0, 1, (n, dim))
    else:
        x = rng.uniform(-1, 1, (n, dim))
    m = rng.uniform(0.1, 1.0, n)
    v = rng.normal(0, 0.01, (n, dim))
    return {"m": m.astype(dtype), "x": x.astype(dtype), "v": v.astype(dtype)}


def _cfg(n, dim, dtype, theta=0.5, dt=0.0):
    return SimConfig(n=n, dim=dim, dtype=dtype, theta=theta, dt=dt)


def _sort_inputs(S, words, data, seed=3):
    rng = np.random.default_rng(seed)
    n = S * SORT_ROWS
    if data == "tied":
        keys = rng.integers(0, 16, (n, words))
    elif data == "equal":
        keys = np.zeros((n, words), np.int64)
    else:  # an almost sorted stream: sorted keys, a few rows moved to another rank
        keys = np.sort(rng.integers(0, 1 << 32, n))[:, None].repeat(words, 1)
        keys[[3, n - 5]] = keys[[n - 5, 3]]
    keys = keys.astype(np.uint32)
    pay = rng.uniform(0.1, 1.0, (n, 2)).astype(np.float32)
    return keys, pay


def _jobs():
    jobs = {}
    for name, (S, adaptive, words, data) in SORTS.items():
        keys, pay = _sort_inputs(S, words, data)
        jobs[f"sort-{name}"] = (dryrun.sort_rows, (S, keys.astype(np.int64), pay, adaptive))
    for name, (algo, dim, dt, cl, n) in STEPS.items():
        jobs[f"step-{name}"] = (dryrun.partitioned_step,
                                (algo, _cfg(n, dim, dt), _bodies(n, dim, dt, cl),
                                 {"tile": TILE}))
    for name, (algo, dim, dt, cl, n) in MULTI.items():
        jobs[f"multi-{name}"] = (dryrun.partitioned_step,
                                 (algo, _cfg(n, dim, dt, dt=0.1), _bodies(n, dim, dt, cl),
                                  {"tile": TILE}, 3))
    for algo, n in THETA0.items():
        jobs[f"theta0-{algo}"] = (dryrun.partitioned_step,
                                  (algo, _cfg(n, 2, np.float32, theta=0.0),
                                   _bodies(n, 2, np.float32, False, seed=9), {"tile": TILE}))
    for algo, n in BUDGET.items():
        args = (algo, _cfg(n, 3, np.float32), _bodies(n, 3, np.float32, True))
        jobs[f"exchange-{algo}"] = (dryrun.partitioned_step, (*args, {"tile": TILE}))
        jobs[f"ring-{algo}"] = (dryrun.partitioned_step,
                                (*args, {"tile": TILE, "beyond_budget": 1}))
    for algo, n in MESH2D.items():
        args = (algo, _cfg(n, 3, np.float32), _bodies(n, 3, np.float32, True, seed=11))
        kw = {"tile": TILE, "n_shards": 2, "halo": 0}
        jobs[f"1d-{algo}"] = (dryrun.partitioned_step, (*args, kw))
        jobs[f"2d-{algo}"] = (dryrun.partitioned_step, (*args, {**kw, "tile_shards": 2}))
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """Every job's result on each of the 4 ranks: ranks[r][job]."""
    jobs = _jobs()
    per_rank = launch.spawn(WORLD, "cpu", launch.run_jobs, list(jobs.values()))
    return [dict(zip(jobs, results)) for results in per_rank]


def _job(ranks, name, grid=WORLD):
    """The job's result, after checking that every rank of its grid has the
    same bits and that the others have none."""
    first = ranks[0][name]
    for r in range(1, WORLD):
        got = ranks[r][name]
        if r >= grid:
            assert got is None
            continue
        for a, b in zip(got, first):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(a, b)
    return first


def _jax_step(algo, cfg, arrays, steps=1, **kw):
    make = jtp.make_partitioned_octree_step if algo == "octree" else jtp.make_partitioned_bvh_step
    jcfg = JConfig(n=cfg.n, dim=cfg.dim, dtype=cfg.dtype, dt=cfg.dt, G=cfg.G, theta=cfg.theta)
    step = make(jcfg, kw.pop("n_shards", WORLD), **kw)
    z = np.zeros_like(arrays["x"])
    st = JState(*(jnp.asarray(arrays.get(f, z)) for f in ("m", "x", "v", "a", "ao")))
    for _ in range(steps):
        # through the host: nbody_tpu's step cannot pad a state that carries
        # its mesh's sharding (the ShardingTypeError of ROADMAP Queue 3)
        st, aux = step(JState(*(jnp.asarray(np.asarray(getattr(st, f)))
                                for f in ("m", "x", "v", "a", "ao"))))
    return {f: np.asarray(getattr(st, f)) for f in ("m", "x", "v", "a", "ao")}, aux


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-300)


def _assert_step(got, aux, ref, jaux, tol):
    np.testing.assert_array_equal(got["m"], ref["m"])
    for f in ("x", "v", "a"):
        assert _rel(got[f], ref[f]) <= tol, f
    for k in EXACT_KEYS:
        assert aux[k] == (jaux[k] if k == "comm" else np.asarray(jaux[k]).item()), k
    assert aux["overflow"] == 0
    assert aux["root_mass"] == pytest.approx(float(jaux["root_mass"]), rel=tol)


@pytest.mark.parametrize("name", list(SORTS))
def test_distributed_sort_vs_nbody_tpu(name, ranks):
    S, adaptive, words, data = SORTS[name]
    got_keys, got_pay = _job(ranks, f"sort-{name}", grid=S)
    keys, pay = _sort_inputs(S, words, data)

    def fn(*arrays):
        ks, cs = jsort(list(arrays[:words]), list(arrays[words:]), BODY_AXIS, S,
                       adaptive=adaptive)
        return (*ks, *cs)

    mapped = jax.jit(jax.shard_map(fn, mesh=body_mesh(S), in_specs=(P(BODY_AXIS),) * (words + 2),
                                   out_specs=(P(BODY_AXIS),) * (words + 2)))
    out = mapped(*(jnp.asarray(keys[:, w]) for w in range(words)),
                 *(jnp.asarray(pay[:, c]) for c in range(2)))
    np.testing.assert_array_equal(got_keys, np.stack([np.asarray(o) for o in out[:words]], 1))
    np.testing.assert_array_equal(got_pay, np.stack([np.asarray(o) for o in out[words:]], 1))


@pytest.mark.parametrize("name", list(STEPS))
def test_partitioned_step_vs_nbody_tpu(name, ranks):
    algo, dim, dt, cl, n = STEPS[name]
    got, aux = _job(ranks, f"step-{name}")
    assert n % (WORLD * TILE)
    ref, jaux = _jax_step(algo, _cfg(n, dim, dt), _bodies(n, dim, dt, cl), tile=TILE)
    _assert_step(got, aux, ref, jaux, TOL[dt])


@pytest.mark.parametrize("name", list(MULTI))
def test_partitioned_steps_in_a_row_vs_nbody_tpu(name, ranks):
    """Three steps with dt > 0: the pad rows are made again from the new
    state's last row before each step, as nbody_tpu pads each step's input."""
    algo, dim, dt, cl, n = MULTI[name]
    got, aux = _job(ranks, f"multi-{name}")
    ref, jaux = _jax_step(algo, _cfg(n, dim, dt, dt=0.1), _bodies(n, dim, dt, cl), steps=3,
                          tile=TILE)
    _assert_step(got, aux, ref, jaux, 10 * TOL[dt])


@pytest.mark.parametrize("algo", list(THETA0))
def test_theta0_is_the_direct_sum(algo, ranks):
    got, aux = _job(ranks, f"theta0-{algo}")
    x, m = got["x"].astype(np.float64), got["m"].astype(np.float64)
    eps = float(np.finfo(np.float32).eps)
    d = x[None, :, :] - x[:, None, :]
    r = np.sqrt((d * d).sum(-1))
    den = (r + eps) ** 3 if algo == "octree" else r ** 3 + eps
    a_ref = np.einsum("ij,ijd->id", m[None, :] / den, d)
    # nbody_tpu's own bound (tests/test_sharding.py:370)
    assert _rel(got["a"], a_ref) < 1e-4
    assert aux["beyond_halo_cells"] >= 0


@pytest.mark.parametrize("algo", list(BUDGET))
def test_beyond_budget_1_takes_the_ring(algo, ranks):
    ex, aux_ex = _job(ranks, f"exchange-{algo}")
    ring, aux_ring = _job(ranks, f"ring-{algo}")
    assert aux_ex["beyond_halo_cells"] > 0 and not aux_ex["beyond_used_ring"]
    assert aux_ring["beyond_used_ring"]
    assert aux_ring["comm_bytes_per_shard"] == (aux_ring["comm"]["step_bytes_no_sort"]
                                                + aux_ring["comm"]["ring_fallback_bytes"])
    np.testing.assert_array_equal(ex["x"], ring["x"])
    assert _rel(ring["a"], ex["a"]) < 1e-4
    n = BUDGET[algo]
    ref, jaux = _jax_step(algo, _cfg(n, 3, np.float32), _bodies(n, 3, np.float32, True),
                          tile=TILE, beyond_budget=1)
    _assert_step(ring, aux_ring, ref, jaux, TOL[np.float32])


@pytest.mark.parametrize("algo", list(MESH2D))
def test_2d_mesh_vs_1d_step(algo, ranks):
    one, aux1 = _job(ranks, f"1d-{algo}", grid=2)
    two, aux2 = _job(ranks, f"2d-{algo}")
    np.testing.assert_array_equal(one["x"], two["x"])
    assert aux1["beyond_halo_cells"] == aux2["beyond_halo_cells"] > 0
    assert _rel(two["a"], one["a"]) < 1e-5
    n = MESH2D[algo]
    ref, jaux = _jax_step(algo, _cfg(n, 3, np.float32), _bodies(n, 3, np.float32, True, seed=11),
                          n_shards=2, tile=TILE, halo=0, tile_shards=2)
    _assert_step(two, aux2, ref, jaux, TOL[np.float32])


@pytest.mark.parametrize("algo,n,dim,S,T", COMM_ONLY)
def test_comm_only_vs_nbody_tpu(algo, n, dim, S, T):
    make = tp.make_partitioned_octree_step if algo == "octree" else tp.make_partitioned_bvh_step
    jmake = jtp.make_partitioned_octree_step if algo == "octree" \
        else jtp.make_partitioned_bvh_step
    got = make(_cfg(n, dim, np.float32), None, n_shards=S, tile_shards=T, comm_only=True)
    assert got == jmake(JConfig(n=n, dim=dim, dtype=np.float32), S, tile_shards=T,
                        comm_only=True)
    nl = -(-n // S)
    assert got["step_bytes_no_sort"] <= 96 * 2 * nl + 64 * (got["beyond_need_psum_bytes"] // 4)


def test_partitioned_bvh_refuses_other_sizes():
    with pytest.raises(ValueError, match="power-of-two"):
        tp.make_partitioned_bvh_step(_cfg(100, 2, np.float32), None, n_shards=3,
                                     comm_only=True)
    with pytest.raises(ValueError) as jerr:
        jtp.make_partitioned_bvh_step(JConfig(n=100), 3, comm_only=True)
    with pytest.raises(ValueError) as err:
        tp.check_bvh_layout(3, tp.TILE, 1)
    assert str(err.value) == str(jerr.value)


def test_near_tile_is_the_kernels_row_block():
    """The near field's tiles are ROWS_PER_BLOCK rows, which must be the
    interval kernel's block (csrc/tiles.cuh kThreads * kRows)."""
    import re
    from pathlib import Path

    from nbody_torch.ops.cuda_group_eval import ROWS_PER_BLOCK

    text = (Path(tp.__file__).parents[1] / "csrc" / "tiles.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kThreads|kRows) = (\d+);", text)}
    assert consts["kThreads"] * consts["kRows"] == ROWS_PER_BLOCK


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_sum_chunks_by_its_temporarys_bytes(softening, masked, monkeypatch):
    """_plain_sum sizes its chunks so that the (pairs, dim) differences stay
    within TEMP_BYTES: a budget of a fifth of a tile's (whole rows taken a
    few at a time) gives the sums of the default budget (tiles taken
    whole)."""
    rng = np.random.default_rng(21)
    ntiles, tb, nj, dim = 6, 64, 300, 3
    xt = torch.tensor(rng.uniform(-1, 1, (ntiles, tb, dim)))
    xj = torch.tensor(rng.uniform(-1, 1, (nj, dim)))
    mj = torch.tensor(rng.uniform(0.1, 1.0, nj))
    mask = torch.tensor(rng.random((ntiles, nj)) < 0.5) if masked else None
    eps = torch.tensor(1e-3, dtype=torch.float64)
    whole = tp._plain_sum(xt, mj, xj, eps, softening, mask)
    monkeypatch.setattr(tp, "TEMP_BYTES", tb * nj * dim * 8 // 5)
    chunked = tp._plain_sum(xt, mj, xj, eps, softening, mask)
    scale = whole.abs().max().item()
    assert torch.allclose(chunked, whole, rtol=0, atol=1e-13 * scale)
