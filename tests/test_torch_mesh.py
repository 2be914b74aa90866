"""The replicated multi-device layouts (nbody_torch.parallel) on 4 gloo
ranks on the CPU, against nbody_tpu's on 4 devices of the 8-device CPU mesh
that tests/conftest.py sets up.

One spawn of 4 ranks serves the module (the fixture `ranks` runs every job
in one group, parallel.launch.run_jobs); every job's result must be the
same, bit for bit, on every rank. Held:

* the ring (parallel/ring.py) against nbody_tpu's make_ring_allpairs(cfg,
  4), 2-D and 3-D, float32 and float64, n = 64 and 101 (which 4 does not
  divide): within 1e-5 (float32) or 1e-12 (float64) of sum |a|, as both
  sum each rotation's terms in other orders; the sharded BVH force on
  Hilbert-sorted bodies against nbody_tpu's make_sharded_bvh_force, n =
  100 and 700 (pads to 704 and 768), within the same tolerance;
* one sharded BVH and octree step on their list paths (--kernel torch,
  and float64) against nbody_tpu's make_sharded_bvh_step /
  make_sharded_octree_step (whose CPU runs take the list paths) from the
  same state: x, v and a within the same tolerance, the aux equal
  (overflow, root_mass and the octree's tree_size);
* one step of every path (the fast paths through the kernels' plain
  twins, the list paths in float64, the ring) against the port's
  single-device step from the same state (dryrun.step_parity): the bodies
  in the same order, a within the same tolerance, the aux equal;
* the dry run (parallel/dryrun.py, nbody_tpu's dryrun_multichip blocks);
* a rank that raises fails the run.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.config import SimConfig
from nbody_torch.models import build_galaxy_model
from nbody_torch.parallel import dryrun, launch
from nbody_torch.ops.bvh import hilbert_sort
from nbody_torch.parallel.ring import make_ring_allpairs
from nbody_torch.parallel.tree_sharded import make_sharded_bvh_force
from nbody_torch.sim.engines import EngineOptions, get_engine
from nbody_torch.state import SystemState
from nbody_tpu.config import SimConfig as JConfig
from nbody_tpu.parallel import ring as jring
from nbody_tpu.parallel import tree_sharded as jsharded
from nbody_tpu.sim.engines import EngineOptions as JOptions
from nbody_tpu.state import SystemState as JState

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TOL = {np.float32: 1e-5, np.float64: 1e-12}
CPU = torch.device("cpu")
FIELDS = ("m", "x", "v", "a", "ao")

RINGS = {f"{n}-{dim}d-{np.dtype(dt).name}": (n, dim, dt)
         for n, dim, dt in ((64, 2, np.float32), (101, 3, np.float32), (101, 2, np.float64),
                            (64, 3, np.float64))}
# (algorithm, dim, dtype, kernel): one sharded step on the list paths (--kernel
# torch, and float64) of a 300-body galaxy, which pads to 384 = 3 * 4 ranks
# * 32, against nbody_tpu's
LISTS = {f"{algo}-{dim}d-{np.dtype(dt).name}-{kernel}": (algo, dim, dt, kernel)
         for algo in ("bvh", "octree")
         for dim, dt, kernel in ((2, np.float32, "torch"), (3, np.float64, "auto"))}
# (algorithm, dim, precision): one step of every path on a 256-body galaxy,
# which needs no pad, against the port's single-device step (dryrun.step_parity;
# a pad would change which tiles take the exact fallback: the copies crowd
# the last body's cell)
PARITY = {f"{algo}-{dim}d-{prec}": (algo, dim, prec)
          for algo in ("all-pairs", "bvh", "octree")
          for dim, prec in ((3, "float"), (2, "float"), (3, "double"))}
N_LIST, N_PARITY, TILE = 300, 256, 32
BVH_FORCE = (100, 700)  # sharded BVH forces at tile 16: pads to 128 and 768


def _ring_inputs(n, dim, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.1, 1.0, n).astype(dtype), rng.uniform(-1.0, 1.0, (n, dim)).astype(dtype))


def _bvh_config(n):
    return SimConfig(n=n, dim=2, dtype=np.float32, G=1.0, theta=0.5)


def _sorted_inputs(n):
    """Hilbert-sorted bodies of the sharded BVH force (nbody_tpu's
    tests/test_sharding.py:242-265 sorts them the same way)."""
    m, x = _ring_inputs(n, 2, np.float32, seed=2)
    st = hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=CPU),
                      _bvh_config(n).eps)
    return st.m.numpy(), st.x.numpy()


def _step_inputs(dim, dtype):
    cfg, state = build_galaxy_model(N_LIST, dim, dtype, CPU)
    return cfg.replace(theta=0.5), state.to_numpy()


def _jobs():
    """{name: (fn, args)}: the module's checks, run on every rank."""
    jobs = {}
    for name, (n, dim, dtype) in RINGS.items():
        cfg = SimConfig(n=n, dim=dim, dtype=dtype, G=2.0)
        jobs[f"ring-{name}"] = (dryrun.sharded_accel,
                                (make_ring_allpairs, cfg, *_ring_inputs(n, dim, dtype)))
    for n in BVH_FORCE:
        jobs[f"bvh-force-{n}"] = (dryrun.sharded_accel,
                                  (make_sharded_bvh_force, _bvh_config(n), *_sorted_inputs(n),
                                   dict(tile=16, list_path=True)))
    for name, (algo, dim, dtype, kernel) in LISTS.items():
        opts = EngineOptions(kernel=kernel, group_tile=TILE, mesh=WORLD)
        cfg, arrays = _step_inputs(dim, dtype)
        jobs[f"list-{name}"] = (dryrun.one_step, (algo, cfg, opts, arrays))
    for name, (algo, dim, prec) in PARITY.items():
        jobs[f"parity-{name}"] = (dryrun.step_parity, (algo, N_PARITY, dim, prec, "auto", TILE))
    jobs["dryrun"] = (dryrun.dryrun_rank, ())
    return jobs


@pytest.fixture(scope="module")
def ranks():
    """Every job's result on each of the 4 ranks: ranks[r][j]."""
    jobs = _jobs()
    per_rank = launch.spawn(WORLD, "cpu", launch.run_jobs, list(jobs.values()))
    return [dict(zip(jobs, results)) for results in per_rank]


def _job(ranks, name):
    """The job's result, after checking that every rank has the same bits."""
    first = ranks[0][name]
    for r in range(1, WORLD):
        got = ranks[r][name]
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(got, first)
        elif isinstance(first, tuple):
            for key in first[0]:
                np.testing.assert_array_equal(got[0][key], first[0][key])
            assert got[1] == first[1]
        else:
            assert got.keys() == first.keys()
            for key in first:
                np.testing.assert_array_equal(got[key], first[key])
    return first


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).sum() / np.abs(ref).sum()


@pytest.mark.parametrize("name", list(RINGS))
def test_ring_vs_nbody_tpu(name, ranks):
    n, dim, dtype = RINGS[name]
    a = _job(ranks, f"ring-{name}")
    cfg = SimConfig(n=n, dim=dim, dtype=dtype, G=2.0)
    m, x = _ring_inputs(n, dim, dtype)
    ref = np.asarray(jring.make_ring_allpairs(cfg, WORLD)(jnp.asarray(m), jnp.asarray(x)))
    assert a.shape == (n, dim) and a.dtype == dtype
    assert _rel(a, ref) < TOL[dtype]


@pytest.mark.parametrize("n", BVH_FORCE)
def test_sharded_bvh_force_vs_nbody_tpu(n, ranks):
    a = _job(ranks, f"bvh-force-{n}")
    m, x = _sorted_inputs(n)
    cfg = _bvh_config(n)
    jcfg = JConfig(n=n, dim=2, dtype=np.float32, G=1.0, theta=0.5)
    ref = np.asarray(jax.jit(jsharded.make_sharded_bvh_force(jcfg, WORLD, tile=16))(
        jnp.asarray(m), jnp.asarray(x)))
    assert a.shape == (n, 2) and cfg.n == n
    assert _rel(a, ref) < TOL[np.float32]


@pytest.mark.parametrize("name", list(LISTS))
def test_sharded_list_step_vs_nbody_tpu(name, ranks):
    """nbody_tpu's sharded step takes its list path on the CPU, as the
    port's does under --kernel torch or in float64."""
    algo, dim, dtype, _ = LISTS[name]
    got, aux = _job(ranks, f"list-{name}")
    cfg, arrays = _step_inputs(dim, dtype)
    jcfg = JConfig(n=cfg.n, dim=dim, dtype=dtype, dt=cfg.dt, G=cfg.G, theta=cfg.theta)
    make = jsharded.make_sharded_bvh_step if algo == "bvh" else jsharded.make_sharded_octree_step
    jstate, jaux = make(jcfg, JOptions(mesh=WORLD, group_tile=TILE))(
        JState(*(jnp.asarray(arrays[f]) for f in FIELDS)), 0)
    for f in ("x", "v", "a"):
        assert _rel(got[f], np.asarray(getattr(jstate, f))) < TOL[dtype], f
    np.testing.assert_array_equal(got["m"], np.asarray(jstate.m))
    assert aux == {k: np.asarray(v).item() for k, v in jaux.items()}


@pytest.mark.parametrize("name", list(PARITY))
def test_sharded_step_vs_single_device_step(name, ranks):
    """The same step on one device (the fast paths through their twins in
    float32, the list paths in float64, the ring against the single-device
    all-pairs): the bodies in the same order, a within TOL of sum |a|, the
    aux equal."""
    algo, _, prec = PARITY[name]
    got = _job(ranks, f"parity-{name}")
    assert got["same_order"]
    assert got["sum_rel_err"] < TOL[np.float32 if prec == "float" else np.float64]
    assert got["aux"] == got["aux_single"]
    if algo != "all-pairs":
        assert got["aux"]["overflow"] == 0 and (algo == "bvh" or got["aux"]["tree_size"] > 0)


def test_dryrun_on_4_ranks(ranks):
    out = _job(ranks, "dryrun")
    assert set(out) == {"ring", "bvh", "octree", "partitioned_octree", "partitioned_bvh",
                        "partitioned_2d", "comm"}
    comm = out.pop("comm")
    assert not comm["ring_used"] and comm["traced_total"] == comm["comm"]["step_bytes_no_sort"]
    for name, x in out.items():
        n = (32 if name.startswith("partitioned") else 16) * WORLD
        assert x.shape == (n, 2) and np.isfinite(x).all()


def test_a_failing_rank_fails_the_run(tmp_path):
    """--csv-total with --save raises on rank 0 alone, while the other rank
    goes on to its first collective: the run still ends, non-zero, with
    rank 0's error on stderr."""
    proc = subprocess.run([sys.executable, "-m", "nbody_torch.cli", "-n", "64", "-s", "11",
                           "--algorithm", "bvh", "--mesh", "2", "--device", "cpu", "--csv-total",
                           "--save", "all"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode != 0
    assert "--csv-total cannot be combined with printing or saving" in proc.stderr
    assert not os.listdir(tmp_path)


def test_mesh_needs_its_group():
    """An engine asked for --mesh 4 outside a group of 4 ranks raises."""
    cfg, _ = build_galaxy_model(64, 2, np.float32, CPU)
    for algo in ("all-pairs", "octree", "bvh"):
        with pytest.raises(RuntimeError, match="parallel.launch"):
            get_engine(algo).make_step(cfg, EngineOptions(mesh=4), CPU)
    for algo in ("octree", "bvh"):
        with pytest.raises(RuntimeError, match="parallel.launch"):
            get_engine(algo).make_step(cfg, EngineOptions(mesh=2, mesh_tile=2,
                                                          mesh_layout="partitioned"), CPU)
    with pytest.raises(ValueError):
        launch.spawn(0, "cpu", dryrun.dryrun_rank)
