"""nbody_torch config, rng, native bridge, builders, state and state files
against nbody_tpu: the same seeds and the same numpy inputs must give the
same bits (workload generation and file formats are exact code)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_torch.config as tconfig
import nbody_torch.models.builders as tbuilders
import nbody_torch.rng as trng
import nbody_torch.state as tstate
import nbody_tpu.config as jconfig
import nbody_tpu.models.builders as jbuilders
import nbody_tpu.rng as jrng
import nbody_tpu.state as jstate
from nbody_torch import native as tnative
from nbody_torch.io import saving as tsaving
from nbody_tpu.io import saving as jsaving

torch.set_num_threads(1)

CPU = torch.device("cpu")

# (workload, n, dim): odd n for galaxy leaves its last body zero
WORKLOADS = [
    ("uniform", 64, 2),
    ("uniform", 65, 3),
    ("plummer", 40, 3),
    ("galaxy", 101, 2),
    ("galaxy", 99, 3),
]


def _assert_same_model(jax_model, torch_model):
    jcfg, js = jax_model
    tcfg, ts = torch_model
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    h = ts.to_numpy()
    for name in ("m", "x", "v", "a", "ao"):
        ref = np.asarray(getattr(js, name))
        assert h[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(h[name], ref, err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("workload,n,dim", WORKLOADS)
def test_builders_bit_equal(workload, n, dim, dtype):
    _assert_same_model(jbuilders.build_model(workload, n, dim, dtype),
                       tbuilders.build_model(workload, n, dim, dtype, device=CPU))


@pytest.mark.parametrize("workload,n,dim", WORKLOADS)
def test_python_fallback_builders_bit_equal(monkeypatch, workload, n, dim):
    """The pure-Python builders of both packages, with native disabled."""
    monkeypatch.setattr(jbuilders, "_use_native", lambda: False)
    monkeypatch.setattr(tbuilders, "_use_native", lambda: False)
    _assert_same_model(jbuilders.build_model(workload, n, dim, np.float32),
                       tbuilders.build_model(workload, n, dim, np.float32, device=CPU))


def test_no_native_env_var(monkeypatch):
    monkeypatch.setenv("NBODY_TORCH_NO_NATIVE", "1")
    assert not tbuilders._use_native()


def test_galaxy_odd_n_leaves_zero_body():
    cfg, s = tbuilders.build_galaxy_model(101, 2, np.float64, CPU)
    assert cfg.n == 101
    h = s.to_numpy()
    assert h["m"][-1] == 0.0 and np.all(h["x"][-1] == 0.0)
    assert np.count_nonzero(h["m"]) == 100


def test_plummer_2d_raises():
    with pytest.raises(ValueError):
        tbuilders.build_plummer_model(10, 2, np.float32, CPU)


def test_rng_stream_equal():
    t, j = trng.MT19937(42), jrng.MT19937(42)
    np.testing.assert_array_equal(t.raw(1500), j.raw(1500))
    np.testing.assert_array_equal(t.canonical(700), j.canonical(700))
    td, jd = trng.ReferenceDistributions(42), jrng.ReferenceDistributions(42)
    np.testing.assert_array_equal(td.angle(5), jd.angle(5))
    np.testing.assert_array_equal(td.sym(5), jd.sym(5))


def test_native_bridge_matches_python_stream():
    if not tnative.available():
        pytest.skip("native library cannot be built here")
    np.testing.assert_array_equal(tnative.mt19937_raw(42, 2000), trng.MT19937(42).raw(2000))
    np.testing.assert_array_equal(tnative.mt19937_canonical(42, 900),
                                  trng.MT19937(42).canonical(900))


@pytest.mark.parametrize("name", ["float", "double"])
def test_config_same_meaning(name):
    dt = tconfig.precision_dtype(name)
    assert dt == jconfig.precision_dtype(name)
    assert tconfig.machine_eps(dt) == jconfig.machine_eps(dt) == float(np.finfo(dt).eps)
    tc, jc = tconfig.SimConfig(n=7, dim=3, dtype=dt), jconfig.SimConfig(n=7, dim=3, dtype=dt)
    assert (tc.eps, tc.child_count, tc.max_tree_nodes) == (jc.eps, jc.child_count, jc.max_tree_nodes)
    with pytest.raises(ValueError):
        tconfig.precision_dtype("half")
    with pytest.raises(ValueError):
        tconfig.SimConfig(n=4, dim=4)


def _random_state_arrays(n, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-3, 3, (n, dim) if k else (n,)).astype(dtype) for k in range(5)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_format_state_byte_identical(dim, dtype):
    m, x, v, a, ao = _random_state_arrays(12, dim, dtype, seed=dim)
    js = dataclasses.replace(jstate.SystemState.from_numpy(m, x, v, dtype=dtype),
                             a=jnp.asarray(a), ao=jnp.asarray(ao))
    ts = tstate.SystemState.from_numpy(m, x, v, a, ao, dtype=dtype, device=CPU)
    assert tstate.format_state(ts) == jstate.format_state(js)


def test_from_numpy_copies_and_round_trips():
    m, x, v, a, ao = _random_state_arrays(5, 3, np.float32, seed=3)
    s = tstate.SystemState.from_numpy(m, x, v, a, ao, device=CPU)
    x[0, 0] = 99.0  # the state must not alias the caller's array
    h = s.to_numpy()
    assert h["x"][0, 0] != 99.0
    np.testing.assert_array_equal(h["ao"], ao)
    assert (s.n, s.dim, s.device) == (5, 3, CPU)
    s0 = tstate.SystemState.from_numpy(m, x, v, dtype=np.float64, device=CPU)
    assert s0.x.dtype == torch.float64 and not s0.a.any() and not s0.ao.any()


@pytest.mark.parametrize("dim", [2, 3])
def test_state_file_bytes_and_load(tmp_path, dim):
    cfg_t, st = tbuilders.build_model("galaxy", 21, dim, np.float64, device=CPU)
    cfg_j, sj = jbuilders.build_model("galaxy", 21, dim, np.float64)
    tsaving.save_system(str(tmp_path / "t.bin"), st, cfg_t)
    jsaving.save_system(str(tmp_path / "j.bin"), sj, cfg_j)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    _assert_same_model(jsaving.load_system(str(tmp_path / "j.bin"), dim, np.float32),
                       tsaving.load_system(str(tmp_path / "j.bin"), dim, np.float32, CPU))
    with pytest.raises(ValueError):
        tsaving.load_system(str(tmp_path / "t.bin"), 5 - dim, np.float32, CPU)
