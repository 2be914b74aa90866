"""nbody_torch potential rowsums, energies and leapfrog against nbody_tpu.

The potential kernel's wrapper runs its plain twin on CPU tensors; it is
held against potential_rowsums_pallas in interpret mode, as
tests/test_integrator_energy.py runs it. Tolerances: the PE terms are all
positive, so a per-row |torch - reference| <= TOL * |reference| bounds
the difference of two summation orders; TOL = 1e-5 in float32, 1e-12 in
float64. The leapfrog update is the same arithmetic in the same order, so
it must match bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_allpairs as ca
from nbody_torch.ops.energy import calc_energies
from nbody_torch.ops.integrator import leapfrog_step
from nbody_torch.state import SystemState
from nbody_tpu.ops import energy as jenergy
from nbody_tpu.ops import integrator as jintegrator
from nbody_tpu.ops.pallas_allpairs import potential_rowsums_pallas
from nbody_tpu.state import SystemState as JaxState

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, np.float64: 1e-12}
CPU = torch.device("cpu")


def _arrays(n, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 1.0, n).astype(dtype)] + [
        rng.uniform(-1, 1, (n, dim)).astype(dtype) for _ in range(4)]


@pytest.mark.parametrize("n", [100, 257])
@pytest.mark.parametrize("dim", [2, 3])
def test_potential_rowsums_vs_pallas(dim, n):
    m, x = _arrays(n, dim, np.float32, seed=n + dim)[:2]
    eps = float(np.finfo(np.float32).eps)
    ref = np.asarray(potential_rowsums_pallas(jnp.asarray(m), jnp.asarray(x), eps,
                                              tile_i=128, tile_j=128, interpret=True))
    got = ca.potential_rowsums_cuda(torch.from_numpy(m), torch.from_numpy(x), eps).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.all(np.abs(got.astype(np.float64) - ref) <= TOL[np.float32] * np.abs(ref))


def test_potential_diagonal_is_masked():
    """One body has no potential; two coincident bodies see only each other
    (m_j / eps), never themselves."""
    eps = 0.25
    one = ca.potential_rowsums_torch(torch.tensor([3.0]), torch.tensor([[0.1, 0.2]]), eps)
    assert one.tolist() == [0.0]
    m = torch.tensor([1.0, 2.0], dtype=torch.float64)
    x = torch.zeros(2, 3, dtype=torch.float64)
    pe = ca.potential_rowsums_cuda(m, x, eps)
    assert pe.tolist() == [1.0 * 2.0 / eps, 2.0 * 1.0 / eps]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_calc_energies_vs_jax(dim, dtype):
    m, x, v = _arrays(90, dim, dtype, seed=7)[:3]
    G, eps = 2.0, float(np.finfo(dtype).eps)
    jke, jpe = jenergy.calc_energies(jnp.asarray(m), jnp.asarray(x), jnp.asarray(v), G, eps,
                                     chunk=32)
    tke, tpe = calc_energies(torch.from_numpy(m), torch.from_numpy(x), torch.from_numpy(v),
                             G, eps)
    assert tke.dtype == torch.from_numpy(x).dtype and tke.dim() == 0
    assert abs(tke.item() - float(jke)) <= TOL[dtype] * abs(float(jke))
    assert abs(tpe.item() - float(jpe)) <= TOL[dtype] * abs(float(jpe))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [2, 3])
def test_leapfrog_bit_equal_to_jax(dim, dtype):
    m, x, v, a, ao = _arrays(33, dim, dtype, seed=dim)
    dt = 0.1
    js = dataclasses.replace(JaxState.from_numpy(m, x, v, dtype=dtype),
                             a=jnp.asarray(a), ao=jnp.asarray(ao))
    ref = jintegrator.leapfrog_step(js, dt)
    ts = SystemState.from_numpy(m, x, v, a, ao, device=CPU)
    out = leapfrog_step(ts, dt).to_numpy()
    for name in ("m", "x", "v", "a", "ao"):
        np.testing.assert_array_equal(out[name], np.asarray(getattr(ref, name)), err_msg=name)


def test_leapfrog_updates_in_place_and_rolls_ao():
    m, x, v, a, ao = _arrays(8, 2, np.float32, seed=1)
    s = SystemState.from_numpy(m, x, v, a, ao, device=CPU)
    x_before = s.x
    out = leapfrog_step(s, 0.5)
    assert out.x is x_before and s.x.data_ptr() == out.x.data_ptr()
    assert out.ao is out.a
    np.testing.assert_array_equal(out.ao.numpy(), a)


def test_two_body_orbit_conserves_energy():
    """Physics oracle as in tests/test_integrator_energy.py: a bound circular
    orbit integrated with the port's force and leapfrog."""
    from nbody_torch.ops.allpairs import allpairs_accel

    G, dt = 1.0, 1e-3
    eps = float(np.finfo(np.float64).eps)
    s = SystemState.from_numpy([1.0, 1e-3], [[0.0, 0.0], [1.0, 0.0]],
                               [[0.0, 0.0], [0.0, 1.0]], dtype=np.float64, device=CPU)
    e0 = sum(t.item() for t in calc_energies(s.m, s.x, s.v, G, eps))
    for _ in range(200):
        s = leapfrog_step(dataclasses.replace(s, a=allpairs_accel(s.m, s.x, G, eps)), dt)
    e1 = sum(t.item() for t in calc_energies(s.m, s.x, s.v, G, eps))
    assert abs(e1 - e0) / abs(e0) < 1e-3
    assert abs(torch.linalg.norm(s.x[1] - s.x[0]).item() - 1.0) < 1e-3
