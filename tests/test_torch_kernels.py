"""The hand-written CUDA kernels against their plain torch twins, on the
card: the all-pairs kernels (csrc/allpairs.cu) and the tree kernels
(csrc/group_eval.cu): far, the octree's interval window, the BVH's
node-mask and dense-mask windows, and entries, each far and entries test
under both softenings, and the list paths' kernel in float32 and float64
under both. Every test here needs an
NVIDIA GPU with nvcc (the kernels are built from nbody_torch/csrc at
first use) and skips without one; on the GPU machine run them with

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerance, per row and component: |kernel - twin| <= TOL * sum_j |term|
(both sum the same terms in different orders), with TOL = 1e-5 in
float32 and 1e-12 in float64; for the potential, whose terms are all
positive, the scale is the row value itself. The same tolerance holds the
kernels against references that share no code with the twins: a float64
numpy evaluation of the same inputs, and nbody_tpu's jnp functions where
jax is importable.
"""

import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_allpairs as ca
from nbody_torch.ops import cuda_group_eval as cg

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bodies(n, dim, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dtype, device=dev),
            torch.tensor(rng.uniform(-1.0, 1.0, (n, dim)), dtype=dtype, device=dev))


def _numpy_refs(xi, mj, xj, eps, softening):
    """float64 numpy force sum_j m_j (x_j - x_i) / t, its sum_j |term|
    scale, and (for a square block) the potential rowsums."""
    xi, mj, xj = (a.double().cpu().numpy() for a in (xi, mj, xj))
    d = xj[None, :, :] - xi[:, None, :]
    d2 = np.sum(d * d, axis=-1)
    r = np.sqrt(d2)
    t = (r + eps) ** 3 if softening == "sqrt3" else d2 * r + eps
    w = mj[None, :] / t
    force = np.einsum("kn,knd->kd", w, d)
    scale = np.einsum("kn,knd->kd", np.abs(w), np.abs(d))
    pe = None
    if xi.shape == xj.shape:
        inv = mj[None, :] / (r + eps)
        np.fill_diagonal(inv, 0.0)
        pe = mj * inv.sum(axis=1)
    return force, scale, pe


def _assert_within(got, ref, scale, dtype):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    assert torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= TOL[dtype] * scale).all()), \
        ((got - ref).abs() / scale).max().item()


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_kernel_vs_twin(dev, dtype, dim, softening, n):
    m, x = _bodies(n, dim, dtype, dev, seed=n + dim)
    eps = float(torch.finfo(dtype).eps)
    got = ca.allpairs_block_cuda(x, m, x, eps, softening)
    _assert_within(got, ca.allpairs_block_torch(x, m, x, eps, softening),
                   ca.allpairs_block_abs_torch(x, m, x, eps, softening), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_kernel_rectangular(dev, dtype):
    _, xi = _bodies(777, 3, dtype, dev, seed=1)
    mj, xj = _bodies(2051, 3, dtype, dev, seed=2)
    eps = float(torch.finfo(dtype).eps)
    for soft in ("poly", "sqrt3"):
        got = ca.allpairs_block_cuda(xi, mj, xj, eps, soft)
        _assert_within(got, ca.allpairs_block_torch(xi, mj, xj, eps, soft),
                       ca.allpairs_block_abs_torch(xi, mj, xj, eps, soft), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_accel_applies_g_after_the_sum(dev, dtype):
    m, x = _bodies(1000, 3, dtype, dev, seed=3)
    eps, G = float(torch.finfo(dtype).eps), 1e-4
    got = ca.allpairs_accel_cuda(m, x, G, eps)
    _assert_within(got, G * ca.allpairs_block_torch(x, m, x, eps),
                   G * ca.allpairs_block_abs_torch(x, m, x, eps), dtype)
    raw = ca.allpairs_block_cuda(x, m, x, eps)
    assert torch.equal(got, G * raw)


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_potential_kernel_vs_twin(dev, dtype, dim, n):
    m, x = _bodies(n, dim, dtype, dev, seed=n * dim)
    eps = float(torch.finfo(dtype).eps)
    ref = ca.potential_rowsums_torch(m, x, eps)
    _assert_within(ca.potential_rowsums_cuda(m, x, eps), ref, ref.abs(), dtype)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_vs_numpy_float64(dev, dtype, dim, softening):
    """Both kernels against a float64 numpy evaluation, square and
    rectangular, so a mistake the twins share with a kernel still shows."""
    mj, xj = _bodies(1029, dim, dtype, dev, seed=7 + dim)
    xi = xj[:300].contiguous()
    eps = float(torch.finfo(dtype).eps)
    for rows in (xj, xi):
        force, scale, pe = _numpy_refs(rows, mj, xj, eps, softening)
        got = ca.allpairs_block_cuda(rows, mj, xj, eps, softening)
        torch.cuda.synchronize()
        err = np.abs(got.double().cpu().numpy() - force)
        assert np.all(err <= TOL[dtype] * scale), float(np.max(err / scale))
    got_pe = ca.potential_rowsums_cuda(mj, xj, eps).double().cpu().numpy()
    _, _, pe = _numpy_refs(xj, mj, xj, eps, softening)
    assert np.all(np.abs(got_pe - pe) <= TOL[dtype] * pe)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_vs_nbody_tpu(dev, dtype):
    """The kernels against nbody_tpu's jnp allpairs_accel and calc_energies
    on the same numpy inputs; skips where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from nbody_tpu.ops import allpairs as jap
    from nbody_tpu.ops import energy as jenergy

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(8)
    m = rng.uniform(0.1, 1.0, 1000).astype(np_dtype)
    x, v = rng.uniform(-1.0, 1.0, (2, 1000, 3)).astype(np_dtype)
    eps, G = float(np.finfo(np_dtype).eps), 0.5
    tm, tx = (torch.tensor(a, device=dev) for a in (m, x))
    ref = np.asarray(jap.allpairs_accel(jnp.asarray(m), jnp.asarray(x), G, eps, chunk=256),
                     np.float64)
    got = ca.allpairs_accel_cuda(tm, tx, G, eps).double().cpu().numpy()
    scale = G * _numpy_refs(tx, tm, tx, eps, "poly")[1]
    assert np.all(np.abs(got - ref) <= TOL[dtype] * scale)
    _, jpe = jenergy.calc_energies(jnp.asarray(m), jnp.asarray(x), jnp.asarray(v), G, eps,
                                   chunk=256)
    pe = -0.5 * G * ca.potential_rowsums_cuda(tm, tx, eps).double().sum().item()
    assert abs(pe - float(jpe)) <= TOL[dtype] * abs(float(jpe))


def test_potential_diagonal_masked_by_global_index(dev):
    """Coincident bodies in different 256-row blocks: only i == j is
    skipped, so each body sees the other one's m / eps."""
    n = 600
    m = torch.ones(n, dtype=torch.float64, device=dev)
    x = torch.zeros(n, 2, dtype=torch.float64, device=dev)
    eps = 0.5
    pe = ca.potential_rowsums_cuda(m, x, eps)
    torch.cuda.synchronize()
    assert torch.equal(pe, torch.full_like(pe, (n - 1) / eps))
    one = ca.potential_rowsums_cuda(m[:1], x[:1], eps)
    assert one.item() == 0.0


def test_self_and_coincident_force_terms_vanish(dev):
    eps = float(torch.finfo(torch.float32).eps)
    m = torch.tensor([1.0, 2.0], device=dev)
    x = torch.tensor([[0.5, 0.5], [0.5, 0.5]], device=dev)
    for soft in ("poly", "sqrt3"):
        a = ca.allpairs_block_cuda(x, m, x, eps, soft)
        torch.cuda.synchronize()
        assert torch.equal(a, torch.zeros_like(a))


def test_launch_counters(dev):
    m, x = _bodies(300, 2, torch.float32, dev, seed=5)
    ca.reset_launch_counts()
    ca.allpairs_accel_cuda(m, x, 1.0, 1e-7)
    ca.allpairs_block_cuda(x, m, x, 1e-7, "sqrt3")
    ca.potential_rowsums_cuda(m, x, 1e-7)
    ca.allpairs_block_cuda(x[:0], m, x, 1e-7)  # no rows: no launch
    ca.allpairs_block_torch(x, m, x, 1e-7)     # the twin never counts
    assert ca.launch_counts == {"allpairs_block_kernel": 2, "potential_rowsums_kernel": 1}
    ca.reset_launch_counts()
    assert ca.launch_counts == {"allpairs_block_kernel": 0, "potential_rowsums_kernel": 0}


def test_wrapper_raises_on_mixed_devices(dev):
    m, x = _bodies(10, 2, torch.float32, dev, seed=6)
    with pytest.raises(ValueError):
        ca.allpairs_accel_cuda(m.cpu(), x, 1.0, 1e-7)


def test_engine_step_on_card_matches_cpu(dev):
    """One all-pairs step through the engine, on the card and on the CPU."""
    import dataclasses

    from nbody_torch.models import build_galaxy_model
    from nbody_torch.sim.engines import EngineOptions, get_engine

    outs = []
    for device in (dev, torch.device("cpu")):
        cfg, s = build_galaxy_model(2000, 3, np.float64, device)
        step = get_engine("all-pairs").make_step(cfg, EngineOptions(), device)
        for _ in range(3):
            s, _ = step(s)
        outs.append({f.name: getattr(s, f.name).cpu() for f in dataclasses.fields(s)})
    for name in ("x", "v", "a"):
        torch.testing.assert_close(outs[0][name], outs[1][name], rtol=1e-10, atol=1e-14)


# ------------------------------------------------ octree fast-path kernels

EPS32 = float(np.finfo(np.float32).eps)


def _group_scale(xi, mj, xj, sel, tb, softening="sqrt3"):
    """float64 sum_j |m_j (x_j - x_i) / t| per row and component over the
    bodies sel[t] (T, nj) bool of each row tile t."""
    xi, mj, xj = (a.double().cpu().numpy() for a in (xi, mj, xj))
    out = np.zeros_like(xi)
    for t in range(sel.shape[0]):
        cols = np.flatnonzero(sel[t])
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[cols][None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        r = np.sqrt(d2)
        t3 = (r + EPS32) ** 3 if softening == "sqrt3" else d2 * r + EPS32
        out[rows] = np.einsum("kn,knd->kd", mj[cols][None, :] / t3, np.abs(d))
    return torch.tensor(out, dtype=torch.float32)


def _assert_group_within(got, ref, scale):
    torch.cuda.synchronize()
    got, ref = got.cpu(), ref.cpu()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got - ref).abs()
    assert bool((err <= 1e-5 * scale).all()), (err / scale.clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("tb", [512, 300, 700])
@pytest.mark.parametrize("dim", [2, 3])
def test_far_kernel_vs_twin(dev, dim, tb, softening):
    """A ragged node count (1500), tiles of 512, 300 and 700 rows, and a
    tile that accepts no node."""
    ntiles, w = 5, 1500
    mj, xj = _bodies(w, dim, torch.float32, dev, seed=40 + dim)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=41 + dim)
    mask = torch.tensor(np.random.default_rng(42).random((ntiles, w)) < 0.3, device=dev)
    mask[1] = False
    words = cg.pack_mask_bits(mask)
    got = cg.masked_eval_bits_cuda(xi, mj, xj, words, EPS32, softening)
    ref = cg.masked_eval_bits_torch(xi, mj, xj, words, EPS32, softening)
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, mask.cpu().numpy(), tb, softening))
    assert not got[tb:2 * tb].any()


@pytest.mark.parametrize("dim", [2, 3])
def test_window_kernel_vs_twin(dev, dim):
    """Random windows and intervals over a ragged body count, an empty
    interval, and an interval that runs past the last body."""
    ntiles, tb, wt = 9, 512, 4
    nj = ntiles * tb - 77
    mj, xj = _bodies(nj, dim, torch.float32, dev, seed=50 + dim)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=51 + dim)
    rng = np.random.default_rng(52)
    w0 = rng.integers(0, ntiles - wt + 1, ntiles)
    lo = (w0 * tb + rng.integers(-300, 900, ntiles)).clip(0)
    hi = lo + rng.integers(0, wt * tb + 600, ntiles)
    hi[2], hi[-1] = lo[2], ntiles * tb + 100
    args = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (w0, lo, hi)]
    got = cg.window_eval_interval_cuda(xi, mj, xj, *args, EPS32, wt)
    ref = cg.window_eval_interval_torch(xi, mj, xj, *args, EPS32, wt)
    cols = np.arange(nj)[None, :]
    sel = (cols >= np.maximum(lo, w0 * tb)[:, None]) & (cols < np.minimum(hi, (w0 + wt) * tb)[:, None])
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, sel, tb))
    assert not got[2 * tb:3 * tb].any()


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_entries_kernel_vs_twin(dev, dim, softening):
    """A tile-sorted entry list with tiles that have no entries, lo == hi
    sentinels, whole blocks, entries past n_real, and a ragged last block."""
    ntiles, tb, S = 7, 512, 1024
    nj = 4 * S - 100
    mj, xj = _bodies(nj, dim, torch.float32, dev, seed=60 + dim)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=61 + dim)
    rng = np.random.default_rng(62)
    ents, lohis = [], []
    sel = np.zeros((ntiles, nj), bool)
    for tile in (0, 1, 3, 6):  # tiles 2, 4 and 5 have no entries
        ents.append(tile << 16)
        lohis.append(0)
        for blk in range(4):
            lo, hi = (0, S) if tile == 3 else sorted(int(v) for v in rng.integers(0, S + 1, 2))
            ents.append((tile << 16) | blk)
            lohis.append(lo | (hi << 16))
            sel[tile, blk * S + lo:min(blk * S + hi, nj)] = True
    n_real = torch.tensor(len(ents), device=dev)
    ents += [(ntiles - 1) << 16 | 2] * 5  # pads: ignored past n_real
    lohis += [7 | (900 << 16)] * 5
    e = torch.tensor(ents, dtype=torch.int32, device=dev)
    lh = torch.tensor(lohis, dtype=torch.int32, device=dev)
    got = cg.entries_lohi_eval_cuda(xi, mj, xj, e, lh, n_real, S, ntiles, EPS32, softening)
    ref = cg.entries_lohi_eval_torch(xi, mj, xj, e, lh, n_real, S, ntiles, EPS32, softening)
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, sel, tb, softening))
    for tile in (2, 4, 5):
        assert not got[tile * tb:(tile + 1) * tb].any()


def _window_case(dev, dim, tb, wt, S, seed):
    """Rows, ragged bodies (nj not a multiple of S or tb) and a random
    per-slot window mask with one tile wholly closed and one wholly open;
    sel (T, nj) marks the bodies each tile sees."""
    ntiles = 9
    nj = ntiles * tb - 77
    mj, xj = _bodies(nj, dim, torch.float32, dev, seed=seed)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    w0 = rng.integers(0, ntiles - wt + 1, ntiles)
    in_win = rng.random((ntiles, wt * tb // S)) < 0.5
    in_win[2], in_win[4] = False, True
    cols = w0[:, None] * tb + np.arange(wt * tb)[None, :]
    seen = np.repeat(in_win, S, axis=1) & (cols < nj)
    sel = np.zeros((ntiles, nj), bool)
    for t in range(ntiles):
        sel[t, cols[t][seen[t]]] = True
    return (xi, mj, xj, torch.tensor(w0, dtype=torch.int32, device=dev),
            torch.tensor(in_win, device=dev), sel)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("tb,wt,S", [(512, 4, 512), (512, 2, 8), (300, 3, 100)])
@pytest.mark.parametrize("dim", [2, 3])
def test_nodemask_window_kernel_vs_twin(dev, dim, tb, wt, S, softening):
    """Slots of 512 (the 2^20 shape), of 8 bodies (128 slots per window
    block, past the TPU kernel's 64) and of 100 in 300-row tiles; ragged
    bodies, a closed and an open window."""
    xi, mj, xj, w0, in_win, sel = _window_case(dev, dim, tb, wt, S, seed=90 + dim)
    got = cg.window_eval_nodemask_cuda(xi, mj, xj, w0, in_win, EPS32, wt, S, softening)
    ref = cg.window_eval_nodemask_torch(xi, mj, xj, w0, in_win, EPS32, wt, S, softening)
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, sel, tb, softening))
    assert not got[2 * tb:3 * tb].any()


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_dense_window_kernel_vs_twin(dev, dim, softening):
    """The dense-mask window: a 0/1 mask from per-slot openness, then
    arbitrary float weights on the masses."""
    tb, wt, S = 512, 4, 16
    xi, mj, xj, w0, in_win, sel = _window_case(dev, dim, tb, wt, S, seed=95 + dim)
    mask = in_win.float().repeat_interleave(S, dim=1).contiguous()
    got = cg.window_eval_dense_cuda(xi, mj, xj, w0, mask, EPS32, wt, softening)
    ref = cg.window_eval_dense_torch(xi, mj, xj, w0, mask, EPS32, wt, softening)
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, sel, tb, softening))
    weights = torch.rand(mask.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    got = cg.window_eval_dense_cuda(xi, mj, xj, w0, weights * mask, EPS32, wt, softening)
    ref = cg.window_eval_dense_torch(xi, mj, xj, w0, weights * mask, EPS32, wt, softening)
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, sel, tb, softening))


@pytest.mark.parametrize("dim", [2, 3])
def test_bvh_fast_path_on_card_matches_cpu(dev, dim):
    """compute_force_grouped_windowed on the card (the far, node-mask,
    entries and poly fallback kernels) and on the CPU (the twins), with a
    2-tile window and a small e_chunk so that the residual and the
    fallback run: equal counters, forces within 1e-5 of sum |a|; and an
    n = 16 system through the dense-mask window."""
    from nbody_torch.ops import bvh, bvh_group
    from nbody_torch.state import SystemState

    for n, kw in ((20000, dict(window_tiles=2, e_chunk=8)), (16, {})):
        rng = np.random.default_rng(75 + dim)
        centers = rng.uniform(-40, 40, (9, dim))
        x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
        m = rng.uniform(0.1, 1, n).astype(np.float32)
        out = {}
        cg.reset_launch_counts()
        for device in (dev, torch.device("cpu")):
            st = bvh.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=device),
                                  EPS32)
            tree = bvh.build_tree(st.m, st.x, EPS32)
            a, info = bvh_group.compute_force_grouped_windowed(tree, st.m, st.x, 0.5, 1.0, EPS32,
                                                               **kw)
            out[device.type] = (a.cpu(), {k: int(v) for k, v in info.items()})
        (ga, ginfo), (ca_, cinfo) = out["cuda"], out["cpu"]
        assert ginfo == cinfo and cinfo["bad_entries"] == 0
        assert ((ga - ca_).abs().sum() / ca_.abs().sum()).item() < 1e-5
        if n == 16:
            assert cg.launch_counts["window_eval_dense_kernel"] == 1
        else:
            assert cinfo["entries"] > 0 and cinfo["fallback_tiles"] > 0
            assert cg.launch_counts["window_eval_nodemask_kernel"] == 1


@pytest.mark.parametrize("dim", [2, 3])
def test_octree_fast_path_on_card_matches_cpu(dev, dim):
    """compute_force_grouped_fast on the card (the three kernels and the
    sqrt3 fallback) and on the CPU (the twins): equal counters, forces
    within 1e-5 of sum |a|."""
    from nbody_torch.ops import octree, octree_group

    n = 20000
    rng = np.random.default_rng(70 + dim)
    x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    m = rng.uniform(0.1, 1, n).astype(np.float32)
    depth = octree.max_depth(n, dim)
    out = {}
    for device in (dev, torch.device("cpu")):
        lo, hi = octree.robust_quant_box(torch.tensor(x, device=device))
        ms, xs, ks, _ = octree.morton_sort(torch.tensor(m, device=device),
                                           torch.tensor(x, device=device), lo, hi, depth)
        a, info = octree_group.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS32,
                                                          window_tiles=1, e_chunk=1024)
        out[device.type] = (a.cpu(), {k: int(v) for k, v in info.items()})
    (ga, ginfo), (ca_, cinfo) = out["cuda"], out["cpu"]
    assert ginfo == cinfo and cinfo["entries"] > 0
    assert ((ga - ca_).abs().sum() / ca_.abs().sum()).item() < 1e-5


def test_group_launch_counters(dev):
    mj, xj = _bodies(64, 2, torch.float32, dev, seed=80)
    cg.reset_launch_counts()
    words = cg.pack_mask_bits(torch.ones(1, 64, dtype=torch.bool, device=dev))
    cg.masked_eval_bits_cuda(xj, mj, xj, words, EPS32, "poly")
    i32 = dict(dtype=torch.int32, device=dev)
    zero = torch.zeros(1, **i32)
    cg.window_eval_interval_cuda(xj, mj, xj, zero, zero, torch.full((1,), 64, **i32), EPS32, 1)
    cg.entries_lohi_eval_cuda(xj, mj, xj, zero, zero, torch.tensor(1, device=dev), 64, 1, EPS32,
                              "poly")
    cg.window_eval_nodemask_cuda(xj, mj, xj, zero, torch.ones(1, 4, dtype=torch.bool, device=dev),
                                 EPS32, 1, 16, "poly")
    cg.window_eval_dense_cuda(xj, mj, xj, zero, torch.ones(1, 64, device=dev), EPS32, 1, "poly")
    heads = (64, torch.full((1,), 64, **i32), zero)
    cg.group_eval_cuda(xj, mj[None], xj[None], EPS32, "sqrt3", *heads)
    cg.group_eval_cuda(xj.double(), mj[None].double(), xj[None].double(), EPS32, "poly", *heads)
    cg.masked_eval_bits_torch(xj, mj, xj, words, EPS32, "poly")  # the twin never counts
    cg.group_eval_torch(xj, mj[None], xj[None], EPS32, "sqrt3", *heads)
    assert cg.launch_counts == {"masked_eval_bits_kernel": 1, "window_eval_interval_kernel": 1,
                                "window_eval_nodemask_kernel": 1, "window_eval_dense_kernel": 1,
                                "entries_lohi_kernel": 1,
                                "group_eval_kernel<float32, poly>": 0,
                                "group_eval_kernel<float32, sqrt3>": 1,
                                "group_eval_kernel<float64, poly>": 1,
                                "group_eval_kernel<float64, sqrt3>": 0}
    with pytest.raises(TypeError):
        cg.masked_eval_bits_cuda(xj.double(), mj.double(), xj.double(), words, EPS32, "poly")


# ------------------------------------------------------- the list paths


def _list_inputs(dev, dim, dtype, seed, ntiles=6, tb=512, split=700, length=1500):
    """Rows and per-tile lists with random live heads n0 <= split and
    n1 <= length - split, mass 0 past them; tile 1's lists are empty and
    tile 3's are all padding (mass 0 everywhere, heads at full length)."""
    rng = np.random.default_rng(seed)
    xi = torch.tensor(rng.uniform(-1, 1, (ntiles * tb, dim)), dtype=dtype, device=dev)
    xj = torch.tensor(rng.uniform(-1.5, 1.5, (ntiles, length, dim)), dtype=dtype, device=dev)
    n0 = rng.integers(0, split + 1, ntiles)
    n1 = rng.integers(0, length - split + 1, ntiles)
    n0[1] = n1[1] = 0
    n0[3], n1[3] = split, length - split
    lane = np.arange(length)[None, :]
    live = (lane < n0[:, None]) | ((lane >= split) & (lane < split + n1[:, None]))
    live[3] = False
    mj = torch.tensor(np.where(live, rng.uniform(0.1, 1, (ntiles, length)), 0), dtype=dtype,
                      device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return xi, mj, xj, split, torch.tensor(n0, **i32), torch.tensor(n1, **i32), live


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_eval_kernel_vs_twin(dev, dtype, dim, softening):
    """The list kernel over the live heads against its twin and against
    float64 numpy, within TOL of each row's sum of |term|; both whole
    padded segments give the same bits (padding adds exact zeros in the
    same groups); empty and all-padding tiles get zeros."""
    xi, mj, xj, split, n0, n1, live = _list_inputs(dev, dim, dtype, seed=110 + dim)
    eps = float(torch.finfo(dtype).eps)
    got = cg.group_eval_cuda(xi, mj, xj, eps, softening, split, n0, n1)
    ref = cg.group_eval_torch(xi, mj, xj, eps, softening, split, n0, n1)
    scale = cg.group_eval_torch(xi, mj, xj, eps, softening, split, n0, n1, absolute=True)
    _assert_within(got, ref, scale, dtype)
    full = torch.full_like(n0, split), torch.full_like(n1, mj.shape[1] - split)
    whole = cg.group_eval_cuda(xi, mj, xj, eps, softening, split, *full)
    torch.cuda.synchronize()
    assert torch.equal(got, whole)
    assert not got[512:1024].any() and not got[3 * 512:4 * 512].any()
    tb = 512
    x64, m64, j64 = (a.double().cpu().numpy() for a in (xi, mj, xj))
    for t in range(mj.shape[0]):
        cols = np.flatnonzero(live[t])
        force, tscale, _ = _numpy_refs(torch.tensor(x64[t * tb:(t + 1) * tb]),
                                       torch.tensor(m64[t][cols]), torch.tensor(j64[t][cols]),
                                       eps, softening)
        err = np.abs(got[t * tb:(t + 1) * tb].double().cpu().numpy() - force)
        assert np.all(err <= TOL[dtype] * tscale), float(np.max(err / np.maximum(tscale, 1e-300)))


@pytest.mark.parametrize("tree", ["octree", "bvh"])
@pytest.mark.parametrize("dim", [2, 3])
def test_list_paths_on_card_match_cpu(dev, tree, dim):
    """compute_force_grouped of a 17,000-body float64 galaxy on the card
    (the list kernel and the all-pairs fallback) and on the CPU (the
    twins), with caps of 1,024, small enough that tiles fall back (25-29
    of 34 in the octree, 10 in the 3-D BVH): equal counters, forces within
    1e-12 of sum |a|; the list kernel and the fallback launched once per
    call."""
    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.ops.geometry import scalar_bounds
    from nbody_torch.state import SystemState

    n = 17000
    _, s = build_galaxy_model(n, dim, np.float64, torch.device("cpu"))
    m, x = s.m.numpy(), s.x.numpy()
    eps = float(np.finfo(np.float64).eps)
    out = {}
    for device in (dev, torch.device("cpu")):
        cg.reset_launch_counts()
        ca.reset_launch_counts()
        if tree == "octree":
            tm, tx = torch.tensor(m, device=device), torch.tensor(x, device=device)
            lo, hi = scalar_bounds(tx)
            levels, _, ms, xs = octree.build_octree(tm, tx, lo, hi, octree.max_depth(n, dim))
            a, info = octree_group.compute_force_grouped(levels, ms, xs, hi - lo, 0.5, 1.0, eps,
                                                         cap_nodes=1024, cap_leaves=1024)
        else:
            st = bvh.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=device),
                                  eps)
            a, info = bvh_group.compute_force_grouped(bvh.build_tree(st.m, st.x, eps), st.m,
                                                      st.x, 0.5, 1.0, eps, cap_nodes=1024,
                                                      cap_leaves=1024)
        out[device.type] = (a.cpu(), {k: int(v) for k, v in info.items()},
                            cg.launch_counts[cg.group_eval_name(
                                torch.float64, "sqrt3" if tree == "octree" else "poly")],
                            ca.launch_counts["allpairs_block_kernel"])
    (ga, ginfo, glaunch, gfb), (pa, pinfo, plaunch, pfb) = out["cuda"], out["cpu"]
    assert ginfo == pinfo and pinfo["fallback_tiles"] < -(-n // 512)
    assert pinfo["fallback_tiles"] > 0 or (tree, dim) == ("bvh", 2)
    assert ((ga - pa).abs().sum() / pa.abs().sum()).item() < 1e-12
    assert (glaunch, plaunch, pfb) == (1, 0, 0) and gfb == int(pinfo["fallback_tiles"] > 0)


@pytest.mark.parametrize("tree", ["octree", "bvh"])
def test_float32_list_step_on_card_matches_cpu(dev, tree):
    """The float32 list path through the step function (list_path=True) of
    a 17,000-body 3-D galaxy launches the list kernel's float32
    instantiation once, and its forces are within 1e-5 of sum |a| of the
    CPU twins', in the same body order."""
    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops import bvh, octree
    from nbody_torch.state import SystemState

    n = 17000
    _, s = build_galaxy_model(n, 3, np.float32, torch.device("cpu"))
    eps = float(np.finfo(np.float32).eps)
    out = {}
    for device in (dev, torch.device("cpu")):
        st = SystemState.from_numpy(s.m.numpy(), s.x.numpy(), s.v.numpy(), device=device)
        cg.reset_launch_counts()
        if tree == "octree":
            got, _ = octree.octree_step_force(st, 0.5, 1.0, eps, octree.max_depth(n, 3),
                                              list_path=True)
        else:
            got, _ = bvh.bvh_step_force(st, 0.5, 1.0, eps, list_path=True)
        out[device.type] = (got.x.cpu(), got.a.cpu(), dict(cg.launch_counts))
    (gx, ga, glaunch), (px, pa, plaunch) = out["cuda"], out["cpu"]
    assert torch.equal(gx, px)
    assert ((ga - pa).abs().sum() / pa.abs().sum()).item() < 1e-5
    key = cg.group_eval_name(torch.float32, "sqrt3" if tree == "octree" else "poly")
    assert glaunch[key] == 1 and sum(plaunch.values()) == 0
