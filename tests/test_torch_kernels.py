"""The hand-written CUDA kernels against their plain torch twins, on the
card: the all-pairs kernels (csrc/allpairs.cu) and the tree kernels
(csrc/group_eval.cu): far, the octree's interval window, the BVH's
node-mask and dense-mask windows, and entries, each far, interval window
and entries test under both softenings, the ablation path's dense-mask far field,
supertile-shared monopoles and packed-source entries (which must equal
the unpacked kernel bit for bit), the list paths' kernel in float32 and float64
under both (split into parts in the kernel, as are the three windows:
every part count and both launches of a call bit-equal; the second pass
bit-equal to its plain version on slices that take 16-byte loads and on
those that do not), the table-driven entries and the entry-cost probes' ladder and
copy-ring kernels (csrc/entry_probes.cu), and the all-pairs variants (the Newton and fast
instantiations, and the hybrid kernel of csrc/allpairs_mxu.cu, whose
counts of tile pairs by branch must equal their twins', and the decision
kernels of csrc/tile_decide.cu that they launch first, bit-equal to their
plain versions, on layouts a few ulps either side of each threshold too), and
the trees' per-body walks (csrc/tree_walk.cu). Every test
here needs an NVIDIA GPU with nvcc (the kernels are built from
nbody_torch/csrc at first use) and skips without one; on the GPU machine
run them with

    python -m pytest tests/test_torch_kernels.py -m cuda

Tolerance, per row and component: |kernel - twin| <= TOL * sum_j |term|
(both sum the same terms in different orders), with TOL = 1e-5 in
float32 and 1e-12 in float64; for the potential, whose terms are all
positive, the scale is the row value itself. The same tolerance holds the
kernels against references that share no code with the twins: a float64
numpy evaluation of the same inputs, and nbody_tpu's jnp functions where
jax is importable. The hybrid kernel's fast instantiation is held within
MXU_FAST_TOL (below) of its twin.
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


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_kernel_vs_twin(dev, dtype, dim, softening, n, exact):
    """The chain (exact=False: Newton in float32, the refined seeds in
    float64) and the IEEE weight, both within TOL of the IEEE twin."""
    m, x = _bodies(n, dim, dtype, dev, seed=n + dim)
    eps = float(torch.finfo(dtype).eps)
    got = ca.allpairs_block_cuda(x, m, x, eps, softening, exact=exact)
    _assert_within(got, ca.allpairs_block_torch(x, m, x, eps, softening),
                   ca.allpairs_block_abs_torch(x, m, x, eps, softening), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_kernel_rectangular(dev, dtype):
    _, xi = _bodies(777, 3, dtype, dev, seed=1)
    mj, xj = _bodies(2051, 3, dtype, dev, seed=2)
    eps = float(torch.finfo(dtype).eps)
    for soft in ("poly", "sqrt3"):
        for exact in (False, True):
            got = ca.allpairs_block_cuda(xi, mj, xj, eps, soft, exact=exact)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_self_and_coincident_force_terms_vanish(dev, dtype):
    """A pair at d2 = 0: the chain lifts d2 to the least normal, so its
    weight is finite and its term w * 0 is zero; the IEEE weight is m / eps."""
    eps = float(torch.finfo(dtype).eps)
    m = torch.tensor([1.0, 2.0], dtype=dtype, device=dev)
    x = torch.tensor([[0.5, 0.5], [0.5, 0.5]], dtype=dtype, device=dev)
    for soft in ("poly", "sqrt3"):
        for exact in (False, True):
            a = ca.allpairs_block_cuda(x, m, x, eps, soft, exact=exact)
            torch.cuda.synchronize()
            assert torch.equal(a, torch.zeros_like(a))
    pe = ca.potential_rowsums_cuda(m, x, eps)
    torch.cuda.synchronize()
    assert torch.isfinite(pe).all() and torch.allclose(pe, m * m.flip(0) / eps, rtol=1e-6)


def test_launch_counters(dev):
    """One count per launch, by instantiation; a plan with splits also
    launches split_sum_kernel (300 bodies are two tiles: two splits)."""
    m, x = _bodies(300, 2, torch.float32, dev, seed=5)
    assert ca.block_plan(300, 300, torch.float32, ca.sm_count_of(0)).splits == 2
    ca.reset_launch_counts()
    ca.allpairs_accel_cuda(m, x, 1.0, 1e-7)
    ca.allpairs_block_cuda(x, m, x, 1e-7, "sqrt3")
    ca.allpairs_block_cuda(x, m, x, 1e-7, exact=True)
    ca.allpairs_block_cuda(x.double(), m.double(), x.double(), 1e-7)
    ca.potential_rowsums_cuda(m, x, 1e-7)
    ca.allpairs_block_cuda(x[:0], m, x, 1e-7)  # no rows: no launch
    ca.allpairs_block_torch(x, m, x, 1e-7)     # the twin never counts
    assert ca.launch_counts == {ca.EXACT: 1, ca.NEWTON: 2, ca.NEWTON64: 1, ca.FAST: 0,
                                ca.POTENTIAL: 1, ca.SPLIT_SUM: 5}
    ca.reset_launch_counts()
    assert set(ca.launch_counts.values()) == {0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_few_rows_take_the_split_path(dev, dtype):
    """Few rows against many bodies (chip_smoke.py phase 2's 9,216 x 2^20 at
    test size): the plan splits the bodies, and the split sums stay within
    TOL of the twin, under both softenings and both weights."""
    mj, xj = _bodies(40000, 3, dtype, dev, seed=21)
    xi = xj[:300].contiguous()
    assert ca.block_plan(300, 40000, dtype, ca.sm_count_of(0)).splits > 1
    eps = float(torch.finfo(dtype).eps)
    for soft in ("poly", "sqrt3"):
        for exact in (False, True):
            _assert_within(ca.allpairs_block_cuda(xi, mj, xj, eps, soft, exact=exact),
                           ca.allpairs_block_torch(xi, mj, xj, eps, soft),
                           ca.allpairs_block_abs_torch(xi, mj, xj, eps, soft), dtype)


@pytest.mark.parametrize("ni", [1, 31, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ragged_rows_vs_twin(dev, dtype, ni):
    mj, xj = _bodies(20011, 3, dtype, dev, seed=ni)
    xi = xj[:ni].contiguous()
    eps = float(torch.finfo(dtype).eps)
    for soft in ("poly", "sqrt3"):
        _assert_within(ca.allpairs_block_cuda(xi, mj, xj, eps, soft),
                       ca.allpairs_block_torch(xi, mj, xj, eps, soft),
                       ca.allpairs_block_abs_torch(xi, mj, xj, eps, soft), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_and_unsplit_plans_vs_twin(dev, dtype):
    """The force and the potential on a plan of one split (a 1-SM card's)
    and on one of several (the H100's)."""
    m, x = _bodies(2500, 3, dtype, dev, seed=22)
    eps = float(torch.finfo(dtype).eps)
    ref, scale = ca.allpairs_block_torch(x, m, x, eps), ca.allpairs_block_abs_torch(x, m, x, eps)
    pe_ref = ca.potential_rowsums_torch(m, x, eps)
    plans = [ca.block_plan(2500, 2500, dtype, sms) for sms in (1, 132)]
    assert plans[0].splits == 1 and plans[1].splits > 1
    for plan in plans:
        _assert_within(ca.allpairs_block_cuda(x, m, x, eps, plan=plan), ref, scale, dtype)
        _assert_within(ca.potential_rowsums_cuda(m, x, eps, plan=plan), pe_ref, pe_ref.abs(),
                       dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_potential_diagonal_across_a_split_boundary(dev, dtype):
    """3,001 bodies against 12 splits of 256 bodies: in float32 the split
    boundaries cut through the row blocks of 512, so the diagonal of a
    block lies in two splits (a float64 row block is one tile). Coincident
    unit masses at eps = 0.5 give exactly (n - 1) / eps; random bodies stay
    within TOL of the twin."""
    n = 3001
    plan = ca.block_plan(n, n, dtype, ca.sm_count_of(0))
    assert plan.splits > 1
    if dtype == torch.float32:
        assert plan.split_len % plan.rows_per_block != 0
    m = torch.ones(n, dtype=dtype, device=dev)
    pe = ca.potential_rowsums_cuda(m, torch.zeros(n, 3, dtype=dtype, device=dev), 0.5)
    torch.cuda.synchronize()
    assert torch.equal(pe, torch.full_like(pe, (n - 1) / 0.5))
    m, x = _bodies(n, 3, dtype, dev, seed=23)
    eps = float(torch.finfo(dtype).eps)
    ref = ca.potential_rowsums_torch(m, x, eps)
    _assert_within(ca.potential_rowsums_cuda(m, x, eps), ref, ref.abs(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_launches_are_bit_equal(dev, dtype):
    """No atomics: the same call twice gives the same bits, split or not."""
    m, x = _bodies(5000, 3, dtype, dev, seed=24)
    eps = float(torch.finfo(dtype).eps)
    for sms in (1, 132):
        plan = ca.block_plan(5000, 5000, dtype, sms)
        for call in (lambda: ca.allpairs_block_cuda(x, m, x, eps, "sqrt3", plan=plan),
                     lambda: ca.allpairs_accel_cuda(m, x, 2.0, eps, plan=plan),
                     lambda: ca.potential_rowsums_cuda(m, x, eps, plan=plan)):
            a, b = call(), call()
            torch.cuda.synchronize()
            assert torch.equal(a, b)


def test_wrapper_refuses_a_plan_of_the_other_dtype(dev):
    """A float32 plan's row blocks hold 512 rows, a float64 kernel's 256."""
    m, x = _bodies(1000, 3, torch.float64, dev, seed=27)
    plan = ca.block_plan(1000, 1000, torch.float32, ca.sm_count_of(0))
    with pytest.raises(ValueError):
        ca.allpairs_block_cuda(x, m, x, 1e-7, plan=plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_sum_kernel_equals_twin(dev, dtype):
    """split_sum_kernel adds in split order, as its twin does: bit for bit."""
    rng = np.random.default_rng(25)
    parts = torch.tensor(rng.standard_normal((7, 1000, 3)), dtype=dtype, device=dev)
    mi = torch.tensor(rng.uniform(0.1, 1, 1000), dtype=dtype, device=dev)
    assert torch.equal(ca.split_sum_cuda(parts, 0.3), ca.split_sum_torch(parts, 0.3))
    one = parts[:, :, :1].contiguous()
    assert torch.equal(ca.split_sum_cuda(one, mi=mi), ca.split_sum_torch(one, mi=mi))


def test_float64_chain_within_ulps_of_ieee(dev):
    """The refined float64 seeds against the IEEE weight on the same plan
    (the same order of summation): within 16 ulps of each row's sum of
    |term|, so within a few ulps per term."""
    mj, xj = _bodies(50000, 3, torch.float64, dev, seed=26)
    xi = xj[:3000].contiguous()
    eps = float(torch.finfo(torch.float64).eps)
    for soft in ("poly", "sqrt3"):
        chain = ca.allpairs_block_cuda(xi, mj, xj, eps, soft)
        ieee = ca.allpairs_block_cuda(xi, mj, xj, eps, soft, exact=True)
        scale = ca.allpairs_block_abs_torch(xi, mj, xj, eps, soft)
        torch.cuda.synchronize()
        assert ((chain - ieee).abs() <= 16 * eps * scale).all()


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
        for k in range(3):
            s, _ = step(s, k)
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


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("case", ["all-set", "none-set", "w-1", "w-above-a-batch"])
@pytest.mark.parametrize("dim", [2, 3])
def test_far_kernel_compaction_edges(dev, dim, case, softening):
    """The compaction's edges on tiles of 700 rows (two row blocks a
    tile): every bit set, no bit set (zeros), one node, and 9,001 nodes
    (not a multiple of 32; two batches of ids, accepts across the batch
    boundary, and bits set past node 9,000 in the last word, which are not
    read); within 1e-5 of sum |term| of the twin, two launches bit-equal."""
    ntiles, tb = 3, 700
    w = {"all-set": 1500, "none-set": 1500, "w-1": 1, "w-above-a-batch": 9001}[case]
    mj, xj = _bodies(w, dim, torch.float32, dev, seed=44 + dim)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=45 + dim)
    xi[5] = xj[w - 1]  # a row on a node: d2 = 0, a zero term
    mask = np.random.default_rng(46).random((ntiles, w)) < 0.3
    if case == "all-set":
        mask[:] = True
    elif case == "none-set":
        mask[:] = False
    elif case == "w-1":
        mask[:, 0] = [True, False, True]
    else:
        mask[:, 8190:8194] = True
    words = cg.pack_mask_bits(torch.tensor(mask, device=dev))
    if case == "w-above-a-batch":
        words[:, -1] |= -(1 << (w % 32))  # bits 9..31 of the last word: no node
    got = cg.masked_eval_bits_cuda(xi, mj, xj, words, EPS32, softening)
    ref = cg.masked_eval_bits_torch(xi, mj, xj, words, EPS32, softening)
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, mask, tb, softening))
    assert _same_bits(got, cg.masked_eval_bits_cuda(xi, mj, xj, words, EPS32, softening))
    if case == "none-set":
        assert not got.any()


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("tb", [512, 700])
@pytest.mark.parametrize("dim", [2, 3])
def test_window_kernel_vs_twin(dev, dim, tb, softening):
    """The interval window: random windows and intervals over a ragged body
    count, an empty interval, an interval that runs past the last body and
    one that starts before its window; at the default part count and at
    P = 1, 2, 4, 8 (interval_parts' split), each within the tolerance, two
    launches bit-equal; tiles of 700 rows take two row blocks a part."""
    ntiles, wt = 9, 4
    nj = ntiles * tb - 77
    mj, xj = _bodies(nj, dim, torch.float32, dev, seed=50 + dim)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=51 + dim)
    rng = np.random.default_rng(52)
    w0 = rng.integers(0, ntiles - wt + 1, ntiles)
    lo = (w0 * tb + rng.integers(-300, 900, ntiles)).clip(0)
    hi = lo + rng.integers(0, wt * tb + 600, ntiles)
    hi[2], hi[-1] = lo[2], ntiles * tb + 100
    lo[4] = max(0, w0[4] * tb - 200)
    args = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (w0, lo, hi)]
    ref = cg.window_eval_interval_torch(xi, mj, xj, *args, EPS32, wt, softening)
    cols = np.arange(nj)[None, :]
    sel = (cols >= np.maximum(lo, w0 * tb)[:, None]) & (cols < np.minimum(hi, (w0 + wt) * tb)[:, None])
    scale = _group_scale(xi, mj, xj, sel, tb, softening)
    got = cg.window_eval_interval_cuda(xi, mj, xj, *args, EPS32, wt, softening)
    _assert_group_within(got, ref, scale)
    assert not got[2 * tb:3 * tb].any()
    assert torch.equal(got, cg.window_eval_interval_cuda(xi, mj, xj, *args, EPS32, wt, softening))
    for parts in (1, 2, 4, 8):
        other = cg.window_eval_interval_cuda(xi, mj, xj, *args, EPS32, wt, softening, parts=parts)
        _assert_group_within(other, ref, scale)
        assert torch.equal(other, cg.window_eval_interval_cuda(xi, mj, xj, *args, EPS32, wt,
                                                               softening, parts=parts))


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
    # two launches give the same bits; other plans (one part a tile, many
    # parts cutting inside entries) the same sums within the tolerance
    assert torch.equal(got, cg.entries_lohi_eval_cuda(xi, mj, xj, e, lh, n_real, S, ntiles,
                                                      EPS32, softening))
    for parts in (1, 5, 64):
        other = cg.entries_lohi_eval_cuda(xi, mj, xj, e, lh, n_real, S, ntiles, EPS32, softening,
                                          parts=parts)
        _assert_group_within(other, ref, _group_scale(xi, mj, xj, sel, tb, softening))


def _same_bits(a, b):
    """a and b equal bit for bit (torch.equal takes -0 for +0)."""
    torch.cuda.synchronize()
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def _signed_zeros(parts, rng):
    """parts with about a tenth of its values set to -0.0, which the sum
    pass must keep where a tile has one part."""
    return torch.where(torch.tensor(rng.random(parts.shape) < 0.1, device=parts.device),
                       torch.full((), -0.0, dtype=parts.dtype, device=parts.device), parts)


@pytest.mark.parametrize("tb, dim", [(300, 3), (129, 3), (512, 2)])
def test_entries_sum_kernel_equals_twin(dev, tb, dim):
    """Tiles of 1, 3, 2 and 11 parts (more than the 8 a thread loads
    before adding) added in part order, bit for bit, on slices of tb * dim
    elements a multiple of 4 (16-byte loads) or not (129 * 3: one element
    a thread), and on parts that lie 4 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(63)
    start = torch.tensor([0, 1, 4, 6, 17], dtype=torch.int32, device=dev)
    flat = torch.tensor(rng.standard_normal(17 * tb * dim + 1), dtype=torch.float32, device=dev)
    for parts in (flat[:-1].view(17, tb, dim), flat[1:].view(17, tb, dim)):
        parts = _signed_zeros(parts, rng) if parts.data_ptr() % 16 == 0 else parts
        got = cg.entries_sum_cuda(parts, start)
        assert got.shape == (4 * tb, dim)
        assert _same_bits(got, cg.entries_sum_torch(parts, start))
        assert _same_bits(got[:tb], parts[0])
        assert _same_bits(got[tb:2 * tb], (parts[1] + parts[2] + parts[3]).view(tb, dim))
        many = parts[6]
        for k in range(7, 17):
            many = many + parts[k]
        assert _same_bits(got[3 * tb:], many)


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


@pytest.mark.parametrize("parts", [1, 3, 8, None])
@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_nodemask_window_parts_vs_twin(dev, dim, softening, parts):
    """The window split into at most `parts` parts a tile (None: the
    default P), on the 2^20 shape's slots of 512 and on slots of 100 in
    300-row tiles: within 1e-5 of sum |term| of the twin, two launches bit
    for bit equal, the closed tile zero."""
    for tb, wt, S in ((512, 4, 512), (300, 3, 100)):
        xi, mj, xj, w0, in_win, sel = _window_case(dev, dim, tb, wt, S, seed=95 + dim)
        args = (xi, mj, xj, w0, in_win, EPS32, wt, S, softening)
        got = cg.window_eval_nodemask_cuda(*args, parts=parts)
        again = cg.window_eval_nodemask_cuda(*args, parts=parts)
        _assert_group_within(got, cg.window_eval_nodemask_torch(*args),
                             _group_scale(xi, mj, xj, sel, tb, softening))
        assert torch.equal(got, again)
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


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_dense_window_parts_padding_and_zero_tiles(dev, dim, softening):
    """The n = 16 evaluation's shape (8 tiles of 512, a window of 8 tiles
    from tile 0, 16 real bodies, then mass-0 padding: all but one stage of
    zero weight) and a ragged window with weights and an all-zero tile, at
    the default P and at parts=1 and 8: within 1e-5 of sum |term| of the
    twin, two launches bit-equal, the all-zero tile zero."""
    mj, xj = _bodies(8 * 512, dim, torch.float32, dev, seed=97 + dim)
    mj[16:] = 0
    padded = (xj, mj, xj, torch.zeros(8, dtype=torch.int32, device=dev),
              torch.ones(8, 8 * 512, device=dev), 512, 8)
    xi, mj2, xj2, w0, in_win, _ = _window_case(dev, dim, 512, 4, 16, seed=98 + dim)
    weights = torch.rand((9, 4 * 512), generator=torch.Generator().manual_seed(5)).to(dev)
    ragged = (xi, mj2, xj2, w0, (weights * in_win.repeat_interleave(16, dim=1)).contiguous(),
              512, 4)
    for xi, mj, xj, w0, mask, tb, wt in (padded, ragged):
        ref = cg.window_eval_dense_torch(xi, mj, xj, w0, mask, EPS32, wt, softening)
        scale = cg.window_eval_dense_torch(xi, mj, xj, w0, mask, EPS32, wt, softening,
                                           absolute=True).cpu()
        for parts in (None, 1, 8):
            got = cg.window_eval_dense_cuda(xi, mj, xj, w0, mask, EPS32, wt, softening,
                                            parts=parts)
            _assert_group_within(got, ref, scale)
            assert _same_bits(got, cg.window_eval_dense_cuda(xi, mj, xj, w0, mask, EPS32, wt,
                                                             softening, parts=parts))
            if mask is ragged[4]:
                assert not got[2 * tb:3 * tb].any()


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
    cg.window_eval_interval_cuda(xj, mj, xj, zero, zero, torch.full((1,), 64, **i32), EPS32, 1,
                                 "sqrt3")
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
                                "entries_lohi_kernel": 1, "masked_eval_kernel": 0,
                                "group_shared_masked_kernel": 0, "entries_lohi_kernel<packed>": 0,
                                "entries_tables_kernel": 0, "entries_sum_kernel": 1,
                                "parts_sum_kernel": 5,
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
    float64 numpy, within TOL of each row's sum of |term|; two launches
    give the same bits; on one part a tile both whole padded segments give
    the same bits as the live heads (padding adds exact zeros in the same
    groups), and on the default parts they are within TOL (the parts cut
    the heads elsewhere); empty and all-padding tiles get zeros."""
    xi, mj, xj, split, n0, n1, live = _list_inputs(dev, dim, dtype, seed=110 + dim)
    eps = float(torch.finfo(dtype).eps)
    got = cg.group_eval_cuda(xi, mj, xj, eps, softening, split, n0, n1)
    ref = cg.group_eval_torch(xi, mj, xj, eps, softening, split, n0, n1)
    scale = cg.group_eval_torch(xi, mj, xj, eps, softening, split, n0, n1, absolute=True)
    _assert_within(got, ref, scale, dtype)
    full = torch.full_like(n0, split), torch.full_like(n1, mj.shape[1] - split)
    whole = cg.group_eval_cuda(xi, mj, xj, eps, softening, split, *full)
    _assert_within(whole, ref, scale, dtype)
    one = cg.group_eval_cuda(xi, mj, xj, eps, softening, split, n0, n1, parts=1)
    whole_one = cg.group_eval_cuda(xi, mj, xj, eps, softening, split, *full, parts=1)
    again = cg.group_eval_cuda(xi, mj, xj, eps, softening, split, n0, n1)
    torch.cuda.synchronize()
    assert torch.equal(one, whole_one) and torch.equal(got, again)
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


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_eval_kernel_parts_and_zero_heads(dev, dtype, dim, softening):
    """Ragged heads over 40 tiles, a third of them zeroed as the list paths
    zero the fallback's tiles, on 1, 2, 3 and 8 parts a tile and the
    default: within TOL of the twin's sum |term|, zero-head tiles zero, two
    launches bit-equal."""
    xi, mj, xj, split, n0, n1, live = _list_inputs(dev, dim, dtype, seed=130 + dim, ntiles=40,
                                                   tb=300, split=900, length=2300)
    skip = torch.arange(40, device=dev) % 3 == 1
    n0, n1 = torch.where(skip, 0, n0), torch.where(skip, 0, n1)
    eps = float(torch.finfo(dtype).eps)
    args = (xi, mj, xj, eps, softening, split, n0, n1)
    ref = cg.group_eval_torch(*args)
    scale = cg.group_eval_torch(*args, absolute=True)
    zeroed = skip.repeat_interleave(300)
    for parts in (1, 2, 3, 8, None):
        got = cg.group_eval_cuda(*args, parts=parts)
        again = cg.group_eval_cuda(*args, parts=parts)
        _assert_within(got, ref, scale, dtype)
        assert torch.equal(got, again) and not got[zeroed].any()


def test_float64_list_chain_within_ulps_of_ieee(dev):
    """One live source a tile, so each row's value is one term: the
    float64 chain's term within 8 ulps of the twin's IEEE one on rows at
    distances 1, 1e-3, 1e-9 and 1e-13 from the source and on coincident
    rows (a finite weight, a zero term), both softenings."""
    dtype, tb, ntiles = torch.float64, 256, 4
    eps = float(torch.finfo(dtype).eps)
    rng = np.random.default_rng(140)
    src = rng.uniform(-1, 1, (ntiles, 1, 3))
    dist = np.array([1.0, 1e-3, 1e-9, 1e-13, 0.0])
    dirs = rng.normal(size=(ntiles, tb, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    which = np.arange(tb) % dist.size  # each row's distance, the same in every tile
    xi = src + dirs * dist[which][None, :, None]
    xi = torch.tensor(xi.reshape(-1, 3), dtype=dtype, device=dev)
    xj = torch.tensor(np.concatenate([src, np.zeros((ntiles, 3, 3))], 1), dtype=dtype, device=dev)
    mj = torch.tensor(np.concatenate([rng.uniform(0.1, 1, (ntiles, 1)), np.zeros((ntiles, 3))], 1),
                      dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    heads = (2, torch.ones(ntiles, **i32), torch.zeros(ntiles, **i32))
    coincident = torch.tensor(np.tile(dist[which] == 0, ntiles), device=dev)
    for soft in ("poly", "sqrt3"):
        got = cg.group_eval_cuda(xi, mj, xj, eps, soft, *heads)
        ref = cg.group_eval_torch(xi, mj, xj, eps, soft, *heads)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and not got[coincident].any()
        assert ((got - ref).abs() <= 8 * eps * ref.abs()).all(), \
            ((got - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("tb, dim", [(300, 3), (129, 3), (512, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_parts_sum_kernel_equals_twin(dev, dtype, tb, dim, P):
    """The split kernels' second pass: each tile's first nparts[t] of P
    slices added in order, zero without parts, -0 kept where a tile has
    one part, bit-equal to its plain version; on slices of tb * dim
    elements a multiple of 4 (16-byte loads) or not (129 * 3), and on
    parts 8 bytes off a 16-byte boundary (one element a thread)."""
    rng = np.random.default_rng(64)
    nparts = torch.tensor([0, 1, P, 2, P - 1, 0, 3], dtype=torch.int32, device=dev)
    n = 7 * P * tb * dim
    flat = torch.tensor(rng.random(n + 1), dtype=dtype, device=dev)
    for parts in (_signed_zeros(flat[:-1], rng).view(7 * P, tb, dim), flat[1:].view(7 * P, tb, dim)):
        got = cg.parts_sum_cuda(parts, nparts, P)
        assert _same_bits(got, cg.parts_sum_torch(parts, nparts, P))
        assert not got[:tb].any() and _same_bits(got[tb:2 * tb], parts[P])
        whole = parts[2 * P]
        for k in range(1, P):
            whole = whole + parts[2 * P + k]
        assert _same_bits(got[2 * tb:3 * tb], whole)


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
                            ca.launch_counts[ca.NEWTON64])
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


# --------------------------------------------------------------------------
# the all-pairs variants: allpairs_block_kernel<float32, newton | fast> and
# allpairs_mxu_kernel (csrc/allpairs_mxu.cu)

MXU_FAST_TOL = 1e-4  # bf16 W and [m yj, m]: a weight within an ulp of a bf16
# tie may round the other way in kernel and twin (rsqrtf against torch's
# rsqrt), moving that one term by 2^-8 of itself


def _layout(layout, n, dim, dev):
    """(m, x) float32 on dev: uniform unsorted, uniform Hilbert-sorted, or
    nine Gaussian clusters Hilbert-sorted (far tiles carry most of the force)."""
    from nbody_torch.ops.geometry import aabb_of_points
    from nbody_torch.ops.hilbert import hilbert_sort_perm

    rng = np.random.default_rng(n + dim)
    m = rng.uniform(0.1, 1.0, n).astype(np.float32)
    if layout == "clusters":
        centers = rng.uniform(-40, 40, (9, dim))
        x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    else:
        x = rng.uniform(-1.0, 1.0, (n, dim)).astype(np.float32)
    m, x = torch.tensor(m, device=dev), torch.tensor(x, device=dev)
    if layout != "unsorted":
        perm = hilbert_sort_perm(x, *aabb_of_points(x, float(np.finfo(np.float32).eps)))
        m, x = m[perm].contiguous(), x[perm].contiguous()
    return m, x


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("dim", [2, 3])
def test_newton_kernel_vs_twin(dev, dim, n):
    m, x = _layout("unsorted", n, dim, dev)
    eps = float(torch.finfo(torch.float32).eps)
    got = ca.allpairs_accel_cuda(m, x, 1.0, eps, exact=False)
    _assert_within(got, ca.allpairs_block_torch(x, m, x, eps),
                   ca.allpairs_block_abs_torch(x, m, x, eps), torch.float32)


@pytest.mark.parametrize("layout", ["unsorted", "sorted", "clusters"])
@pytest.mark.parametrize("dim", [2, 3])
def test_fast_kernel_vs_twin(dev, dim, layout):
    """The same tiles take the same branch (equal counts), and the sums
    agree within 1e-5 of sum |term|."""
    m, x = _layout(layout, 6000, dim, dev)
    eps = float(torch.finfo(torch.float32).eps)
    got, counts = ca.allpairs_accel_cuda(m, x, 1.0, eps, exact=False, fast=True,
                                         return_counts=True)
    ref, tiles = ca.allpairs_fast_torch(m, x, 1.0, eps)
    assert counts.cpu().tolist() == tiles.tolist()
    _assert_within(got, ref, ca.allpairs_block_abs_torch(x, m, x, eps), torch.float32)
    if layout == "clusters":
        assert tiles[:, 1].sum() > 0


def test_fast_kernel_small_tiles_and_tol_vs_twin(dev):
    """tile_i 256, tile_j 1024 and a looser fast_tol on a ragged n."""
    m, x = _layout("clusters", 5001, 3, dev)
    eps = float(torch.finfo(torch.float32).eps)
    kw = {"fast_tol": 1e-4, "tile_i": 256, "tile_j": 1024}
    got, counts = ca.allpairs_accel_cuda(m, x, 1.0, eps, exact=False, fast=True,
                                         return_counts=True, **kw)
    ref, tiles = ca.allpairs_fast_torch(m, x, 1.0, eps, **kw)
    assert counts.cpu().tolist() == tiles.tolist()
    _assert_within(got, ref, ca.allpairs_block_abs_torch(x, m, x, eps), torch.float32)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("layout", ["unsorted", "sorted", "clusters"])
@pytest.mark.parametrize("dim", [2, 3])
def test_mxu_kernel_vs_twin(dev, dim, layout, fast):
    from nbody_torch.ops import cuda_allpairs_mxu as cm

    m, x = _layout(layout, 6000, dim, dev)
    eps = float(torch.finfo(torch.float32).eps)
    kw = {"fast": True, "far_thresh": 1e-2} if fast else {}
    got, counts = cm.allpairs_accel_mxu_cuda(m, x, 1.0, eps, return_counts=True, **kw)
    ref, tiles = cm.allpairs_accel_mxu_torch(m, x, 1.0, eps, **kw)
    assert counts.cpu().tolist() == tiles.tolist()
    if layout != "unsorted":
        assert tiles[:, 1:].sum() > 0
    scale = ca.allpairs_block_abs_torch(x, m, x, eps)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = ((got - ref).abs() / scale).max().item()
    assert err <= (MXU_FAST_TOL if fast else TOL[torch.float32]), err


def test_mxu_tiles_of_jax_tests(dev):
    """tile_i = tile_j = 128 (test_mxu_kernel.py's tiles) on a ragged n."""
    from nbody_torch.ops import cuda_allpairs_mxu as cm

    m, x = _layout("clusters", 1000, 3, dev)
    eps = float(torch.finfo(torch.float32).eps)
    got = cm.allpairs_accel_mxu_cuda(m, x, 1.0, eps, tile_i=128, tile_j=128)
    ref, _ = cm.allpairs_accel_mxu_torch(m, x, 1.0, eps, tile_i=128, tile_j=128)
    _assert_within(got, ref, ca.allpairs_block_abs_torch(x, m, x, eps), torch.float32)


def test_variant_launch_counters(dev):
    """Each variant call launches its decision (the statistics, then the
    table) before its kernel; the fast variant runs on block_plan's plan,
    which splits 300 bodies, so split_sum_kernel follows it too."""
    from nbody_torch.ops import cuda_allpairs_mxu as cm
    from nbody_torch.ops import cuda_variant_decide as vd

    m, x = _bodies(300, 2, torch.float32, dev, seed=7)
    ca.reset_launch_counts()
    cm.reset_launch_counts()
    vd.reset_launch_counts()
    ca.allpairs_accel_cuda(m, x, 1.0, 1e-7, exact=False)
    ca.allpairs_accel_cuda(m, x, 1.0, 1e-7, exact=False, fast=True)
    ca.allpairs_accel_cuda(m, x, 1.0, 1e-7, exact=False, fast=True, return_counts=True)
    cm.allpairs_accel_mxu_cuda(m, x, 1.0, 1e-7)
    cm.allpairs_accel_mxu_cuda(m, x, 1.0, 1e-7, fast=True)
    assert ca.launch_counts == {ca.EXACT: 0, ca.NEWTON: 1, ca.NEWTON64: 0, ca.FAST: 2,
                                ca.POTENTIAL: 0, ca.SPLIT_SUM: 3}
    assert cm.launch_counts == {cm.PLAIN: 1, cm.FAST: 1}
    assert vd.launch_counts == {vd.STATS: 4, vd.DECIDE["fast"]: 2, vd.DECIDE["mxu"]: 1,
                                vd.DECIDE["mxu-fast"]: 1}


EPS32 = float(np.finfo(np.float32).eps)
NEAR_COEF = float(np.float32(1e5 * EPS32))
DECIDE_MODES = {"fast": ca.far_threshold(EPS32), "mxu": 0.0, "mxu-fast": 1e-2}


@pytest.mark.parametrize("layout", ["unsorted", "sorted", "clusters"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", list(DECIDE_MODES))
def test_decision_kernels_vs_plain(dev, mode, dim, layout):
    """tile_stats_kernel and tile_decide_kernel bit-equal to their plain
    versions; the exact pass taken by the tile pairs the box mirror leaves
    open, and no others; its pairs within what those tile pairs hold."""
    from nbody_torch.ops import cuda_allpairs_mxu as cm
    from nbody_torch.ops import cuda_variant_decide as vd

    _, x = _layout(layout, 6000, dim, dev)
    ti, tj = (256, 512) if layout == "clusters" else (512, 1024)
    npad = cm.mxu_padding(6000, ti, tj)
    thresh = DECIDE_MODES[mode]
    table, stats, work = vd.decide_cuda(x, mode, npad, ti, tj, NEAR_COEF, thresh, work=True)
    plain_stats = vd.tile_stats_torch(x, npad, ti, tj, means=mode != "fast")
    assert torch.equal(stats, plain_stats)
    assert torch.equal(table, vd.decide_torch(x, mode, npad, ti, tj, NEAR_COEF, thresh))
    boxes = vd.box_table_torch(plain_stats, npad // ti, npad // tj, mode, NEAR_COEF,
                               thresh)
    assert work[:, 0].tolist() == (boxes < 0).sum(1).tolist()
    assert (work[:, 1] <= work[:, 0] * ti * tj).all()
    assert torch.equal(boxes[boxes >= 0], table[boxes >= 0])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["fast", "fast-notch", "mxu", "mxu-fast"])
def test_decision_kernel_on_straddling_layouts(dev, kind, dim):
    """A few ulps either side of each threshold: the kernel's table is its
    plain version's, both branches occur, and the variants at tiles (64,
    64) take the twins' branches."""
    from nbody_torch.ops import cuda_allpairs_mxu as cm
    from nbody_torch.ops import cuda_variant_decide as vd

    mode = "fast" if kind.startswith("fast") else kind
    thresh = DECIDE_MODES[mode]
    seen = set()
    for _, x in vd.straddle_layouts(kind, dim, NEAR_COEF, thresh):
        x = x.to(dev)
        table, _ = vd.decide_cuda(x, mode, 128, 64, 64, NEAR_COEF, thresh)
        assert torch.equal(table.cpu(), vd.decide_torch(x.cpu(), mode, 128, 64, 64, NEAR_COEF,
                                                        thresh))
        seen.add(int(table[0, 1]))
        m = torch.ones(128, device=dev)
        if mode == "fast":
            _, counts = ca.allpairs_accel_cuda(m, x, 1.0, EPS32, fast=True, tile_i=64,
                                               tile_j=64, return_counts=True)
            _, twin = ca.allpairs_fast_torch(m, x, 1.0, EPS32, tile_i=64, tile_j=64)
        else:
            kw = {"fast": True, "far_thresh": thresh} if mode == "mxu-fast" else {}
            _, counts = cm.allpairs_accel_mxu_cuda(m, x, 1.0, EPS32, 64, 64, return_counts=True,
                                                   **kw)
            _, twin = cm.allpairs_accel_mxu_torch(m, x, 1.0, EPS32, 64, 64, **kw)
        assert counts.cpu().tolist() == twin.tolist()
    assert len(seen) == 2


# ------------------------------------------------ the ablation path's kernels


def _shared_scale(xi, mj, xj, mask, G, tb, softening):
    """float64 sum_k |mask m_k (x_k - x_i) / t| per row and component, row
    tile t against list t // G."""
    xi, mj, xj, mask = (a.double().cpu().numpy() for a in (xi, mj, xj, mask))
    out = np.zeros_like(xi)
    for t in range(mask.shape[0]):
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[t // G][None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        r = np.sqrt(d2)
        t3 = (r + EPS32) ** 3 if softening == "sqrt3" else d2 * r + EPS32
        out[rows] = np.einsum("kn,knd->kd", (mask[t] * mj[t // G])[None, :] / t3, np.abs(d))
    return torch.tensor(out, dtype=torch.float32)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("tb", [512, 700])
@pytest.mark.parametrize("dim", [2, 3])
def test_masked_eval_kernel_vs_twin(dev, dim, tb, softening):
    """The dense-mask far field: a ragged node count (1500), dead nodes of
    mass 0, a tile that accepts nothing and one that accepts everything."""
    ntiles, w = 5, 1500
    mj, xj = _bodies(w, dim, torch.float32, dev, seed=140 + dim)
    mj[::17] = 0
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=141 + dim)
    mask = torch.tensor(np.random.default_rng(142).random((ntiles, w)) < 0.3, device=dev)
    mask[1], mask[3] = False, True
    fmask = mask.float().contiguous()
    got = cg.masked_eval_cuda(xi, mj, xj, fmask, EPS32, softening)
    ref = cg.masked_eval_torch(xi, mj, xj, fmask, EPS32, softening)
    _assert_group_within(got, ref, _group_scale(xi, mj, xj, mask.cpu().numpy(), tb, softening))
    assert not got[tb:2 * tb].any()
    # the same accepts through the bit-packed far kernel
    bits = cg.masked_eval_bits_cuda(xi, mj, xj, cg.pack_mask_bits(mask), EPS32, softening)
    _assert_group_within(got, bits, _group_scale(xi, mj, xj, mask.cpu().numpy(), tb, softening))


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("G", [8, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_group_shared_masked_kernel_vs_twin(dev, dim, G, softening):
    """Supertile-shared lists: 11 tiles (not a multiple of G), a ragged list
    width (1100) with a padded tail of mass 0, and a tile with an empty
    mask."""
    ntiles, tb, width = 11, 512, 1100
    nsuper = -(-ntiles // G)
    mj, xj = _bodies(nsuper * width, dim, torch.float32, dev, seed=150 + dim)
    mj, xj = mj.view(nsuper, width), xj.view(nsuper, width, dim)
    mj[:, -90:] = 0
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=151 + dim)
    mask = torch.tensor(np.random.default_rng(152).random((ntiles, width)) < 0.4,
                        dtype=torch.float32, device=dev)
    mask[4] = 0
    got = cg.group_shared_masked_eval_cuda(xi, mj, xj, mask, EPS32, G, softening)
    ref = cg.group_shared_masked_eval_torch(xi, mj, xj, mask, EPS32, G, softening)
    _assert_group_within(got, ref, _shared_scale(xi, mj, xj, mask, G, tb, softening))
    assert not got[4 * tb:5 * tb].any()


def _float_weights(shape, density, dev, seed):
    """Weights that are not 0/1 (0.5, 3.0, 0.25, -0.0 where drawn, else 0)."""
    rng = np.random.default_rng(seed)
    drawn = rng.random(shape) < density
    return torch.tensor(np.where(drawn, rng.choice([0.5, 3.0, 0.25, -0.0], shape), 0.0),
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("w", [1501, 20001])
@pytest.mark.parametrize("dim", [2, 3])
def test_masked_eval_kernel_compaction(dev, dim, w, softening):
    """The dense-mask far field's compaction: float weights that are not
    0/1, W not a multiple of 4 (rows not 16-byte aligned) and above one
    batch of 8,192 nodes (20,001: three), a tile of zeros and -0.0 (zeros
    out), a tile with a NaN weight (NaN rows, the others untouched), two
    launches bit-equal, two row blocks a tile."""
    ntiles, tb = 4, 1024
    mj, xj = _bodies(w, dim, torch.float32, dev, seed=180 + dim)
    mj[::29] = 0
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=181 + dim)
    mask = _float_weights((ntiles, w), 0.05, dev, seed=182)
    mask[1] = 0
    mask[1, ::3] = -0.0
    mask[0, w - 1] = 3.0
    got = cg.masked_eval_cuda(xi, mj, xj, mask, EPS32, softening)
    assert _same_bits(got, cg.masked_eval_cuda(xi, mj, xj, mask, EPS32, softening))
    ref = cg.masked_eval_torch(xi, mj, xj, mask, EPS32, softening)
    _assert_group_within(got, ref, cg.masked_eval_torch(xi, mj, xj, mask, EPS32, softening,
                                                        absolute=True).cpu())
    assert not got[tb:2 * tb].any()
    mask[3, w // 2] = float("nan")
    nan = cg.masked_eval_cuda(xi, mj, xj, mask, EPS32, softening)
    torch.cuda.synchronize()
    assert bool(torch.isnan(nan[3 * tb:]).all())
    assert _same_bits(nan[:3 * tb], got[:3 * tb])


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_group_shared_masked_kernel_compaction(dev, dim, softening):
    """Supertile-shared lists with float weights: G = 8 over 11 tiles of
    1,024 rows (two row blocks), M = 9,001 (two batches, rows not 16-byte
    aligned), padded tails of mass 0, a tile of zeros; two launches
    bit-equal."""
    ntiles, tb, width, G = 11, 1024, 9001, 8
    nsuper = -(-ntiles // G)
    mj, xj = _bodies(nsuper * width, dim, torch.float32, dev, seed=190 + dim)
    mj, xj = mj.view(nsuper, width), xj.view(nsuper, width, dim)
    mj[:, -300:] = 0
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=191 + dim)
    mask = _float_weights((ntiles, width), 0.03, dev, seed=192)
    mask[9] = 0
    args = (xi, mj, xj, mask, EPS32, G, softening)
    got = cg.group_shared_masked_eval_cuda(*args)
    assert _same_bits(got, cg.group_shared_masked_eval_cuda(*args))
    _assert_group_within(got, cg.group_shared_masked_eval_torch(*args),
                         _shared_scale(xi, mj, xj, mask, G, tb, softening))
    assert not got[9 * tb:10 * tb].any()


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_packed_entries_kernel_equals_unpacked(dev, dim, softening):
    """entries_lohi_kernel<packed> on the entries test's list: the same
    sums as the unpacked kernel, bit for bit, and within the tolerance of
    the twin."""
    ntiles, tb, S = 7, 512, 1024
    nj = 4 * S - 100
    mj, xj = _bodies(nj, dim, torch.float32, dev, seed=160 + dim)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=161 + dim)
    rng = np.random.default_rng(162)
    ents, lohis = [], []
    sel = np.zeros((ntiles, nj), bool)
    for tile in (0, 1, 3, 6):
        ents.append(tile << 16)
        lohis.append(0)
        for blk in range(4):
            lo, hi = (0, S) if tile == 3 else sorted(int(v) for v in rng.integers(0, S + 1, 2))
            ents.append((tile << 16) | blk)
            lohis.append(lo | (hi << 16))
            sel[tile, blk * S + lo:min(blk * S + hi, nj)] = True
    n_real = torch.tensor(len(ents), device=dev)
    e = torch.tensor(ents, dtype=torch.int32, device=dev)
    lh = torch.tensor(lohis, dtype=torch.int32, device=dev)
    args = (xi, mj, xj, e, lh, n_real, S, ntiles, EPS32, softening)
    cg.reset_launch_counts()
    got = cg.entries_lohi_eval_cuda(*args, packed=True)
    plain = cg.entries_lohi_eval_cuda(*args)
    torch.cuda.synchronize()
    assert cg.launch_counts["entries_lohi_kernel<packed>"] == 1
    assert cg.launch_counts["entries_lohi_kernel"] == 1
    assert torch.equal(got, plain)
    _assert_group_within(got, cg.entries_lohi_eval_torch(*args, packed=True),
                         _group_scale(xi, mj, xj, sel, tb, softening))


@pytest.mark.parametrize("tree,ablate", [("octree", "densemask"), ("octree", "farcompact"),
                                         ("octree", "packedj"), ("octree", "desc2"),
                                         ("bvh", "densemask"), ("bvh", "packedj")])
def test_ablate_paths_on_card_match_cpu(dev, tree, ablate):
    """Each ported ablate token on a 20,000-body 3-D clustered system, on
    the card and through the CPU twins: equal counters (descend_* included),
    forces within 1e-5 of sum |a|, and the token's kernel launched once."""
    from nbody_torch.ops import bvh, bvh_group, octree, octree_group
    from nbody_torch.state import SystemState

    n, dim = 20000, 3
    rng = np.random.default_rng(170)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    m = rng.uniform(0.1, 1, n).astype(np.float32)
    kernel = {"densemask": "masked_eval_kernel", "farcompact": "group_shared_masked_kernel",
              "desc2": "group_shared_masked_kernel", "packedj": "entries_lohi_kernel<packed>"}
    out = {}
    for device in (dev, torch.device("cpu")):
        cg.reset_launch_counts()
        if tree == "octree":
            depth = octree.max_depth(n, dim)
            lo, hi = octree.robust_quant_box(torch.tensor(x, device=device))
            ms, xs, ks, _ = octree.morton_sort(torch.tensor(m, device=device),
                                               torch.tensor(x, device=device), lo, hi, depth)
            a, info = octree_group.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS32,
                                                              window_tiles=2, ablate=ablate)
        else:
            st = bvh.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=device),
                                  EPS32)
            a, info = bvh_group.compute_force_grouped_windowed(
                bvh.build_tree(st.m, st.x, EPS32), st.m, st.x, 0.5, 1.0, EPS32, window_tiles=2,
                ablate=ablate)
        out[device.type] = (a.cpu(), {k: int(v) for k, v in info.items()},
                            cg.launch_counts[kernel[ablate]])
    (ga, ginfo, glaunch), (ca_, cinfo, claunch) = out["cuda"], out["cpu"]
    assert ginfo == cinfo and cinfo["entries"] > 0
    assert ((ga - ca_).abs().sum() / ca_.abs().sum()).item() < 1e-5
    assert glaunch == 1 and claunch == 0


# ------------------------------------------- the entry-cost probes' kernels
from nbody_torch.ops import cuda_entry_probes as ce  # noqa: E402


def _scaled_within(got, ref, scale):
    """|got - ref| <= 1e-5 of each row's sum of |term| (the twin's)."""
    _assert_group_within(got, ref, scale.cpu())


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_entries_tables_kernel_vs_twin(dev, dim, chunked, softening):
    """entries_tables_kernel on a tile-sorted list with empty tiles, the
    pad row, lo == hi rows, hi > S (cut at S), and as (4, E) chunks with
    n_real inside chunk 1: chunks 0-1 run whole (tile 3 in part), 2-3 not."""
    ntiles, tb, S, nblocks = 6, 512, 256, 9
    mj, xj = _bodies(nblocks * S, dim, torch.float32, dev, seed=300 + dim)
    _, xi = _bodies(ntiles * tb, dim, torch.float32, dev, seed=301 + dim)
    rng = np.random.default_rng(302)
    lo = rng.integers(0, S // 2, nblocks)
    hi = lo + rng.integers(0, S, nblocks)
    hi[2], lo[3], hi[3] = S + 300, 40, 40  # beyond S; an empty range
    blk = torch.tensor(np.r_[rng.permutation(nblocks), 0], dtype=torch.int32, device=dev)
    lohi = torch.tensor(np.r_[lo | (hi << 16), 0], dtype=torch.int32, device=dev)
    ents = np.sort(np.concatenate([np.repeat([0, 1, 3, 5], 10) << 16, [5 << 16] * 8]))
    ents |= np.r_[rng.integers(0, nblocks + 1, 40), [nblocks] * 8]
    ents = torch.tensor(ents, dtype=torch.int32, device=dev)
    n_real = None
    if chunked:
        ents, n_real = ents.view(4, 12), torch.tensor(13, device=dev)
    args = (xi, mj, xj, ents, blk, lohi, EPS32, S, tb, softening, n_real)
    cg.reset_launch_counts()
    got = cg.entries_tables_eval_cuda(*args)
    assert cg.launch_counts["entries_tables_kernel"] == 1
    ref = cg.entries_tables_eval_torch(*args)
    _scaled_within(got, ref, cg.entries_tables_eval_torch(*args, absolute=True))
    assert not got.view(ntiles, tb, dim)[[2, 4]].any()  # tiles without entries
    if chunked:  # chunks 2-3 (the rest of tile 3, tile 5) do not run
        assert not got.view(ntiles, tb, dim)[5].any()


def _ladder_case(dev, dim, S=256, ntiles=5, per_tile=(7, 0, 12, 3, 9), seed=310):
    """Packed and split sources of 6 blocks, rows of ntiles tiles of 512,
    tile-sorted entries (per_tile of each tile) with random blocks and
    [lo, hi) lanes, one lo == hi and one hi > S."""
    rng = np.random.default_rng(seed)
    mj, xj = _bodies(6 * S, dim, torch.float32, dev, seed=seed + 1)
    _, xi = _bodies(ntiles * 512, dim, torch.float32, dev, seed=seed + 2)
    tid = np.repeat(np.arange(ntiles), per_tile)
    ents = torch.tensor((tid << 16) | rng.integers(0, 6, tid.size), dtype=torch.int32, device=dev)
    lo = rng.integers(0, S // 4, tid.size)
    hi = S - rng.integers(0, S // 4, tid.size)
    lo[3], hi[3], hi[5] = 50, 50, S + 77
    lohi = torch.tensor(lo | (hi << 16), dtype=torch.int32, device=dev)
    return xi, (mj, xj), cg.pack_sources(mj, xj), ents, lohi


@pytest.mark.parametrize("per_block", [1, 8])
@pytest.mark.parametrize("rung", list(ce.RUNGS))
@pytest.mark.parametrize("dim", [2, 3])
def test_entry_ladder_kernel_vs_twin(dev, dim, rung, per_block):
    """Each rung against its twin, at the default P parts a block. Under
    switch / noskip, one entry a block makes every tile with more than one
    entry cross blocks (atomics); 8 a block holds tile 0's whole run (plain
    stores) while the others straddle blocks."""
    xi, split, packed, ents, lohi = _ladder_case(dev, dim)
    pk, sel, _, switch = ce.RUNGS[rung]
    src = packed if pk else split
    x = xi if switch else xi[:512].contiguous()
    args = (rung, x, src, ents, lohi if sel else None, 256)
    ce.reset_launch_counts()
    cg.reset_launch_counts()
    got = ce.entry_ladder_cuda(*args, tb=512, per_block=per_block)
    assert ce.launch_counts[ce.ladder_name(rung)] == 1
    # the second pass: on one tile each block's parts, then the blocks
    assert cg.launch_counts["parts_sum_kernel"] == (1 if switch else 2)
    _scaled_within(got, ce.entry_ladder_torch(*args, tb=512),
                   ce.entry_ladder_torch(*args, tb=512, absolute=True))
    if switch:
        assert not got.view(5, 512, dim)[1].any()  # the tile without entries


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("rung", ["ideal", "sel", "switch"])
def test_entry_ladder_parts(dev, rung, parts):
    """P = 1, 2, 4, 8 parts a block, within 1e-5 of sum |term| of the twin;
    blocks of 8 entries, so P = 8 gives parts of one entry."""
    xi, split, packed, ents, lohi = _ladder_case(dev, 3)
    _, sel, _, switch = ce.RUNGS[rung]
    x = xi if switch else xi[:512].contiguous()
    args = (rung, x, packed, ents, lohi if sel else None, 256)
    got = ce.entry_ladder_cuda(*args, tb=512, per_block=8, parts=parts)
    _scaled_within(got, ce.entry_ladder_torch(*args, tb=512),
                   ce.entry_ladder_torch(*args, tb=512, absolute=True))


@pytest.mark.parametrize("rung", ["ideal", "sepmj", "sel", "when"])
def test_entry_ladder_launches_bit_equal(dev, rung):
    """Two launches of a fixed-tile rung give equal bits: each part writes
    its own slice and the second pass adds them in order (no atomics);
    the touch-only control too."""
    xi, split, packed, ents, lohi = _ladder_case(dev, 3)
    pk, sel, _, _ = ce.RUNGS[rung]
    x0 = xi[:512].contiguous()
    args = (rung, x0, packed if pk else split, ents, lohi if sel else None, 256)
    assert torch.equal(ce.entry_ladder_cuda(*args, per_block=4),
                       ce.entry_ladder_cuda(*args, per_block=4))
    if rung == "ideal":
        assert torch.equal(ce.entry_ladder_cuda(*args, per_block=4, math=False),
                           ce.entry_ladder_cuda(*args, per_block=4, math=False))


@pytest.mark.parametrize("parts", [None, 1, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_entry_ladder_equal_rungs(dev, dim, parts):
    """ideal == sepmj and sel == when bit for bit on the same grid (the
    same staged values, summed in the same order); switch within the
    tolerance of the production entries kernel on the same entries."""
    xi, split, packed, ents, lohi = _ladder_case(dev, dim)
    x0 = xi[:512].contiguous()
    call = ce.entry_ladder_cuda
    kw = {"parts": parts}
    assert torch.equal(call("ideal", x0, packed, ents, None, 256, **kw),
                       call("sepmj", x0, split, ents, None, 256, **kw))
    assert torch.equal(call("sel", x0, packed, ents, lohi, 256, **kw),
                       call("when", x0, packed, ents, lohi, 256, **kw))
    # 16 entries a block: at most two blocks add to a tile's slice, (0 + a) + b == (0 + b) + a
    assert torch.equal(call("switch", xi, packed, ents, lohi, 256, tb=512, per_block=16, **kw),
                       call("noskip", xi, split, ents, lohi, 256, tb=512, per_block=16, **kw))
    n_real = torch.tensor(ents.shape[0], device=dev)
    prod_lohi = torch.where(lohi >> 16 > 256, (lohi & 0xFFFF) | (256 << 16), lohi)
    prod = cg.entries_lohi_eval_cuda(xi, *split, ents, prod_lohi, n_real, 256, 5, ce.EPS, "sqrt3")
    args = ("switch", xi, packed, ents, lohi, 256)
    _scaled_within(call(*args, tb=512, **kw), prod,
                   ce.entry_ladder_torch(*args, tb=512, absolute=True))


@pytest.mark.parametrize("parts", [None, 1, 5])
@pytest.mark.parametrize("math", [True, False])
@pytest.mark.parametrize("nbuf", [2, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_dma_ring_kernel_vs_twin(dev, dim, nbuf, math, parts):
    """The copy ring at S = 1,024 (64 KB of ring at nbuf 4) on 200 entries,
    a ragged last block of sources (its in-range prefix copied): within
    the tolerance of its twin, equal bit for bit to the ideal rung at the
    ring's launch bounds (dma-pipeline's blockspec) on the same grid of 64
    entries a block and P parts, and to a second launch; the ideal rung at
    its own bounds within the tolerance."""
    S = 1024
    mj, xj = _bodies(7 * S - 5, dim, torch.float32, dev, seed=320 + dim)  # a ragged last block
    _, xi = _bodies(512, dim, torch.float32, dev, seed=321)
    xm = cg.pack_sources(mj, xj)
    ents = torch.tensor(np.random.default_rng(322).integers(0, 8, 200), dtype=torch.int32,
                        device=dev)  # block 7 lies past the sources: nothing copied
    ce.reset_launch_counts()
    got = ce.dma_ring_cuda(xi, xm, ents, S, nbuf, math=math, parts=parts)
    assert ce.launch_counts[ce.ring_name(nbuf, math)] == 1
    _scaled_within(got, ce.dma_ring_torch(xi, xm, ents, S, math=math),
                   ce.dma_ring_torch(xi, xm, ents, S, math=math, absolute=True))
    blockspec = ce.entry_ladder_cuda("ideal", xi, xm, ents, None, S, per_block=64, math=math,
                                     parts=parts, min_blocks=ce.RING_BLOCKS)
    assert ce.launch_counts[ce.ladder_name("ideal", math, ce.RING_BLOCKS)] == 1
    assert torch.equal(got, blockspec)
    assert torch.equal(got, ce.dma_ring_cuda(xi, xm, ents, S, nbuf, math=math, parts=parts))
    _scaled_within(ce.entry_ladder_cuda("ideal", xi, xm, ents, None, S, per_block=64, math=math,
                                        parts=parts),
                   ce.dma_ring_torch(xi, xm, ents, S, math=math),
                   ce.dma_ring_torch(xi, xm, ents, S, math=math, absolute=True))


def test_dma_ring_refuses_more_shared_memory_than_the_card_has(dev):
    """4 slots of S = 4,096 float4 rows (256 KB) exceed the 227 KB a block
    may have: the wrapper raises before the launch and counts none."""
    mj, xj = _bodies(4096 * 2, 3, torch.float32, dev, seed=330)
    xm = cg.pack_sources(mj, xj)
    ents = torch.zeros(8, dtype=torch.int32, device=dev)
    ce.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        ce.dma_ring_cuda(xj[:512].contiguous(), xm, ents, 4096, 4)
    assert ce.launch_counts[ce.ring_name(4)] == 0


def test_entry_probe_budgets_from_the_runtime(dev):
    """The CUDA runtime's budget of each probe kernel: every rung at most 48
    registers, no spill, 5 blocks an SM or more; the ring and the ideal
    rung at the ring's bounds at most 64 registers; the ring's slots (64
    KB at NBUF 4, S = 1,024) leave it at most 3 blocks an SM."""
    for rung in ce.RUNGS:
        b = ce.kernel_budget("ladder", rung, True, 3, 1024, dev)
        assert b["registers"] <= 48 and b["spill_bytes"] == 0 and b["blocks_an_sm"] >= 5
    for math in (True, False):
        b = ce.kernel_budget("ladder", "ideal", math, 3, 1024, dev, ce.RING_BLOCKS)
        assert b["registers"] <= 64 and b["blocks_an_sm"] >= 4
        for nbuf in ce.NBUFS:
            b = ce.kernel_budget("ring", nbuf, math, 3, 1024, dev)
            assert b["registers"] <= 64 and b["dynamic_shared"] == nbuf * 1024 * 16
            assert 1 <= b["blocks_an_sm"] <= (4 if nbuf == 2 else 3)
    with pytest.raises(RuntimeError):
        ce.kernel_budget("ladder", "sel", True, 3, 1024, dev, ce.RING_BLOCKS)


# ------------------------------------------------------------ per-body walks


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_walk_kernels_vs_twins(dev, dim, dtype):
    """bvh_walk_kernel and octree_walk_kernel on a 5,001-body galaxy (its
    last body massless at the origin) against their twins on every row,
    and the kernel's call on some rows bit-equal to those rows of the whole
    call; one launch counted a call (the octree's also one of
    octree_pack_kernel, whose records equal its plain version's bit for
    bit)."""
    from nbody_torch.models import build_galaxy_model
    from nbody_torch.ops import bvh, octree
    from nbody_torch.ops import cuda_tree_walk as tw
    from nbody_torch.ops.geometry import scalar_bounds

    cfg, s = build_galaxy_model(5001, dim, np.dtype(str(dtype).removeprefix("torch.")), dev)
    st = bvh.hilbert_sort(s, cfg.eps)
    tree = bvh.build_tree(st.m, st.x, cfg.eps)
    lo, hi = scalar_bounds(s.x)
    levels, _, ms, xs = octree.build_octree(s.m, s.x, lo, hi, octree.max_depth(5001, dim))
    walks = {
        tw.BVH_WALK: (lambda r=None: tw.bvh_walk_cuda(tree.mm, tree.mx, tree.bw, tree.nlevels,
                                                       st.m, st.x, cfg.theta, cfg.G, cfg.eps, r),
                      lambda: tw.bvh_walk_torch(tree.mm, tree.mx, tree.bw, tree.nlevels, st.m,
                                                st.x, cfg.theta, cfg.G, cfg.eps, detail=True)),
        tw.OCTREE_WALK: (lambda r=None: tw.octree_walk_cuda(levels, ms, xs, hi - lo, cfg.theta,
                                                             cfg.G, cfg.eps, r),
                         lambda: tw.octree_walk_torch(levels, ms, xs, hi - lo, cfg.theta, cfg.G,
                                                      cfg.eps, detail=True)),
    }
    rows = torch.tensor([5000, 0, 2500, 17], device=dev)
    for name, (kern, twin) in walks.items():
        tw.reset_launch_counts()
        got = kern()
        assert tw.launch_counts[name] == 1 and tw.twin_calls[name] == 0
        assert tw.launch_counts[tw.OCTREE_PACK] == (name == tw.OCTREE_WALK)
        ref, scale, _ = twin()
        assert bool(((got - ref).abs() <= TOL[dtype] * scale).all()), name
        assert torch.equal(kern(rows), got[rows]), name
    packed = tw.octree_records_cuda(levels, ms, xs)
    for a, b in zip(packed, tw.octree_records_torch(levels, ms, xs)):
        assert torch.equal(a, b)
