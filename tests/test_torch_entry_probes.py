"""The entry-cost probes (python -m nbody_torch.probe entries | entry-overhead
| dma-pipeline, nbody_torch/probes/) and the twins of their kernels
(ops/cuda_entry_probes), on the CPU.

The workloads are held bit for bit against the TPU scripts' own numpy
lines, re-derived here. Each probe mode's twin is held against nbody_tpu's
entries_lohi_eval_pallas in interpret mode on the same inputs: the
fixed-tile rungs and the DMA modes with every tile id 0, switch and the
production modes with the real ones. Tolerances as in
tests/test_torch_ablate.py: the twin within 1e-5, the Pallas function
within 1e-4 of each row's float64 sum of |term|. With one intra-op
thread the twins of rungs that sum the same values (ideal and sepmj, sel
and when, the DMA modes) are equal bit for bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import probe
from nbody_torch.ops import cuda_entry_probes as tce
from nbody_torch.ops import cuda_group_eval as tge
from nbody_torch.probes import dma_pipeline, entries_kernel, entry_overhead
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

EPS = 1e-3  # the probes' softening
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


# ----------------------------------------------------------- the workloads


def test_entries_workload_is_the_scripts():
    """scripts/probe_entries_kernel.py:43-67 at n = 8,192 (16 tiles) and
    E = 256: bodies, then each mode's entries in the script's order."""
    n, e_total, tile = 8192, 256, 512
    cases = entries_kernel.workload(n, e_total)
    x, m = next(cases)
    rng = np.random.default_rng(0)
    ntiles = n // tile
    np.testing.assert_array_equal(
        x, np.asarray(jnp.asarray(rng.uniform(-100, 100, (n, 3)).astype(np.float32))))
    np.testing.assert_array_equal(
        m, np.asarray(jnp.asarray(rng.uniform(0.1, 1.0, n).astype(np.float32))))
    got = list(cases)
    assert [(c[0], c[1], c[2]) for c in got] == [(256, "real", 256), (256, "pad", 256),
                                                 (512, "real", 256), (1024, "real", 256),
                                                 (256, "half_real", 128)]
    for S, mode, e, entries, blk_tbl, lohi in got:
        nblocks = n // S
        pt = e // ntiles
        tid = np.repeat(np.arange(ntiles, dtype=np.int32), pt)
        if mode == "pad":
            gbe = np.full(e, nblocks, np.int32)
        else:
            gbe = rng.integers(0, nblocks, e).astype(np.int32)
            gbe = np.sort(gbe.reshape(ntiles, pt), axis=1).reshape(-1)
        ref = jnp.asarray((tid << 16) | gbe)
        np.testing.assert_array_equal(entries, np.asarray(ref.reshape(8, -1)))
        np.testing.assert_array_equal(blk_tbl, np.asarray(jnp.concatenate(
            [jnp.arange(nblocks, dtype=jnp.int32), jnp.zeros((1,), jnp.int32)])))
        np.testing.assert_array_equal(lohi, np.asarray(jnp.concatenate(
            [jnp.full((nblocks,), S << 16, jnp.int32), jnp.zeros((1,), jnp.int32)])))
        assert entries.dtype == blk_tbl.dtype == lohi.dtype == np.int32


def test_entries_workload_refuses_the_scripts_own_n():
    """At N = 1,000,000 the script's 1,953 tiles do not divide E: it fails
    at its reshape, and the port says why before it draws."""
    with pytest.raises(ValueError, match="do not split"):
        next(entries_kernel.workload(1_000_000))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("S", [1024, 256])
def test_entry_overhead_workload_is_the_scripts(S, dim):
    """scripts/probe_entry_overhead.py:79-101 at E = 8,192, T = 128."""
    E, T, TB = 8192, 128, 512
    w = entry_overhead.workload(S, E, dim, T)
    nblk = (1_000_000 + S - 1) // S
    npad = nblk * S
    rng = np.random.default_rng(42)
    xm = np.zeros((4, npad), np.float32)
    xm[:dim] = rng.standard_normal((dim, npad))
    xm[dim] = rng.uniform(0.5, 1.0, npad)
    np.testing.assert_array_equal(w["xm"], np.asarray(jnp.asarray(xm)))
    xi_all = jnp.asarray(rng.standard_normal((T * TB, dim)), jnp.float32)
    np.testing.assert_array_equal(w["xi_all"], np.asarray(xi_all))
    ept = E // T
    ents = rng.integers(0, nblk, E).astype(np.int32)
    tids = np.repeat(np.arange(T, dtype=np.int32), ept)[:E]
    lo = rng.integers(0, S // 8, E).astype(np.int32)
    hi = np.clip(S - rng.integers(0, S // 8, E), 1, S).astype(np.int32)
    np.testing.assert_array_equal(w["ents"], np.asarray(jnp.asarray(ents)))
    np.testing.assert_array_equal(w["ent_tiled"], np.asarray(jnp.asarray((tids << 16) | ents)))
    np.testing.assert_array_equal(w["lohi"], np.asarray(jnp.asarray(lo | (hi << 16))))


def test_dma_pipeline_workload_is_the_scripts():
    """scripts/probe_dma_pipeline.py:63-76 at its defaults."""
    E, S, DIM = 8192, 1024, 3
    w = dma_pipeline.workload(E, S, DIM)
    rng = np.random.default_rng(42)
    xm = np.zeros((4, 977 * S), np.float32)
    xm[:DIM] = rng.standard_normal((DIM, 977 * S))
    xm[DIM] = rng.uniform(0.5, 1.0, 977 * S)
    np.testing.assert_array_equal(w["xm"], np.asarray(jnp.asarray(xm)))
    xi0 = jnp.asarray(rng.standard_normal((512, DIM)), jnp.float32)
    np.testing.assert_array_equal(w["xi0"], np.asarray(xi0))
    np.testing.assert_array_equal(w["ent"], np.asarray(jnp.asarray(rng.integers(0, 977, E),
                                                                   jnp.int32)))


# ------------------------------------------------- the twins against Pallas


def _f64_sums(xi, mj, xj, tid, start, stop, tb):
    """float64 sqrt3 force of entries (tile tid, bodies [start, stop)) and
    its scale sum |term| per row."""
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for t, a, b in zip(tid, start, stop):
        cols = np.arange(a, max(a, b))
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[cols][None, :, :] - xi[rows][:, None, :]
        r = np.sqrt(np.sum(d * d, axis=-1))
        w = mj[cols][None, :] / (r + EPS) ** 3
        force[rows] += np.einsum("kn,knd->kd", w, d)
        scale[rows] += np.einsum("kn,knd->kd", w, np.abs(d))
    return force, scale


def _assert_twin_and_pallas(got, pallas, sums):
    exact, scale = sums
    for arr, tol in ((got, TOL), (pallas, 10 * TOL)):
        arr = np.asarray(arr, np.float64)
        assert arr.shape == exact.shape and np.all(np.isfinite(arr))
        err = np.abs(arr - exact)
        assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))


def _ladder_case(dim, seed, S=256, tiles=3, ept=6, tb=128):
    """The entry-overhead workload's shape at a small size: packed xm rows
    (x, y, z | 0, m), rows of `tiles` tiles, tile-sorted random entries, lo
    / hi lanes with one lo == hi and one hi past S."""
    rng = np.random.default_rng(seed)
    nblk = 5
    mj = rng.uniform(0.5, 1.0, nblk * S).astype(np.float32)
    xj = rng.standard_normal((nblk * S, dim)).astype(np.float32)
    xi = rng.standard_normal((tiles * tb, dim)).astype(np.float32)
    xi[3:6] = xj[:3]  # coincident pairs: m / eps^3 terms
    E = tiles * ept
    ents = rng.integers(0, nblk, E).astype(np.int32)
    tid = np.repeat(np.arange(tiles, dtype=np.int32), ept)
    lo = rng.integers(0, S // 8, E)
    hi = np.clip(S - rng.integers(0, S // 8, E), 1, S)
    lo[2], hi[2], hi[4] = 30, 30, S + 40
    return xi, mj, xj, ents, (tid << 16) | ents, (lo | (hi << 16)).astype(np.int32), tb, S


def _pallas_entries(xi, mj, xj, ents, lohi, tb, S, skip_empty=True):
    return jpg.entries_lohi_eval_pallas(
        jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T), jnp.asarray(ents),
        jnp.asarray(lohi), EPS, S=S, tb=tb, interpret=True, softening="sqrt3",
        skip_empty=skip_empty)


@pytest.mark.parametrize("rung", ["ideal", "sepmj", "sel", "when", "switch", "noskip"])
@pytest.mark.parametrize("dim", [2, 3])
def test_ladder_twins_vs_pallas(dim, rung):
    """Each rung's twin against entries_lohi_eval_pallas on the same
    entries: the fixed-tile rungs with every tile id 0 (ideal, sepmj with
    lo = 0, hi = S), switch and noskip (skip_empty=False) with the real
    tile ids; hi past S is the lane mask's edge in both."""
    xi, mj, xj, ents, ent_tiled, lohi, tb, S = _ladder_case(dim, seed=500 + dim)
    packed, sel, _, switch = tce.RUNGS[rung]
    x = xi if switch else xi[:tb]
    pe = ent_tiled if switch else ents
    plohi = lohi if sel else np.full_like(lohi, S << 16)
    ref = _pallas_entries(x, mj, xj, pe, plohi, tb, S, skip_empty=rung != "noskip")
    src = tge.pack_sources(_t(mj), _t(xj)) if packed else (_t(mj), _t(xj))
    got = tce.entry_ladder_cuda(rung, _t(x), src, _t(pe), _t(lohi) if sel else None, S, EPS,
                                tb=tb)
    hi = np.minimum(plohi >> 16, S)
    sums = _f64_sums(x, mj, xj, pe >> 16, (pe & 0xFFFF) * S + (plohi & 0xFFFF),
                     (pe & 0xFFFF) * S + hi, tb)
    _assert_twin_and_pallas(got, ref, sums)


@pytest.mark.parametrize("dim", [2, 3])
def test_ladder_twins_that_sum_the_same_values_are_equal(dim):
    """ideal == sepmj and sel == when, bit for bit; switch equals the
    production twin within 1e-5 of sum |term|."""
    xi, mj, xj, ents, ent_tiled, lohi, tb, S = _ladder_case(dim, seed=510 + dim)
    x0, packed, split = _t(xi[:tb]), tge.pack_sources(_t(mj), _t(xj)), (_t(mj), _t(xj))
    call = tce.entry_ladder_cuda
    assert torch.equal(call("ideal", x0, packed, _t(ents), None, S, tb=tb),
                       call("sepmj", x0, split, _t(ents), None, S, tb=tb))
    assert torch.equal(call("sel", x0, packed, _t(ents), _t(lohi), S, tb=tb),
                       call("when", x0, packed, _t(ents), _t(lohi), S, tb=tb))
    args = ("switch", _t(xi), packed, _t(ent_tiled), _t(lohi), S, EPS, tb)
    prod_lohi = np.where(lohi >> 16 > S, (lohi & 0xFFFF) | (S << 16), lohi)
    prod = tge.entries_lohi_eval_cuda(_t(xi), _t(mj), _t(xj), _t(ent_tiled), _t(prod_lohi),
                                      torch.tensor(len(ents)), S, 3, EPS, "sqrt3")
    scale = tce.entry_ladder_torch(*args, absolute=True)
    assert bool(((call(*args) - prod).abs() <= TOL * scale).all())


def test_ladder_twin_rejects_unsorted_tiles():
    xi, mj, xj, ents, ent_tiled, lohi, tb, S = _ladder_case(3, seed=520)
    bad = ent_tiled[::-1].copy()
    with pytest.raises(ValueError, match="sorted by tile"):
        tce.entry_ladder_cuda("switch", _t(xi), tge.pack_sources(_t(mj), _t(xj)), _t(bad),
                              _t(lohi), S, tb=tb)


@pytest.mark.parametrize("dim", [2, 3])
def test_dma_modes_twins(dim):
    """blockspec == manual2 == manual4 bit for bit; with math the ideal
    function against entries_lohi_eval_pallas on tile 0, full width; with
    math=0 every row gets the blocks' coordinate sums (numpy, float64)."""
    E, S = 24, 256
    w = dma_pipeline.workload(E, S, dim)
    for math in (True, False):
        run_of, xi0 = dma_pipeline.runners(E, S, dim, math, torch.device("cpu"))
        vals = [run_of[m](xi0) for m in dma_pipeline.MODES]
        assert all(torch.equal(vals[0], v) for v in vals[1:])
        if math:
            mj, xj = w["xm"][dim], np.ascontiguousarray(w["xm"][:dim].T)
            ref = _pallas_entries(w["xi0"], mj, xj, w["ent"], np.full(E, S << 16, np.int32),
                                  512, S)
            blk = w["ent"].astype(np.int64) * S
            _assert_twin_and_pallas(vals[0], ref, _f64_sums(w["xi0"], mj, xj, np.zeros(E, int),
                                                            blk, blk + S, 512))
        else:
            cols = w["ent"][:, None] * S + np.arange(S)
            sums = w["xm"][:dim, cols].astype(np.float64).sum(axis=(1, 2))
            np.testing.assert_allclose(vals[0].numpy(), np.broadcast_to(sums, (512, dim)),
                                       rtol=1e-6, atol=1e-6 * np.abs(w["xm"][:dim, cols]).sum())


@pytest.mark.parametrize("call", ["bad_rung", "math0_rung", "tb", "one_tile", "nbuf", "lohis",
                                  "sources", "ring_bounds_rung", "min_blocks"])
def test_probe_wrappers_reject_bad_inputs(call):
    xi, mj, xj, ents, ent_tiled, lohi, tb, S = _ladder_case(3, seed=530)
    packed = tge.pack_sources(_t(mj), _t(xj))
    x0 = _t(xi[:tb])
    calls = {
        "bad_rung": lambda: tce.entry_ladder_cuda("prod", x0, packed, _t(ents), None, S),
        "math0_rung": lambda: tce.entry_ladder_cuda("sel", x0, packed, _t(ents), _t(lohi), S,
                                                    math=False),
        "tb": lambda: tce.dma_ring_cuda(_t(np.zeros((1024, 3), np.float32)), packed, _t(ents), S,
                                        2),
        "one_tile": lambda: tce.entry_ladder_cuda("ideal", _t(xi), packed, _t(ents), None, S,
                                                  tb=tb),
        "nbuf": lambda: tce.dma_ring_cuda(x0, packed, _t(ents), S, 3),
        "lohis": lambda: tce.entry_ladder_cuda("when", x0, packed, _t(ents), None, S),
        "sources": lambda: tce.entry_ladder_cuda("sepmj", x0, packed, _t(ents), None, S),
        # only the ideal rung is built at the ring's launch bounds, and no rung at 3
        "ring_bounds_rung": lambda: tce.entry_ladder_cuda("sel", x0, packed, _t(ents), _t(lohi),
                                                          S, min_blocks=tce.RING_BLOCKS),
        "min_blocks": lambda: tce.entry_ladder_cuda("ideal", x0, packed, _t(ents), None, S,
                                                    min_blocks=3),
    }
    with pytest.raises(ValueError):
        calls[call]()


# ------------------------------------------------------------- the probes

CASES = {
    "entries": (["entries", "--n", "4096", "--e", "64"],
                {"probe", "S", "mode", "E", "sec", "us_per_entry", "pairs_per_s"}, 6),
    "entry-overhead": (["entry-overhead", "ideal,sel,when,switch,prod,prod_packed_noskip", "256",
                        "2", "--e", "16"],
                       {"probe", "mode", "E", "S", "dim", "T", "sec_per_call", "us_per_entry",
                        "pairs", "pairs_per_s", "mufu_floor_ms", "mufu_share", "parts",
                        "budget"},
                       8),
    "dma-pipeline": (["dma-pipeline", "all", "--e", "64", "--s", "256", "--math", "0"],
                     {"probe", "mode", "E", "S", "dim", "math", "sec_per_call", "us_per_entry",
                      "copied_bytes", "parts", "budget"},
                     5),
}


def _rate_fields_hold(r, pairs):
    """The line's pairs are `pairs`, its rate and MUFU floor follow from
    them (two MUFU a pair at 16 a clock on an H100's 132 SMs at 1.98 GHz,
    worked out), and the CPU run claims no share of it and no P."""
    assert r["pairs"] == pairs
    assert r["pairs_per_s"] == pytest.approx(pairs / r["sec_per_call"], rel=1e-12)
    assert r["mufu_floor_ms"] == pytest.approx(pairs * 2 / (132 * 16 * 1.98e9) * 1e3, rel=1e-12)
    assert r["mufu_share"] is None and r["parts"] is None


@pytest.mark.parametrize("sub", list(CASES))
def test_probe_on_the_cpu(sub, tmp_path):
    """Each probe at a toy size through the twins: the scripts' JSON keys,
    and device, kernel and launches (none on the CPU)."""
    argv, keys, lines = CASES[sub]
    out = tmp_path / "probe.jsonl"
    assert probe.main([argv[0], str(out), *argv[1:], "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == lines
    timed = [r for r in rows if r["probe"] in ("entries", "entov", "dmapipe")]
    for r in timed:
        assert keys <= set(r) and r["device"] == "cpu" and r["launches"] == {} and r["kernel"]
        assert r.get("budget") is None  # the CUDA runtime's registers and blocks: the card's only
        assert r["sec" if sub == "entries" else "sec_per_call"] > 0
    equiv = [r for r in rows if r["probe"].endswith("_equiv")]
    assert all(r["rel_err"] == 0 for r in equiv) and (sub == "entries") == (not equiv)
    if sub == "entry-overhead":  # every lane of each entry a rung runs; prod the live ones
        lohi = entry_overhead.workload(256, 16, 3, 2)["lohi"]
        lo, hi = lohi & 0xFFFF, lohi >> 16
        for r in timed:
            if r["mode"] == "prod":
                pairs = int(np.maximum(np.minimum(hi, 256) - lo, 0).sum()) * 512
            else:
                pairs = (int((hi > lo).sum()) if r["mode"] == "when" else 16) * 256 * 512
            _rate_fields_hold(r, pairs)
    if sub == "dma-pipeline":  # math 0: no pairs, the copies' bytes
        assert all(r["copied_bytes"] == 64 * 256 * 16 and r["parts"] is None
                   and "pairs" not in r for r in timed)
        # blockspec is the ideal rung at the ring's launch bounds
        assert timed[0]["kernel"] == tce.ladder_name("ideal", False, tce.RING_BLOCKS)
    if sub == "entries":
        assert rows[-1] == {"probe": "entries_done"}
        assert [r["pairs_per_s"] == 0 for r in timed] == [m == "pad" for _, m in
                                                         entries_kernel.MODES]


@pytest.mark.parametrize("sub", list(CASES))
def test_probe_runs_on_the_card_by_default(sub, tmp_path, capsys):
    """Without --device a probe takes the GPU; without one it exits 1 and
    names --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is taken")
    argv = CASES[sub][0]
    with pytest.raises(SystemExit) as e:
        probe.main([argv[0], str(tmp_path / "o.jsonl"), *argv[1:]])
    assert e.value.code == 1 and "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "o.jsonl").exists()


def test_probe_rejects_unknown_modes(tmp_path):
    with pytest.raises(ValueError, match="unknown modes"):
        probe.main(["entry-overhead", str(tmp_path / "o.jsonl"), "ideal,fast", "--device", "cpu"])
