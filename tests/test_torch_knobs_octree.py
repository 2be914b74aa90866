"""The octree fast path's `ablate=` knobs and parameters against nbody_tpu
on the CPU, the two kernel modes they bring to the octree (the interval
window's <full>, the entries' <span>), and the knob probe's SPECs of the
TPU rounds (results/r4, results/r5).

The same numpy-made inputs go through both packages; the Pallas functions
run in interpret mode, as nbody_tpu's own tests run them, and JAX's runs
are cached for the module.

Tolerances. Each token's forces are held within 1e-5 of sum |a| of
nbody_tpu's with the same token (the bound of tests/test_trees.py:1008),
every integer counter equal, nbody_tpu's key set included in the port's,
and the pbdiag sums (float32 in nbody_tpu) within 1e-6 relative. A
mode's twin is held within 1e-5 of each row's sum of |term| of a float64
sum of the pairs it visits, the masked ones weighted 0, and of the Pallas
kernel's mode within 1e-4 (its interpret-mode reciprocal is about 1e-5
off by itself); against the default mode's twin within 1e-6 of sum |a|:
the twins reduce in float64 and round once, so the masked zeros can move
only that rounding.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import probe
from nbody_torch.models import build_model
from nbody_torch.ops import cuda_group_eval as tge
from nbody_torch.ops import octree as tot
from nbody_torch.ops import octree_group as tog
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jot
from nbody_tpu.ops import octree_group as jog
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
KNOB_FILES = [ROOT / "results" / r / f"knob_{t}.jsonl" for r in ("r4", "r5") for t in ("oct", "bvh")]


def _t(a):
    return torch.tensor(np.asarray(a))


def _two_gaussians(n, dim, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, (n // 2, dim)),
                        rng.normal(3, 1, (n - n // 2, dim))]).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


# 2,048 bodies in tiles of 128 over S-blocks of 256 with a 2-tile window:
# several blocks, hundreds of open cells and entries outside the window
BASE = dict(tile=128, s_block=256, window_tiles=2)

# case -> (dim, ablate, extra keyword arguments of both fast paths)
CASES = {
    **{tok: (3, tok, {}) for tok in (
        "none", "epg1", "epg8", "epg16", "subw128", "fheapcap16", "fheapcap64", "nofheap", "wj1",
        "wj2", "sidefloor", "mono", "subdiag", "pbdiag", "ftg2", "nowinskip", "wordextract",
        "widextract,wordextract", "noskip", "far", "win", "near", "nlist", "fheap",
        "sortunperm", "winskip", "subw128,noskip,packedj")},
    "desc2,dbg": (3, "desc2,dbg", {}),
    "desc2,epg8": (3, "desc2,epg8", {}),
    "desc2,near": (3, "desc2,near", {}),
    "depth_bias=1": (3, "", dict(depth_bias=1)),
    "epg=8": (3, "", dict(epg=8)),
    "sub_width=256": (3, "", dict(sub_width=256)),
    **{f"{tok}-2d": (2, tok, {}) for tok in ("nowinskip", "subw128", "nlist")},
}
# held against the default path only: the packed span mode's Pallas
# counterpart is test_entries_span_twin's (None, False, True) case
PORT_ONLY = ("subw128,noskip,packedj",)
# tokens whose JAX run takes x64 off, as nbody_tpu runs on its TPU: nlist's
# entries.sum() is an int32 sum there (int64 under the tests' x64)
INT32_SUM = ("nlist",)


def jax_call(case):
    """(dim, ablate, kw) of nbody_tpu's run that a case is held against:
    the case's own, with the no-op aliases (which nbody_tpu reads nowhere)
    dropped and the parameter epg=8 as its token, so that runs that are
    the same computation share one compile."""
    dim, ablate, kw = CASES[case]
    ablate = ",".join(t for t in ablate.split(",") if t not in tog.ALIASES and t != "none")
    if kw.get("epg") == 8:
        ablate, kw = "epg8", {}
    return dim, ablate, kw


@pytest.fixture(scope="module")
def systems():
    """Per dimension: nbody_tpu's sorted bodies, keys and box, and the
    port's."""
    out = {}
    for dim in (3, 2):
        m, x = _two_gaussians(2048, dim, 5)
        depth = jot.max_depth(2048, dim)
        lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
        lo_r, hi_r = jot.robust_quant_box(jnp.asarray(x), lo, hi)
        jsorted = jot.morton_sort(jnp.asarray(m), jnp.asarray(x), lo_r, hi_r, depth)[:3]
        tsorted = tot.morton_sort(_t(m), _t(x), _t(lo_r), _t(hi_r), depth)[:3]
        out[dim] = (depth, jsorted, (lo_r, hi_r), tsorted, (_t(lo_r), _t(hi_r)))
    return out


@pytest.fixture(scope="module")
def jax_runs(systems):
    cache = {}

    def get(case):
        dim, ablate, kw = key = jax_call(case)
        key = (dim, ablate, tuple(sorted(kw.items())))
        if key not in cache:
            depth, (ms, xs, ks), (lo, hi), *_ = systems[dim]
            with jax.enable_x64(not any(tok in ablate.split(",") for tok in INT32_SUM)):
                a, info = jog.compute_force_grouped_fast(ms, xs, ks, lo, hi, depth, 0.5, 1.0, EPS,
                                                         interpret=True, ablate=ablate,
                                                         **BASE, **kw)
                dbg = info.pop("descend__dbg", None)
                cache[key] = (np.asarray(a), {k: np.asarray(v) for k, v in info.items()}, dbg)
        return cache[key]

    return get


def _port(systems, case):
    dim, ablate, kw = CASES[case]
    depth, _, _, (ms, xs, ks), box = systems[dim]
    ablate = "" if ablate == "none" else ablate
    return tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate=ablate,
                                          box=box, **BASE, **kw)


def assert_info_matches(tinfo, jinfo):
    """nbody_tpu's keys all in the port's; every integer counter equal;
    the float diagnostics (pb_width_*) within 1e-6 relative."""
    tinfo = {k: v for k, v in tinfo.items() if k != "descend__dbg"}
    missing = set(jinfo) - set(tinfo)
    assert not missing, missing
    for key, want in jinfo.items():
        got = np.asarray(tinfo[key])
        if np.issubdtype(want.dtype, np.floating):
            assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want)), (key, got, want)
        else:
            assert int(got) == int(want), (key, int(got), int(want))


@pytest.mark.parametrize("case", [c for c in CASES if c not in PORT_ONLY])
def test_octree_knob_vs_nbody_tpu(case, systems, jax_runs):
    ja, jinfo, jdbg = jax_runs(case)
    ta, tinfo = _port(systems, case)
    assert_info_matches(tinfo, jinfo)
    assert int(jinfo["open_cells"]) > 0
    rel = np.abs(ta.numpy() - ja).sum() / np.abs(ja).sum()
    assert rel < TOL, rel
    dim, ablate, kw = CASES[case]
    tokens = set(ablate.split(","))
    if "desc2" not in tokens:  # the default branch's keys, the repaired ones included
        assert {"bad_entries", "flag_entcnt", "flag_rank", "flag_extra", "max_leaves",
                "leaf_overflow"} <= set(tinfo)
        assert int(tinfo["bad_entries"]) == 0
    if "dbg" in tokens:
        tdbg = tinfo["descend__dbg"]
        assert set(tdbg) == set(jdbg)
        for key in ("entries", "lohis", "open_mask", "win_lo", "win_hi", "cellid", "cid_d"):
            np.testing.assert_array_equal(np.asarray(tdbg[key]), np.asarray(jdbg[key]), key)
        for key in ("mono_far", "ent_near", "far_win"):
            got, want = np.asarray(tdbg[key], np.float64), np.asarray(jdbg[key], np.float64)
            assert np.abs(got - want).sum() <= TOL * np.abs(want).sum(), key
    if "nofheap" in tokens or "far" in tokens:
        assert "far_heap_nonempty" not in tinfo
    if case.startswith("fheapcap"):
        assert "far_heap_nonempty" in tinfo


def test_octree_knob_cases_reach_their_branches(systems, jax_runs):
    """The cases exercise what they name: the compacted far heap both
    within its cap (fheapcap64) and past it (fheapcap16, the dense
    fallback); epg's no-op pads; depth_bias a deeper L*; the word
    extraction's entries equal to the wide one's here (no word, cell or
    block limit hit)."""
    cap16, cap64 = (jax_runs(c)[1] for c in ("fheapcap16", "fheapcap64"))
    assert int(cap16["far_heap_nonempty"]) > 16 >= 0 and int(cap64["far_heap_nonempty"]) <= 64
    base, epg8 = (jax_runs(c)[1] for c in ("epg1", "epg8"))
    assert int(epg8["entries"]) > int(base["entries"]) and int(epg8["entries"]) % 8 == 0
    assert int(jax_runs("depth_bias=1")[1]["open_cells"]) != int(base["open_cells"])
    word = jax_runs("wordextract")[1]
    assert int(word["flag_extra"]) == 0 and int(word["entries"]) == int(base["entries"])


@pytest.mark.parametrize("case", ["epg8", "subw128", "noskip", "ftg2", "nowinskip", "wordextract",
                                  "subw128,noskip,packedj", "sub_width=256", "subw128-2d",
                                  "nowinskip-2d", "fheap", "winskip"])
def test_octree_knob_vs_default_path(case, systems):
    """Within the port: a knob that changes only how a kernel walks (the
    modes, epg's pads, the extraction) or nothing (the aliases) leaves the
    forces within 1e-6 of sum |a| of the default path's. (wj1 / wj2 move
    the window, sidefloor and mono the MAC: other forces.)"""
    dim = CASES[case][0]
    depth, _, _, (ms, xs, ks), box = systems[dim]
    a0, _ = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, **BASE)
    a1, _ = _port(systems, case)
    assert float(a0.abs().max()) > 0
    assert ((a1 - a0).abs().sum() / a0.abs().sum()).item() < 1e-6


def test_octree_wrong_force_probes(systems):
    """far, win, near: the three parts of the default path, each zeroed by
    its token, add up to it; nlist is near's zeros plus one constant."""
    depth, _, _, (ms, xs, ks), box = systems[3]
    a0, _ = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, **BASE)
    parts = {tok: tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate=tok,
                                                 **BASE)[0] for tok in ("far", "win", "near")}
    total = (a0 - parts["far"]) + (a0 - parts["win"]) + (a0 - parts["near"])
    assert ((total - a0).abs().sum() / a0.abs().sum()).item() < 1e-5
    nlist = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate="nlist",
                                           **BASE)[0]
    const = nlist - parts["near"]
    assert torch.all(const == const[0, 0]) and float(const[0, 0]) != 0


@pytest.mark.parametrize("bad", ["forceover0", "densmask", "subw", "subwx1", "dblk2048"])
def test_octree_unknown_tokens_raise(bad, systems):
    """A token nbody_tpu's octree reads nowhere raises, whole or numbered
    (dblkN is the BVH's); a sub_width that does not divide S or is not a
    multiple of 128 raises nbody_tpu's ValueError."""
    depth, _, _, (ms, xs, ks), _ = systems[2]
    with pytest.raises(ValueError, match="read by no nbody_tpu fast path"):
        tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate=f"packedj,{bad}",
                                       **BASE)


@pytest.mark.parametrize("ablate,kw", [("subw192", {}), ("", dict(sub_width=64))])
def test_octree_sub_width_checks(ablate, kw, systems):
    depth, _, _, (ms, xs, ks), _ = systems[2]
    with pytest.raises(ValueError, match="sub_width must divide S"):
        tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate=ablate,
                                       **BASE, **kw)
    with pytest.raises(ValueError, match="sidefloor"):
        tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate="sidefloor",
                                       **BASE)


def test_merge_epg_vs_nbody_tpu():
    """merge_contiguous_entries at epg 4 against nbody_tpu's: the aligned
    stream, its pads, n_final and each tile's stream end, with tiles that
    spill past E_cap."""
    rng = np.random.default_rng(3)
    ntiles, S = 12, 256
    ents, lohis = [], []
    for t in range(ntiles):
        ents.append(t << 16)
        lohis.append(0)
        for _ in range(int(rng.integers(0, 9))):
            blk = int(rng.integers(0, 4))
            lo = int(rng.integers(0, S))
            hi = int(rng.integers(lo, S + 1))
            ents.append((t << 16) | blk)
            lohis.append(lo | (hi << 16))
    n_raw = len(ents)
    order = np.lexsort((np.array(lohis) & 0xFFFF, np.array(ents)))
    ents, lohis = np.array(ents, np.int32)[order], np.array(lohis, np.int32)[order]
    e_cap = n_raw + 4  # too few for every tile's round-up: the last tiles spill
    pad = (ntiles - 1) << 16
    ents = np.concatenate([ents, np.full(e_cap - n_raw, pad, np.int32)])
    lohis = np.concatenate([lohis, np.zeros(e_cap - n_raw, np.int32)])
    want = jog.merge_contiguous_entries(jnp.asarray(ents), jnp.asarray(lohis),
                                        jnp.asarray(n_raw, jnp.int32), pad, ntiles=ntiles, epg=4)
    got = tog.merge_contiguous_entries(_t(ents), _t(lohis), torch.tensor(n_raw), pad, ntiles, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[3][-1]) > e_cap


# ------------------------------------------------ the octree's kernel modes


def _f64_visited(xi, mj, xj, cols, keep, tb):
    """float64 force and sum |term| (sqrt3) of each row tile t against the
    sources cols[t] (a list of index arrays), each weighted keep[t]."""
    force, scale = np.zeros(xi.shape), np.zeros(xi.shape)
    xi, mj, xj = (np.asarray(a, np.float64) for a in (xi, mj, xj))
    for t, (c, k) in enumerate(zip(cols, keep)):
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[c][None, :, :] - xi[rows][:, None, :]
        r = np.sqrt(np.sum(d * d, axis=-1))
        w = (k * mj[c])[None, :] / (r + EPS) ** 3
        force[rows] = np.einsum("kn,knd->kd", w, d)
        scale[rows] = np.einsum("kn,knd->kd", np.abs(w), np.abs(d))
    return force, scale


def _within(got, ref, tol):
    exact, scale = ref
    got = np.asarray(got, np.float64)
    assert got.shape == exact.shape and np.all(np.isfinite(got))
    err = np.abs(got - exact)
    assert np.all(err <= tol * scale), float(np.max(err / np.maximum(scale, 1e-30)))


@pytest.mark.parametrize("dim", [2, 3])
def test_interval_full_twin(dim):
    """window_eval_interval_kernel<full> (nowinskip): the twin against a
    float64 sum over every window column, those outside [lo, hi) weighted
    0, and against window_eval_interval_pallas(skip_outside=False); an
    empty interval and an interval past nj."""
    rng = np.random.default_rng(40 + dim)
    ntiles, tb, wt = 6, 128, 2
    nj = (ntiles + 1) * tb
    mj = rng.uniform(0.1, 1, nj).astype(np.float32)
    xj = rng.uniform(-1, 1, (nj, dim)).astype(np.float32)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tb, dim)).astype(np.float32)
    xi[3] = xj[5]
    w0 = np.array([0, 1, 2, 2, 4, 5], np.int32)
    lo = (w0 * tb + rng.integers(0, tb, ntiles)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, 2 * tb, ntiles), nj).astype(np.int32)
    hi[2] = lo[2]  # empty
    args = (_t(xi), _t(mj), _t(xj), _t(w0), _t(lo), _t(hi), EPS, wt, "sqrt3")
    got = tge.window_eval_interval_cuda(*args, skip_outside=False)
    cols = [np.arange(w * tb, min((w + wt) * tb, nj)) for w in w0]
    keep = [((c >= a) & (c < b)).astype(np.float64) for c, a, b in zip(cols, lo, hi)]
    ref = _f64_visited(xi, mj, xj, cols, keep, tb)
    _within(got, ref, TOL)
    pallas = jpg.window_eval_interval_pallas(
        jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T), jnp.asarray(w0), jnp.asarray(lo),
        jnp.asarray(hi), EPS, window_tiles=wt, interpret=True, softening="sqrt3", wj=1,
        skip_outside=False)
    _within(pallas, ref, 10 * TOL)
    default = tge.window_eval_interval_cuda(*args)
    assert ((got - default).abs().sum() / default.abs().sum()).item() < 1e-6
    assert not got[2 * tb:3 * tb].any()


@pytest.mark.parametrize("sub_width,skip_empty,packed", [(128, True, False), (None, False, True),
                                                        (256, False, False)])
def test_entries_span_twin(sub_width, skip_empty, packed):
    """entries_lohi_kernel<span> (subwN, noskip): entry_spans' visited span
    of each entry against nbody_tpu's subwindow guard (pallas_group_eval.
    py:883-891), the twin against a float64 sum over the span (the
    sources outside [lo, hi) weighted 0) and against
    entries_lohi_eval_pallas with the same sub_width and skip_empty."""
    rng = np.random.default_rng(7)
    ntiles, tb, S, dim = 5, 128, 512, 3
    nj = 4 * S
    mj = rng.uniform(0.1, 1, nj).astype(np.float32)
    xj = rng.uniform(-1, 1, (nj, dim)).astype(np.float32)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tb, dim)).astype(np.float32)
    ents, lohis = [], []
    for t in (0, 1, 3, 4):
        ents.append(t << 16)
        lohis.append(0)  # the tile's sentinel, lo == hi
        for blk in range(4):
            lo = int(rng.integers(0, S))
            hi = int(rng.integers(lo, S + 1))
            ents.append((t << 16) | blk)
            lohis.append(lo | (hi << 16))
    n_real = len(ents)
    ents = np.array(ents + [(ntiles - 1) << 16] * 3, np.int32)
    lohis = np.array(lohis + [0] * 3, np.int32)
    tid, start, stop, klo, khi = (v.numpy() for v in tge.entry_spans(
        _t(ents[:n_real]), _t(lohis[:n_real]), S, sub_width, skip_empty))
    cols, keep = [[] for _ in range(ntiles)], [[] for _ in range(ntiles)]
    W = sub_width or S
    for e in range(n_real):
        blk, lo, hi = ents[e] & 0xFFFF, lohis[e] & 0xFFFF, lohis[e] >> 16
        visited = [w for w in range(0, S, W) if not skip_empty or (hi > max(lo, w) and lo < w + W)]
        span = np.concatenate([np.arange(w, w + W) for w in visited]) if visited else \
            np.zeros(0, np.int64)
        np.testing.assert_array_equal(np.arange(start[e], stop[e]), blk * S + span)
        cols[tid[e]].append(blk * S + span)
        keep[tid[e]].append(((span >= lo) & (span < hi)).astype(np.float64))
    cols = [np.concatenate(c) if c else np.zeros(0, np.int64) for c in cols]
    keep = [np.concatenate(k) if k else np.zeros(0) for k in keep]
    args = (_t(xi), _t(mj), _t(xj), _t(ents), _t(lohis), torch.tensor(n_real), S, ntiles, EPS,
            "sqrt3")
    got = tge.entries_lohi_eval_cuda(*args, packed=packed, sub_width=sub_width,
                                     skip_empty=skip_empty)
    ref = _f64_visited(xi, mj, xj, cols, keep, tb)
    _within(got, ref, TOL)
    pallas = jpg.entries_lohi_eval_pallas(
        jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T), jnp.asarray(ents),
        jnp.asarray(lohis), EPS, S=S, tb=tb, interpret=True, softening="sqrt3",
        n_real=jnp.asarray(n_real, jnp.int32), skip_empty=skip_empty, packed_j=packed,
        sub_width=sub_width)
    _within(pallas, ref, 10 * TOL)
    default = tge.entries_lohi_eval_cuda(*args)
    assert ((got - default).abs().sum() / default.abs().sum()).item() < 1e-6
    assert not got[2 * tb:3 * tb].any()


# ------------------------------------------------------- the knob probe


def _specs(path):
    return [json.loads(line)["spec"] for line in path.read_text().splitlines() if line.strip()]


def test_every_round_spec_parses():
    """Every SPEC of results/r4 and results/r5's knob files: the probe's
    grammar, and every ablate token one the tree's fast path runs."""
    from nbody_torch.ops import bvh_group as tbg

    known = {"oct": (tog.OCTREE_ABLATE, tog.OCTREE_NUMBERED),
             "bvh": (tbg.BVH_ABLATE, tbg.BVH_NUMBERED)}
    count = 0
    for path in KNOB_FILES:
        tree = path.stem.split("_")[1]
        for spec in _specs(path):
            dim, evolved = probe.parse_knob_spec(tree, spec)
            assert dim in (2, 3) and evolved in (0, 1)
            ablate = spec.split(",")[3]
            if ablate != "none":
                tog.ablate_tokens(ablate.replace(".", ","), *known[tree])
            count += 1
    assert count == 114


OCT_SPECS = {}
for _spec in _specs(KNOB_FILES[0]) + _specs(KNOB_FILES[2]):
    OCT_SPECS.setdefault(_spec.split(",")[3], _spec)


@pytest.mark.parametrize("ablate", sorted(OCT_SPECS))
def test_round_spec_knob_step(ablate):
    """Each distinct ablate string of the octree knob files, with its
    first SPEC's tile, S and window, through the probe's step on a fresh
    4,096-body galaxy on the CPU: a finite state, the counters."""
    spec = OCT_SPECS[ablate]
    dim, _ = probe.parse_knob_spec("oct", spec)
    cfg, state = build_model("galaxy", 4096, dim, np.float32, device=torch.device("cpu"))
    new, info = probe.knob_step("oct", spec, cfg)(state)
    assert bool(torch.isfinite(new.x).all()) and int(info["entries"]) > 0
    if "subdiag" in ablate:
        assert {"near_width_cell_tile", "near_width_cell_subtile_xnsub"} <= set(info)
    if "pbdiag" in ablate:
        assert {"pb_width_box", "pb_width_com", "pb_width_tile"} <= set(info)


def test_probe_knobs_diagnostic_keys(tmp_path):
    """probe knobs carries subdiag's widths as ints and pbdiag's as floats,
    and skips the dbg tensors."""
    out = tmp_path / "knobs.jsonl"
    specs = ["512,1024,2,subdiag.pbdiag,3,0", "512,1024,2,desc2.dbg,2,0", "512,1024,2,ftg2,3,0"]
    assert probe.main(["knobs", "oct", str(out), *specs, "--n", "2048", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["spec"] for r in rows] == specs
    assert isinstance(rows[0]["near_width_cell_tile"], int)
    assert isinstance(rows[0]["near_width_cell_subtile_xnsub"], int)
    assert all(isinstance(rows[0][k], float) for k in ("pb_width_box", "pb_width_com",
                                                       "pb_width_tile"))
    assert "descend_open_2" in rows[1] and not any("dbg" in k for k in rows[1])
