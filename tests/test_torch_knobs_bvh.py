"""The BVH fast path's `ablate=` knobs and parameters against nbody_tpu on
the CPU, the two kernel modes they bring to the BVH (the node-mask
window's <full>, the far field's <tg2>), and the BVH knob probe's SPECs of
the TPU rounds (results/r4, results/r5).

The same numpy-made inputs go through both packages; the Pallas functions
run in interpret mode and JAX's runs are cached for the module.
Tolerances as in tests/test_torch_knobs_octree.py: a token's forces
within 1e-5 of sum |a| of nbody_tpu's, every integer counter equal and
nbody_tpu's keys included; a mode's twin within 1e-5 of each row's sum of
|term| of a float64 sum of the pairs it visits (the masked ones weighted
0), the Pallas mode within 1e-4, and the default mode within 1e-6 of sum
|a|.
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
from nbody_torch.ops import bvh as tbvh
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import cuda_group_eval as tge
from nbody_tpu.ops import bvh as jbvh
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import hilbert as jh
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.tensor(np.asarray(a))


def _two_gaussians(n, dim, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, (n // 2, dim)),
                        rng.normal(3, 1, (n - n // 2, dim))]).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


# 4,096 bodies in tiles of 128, L* nodes of 128 bodies, a 4-tile window:
# residual entries outside the window over several d_block-wide blocks
BASE = dict(tile=128, s_target=128, window_tiles=4)

# case -> (dim, ablate, extra keyword arguments of both fast paths)
CASES = {
    **{tok: (3, tok, {}) for tok in (
        "none", "epg1", "epg8", "epg16", "subw256", "subw128,subw512", "dblk1024", "dblk0",
        "dblk2048,subw256", "wj1", "wj2", "win", "far", "resid", "rlist", "ftg2", "nowinskip",
        "fheap", "sortunperm", "winskip", "nowinskip,wj2")},
    "d_block=0": (3, "", dict(d_block=0)),
    "epg=8": (3, "", dict(epg=8)),
    "sub_width=512": (3, "", dict(sub_width=512)),
    **{f"{tok}-2d": (2, tok, {}) for tok in ("ftg2", "nowinskip", "subw256", "dblk0", "rlist")},
}
INT32_SUM = ("rlist",)  # JAX's x64 off, as on its TPU (see the octree file)


def jax_call(case):
    """nbody_tpu's run a case is held against (the octree file's rule):
    the aliases dropped, epg=8 as its token, d_block=0 as dblk0."""
    dim, ablate, kw = CASES[case]
    ablate = ",".join(t for t in ablate.split(",") if t not in tbg.ALIASES if t != "none")
    if kw.get("epg") == 8:
        ablate, kw = "epg8", {}
    if kw.get("d_block") == 0:
        ablate, kw = "dblk0", {}
    return dim, ablate, kw


@pytest.fixture(scope="module")
def systems():
    """Per dimension: the Hilbert-sorted bodies (nbody_tpu's order) and
    their tree in both packages."""
    out = {}
    for dim in (3, 2):
        m, x = _two_gaussians(4096, dim, 11)
        jx = jnp.asarray(x)
        perm = np.asarray(jh.hilbert_sort_perm(jx, *jgeo.aabb_of_points(jx, EPS)))
        ms, xs = m[perm], x[perm]
        out[dim] = (ms, xs, jbvh.build_tree(jnp.asarray(ms), jnp.asarray(xs), EPS),
                    tbvh.build_tree(_t(ms), _t(xs), EPS))
    return out


@pytest.fixture(scope="module")
def jax_runs(systems):
    cache = {}

    def get(case):
        dim, ablate, kw = jax_call(case)
        key = (dim, ablate, tuple(sorted(kw.items())))
        if key not in cache:
            ms, xs, jtree, _ = systems[dim]
            with jax.enable_x64(not any(tok in ablate.split(",") for tok in INT32_SUM)):
                a, info = jbg.compute_force_grouped_windowed(
                    jtree, jnp.asarray(ms), jnp.asarray(xs), 0.5, 1.0, EPS, interpret=True,
                    ablate=ablate, **BASE, **kw)
                cache[key] = (np.asarray(a), {k: int(v) for k, v in info.items()})
        return cache[key]

    return get


def _port(systems, case):
    dim, ablate, kw = CASES[case]
    ms, xs, _, ttree = systems[dim]
    return tbg.compute_force_grouped_windowed(ttree, _t(ms), _t(xs), 0.5, 1.0, EPS,
                                              ablate="" if ablate == "none" else ablate,
                                              **BASE, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_bvh_knob_vs_nbody_tpu(case, systems, jax_runs):
    ja, jinfo = jax_runs(case)
    ta, tinfo = _port(systems, case)
    assert not set(jinfo) - set(tinfo), set(jinfo) - set(tinfo)
    assert {k: int(tinfo[k]) for k in jinfo} == jinfo
    assert jinfo["res_pairs"] > 0 and jinfo["bad_entries"] == 0
    rel = np.abs(ta.numpy() - ja).sum() / np.abs(ja).sum()
    assert rel < TOL, rel


def test_bvh_knob_cases_reach_their_branches(jax_runs):
    """dblk0 takes node-sized blocks (more entries than the default's
    4096-wide ones merge into), dblk1024 fewer; epg8's pads make the count
    a multiple of 8 a tile."""
    base, node, mid, epg8 = (jax_runs(c)[1]["entries"] for c in ("none", "dblk0", "dblk1024",
                                                                 "epg8"))
    assert node > mid > base and epg8 > base and epg8 % 8 == 0


@pytest.mark.parametrize("case", ["epg8", "subw256", "dblk0", "dblk1024", "ftg2", "nowinskip",
                                  "sub_width=512", "ftg2-2d", "nowinskip-2d", "fheap",
                                  "winskip"])
def test_bvh_knob_vs_default_path(case, systems):
    """Within the port: a knob that changes only how the kernels walk (the
    modes, epg's pads, the residual's block width) or nothing (the
    aliases) leaves the forces within 1e-6 of sum |a| of the default
    path's (wj1 / wj2 move the window: other forces)."""
    dim = CASES[case][0]
    ms, xs, _, ttree = systems[dim]
    a0, _ = tbg.compute_force_grouped_windowed(ttree, _t(ms), _t(xs), 0.5, 1.0, EPS, **BASE)
    a1, _ = _port(systems, case)
    assert ((a1 - a0).abs().sum() / a0.abs().sum()).item() < 1e-6


def test_bvh_wrong_force_probes(systems):
    """win, far, resid: the three parts, each zeroed by its token, add up
    to the default path; rlist is resid's zeros plus one constant."""
    ms, xs, _, ttree = systems[3]
    run = lambda tok: tbg.compute_force_grouped_windowed(ttree, _t(ms), _t(xs), 0.5, 1.0, EPS,
                                                         ablate=tok, **BASE)[0]
    a0 = run("")
    parts = {tok: run(tok) for tok in ("win", "far", "resid")}
    total = sum(a0 - p for p in parts.values())
    assert ((total - a0).abs().sum() / a0.abs().sum()).item() < 1e-5
    const = run("rlist") - parts["resid"]
    assert torch.all(const == const[0, 0]) and float(const[0, 0]) != 0


# ---------------------------------------------------- the BVH's kernel modes


def _f64_rows(xi, mj, xj, weight, tb):
    """float64 force and sum |term| (poly softening) of row tile t
    against the sources (mj (c,), xj (c, dim)) weighted weight (T, c)."""
    xi, mj, xj, weight = (np.asarray(a, np.float64) for a in (xi, mj, xj, weight))
    force, scale = np.zeros_like(xi), np.zeros_like(xi)
    for t in range(weight.shape[0]):
        rows = slice(t * tb, (t + 1) * tb)
        d = xj[None, :, :] - xi[rows][:, None, :]
        d2 = np.sum(d * d, axis=-1)
        w = (weight[t] * mj)[None, :] / (d2 * np.sqrt(d2) + EPS)
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
def test_nodemask_full_twin(dim):
    """window_eval_nodemask_kernel<full> (nowinskip): the twin against a
    float64 sum over every window body, a closed slot's weighted 0, and
    against window_eval_nodemask_pallas(skip_outside=False); a tile with
    every slot closed."""
    rng = np.random.default_rng(50 + dim)
    ntiles, tb, wt, S = 5, 128, 2, 32
    nj = (ntiles + 1) * tb
    mj = rng.uniform(0.1, 1, nj).astype(np.float32)
    xj = rng.uniform(-1, 1, (nj, dim)).astype(np.float32)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tb, dim)).astype(np.float32)
    xi[4] = xj[2]
    w0 = np.array([0, 0, 2, 3, 4], np.int32)
    in_win = rng.random((ntiles, wt * tb // S)) < 0.5
    in_win[3] = False
    args = (_t(xi), _t(mj), _t(xj), _t(w0), _t(in_win), EPS, wt, S, "poly")
    got = tge.window_eval_nodemask_cuda(*args, skip_outside=False)
    weight = np.zeros((ntiles, nj))
    for t in range(ntiles):
        weight[t, w0[t] * tb:(w0[t] + wt) * tb] = np.repeat(in_win[t], S)
    ref = _f64_rows(xi, mj, xj, weight, tb)
    _within(got, ref, TOL)
    pallas = jpg.window_eval_nodemask_pallas(
        jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T), jnp.asarray(in_win), jnp.asarray(w0),
        EPS, window_tiles=wt, S=S, interpret=True, softening="poly", wj=1, skip_outside=False)
    _within(pallas, ref, 10 * TOL)
    default = tge.window_eval_nodemask_cuda(*args)
    assert ((got - default).abs().sum() / default.abs().sum()).item() < 1e-6
    assert not got[3 * tb:4 * tb].any()


@pytest.mark.parametrize("ntiles", [6, 7])
@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
def test_masked_bits_tg2_twin(ntiles, softening):
    """masked_eval_bits_kernel<tg2> (ftg2): the twin against a float64 sum
    of each row's tile's accepted nodes (the pair's other nodes weighted
    0), against masked_eval_bits_pallas(tile_group=2) (an odd count of
    tiles pairs the last with a pad tile) and against the default mode; W
    not a multiple of 32, a tile that accepts nothing."""
    rng = np.random.default_rng(60 + ntiles)
    tb, w, dim = 128, 1001, 3
    mj = rng.uniform(0.1, 1, w).astype(np.float32)
    mj[::17] = 0
    xj = rng.uniform(-1, 1, (w, dim)).astype(np.float32)
    xi = rng.uniform(-1.2, 1.2, (ntiles * tb, dim)).astype(np.float32)
    mask = rng.random((ntiles, w)) < 0.2
    mask[ntiles - 1] = False
    words = tge.pack_mask_bits(_t(mask))
    got = tge.masked_eval_bits_cuda(_t(xi), _t(mj), _t(xj), words, EPS, softening, tile_group=2)
    if softening == "poly":
        ref = _f64_rows(xi, mj, xj, mask, tb)
    else:
        xi64, mj64, xj64 = (np.asarray(a, np.float64) for a in (xi, mj, xj))
        d = xj64[None, None, :, :] - xi64.reshape(ntiles, tb, 1, dim)
        r = np.sqrt(np.sum(d * d, axis=-1))
        wgt = (mask * mj64)[:, None, :] / (r + EPS) ** 3
        ref = (np.einsum("tkn,tknd->tkd", wgt, d).reshape(-1, dim),
               np.einsum("tkn,tknd->tkd", np.abs(wgt), np.abs(d)).reshape(-1, dim))
    _within(got, ref, TOL)
    pallas = jpg.masked_eval_bits_pallas(jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T),
                                         jpg.pack_mask_bits(jnp.asarray(mask)), EPS,
                                         interpret=True, softening=softening, tile_group=2)
    _within(pallas, ref, 10 * TOL)
    default = tge.masked_eval_bits_cuda(_t(xi), _t(mj), _t(xj), words, EPS, softening)
    assert ((got - default).abs().sum() / default.abs().sum()).item() < 1e-6
    assert not got[(ntiles - 1) * tb:].any()
    with pytest.raises(ValueError, match="tile_group"):
        tge.masked_eval_bits_cuda(_t(xi), _t(mj), _t(xj), words, EPS, softening, tile_group=4)


def test_bvh_unknown_tokens_raise(systems):
    """Tokens the BVH reads nowhere raise: the octree's farcompact, desc2,
    fheapcapN and nlist, a misspelt one."""
    ms, xs, _, ttree = systems[2]
    for bad in ("farcompact", "desc2", "fheapcap1024", "nlist", "dblk", "nowinskp"):
        with pytest.raises(ValueError, match="read by no nbody_tpu fast path"):
            tbg.compute_force_grouped_windowed(ttree, _t(ms), _t(xs), 0.5, 1.0, EPS,
                                               ablate=f"packedj,{bad}", **BASE)


# ------------------------------------------------------- the knob probe


BVH_SPECS = {}
for _path in (ROOT / "results" / "r4" / "knob_bvh.jsonl", ROOT / "results" / "r5" / "knob_bvh.jsonl"):
    for _line in _path.read_text().splitlines():
        if _line.strip():
            _spec = json.loads(_line)["spec"]
            BVH_SPECS.setdefault(_spec.split(",")[3], _spec)


@pytest.mark.parametrize("ablate", sorted(BVH_SPECS))
def test_round_spec_knob_step(ablate):
    """Each distinct ablate string of the BVH knob files, with its first
    SPEC's tile, node size and window, through the probe's step on a
    fresh 4,096-body galaxy on the CPU."""
    spec = BVH_SPECS[ablate]
    dim, _ = probe.parse_knob_spec("bvh", spec)
    cfg, state = build_model("galaxy", 4096, dim, np.float32, device=torch.device("cpu"))
    new, info = probe.knob_step("bvh", spec, cfg)(state)
    assert bool(torch.isfinite(new.x).all()) and int(info["entries"]) > 0
