"""The BVH's --sort-every cadence and --refine-levels refinement, and
--profile, of nbody_torch against nbody_tpu, on the CPU.

Cadence: both CLIs in double precision take the BVH's list path on the
CPU, so their printed text is compared line by line (times aside): the
body order re-sorts on the steps k with k % K == 0, k counting the warmup
steps from 0 and the timed steps on from there. Refinement: nbody_tpu's
CLI on the CPU takes the list path, which ignores --refine-levels, so the
windowed path is compared at the function level, nbody_tpu's Pallas
functions in interpret mode: every counter equal and the forces within
1e-5 of sum |a| (the bound of tests/test_torch_bvh.py).
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import cli as tcli
from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.state import SystemState
from nbody_tpu import cli as jcli
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import hilbert as jh
from nbody_tpu.ops.permutation import sort_arrays_by_u32pair
from nbody_tpu.state import SystemState as JState

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5


def _clusters(n, dim, seed=11):
    """Nine Gaussian clusters (tests/test_torch_bvh.py's workload)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_sorted(m, x):
    """nbody_tpu's Hilbert sort of (m, x): the sorted arrays as numpy."""
    xmin, xmax = jgeo.aabb_of_points(jnp.asarray(x), EPS)
    cell = jh.quantize(jnp.asarray(x), xmin, xmax - xmin, x.shape[1])
    hi, lo = jh.hilbert_key_u32pair(cell, x.shape[1])
    return (np.asarray(a) for a in sort_arrays_by_u32pair(hi, lo, jnp.asarray(m), jnp.asarray(x)))


def _lines(main, argv, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    assert main(list(argv), out=out) == 0
    return [ln for ln in out.getvalue().splitlines() if not ln.startswith("Total time")]


# ------------------------------------------------------------------ cadence


@pytest.mark.parametrize("every", ["2", "3"])
@pytest.mark.parametrize("info", [[], ["--print-info"]])
def test_sort_every_cli_vs_nbody_tpu(every, info, tmp_path, monkeypatch):
    """--sort-every 2 and 3, -n 200 -s 12 (10 warmup and 2 timed steps, k
    = 0..11) in double: the same printed lines as nbody_tpu's CLI, with
    and without --print-info (nbody_tpu's per-step and scan loops)."""
    argv = ["-n", "200", "-s", "12", "--algorithm", "bvh", "--precision", "double",
            "--sort-every", every, "--print-state", *info]
    j = _lines(jcli.main, argv, tmp_path, monkeypatch)
    t = _lines(tcli.main, [*argv, "--device", "cpu"], tmp_path, monkeypatch)
    assert t == j
    # the cadence shows: the final order differs from every-step sorting
    t1 = _lines(tcli.main, [*argv[:9], "1", *argv[10:], "--device", "cpu"], tmp_path,
                monkeypatch)
    assert t1 != t


@pytest.mark.parametrize("dim", [2, 3])
def test_step_force_without_resort_vs_nbody_tpu(dim):
    """bvh_step_force(resort=False) builds its tree over the current order:
    the state keeps the caller's order, as nbody_tpu's; the list path's
    forces within 1e-12 of sum |a| of nbody_tpu's."""
    m, x = _clusters(600, dim)
    m, x = m.astype(np.float64), x.astype(np.float64)
    v = np.zeros_like(x)
    js = JState(m=jnp.asarray(m), x=jnp.asarray(x), v=jnp.asarray(v), a=jnp.asarray(v),
                ao=jnp.asarray(v))
    jout, _, _ = jb.bvh_step_force(js, 0.5, 1.0, EPS, resort=False)
    ts = SystemState.from_numpy(m, x, v, device=torch.device("cpu"))
    tout, _ = tb.bvh_step_force(ts, 0.5, 1.0, EPS, list_path=True, resort=False)
    np.testing.assert_array_equal(tout.x.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jout.x), x)
    ja = np.asarray(jout.a)
    assert np.abs(tout.a.numpy() - ja).sum() <= 1e-12 * np.abs(ja).sum()


# --------------------------------------------------------------- refinement

REFINE = {  # name -> (n, dim, windowed path's keywords)
    "5000-3d-window2-r1": (5000, 3, dict(window_tiles=2, refine_levels=1)),
    "5000-3d-window2-r2": (5000, 3, dict(window_tiles=2, refine_levels=2)),
    "3000-3d-tile128-r1": (3000, 3, dict(tile=128, window_tiles=2, refine_levels=1)),
    "3000-3d-tile128-r2": (3000, 3, dict(tile=128, window_tiles=2, refine_levels=2)),
    "3000-2d-window1-r1": (3000, 2, dict(window_tiles=1, refine_levels=1)),
    "5000-3d-window2-r1-forceover0": (5000, 3, dict(window_tiles=2, refine_levels=1,
                                                    ablate="forceover0")),
    "3000-3d-tile128-r2-widextract": (3000, 3, dict(tile=128, window_tiles=2, refine_levels=2,
                                                    ablate="widextract")),
}


@contextlib.contextmanager
def _far_widths():
    """Record the node count of each far-field call."""
    widths = []
    saved = tbg.masked_eval_bits_cuda

    def call(xi, mj, *args, **kwargs):  # the keywords select the kernel's mode
        widths.append(mj.shape[0])
        return saved(xi, mj, *args, **kwargs)

    tbg.masked_eval_bits_cuda = call
    try:
        yield widths
    finally:
        tbg.masked_eval_bits_cuda = saved


@pytest.mark.parametrize("name", list(REFINE))
def test_refined_windowed_vs_nbody_tpu(name):
    """compute_force_grouped_windowed(refine_levels=R): every counter equal
    to nbody_tpu's, forces within 1e-5 of sum |a|, the far field over heap
    levels 0..L*+R."""
    n, dim, kw = REFINE[name]
    ms, xs = _jax_sorted(*_clusters(n, dim))
    jtree = jb.build_tree(jnp.asarray(ms), jnp.asarray(xs), EPS)
    ja, jinfo = jbg.compute_force_grouped_windowed(jtree, jnp.asarray(ms), jnp.asarray(xs), 0.5,
                                                   1.0, EPS, interpret=True, **kw)
    tree = tb.build_tree(_t(ms), _t(xs), EPS)
    with _far_widths() as widths:
        ta, tinfo = tbg.compute_force_grouped_windowed(tree, _t(ms), _t(xs), 0.5, 1.0, EPS, **kw)
    jinfo = {k: int(v) for k, v in jinfo.items()}
    assert {k: int(v) for k, v in tinfo.items()} == jinfo
    assert jinfo["bad_entries"] == 0 and jinfo["res_pairs"] > 0
    if "forceover0" in name:
        assert jinfo["fallback_tiles"] > 0
    ja = np.asarray(ja)
    assert np.abs(ta.numpy() - ja).sum() <= TOL * np.abs(ja).sum()
    level_star = tree.nlevels - (min(512, kw.get("tile", 512)).bit_length() - 1)
    assert widths == [(1 << (level_star + kw["refine_levels"] + 1)) - 1]


def test_refinement_guard_raises_where_nbody_tpu_raises():
    """(1 << (L* + R)) + 1 > 2^16 raises the same ValueError in both: at
    70,000 bodies (17 levels) L* = 8, and R = 9 is capped at nlevels - 1 -
    L* = 8, which reaches it."""
    m, x = _clusters(70000, 2)
    tree = tb.build_tree(_t(m), _t(x), EPS)
    jtree = jb.build_tree(jnp.asarray(m), jnp.asarray(x), EPS)
    errors = []
    for fn, args in ((jbg.compute_force_grouped_windowed, (jtree, jnp.asarray(m), jnp.asarray(x))),
                     (tbg.compute_force_grouped_windowed, (tree, _t(m), _t(x)))):
        with pytest.raises(ValueError) as e:
            fn(*args, 0.5, 1.0, EPS, refine_levels=9)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "2^16 residual nodes" in errors[0]
    assert tree.nlevels == 17


def test_cli_refine_levels_reaches_the_windowed_path(tmp_path, monkeypatch):
    """--refine-levels 1 in float32 runs the port's fast path with R = 1 on
    every step; the default passes None (nbody_tpu's auto, 0)."""
    seen = []
    saved = tbg.compute_force_grouped_windowed

    def call(*args, **kwargs):
        seen.append(kwargs["refine_levels"])
        return saved(*args, **kwargs)

    monkeypatch.setattr(tbg, "compute_force_grouped_windowed", call)
    for flags, want in ((["--refine-levels", "1"], 1), ([], None)):
        seen.clear()
        lines = _lines(tcli.main, ["-n", "3000", "-s", "11", "-d", "3", "--algorithm", "bvh",
                                   "--workload", "galaxy", "--csv-total", "--device", "cpu",
                                   *flags], tmp_path, monkeypatch)
        assert lines[1].startswith("bvh,3,32,1,3000,")
        assert seen == [want] * 11


# ------------------------------------------------------------------ profile


def test_profile_writes_a_trace_and_leaves_the_output(tmp_path, monkeypatch):
    """--profile DIR: a Chrome trace in DIR (made if missing) with the run's
    events; the CSV header and columns as without it."""
    argv = ["-n", "300", "-s", "11", "--algorithm", "octree", "--csv-total", "--device", "cpu"]
    plain = _lines(tcli.main, argv, tmp_path, monkeypatch)
    traced = _lines(tcli.main, [*argv, "--profile", "prof/run"], tmp_path, monkeypatch)
    assert traced[0] == plain[0] and traced[1].split(",")[:5] == plain[1].split(",")[:5]
    trace = json.loads((tmp_path / "prof" / "run" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
