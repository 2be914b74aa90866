"""The trees' list paths of nbody_torch against nbody_tpu on the CPU, at the
sizes where most tiles outgrow the default list caps: a 2^16-body 3-D
float64 galaxy for the octree (94 of 128 tiles fall back) and a 2^18-body
one for the BVH (442 of 512). At 2^20 on the GPU nearly every tile of both
trees falls back; these sizes show that the port flags the same tiles as
nbody_tpu where the share is already large, and that each overflow cause
(frontier, node cap, leaf cap and, in the octree, K_CELL) occurs.

The exact fallback itself is held against nbody_tpu in tests/test_torch_lists.py
at small sizes. Here the port's fallback is replaced by a stand-in that only
keeps the flagged tiles (its direct sum of 2^18 rows would take minutes on
one core), and so is nbody_tpu's for the BVH, whose _finish_grouped is a
module function; nbody_tpu's octree fallback is inline and runs. The
counters max_nodes, max_leaves and fallback_tiles are equal, the BVH's set
of flagged tiles is equal, and the rows of the tiles evaluated through the
lists agree within 1e-12 of their sum |a|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.models import build_galaxy_model
from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import geometry as tgeo
from nbody_torch.ops import octree as to
from nbody_torch.ops import octree_group as tog
from nbody_torch.state import SystemState
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jo
from nbody_tpu.ops import octree_group as jog

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS = float(np.finfo(np.float64).eps)
TILE = 512


def _galaxy(n):
    _, s = build_galaxy_model(n, 3, np.float64, CPU)
    return s.m.numpy(), s.x.numpy()


def _counters(info):
    return {k: int(info[k]) for k in ("max_nodes", "max_leaves", "fallback_tiles")}


@pytest.fixture
def port_flags(monkeypatch):
    """The port's exact fallback replaced by a stand-in that keeps the
    flagged tiles (tile_over, (T,) bool) and leaves their rows as the lists
    gave them."""
    flags = {}

    def keep(acc, xt, tile_over, *rest):
        flags["tile_over"] = tile_over.clone()

    monkeypatch.setattr(tog, "exact_fallback", keep)
    monkeypatch.setattr(tbg, "exact_fallback", keep)
    return flags


def _assert_list_rows(ta, ja, tile_over, n):
    """The rows of the tiles that did not fall back, within 1e-12 of sum |a|."""
    rows = ~np.repeat(tile_over.numpy(), TILE)[:n]
    assert rows.sum() >= 4 * TILE
    ta, ja = ta[rows], ja[rows]
    assert np.abs(ta - ja).sum() / np.abs(ja).sum() < 1e-12


def test_octree_overflow_vs_nbody_tpu_at_2_16(port_flags):
    n = 1 << 16
    m, x = _galaxy(n)
    depth = jo.max_depth(n, 3)
    lo, hi = jgeo.scalar_bounds(jnp.asarray(x))
    jl, _, jms, jxs = jax.jit(jo.build_octree, static_argnums=4)(jnp.asarray(m), jnp.asarray(x),
                                                                 lo, hi, depth)
    ja, jinfo = jog.compute_force_grouped(jl, jms, jxs, hi - lo, 0.5, 1.0, EPS)
    tlo, thi = tgeo.scalar_bounds(torch.tensor(x))
    tl, _, tms, txs = to.build_octree(torch.tensor(m), torch.tensor(x), tlo, thi, depth)
    ta, tinfo = tog.compute_force_grouped(tl, tms, txs, thi - tlo, 0.5, 1.0, EPS)
    assert _counters(tinfo) == _counters(jinfo)
    over = port_flags["tile_over"]
    assert int(over.sum()) == int(tinfo["fallback_tiles"]) > n // TILE // 2
    causes = {k: int(v) for k, v in tinfo.items() if k.startswith("over_")}
    assert set(causes) == {f"over_{c}" for c in tog.OCTREE_CAUSES}
    assert causes["over_k_cell"] > 0 and causes["over_leaves"] > 0
    assert max(causes.values()) <= int(tinfo["fallback_tiles"]) <= sum(causes.values())
    _assert_list_rows(ta.numpy(), np.asarray(ja), over, n)


def test_bvh_overflow_vs_nbody_tpu_at_2_18(port_flags, monkeypatch):
    n = 1 << 18
    m, x = _galaxy(n)
    st = tb.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=CPU), EPS)
    ms, xs = st.m.numpy(), st.x.numpy()

    def finish_keep(acc, xt, tile_over, ncount, lcount, ncnt, lcnt, m, x, n, ntiles, tile,
                    npad, out_rows, dtype, epsv, Gv, **_):
        return Gv * acc[:out_rows], {"max_nodes": jnp.max(ncnt), "max_leaves": jnp.max(lcnt),
                                     "fallback_tiles": jnp.sum(tile_over), "tile_over": tile_over}

    monkeypatch.setattr(jbg, "_finish_grouped", finish_keep)
    try:
        jtree = jax.jit(jb.build_tree, static_argnums=2)(jnp.asarray(ms), jnp.asarray(xs), EPS)
        ja, jinfo = jbg.compute_force_grouped(jtree, jnp.asarray(ms), jnp.asarray(xs), 0.5, 1.0,
                                              EPS)
        ja, jover = np.asarray(ja), np.asarray(jinfo["tile_over"])
    finally:
        jax.clear_caches()  # no later call may reuse the trace with the stand-in
    ta, tinfo = tbg.compute_force_grouped(tb.build_tree(st.m, st.x, EPS), st.m, st.x, 0.5, 1.0,
                                          EPS)
    assert _counters(tinfo) == _counters(jinfo)
    over = port_flags["tile_over"]
    assert np.array_equal(over.numpy(), jover)
    assert int(over.sum()) > n // TILE // 2
    causes = {k: int(v) for k, v in tinfo.items() if k.startswith("over_")}
    assert set(causes) == {f"over_{c}" for c in tbg.BVH_CAUSES}
    assert min(causes.values()) > 0
    assert max(causes.values()) <= int(tinfo["fallback_tiles"]) <= sum(causes.values())
    _assert_list_rows(ta.numpy(), ja, over, n)
