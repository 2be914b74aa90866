"""The group paths' row-range mode (row_start / nrows), which the
replicated multi-device layouts run, against nbody_tpu's, in one process.

Each of the four group functions (the BVH's windowed and list paths, the
octree's fast and list paths) evaluates the rows [r * nrows, (r + 1) *
nrows) of bodies padded as parallel/tree_sharded pads them (zero-mass
copies of the last sorted body up to a multiple of world * tile), for
every rank r of a world of 4 (2-D, tile 16) and of 2 (3-D, tile 32). The
same numpy-seeded inputs go through nbody_tpu's row-range call (its fast
paths in interpret mode, as tests/test_sharding.py:192-240 runs them).

Held: every integer counter equal; forces within 1e-5 of sum |a| of
nbody_tpu's rows (the interpret-mode reciprocal leaves about 1e-5 of a
row's sum of |term|, and both sum the same terms in other orders); the
list paths' rows bit-equal to the same rows of the port's call over all
rows, and the fast paths' within 1e-5 of sum |a| of them (the call over
all rows widens its pad to the residual's block, which the row range does
not, so its entries merge otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import geometry as tgeo
from nbody_torch.ops import octree as to
from nbody_torch.ops import octree_group as tog
from nbody_torch.parallel.tree_sharded import pad_bodies
from nbody_torch.state import SystemState
from nbody_tpu.ops import bvh as jb
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import geometry as jgeo
from nbody_tpu.ops import octree as jo
from nbody_tpu.ops import octree_group as jog

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
TOL = 1e-5
CPU = torch.device("cpu")
# (dim, world, tile); n = 500 is a multiple of neither world * tile (64); its pad, 512,
# keeps nbody_tpu's sub_width a divisor of the fast octree's S
WORLDS = {"2d-4ranks": (2, 4, 16), "3d-2ranks": (3, 2, 32)}
N = 500
PATHS = ("bvh-windowed", "bvh-list", "octree-fast", "octree-list")


def _clusters(n, dim, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20, 20, (4, dim))
    x = (centers[rng.integers(0, 4, n)] + rng.normal(0, 1.5, (n, dim))).astype(np.float32)
    return rng.uniform(0.1, 1, n).astype(np.float32), x


def _t(a):
    return torch.tensor(np.asarray(a))


def _ints(info):
    return {k: int(v) for k, v in info.items() if np.asarray(v).dtype.kind in "iub"}


def _padded(ms, xs, world, tile):
    step = world * tile
    npad = -(-ms.shape[0] // step) * step
    m, x = pad_bodies(_t(ms), _t(xs), npad)
    return m.numpy(), x.numpy(), npad // world


def _bvh_inputs(dim, world, tile):
    m, x = _clusters(N, dim)
    st = tb.hilbert_sort(SystemState.from_numpy(m, x, np.zeros_like(x), device=CPU), EPS)
    return _padded(st.m.numpy(), st.x.numpy(), world, tile)


def _runs(path, dim, world, tile):
    """[(port rows, port counters, JAX rows, JAX counters)] for each rank,
    and the port's call over all rows."""
    out = []
    if path.startswith("bvh"):
        m, x, nrows = _bvh_inputs(dim, world, tile)
        jtree = jb.build_tree(jnp.asarray(m), jnp.asarray(x), EPS)
        ttree = tb.build_tree(_t(m), _t(x), EPS)
        if path == "bvh-windowed":
            def jcall(**kw):
                return jbg.compute_force_grouped_windowed(jtree, jnp.asarray(m), jnp.asarray(x),
                                                          0.5, 1.0, EPS, tile=tile,
                                                          interpret=True, **kw)

            def tcall(**kw):
                return tbg.compute_force_grouped_windowed(ttree, _t(m), _t(x), 0.5, 1.0, EPS,
                                                          tile=tile, **kw)
        else:
            def jcall(**kw):
                return jbg.compute_force_grouped(jtree, jnp.asarray(m), jnp.asarray(x), 0.5, 1.0,
                                                 EPS, tile=tile, **kw)

            def tcall(**kw):
                return tbg.compute_force_grouped(ttree, _t(m), _t(x), 0.5, 1.0, EPS, tile=tile,
                                                 **kw)
    else:
        m0, x0 = _clusters(N, dim)
        depth = jo.max_depth(N, dim)
        lo, hi = jgeo.scalar_bounds(jnp.asarray(x0))
        if path == "octree-fast":
            lo_r, hi_r = jo.robust_quant_box(jnp.asarray(x0), lo, hi)
            ms, xs, _, _ = jo.morton_sort(jnp.asarray(m0), jnp.asarray(x0), lo_r, hi_r, depth)
            m, x, nrows = _padded(np.asarray(ms), np.asarray(xs), world, tile)
            ks = jo.morton_keys(jnp.asarray(x), lo_r, hi_r, depth)

            def jcall(**kw):
                return jog.compute_force_grouped_fast(jnp.asarray(m), jnp.asarray(x), ks, lo_r,
                                                      hi_r, depth, 0.5, 1.0, EPS, tile=tile,
                                                      interpret=True, **kw)

            def tcall(**kw):
                return tog.compute_force_grouped_fast(_t(m), _t(x), _t(np.asarray(ks, np.int64)),
                                                      depth, 0.5, 1.0, EPS, tile=tile, **kw)
        else:
            _, _, ms, xs = jax.jit(jo.build_octree, static_argnums=4)(
                jnp.asarray(m0), jnp.asarray(x0), lo, hi, depth)
            m, x, nrows = _padded(np.asarray(ms), np.asarray(xs), world, tile)
            jl, _, jms, jxs = jax.jit(jo.build_octree, static_argnums=4)(
                jnp.asarray(m), jnp.asarray(x), lo, hi, depth)
            tl, _, tms, txs = to.build_octree(_t(m), _t(x), *tgeo.scalar_bounds(_t(x0)), depth)

            def jcall(**kw):
                return jog.compute_force_grouped(jl, jms, jxs, hi - lo, 0.5, 1.0, EPS, tile=tile,
                                                 **kw)

            def tcall(**kw):
                side = _t(np.asarray(hi - lo))
                return tog.compute_force_grouped(tl, tms, txs, side, 0.5, 1.0, EPS, tile=tile,
                                                 **kw)
    for r in range(world):
        ta, tinfo = tcall(row_start=r * nrows, nrows=nrows)
        ja, jinfo = jcall(row_start=r * nrows, nrows=nrows)
        out.append((ta.numpy(), _ints(tinfo), np.asarray(ja), _ints(jinfo)))
    return out, tcall()[0].numpy()


@pytest.fixture(scope="module")
def row_runs():
    cache = {}

    def get(path, world_name):
        if (path, world_name) not in cache:
            cache[path, world_name] = _runs(path, *WORLDS[world_name])
        return cache[path, world_name]

    return get


@pytest.mark.parametrize("world_name", list(WORLDS))
@pytest.mark.parametrize("path", PATHS)
def test_rows_vs_nbody_tpu(path, world_name, row_runs):
    """Each rank's rows: nrows of them, nbody_tpu's counters, forces within
    TOL of sum |a| of nbody_tpu's."""
    ranks, _ = row_runs(path, world_name)
    dim, world, tile = WORLDS[world_name]
    for ta, tinfo, ja, jinfo in ranks:
        assert ta.shape == ja.shape and ta.shape[0] % tile == 0 and ta.dtype == np.float32
        shared = set(tinfo) & set(jinfo)
        assert {"fallback_tiles", "node_overflow"} <= shared
        assert {k: tinfo[k] for k in shared} == {k: jinfo[k] for k in shared}
        rel = np.abs(ta - ja).sum() / np.abs(ja).sum()
        assert rel < TOL, rel


@pytest.mark.parametrize("world_name", list(WORLDS))
@pytest.mark.parametrize("path", PATHS)
def test_rows_vs_the_call_over_all_rows(path, world_name, row_runs):
    """The ranks' rows, in rank order, are the call over all rows: bit for
    bit on the list paths, within TOL of sum |a| on the fast paths."""
    ranks, full = row_runs(path, world_name)
    rows = np.concatenate([r[0] for r in ranks])[:full.shape[0]]
    if path.endswith("list"):
        np.testing.assert_array_equal(rows, full)
    else:
        assert np.abs(rows - full).sum() / np.abs(full).sum() < TOL


def test_row_range_checks_its_rows():
    """A range off the tiles, or outside the tile-padded bodies, raises."""
    for start, nrows in ((0, 24), (8, 16), (32, 16), (-16, 16)):
        with pytest.raises(ValueError):
            tog.row_range(start, nrows, 16, 32)
    assert tog.row_range(16, 16, 16, 32) == (16, 16)
    assert tog.row_range(5, None, 16, 32) == (0, 32)
