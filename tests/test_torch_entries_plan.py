"""The entries kernels' plan (nbody_torch/ops/cuda_group_eval.entries_plan)
and the paths' routing to them, on the CPU.

entries_plan numbers the live entries' bodies in list order and cuts each
tile's run of them into parts of about equal work, one CUDA block a part
(entries_lohi_kernel, its <packed> form and entries_tables_kernel all run
on it). Walked as the kernel walks it, the plan must give every (entry,
body) pair of every live entry to exactly one part of the entry's tile.
The parts' partial sums, each computed with the twin's own pair math and
added in part order (entries_sum_torch, as entries_sum_kernel adds them),
are held per row and component, as a fraction of the row's float64 sum of
|term|, against the unsplit twin within 1e-5 and against nbody_tpu's
entries_lohi_eval_pallas / entries_tables_eval_pallas in interpret mode
within 1e-4 (the interpret-mode reciprocal alone leaves ~1e-5 of that sum).

The routing tests hold the port to nbody_tpu's softenings: the octree's
near field passes "sqrt3" and the BVH's residual "poly", in both packages.
The plan's sweep probe (python -m nbody_torch.probe entries-plan) runs
here at a toy size through the twins.
"""

import inspect
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch import probe
from nbody_torch.ops import bvh as tb
from nbody_torch.ops import bvh_group as tbg
from nbody_torch.ops import cuda_group_eval as cg
from nbody_torch.ops import octree as tot
from nbody_torch.ops import octree_group as tog
from nbody_torch.ops.geometry import aabb_of_points
from nbody_torch.ops.hilbert import hilbert_sort_perm
from nbody_tpu.ops import bvh_group as jbg
from nbody_tpu.ops import octree_group as jog
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)
NTILES, TB, S, NBLOCKS = 6, 32, 1024, 4
TARGETS = [1, 3, 7, 40, 1 << 20]


def _entries(kind: str, seed: int):
    """A tile-sorted list of (tile, blk, lo, hi) rows over NTILES tiles and
    NBLOCKS blocks of S bodies, the number of live rows, and the rows past
    it (garbage that must add nothing). Each tile's run starts with a
    lo == hi sentinel; kind picks what else the list holds:
      empty  tiles 1 and 4 have no entries, tile 2 only sentinels;
      heavy  tile 3 holds most of the bodies (every block whole, twice);
      wide   whole-block entries, each wider than a part of 256 bodies."""
    rng = np.random.default_rng(seed)
    rows = []
    for tile in range(NTILES):
        if kind == "empty" and tile in (1, 4):
            continue
        rows.append((tile, 0, 0, 0))
        if kind == "empty" and tile == 2:
            rows += [(tile, 1, 5, 5), (tile, 3, 700, 700)]
            continue
        for blk in rng.permutation(NBLOCKS)[:3]:
            lo, hi = sorted(int(v) for v in rng.integers(0, S + 1, 2))
            rows.append((tile, int(blk), lo, hi))
        if kind == "heavy" and tile == 3:
            rows += [(tile, blk, 0, S) for blk in range(NBLOCKS)] * 2
        if kind == "wide":
            rows.append((tile, int(rng.integers(0, NBLOCKS)), 0, S))
    n_live = len(rows)
    past = [(1, 2, 3, 900), (0, 1, 0, S), (5, 0, 10, 20)]
    return rows + past, n_live


def _lohi(rows):
    ent = np.array([(t << 16) | b for t, b, _, _ in rows], np.int32)
    lohi = np.array([lo | (hi << 16) for _, _, lo, hi in rows], np.int32)
    return ent, lohi


def _tables(rows):
    """The same rows as table-driven entries: entry k reads table row k,
    plus a pad row (lo == hi); the garbage past n_live points past the
    tables (a row that adds nothing) or at real rows."""
    ent, lohi = _lohi(rows)
    blk = np.array([b for _, b, _, _ in rows] + [0], np.int32)
    lohi_tbl = np.r_[lohi, 0].astype(np.int32)
    g = np.arange(len(rows))
    g[-1] = len(rows) + 7  # past the tables
    tid = np.array([t for t, _, _, _ in rows])
    return ((tid << 16) | g).astype(np.int32), blk, lohi_tbl


def _ranges(decoder, rows, nj):
    """(entries, start, stop) as the wrapper hands them to entries_plan."""
    if decoder == "tables":
        ent, blk, lohi = (torch.from_numpy(a) for a in _tables(rows))
        _, a, b = cg.table_ranges(ent, blk, lohi, S)
    else:
        ent, lohi = (torch.from_numpy(a) for a in _lohi(rows))
        _, a, b = cg.lohi_ranges(ent, lohi, S)
    return ent, a.clamp_max(nj), b.clamp_max(nj)


def _walk(plan, ent):
    """The (block, entry, body) triples of a plan, found as the kernel
    finds them: body u of block b lies in the last entry e of [e0, e1)
    with cum[e] <= u, and is the source plan.start[e] + u - cum[e]."""
    out = []
    cum = plan.cum.numpy()
    for b in range(plan.blocks):
        t = int(plan.tile[b])
        u0, u1 = int(plan.u0[b]), int(plan.u1[b])
        if t < 0:
            assert u0 == u1
            continue
        e0, e1 = int(plan.e0[b]), int(plan.e1[b])
        for u in range(u0, u1):
            e = e0 + int(np.searchsorted(cum[e0:e1], u, side="right")) - 1
            assert e0 <= e < e1 and cum[e] <= u < cum[e + 1] and int(ent[e]) >> 16 == t
            out.append((b, e, int(plan.start[e]) + u - int(cum[e])))
    return out


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("decoder", ["lohi", "tables"])
@pytest.mark.parametrize("kind", ["empty", "heavy", "wide"])
def test_plan_covers_each_entry_body_once(kind, decoder, target):
    """Every (entry, body) pair of every live entry falls in exactly one
    block of its tile, and nothing past n_live does; the grid is target +
    ntiles blocks whatever the data; each tile's parts are contiguous, in
    order, at least one, all but the last part_len bodies long."""
    rows, n_live = _entries(kind, seed={"empty": 1, "heavy": 2, "wide": 3}[kind])
    nj = NBLOCKS * S - 37
    ent, start, stop = _ranges(decoder, rows, nj)
    plan = cg.entries_plan(ent, start, stop, torch.tensor(n_live), NTILES, target)
    assert plan.blocks == target + NTILES
    assert plan.start.dtype == torch.int64 and plan.start.shape == ent.shape
    want = sorted((e, j) for e in range(n_live) for j in range(int(start[e]), int(stop[e])))
    got = _walk(plan, ent)
    assert sorted((e, j) for _, e, j in got) == want
    part_len = int(plan.part_len)
    assert part_len % cg.ENTRY_CHUNK == 0
    ps = plan.part_start.tolist()
    assert ps[0] == 0 and all(b > a for a, b in zip(ps, ps[1:])) and ps[-1] <= plan.blocks
    for t in range(NTILES):
        blocks = range(ps[t], ps[t + 1])
        assert all(int(plan.tile[b]) == t for b in blocks)
        lens = [int(plan.u1[b] - plan.u0[b]) for b in blocks]
        assert all(n == part_len for n in lens[:-1]) and 0 <= lens[-1] <= part_len
        assert all(int(plan.u1[b]) == int(plan.u0[b + 1]) for b in blocks[:-1])
        live_t = [e for e in range(n_live) if int(ent[e]) >> 16 == t]
        work = sum(max(0, int(stop[e] - start[e])) for e in live_t)
        assert sum(lens) == work
    assert (plan.tile[ps[-1]:] == -1).all()
    if kind == "empty":  # tiles without bodies keep one empty part, so their rows are written
        for t in (1, 2, 4):
            assert ps[t + 1] - ps[t] == 1 and int(plan.u1[ps[t]] - plan.u0[ps[t]]) == 0
    if kind == "wide" and target == TARGETS[-1]:  # entries wider than a part are cut
        assert part_len == cg.ENTRY_CHUNK
        blocks_of = {}
        for b, e, _ in got:
            blocks_of.setdefault(e, set()).add(b)
        assert any(len(v) > 1 for v in blocks_of.values())


@pytest.mark.parametrize("n_live", [0, 1, 5])
def test_plan_with_few_or_no_live_entries(n_live):
    """n_live as a tensor or an int: tiles past the live entries get one
    empty part each; with none live every tile does."""
    rows, _ = _entries("heavy", seed=7)
    ent, start, stop = _ranges("lohi", rows, NBLOCKS * S)
    for n in (n_live, torch.tensor(n_live)):
        plan = cg.entries_plan(ent, start, stop, n, NTILES, 40)
        got = _walk(plan, ent)
        assert sorted((e, j) for _, e, j in got) == sorted(
            (e, j) for e in range(n_live) for j in range(int(start[e]), int(stop[e])))
        assert int(plan.cum[-1]) == sum(int(stop[e] - start[e]) for e in range(n_live))
    empty = torch.zeros(0, dtype=torch.int64)
    plan = cg.entries_plan(empty.int(), empty, empty, 0, NTILES, 9)
    assert plan.blocks == 9 + NTILES and plan.part_start.tolist() == list(range(NTILES + 1))


def test_plan_target_from_shapes():
    """The target parts depend on shapes alone: per SM, per tile and per
    256 bodies that E entries of S can hold."""
    assert cg.plan_target(393216, 8192, 2048, 132) == cg.PARTS_PER_SM * 132
    assert cg.plan_target(2000, 8192, 34, 132) == cg.PARTS_PER_TILE * 34
    assert cg.plan_target(3, 64, 34, 132) == 1
    assert cg.plan_target(0, 64, 34, 132) == 1


def test_entries_sum_adds_parts_in_order():
    """entries_sum_torch (and the wrapper on CPU tensors) adds each tile's
    parts one after another."""
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.standard_normal((6, 5, 3)).astype(np.float32))
    start = torch.tensor([0, 2, 3, 6], dtype=torch.int32)
    got = cg.entries_sum_cuda(parts, start)
    assert torch.equal(got[:5], parts[0] + parts[1]) and torch.equal(got[5:10], parts[2])
    assert torch.equal(got[10:], (parts[3] + parts[4]) + parts[5])
    with pytest.raises(TypeError):
        cg.entries_sum_cuda(parts, start.long())


# ------------------------------------------- part-ordered sums vs twin and JAX


def _case(dim, seed, kind="wide"):
    rng = np.random.default_rng(seed)
    nj = NBLOCKS * S
    mj = rng.uniform(0.1, 1.0, nj).astype(np.float32)
    xj = rng.uniform(-1.0, 1.0, (nj, dim)).astype(np.float32)
    xi = rng.uniform(-1.2, 1.2, (NTILES * TB, dim)).astype(np.float32)
    xi[3:9] = xj[S:S + 6]  # coincident pairs: the self-pairs of the real path
    rows, n_live = _entries(kind, seed)
    return xi, mj, xj, rows, n_live


def _part_rows(xi, mj, xj, plan, b, softening):
    """Part b's partial rows (TB, dim): its tile's rows against the pieces
    of its entries that lie in [u0, u1), addressed from plan.start as the
    kernel addresses them, by the twin's pair math."""
    cum, start, t = plan.cum, plan.start, int(plan.tile[b])
    u0, u1 = int(plan.u0[b]), int(plan.u1[b])
    if u0 == u1:
        return torch.zeros(TB, xi.shape[1])
    e = torch.arange(int(plan.e0[b]), int(plan.e1[b]))
    lo = start[e] + (cum[e].clamp_min(u0) - cum[e])
    hi = start[e] + (cum[e + 1].clamp_max(u1) - cum[e])
    out = cg._entries_torch(xi, mj, xj, torch.full_like(e, t), lo, hi.maximum(lo), NTILES, EPS,
                            softening, False)
    return out.view(NTILES, TB, -1)[t]


def _part_sums(xi, mj, xj, decoder, rows, n_live, softening, target):
    """The plan's parts, each summed with the twin's pair math, then added
    in part order as entries_sum_kernel adds them."""
    ent, start, stop = _ranges(decoder, rows, mj.shape[0])
    plan = cg.entries_plan(ent, start, stop, torch.tensor(n_live), NTILES, target)
    parts = torch.zeros(plan.blocks, TB, xi.shape[1])
    for b in range(int(plan.part_start[-1])):
        parts[b] = _part_rows(xi, mj, xj, plan, b, softening)
    return cg.entries_sum_torch(parts, plan.part_start)


def _pallas(decoder, xi, mj, xj, rows, n_live, softening):
    """nbody_tpu's function on the live rows, in interpret mode."""
    args = (jnp.asarray(xi), jnp.asarray(mj), jnp.asarray(xj.T))
    if decoder == "tables":
        ent, blk, lohi = _tables(rows)
        return jpg.entries_tables_eval_pallas(*args, jnp.asarray(ent[:n_live]), jnp.asarray(blk),
                                              jnp.asarray(lohi), EPS, S=S, tb=TB, interpret=True,
                                              softening=softening)
    ent, lohi = _lohi(rows[:n_live])
    return jpg.entries_lohi_eval_pallas(*args, jnp.asarray(ent), jnp.asarray(lohi), EPS, S=S,
                                        tb=TB, interpret=True, softening=softening,
                                        packed_j=decoder == "packed")


def _twin(decoder, xi, mj, xj, rows, n_live, softening, absolute=False):
    """The unsplit twin (the wrapper on CPU tensors), or its sum of |term|."""
    if decoder == "tables":
        ent, blk, lohi = (torch.from_numpy(a) for a in _tables(rows))
        args = (xi, mj, xj, ent[:n_live], blk, lohi, EPS, S, TB, softening)
        if absolute:
            return cg.entries_tables_eval_torch(*args, absolute=True)
        return cg.entries_tables_eval_cuda(*args)
    ent, lohi = (torch.from_numpy(a) for a in _lohi(rows))
    args = (xi, mj, xj, ent, lohi, torch.tensor(n_live), S, NTILES, EPS, softening)
    if absolute:
        return cg.entries_lohi_eval_torch(*args, absolute=True, packed=decoder == "packed")
    return cg.entries_lohi_eval_cuda(*args, packed=decoder == "packed")


@pytest.mark.parametrize("decoder", ["lohi", "packed", "tables"])
@pytest.mark.parametrize("softening", ["sqrt3", "poly"])
@pytest.mark.parametrize("dim", [2, 3])
def test_part_sums_vs_twin_and_pallas(dim, softening, decoder):
    """Whole-block entries cut over parts of 256 bodies (target 2^20), and
    the default-sized plan of an H100 (plan_target): the part-ordered sums
    against the unsplit twin (1e-5) and nbody_tpu in interpret mode (1e-4),
    per row and component of the float64 sum of |term|. In 2-D the list
    has tiles without entries or with sentinels only, which get zeros."""
    xi, mj, xj, rows, n_live = _case(dim, seed=500 + dim, kind="empty" if dim == 2 else "wide")
    if decoder == "packed":  # the packed sources carry the same values
        xm = cg.pack_sources(torch.from_numpy(mj), torch.from_numpy(xj))
        assert torch.equal(xm[:, 3], torch.from_numpy(mj))
    txi, tmj, txj = (torch.from_numpy(a) for a in (xi, mj, xj))
    twin = _twin(decoder, txi, tmj, txj, rows, n_live, softening).double().numpy()
    scale = _twin(decoder, txi.double(), tmj.double(), txj.double(), rows, n_live, softening,
                  absolute=True).numpy()
    ref = np.asarray(_pallas(decoder, xi, mj, xj, rows, n_live, softening), np.float64)
    sizes = (1 << 20, cg.plan_target(len(rows), S, NTILES, 132))
    for target in sizes:
        got = _part_sums(txi, tmj, txj, "tables" if decoder == "tables" else "lohi", rows,
                         n_live, softening, target).double().numpy()
        assert np.all(np.isfinite(got)) and got.shape == twin.shape
        for other, tol in ((twin, 1e-5), (ref, 1e-4)):
            err = np.abs(got - other)
            assert np.all(err <= tol * scale), (target, tol, float(np.max(err / scale)))
        if dim == 2:
            assert not got.reshape(NTILES, TB, dim)[[1, 2, 4]].any()


# ------------------------------------------------------------ routing


def _record_softening(monkeypatch, module):
    seen = []
    wrapper = module.entries_lohi_eval_cuda
    sig = inspect.signature(wrapper)

    def call(*args, **kwargs):
        seen.append(sig.bind(*args, **kwargs).arguments["softening"])
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(module, "entries_lohi_eval_cuda", call)
    return seen


def _jax_softening(module) -> set:
    """The softenings nbody_tpu's module passes to entries_lohi_eval_pallas."""
    src = inspect.getsource(module)
    calls = re.findall(r"entries_lohi_eval_pallas\((.*?)\)\n", src, flags=re.S)
    return {m for c in calls for m in re.findall(r'softening="(\w+)"', c)}


def _clustered(n, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, (9, dim))
    x = (centers[rng.integers(0, 9, n)] + rng.normal(0, 1.2, (n, dim))).astype(np.float32)
    return (torch.from_numpy(rng.uniform(0.1, 1, n).astype(np.float32)), torch.from_numpy(x))


@pytest.mark.parametrize("ablate", ["", "packedj"])
def test_octree_near_field_takes_sqrt3(ablate, monkeypatch):
    seen = _record_softening(monkeypatch, tog)
    m, x = _clustered(3000, 3, seed=21)
    depth = tot.max_depth(3000, 3)
    ms, xs, ks, _ = tot.morton_sort(m, x, *tot.robust_quant_box(x), depth)
    _, info = tog.compute_force_grouped_fast(ms, xs, ks, depth, 0.5, 1.0, EPS, ablate=ablate)
    assert int(info["entries"]) > 0
    assert seen == ["sqrt3"] and _jax_softening(jog) == {"sqrt3"}


@pytest.mark.parametrize("ablate", ["", "packedj"])
def test_bvh_residual_takes_poly(ablate, monkeypatch):
    seen = _record_softening(monkeypatch, tbg)
    m, x = _clustered(3000, 2, seed=22)
    perm = hilbert_sort_perm(x, *aabb_of_points(x, EPS))
    m, x = m[perm].contiguous(), x[perm].contiguous()
    _, info = tbg.compute_force_grouped_windowed(tb.build_tree(m, x, EPS), m, x, 0.5, 1.0, EPS,
                                                 window_tiles=1, ablate=ablate)
    assert int(info["entries"]) > 0
    assert seen == ["poly"] and _jax_softening(jbg) == {"poly"}


# ------------------------------------------------------ the plan's sweep probe


def test_entries_plan_probe_on_the_cpu(tmp_path):
    """One JSON line per (tree, dim), each entries call recorded from the
    path and timed at one part a tile, ntiles parts and the default
    target; no launches on the CPU."""
    out = tmp_path / "plan.jsonl"
    assert probe.main(["entries-plan", str(out), "--n", "2048", "--dims", "3,2",
                       "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["tree"], r["dim"], r["softening"]) for r in rows] == [
        ("octree", 3, "sqrt3"), ("octree", 2, "sqrt3"), ("bvh", 3, "poly"), ("bvh", 2, "poly")]
    for r in rows:
        assert r["probe"] == "entries_plan" and r["n"] == 2048 and r["device"] == "cpu"
        assert r["launches"] == {} and r["plan_ms"] > 0
        want = {1, r["ntiles"], r["default_target"], 2 * r["default_target"]}
        assert want <= {int(k) for k in r["ms_by_target"]}
        assert all(v > 0 for v in r["ms_by_target"].values())


def test_entries_plan_probe_takes_the_card_by_default(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is taken")
    with pytest.raises(SystemExit) as e:
        probe.main(["entries-plan", str(tmp_path / "o.jsonl"), "--n", "2048"])
    assert e.value.code == 1 and "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "o.jsonl").exists()
