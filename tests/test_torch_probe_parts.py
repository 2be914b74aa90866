"""The entry-cost probes' grid on the CPU: ops/cuda_entry_probes.ladder_parts,
the Python mirror of how entry_ladder_kernel and dma_ring_kernel split
each block of entries into P parts (csrc/entry_probes.cu), held against a
direct numpy reckoning; the default P; the twin summed part by part in
the kernels' slice order; and the wrappers' preconditions, which raise
before any launch.
"""

import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_entry_probes as ce
from nbody_torch.ops import cuda_group_eval as cg
from nbody_torch.probes import entry_overhead

torch.set_num_threads(1)


def _numpy_parts(E, per_block, P, tiles=None):
    """Each block's runs of one tile cut at run[0] + len * (0..np) // np,
    np = min(len, P), as (block, part) -> [(tile, a, c)]."""
    out = {}
    for b, block in enumerate(np.split(np.arange(E), range(per_block, E, per_block))):
        ids = np.zeros(len(block), int) if tiles is None else np.asarray(tiles)[block]
        for run in np.split(block, np.flatnonzero(np.diff(ids)) + 1):
            n = min(len(run), P)
            cuts = run[0] + len(run) * np.arange(n + 1) // n
            for p in range(n):
                out.setdefault((b, p), []).append(
                    (0 if tiles is None else int(tiles[run[0]]), int(cuts[p]), int(cuts[p + 1])))
    return out


@pytest.mark.parametrize("E, per_block, P", [(8192, 64, 8), (200, 64, 8), (37, 5, 3),
                                             (10, 16, 4), (64, 64, 1), (9, 3, 8)])
def test_fixed_tile_parts_cover_each_block_once(E, per_block, P):
    """Parts of a block cover its entries exactly once, in order, with at
    most P parts and none empty; every part's share is numpy's."""
    parts = ce.ladder_parts(E, per_block, P)
    blocks = -(-E // per_block)
    assert len(parts) == blocks * P
    ref = _numpy_parts(E, per_block, P)
    for b in range(blocks):
        pieces = [pc for p in range(P) for pc in parts[b * P + p]]
        e0, e1 = b * per_block, min(E, (b + 1) * per_block)
        assert [e for _, a, c in pieces for e in range(a, c)] == list(range(e0, e1))
        assert all(c > a and t == 0 for t, a, c in pieces)
        assert 1 <= len(pieces) <= P
        for p in range(P):
            assert parts[b * P + p] == ref.get((b, p), [])
        # the shares of one block differ by at most one entry
        sizes = [c - a for _, a, c in pieces]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("per_block, P", [(16, 4), (7, 3), (64, 8), (1, 2), (40, 8)])
def test_switch_parts_split_each_run_of_a_block(per_block, P):
    """switch / noskip: each run of one tile inside a block is cut into at
    most P non-empty shares; part p takes the p-th share of every run;
    runs from the first tile id of ntiles or more are dropped."""
    rng = np.random.default_rng(per_block * 10 + P)
    counts = rng.integers(0, 25, 9)
    tiles = np.repeat(np.arange(9), counts)
    E, ntiles = len(tiles), 7  # tiles 7 and 8 lie past the rows
    parts = ce.ladder_parts(E, per_block, P, tiles, ntiles)
    ref = _numpy_parts(E, per_block, P, tiles)
    live = int(np.searchsorted(tiles, ntiles))
    for b in range(-(-E // per_block)):
        pieces = [pc for p in range(P) for pc in parts[b * P + p]]
        e0, e1 = b * per_block, min(live, (b + 1) * per_block)
        assert sorted(e for _, a, c in pieces for e in range(a, c)) == list(range(e0, max(e0, e1)))
        assert all(c > a and t < ntiles and (tiles[a:c] == t).all() for t, a, c in pieces)
        for p in range(P):
            want = [pc for pc in ref.get((b, p), []) if pc[0] < ntiles]
            assert parts[b * P + p] == want
            assert len({t for t, _, _ in parts[b * P + p]}) == len(parts[b * P + p])


def _atomic_tiles(tiles, per_block):
    """The tiles whose run of entries crosses a block of per_block: the
    only rows switch and noskip add with atomics (csrc/entry_probes.cu)."""
    tiles = [int(t) for t in tiles]
    return {tiles[e] for e in range(per_block, len(tiles), per_block)
            if tiles[e] == tiles[e - 1]}


def test_the_probe_grid_needs_no_atomics():
    """At the probe's E = 8,192, T = 128 a block of E / T entries is one
    tile's whole run: no tile crosses a block, so switch and noskip write
    only plain stores; a run that crosses one is named."""
    w = entry_overhead.workload(256, 8192, 3, 128)
    tiles = w["ent_tiled"] >> 16
    assert _atomic_tiles(tiles, 8192 // 128) == set()
    assert _atomic_tiles([0, 0, 0, 1, 1, 2, 2, 2, 2], 4) == {1, 2}
    assert _atomic_tiles([0, 0, 0, 0, 1, 1, 2, 2, 2], 4) == {2}
    assert _atomic_tiles([0, 0, 1, 1, 1, 1, 2], 2) == {1}


@pytest.mark.parametrize("E, per_block, sms, want", [(8192, 64, 132, 8), (8192, 64, 1, 1),
                                                     (8192, 4, 132, 1), (8192, 64, 200, 8),
                                                     (100, 3, 132, 3), (200, 64, 132, 64)])
def test_default_parts(E, per_block, sms, want):
    """The least power of two giving >= 4 parts an SM, at most per_block."""
    P = ce.default_parts(E, per_block, sms)
    assert P == want
    blocks = -(-E // per_block)
    assert P <= per_block and (blocks * P >= ce.RESIDENT * sms or P == per_block
                               or P * 2 > per_block)


def _case(dim, seed, S=64, tiles=4, per_tile=(5, 0, 9, 3)):
    rng = np.random.default_rng(seed)
    mj = torch.tensor(rng.uniform(0.5, 1.0, 6 * S), dtype=torch.float32)
    xj = torch.tensor(rng.standard_normal((6 * S, dim)), dtype=torch.float32)
    xi = torch.tensor(rng.standard_normal((tiles * 32, dim)), dtype=torch.float32)
    tid = np.repeat(np.arange(tiles), per_tile)
    ents = torch.tensor((tid << 16) | rng.integers(0, 6, tid.size), dtype=torch.int32)
    lo = rng.integers(0, S // 4, tid.size)
    hi = S - rng.integers(0, S // 4, tid.size)
    lohi = torch.tensor(lo | (hi << 16), dtype=torch.int32)
    return xi, mj, xj, ents, lohi, S


@pytest.mark.parametrize("rung", ["ideal", "sel", "switch", "noskip"])
@pytest.mark.parametrize("per_block, P", [(4, 3), (17, 8), (2, 1)])
def test_twin_by_parts_in_slice_order(rung, per_block, P):
    """The twin on each part's pieces, written to the kernels' slices (b *
    P + p on one tile; tile * P + p for switch and noskip) and added by the
    sum pass's plain version as the wrappers add them (on one tile each
    block's parts, then the blocks), gives the twin's rows within 1e-5 of
    each row's sum of |term|."""
    xi, mj, xj, ents, lohi, S = _case(3, seed=40 + P)
    packed, sel, _, switch = ce.RUNGS[rung]
    tb = 32
    x = xi if switch else xi[:tb].contiguous()
    src = cg.pack_sources(mj, xj) if packed else (mj, xj)
    lh = lohi if sel else None
    ntiles = x.shape[0] // tb
    E = ents.shape[0]
    parts = ce.ladder_parts(E, per_block, P, (ents >> 16).tolist() if switch else None, ntiles)
    slices = len(parts) if not switch else ntiles * P
    scratch = torch.zeros(slices, tb, 3)
    for q, pieces in enumerate(parts):
        for tile, a, c in pieces:
            idx = torch.arange(a, c)
            got = ce.entry_ladder_torch(rung, x, src, ents[idx], lh[idx] if sel else None, S,
                                        tb=tb).view(ntiles, tb, 3)
            scratch[tile * P + q % P if switch else q] += got[tile]
    if switch:
        summed = cg.parts_sum_torch(scratch, torch.full((ntiles,), P, dtype=torch.int32), P)
    else:  # each block's P parts, then the blocks
        blocks = slices // P
        per_block = cg.parts_sum_torch(scratch, torch.full((blocks,), P, dtype=torch.int32), P)
        summed = cg.parts_sum_torch(per_block.view(blocks, tb, 3),
                                    torch.tensor([blocks], dtype=torch.int32), blocks)
    want = ce.entry_ladder_torch(rung, x, src, ents, lh, S, tb=tb)
    scale = ce.entry_ladder_torch(rung, x, src, ents, lh, S, tb=tb, absolute=True)
    assert summed.shape == want.shape
    assert bool(((summed - want).abs() <= 1e-5 * scale).all())


def test_wrappers_refuse_bad_parts_and_oversized_rings():
    """ValueError before any launch, on CPU tensors too: parts <= 0 for
    either kernel, and a ring of more shared memory than a block may take
    (4 slots of S = 4,096 rows: 256 KB against 227 KB); 2 slots of 4,096
    (128 KB) are taken."""
    xi, mj, xj, ents, lohi, S = _case(3, seed=7)
    xm = cg.pack_sources(mj, xj)
    x0 = xi[:32].contiguous()
    with pytest.raises(ValueError, match="parts"):
        ce.entry_ladder_cuda("ideal", x0, xm, ents, None, S, parts=0)
    with pytest.raises(ValueError, match="parts"):
        ce.dma_ring_cuda(x0, xm, ents, S, 2, parts=-1)
    assert ce.ring_shared_bytes(4, 4096) == 262_144 > ce.SHARED_PER_BLOCK
    big = torch.zeros(4096 * 2, 4)
    ents0 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        ce.dma_ring_cuda(x0, big, ents0, 4096, 4)
    out = ce.dma_ring_cuda(x0, big, ents0, 4096, 2, math=False)
    assert out.shape == x0.shape and not out.any()
    with pytest.raises(ValueError):
        ce.ladder_parts(10, 0, 2)


def test_dma_pipeline_lines_carry_the_math_rate(tmp_path):
    """probe dma-pipeline --math 1 at a toy size through the twins: each
    line's pairs are E * S * 512, its MUFU floor follows from them, and the
    CPU run claims no share of it and no P; the modes agree bit for bit."""
    import json

    from nbody_torch import probe

    out = tmp_path / "d.jsonl"
    assert probe.main(["dma-pipeline", str(out), "all", "--e", "8", "--s", "64", "--math", "1",
                       "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["rel_err"] for r in rows if r["probe"] == "dmapipe_equiv"] == [0.0, 0.0]
    timed = [r for r in rows if r["probe"] == "dmapipe"]
    assert [r["mode"] for r in timed] == ["blockspec", "manual2", "manual4"]
    for r in timed:
        assert r["pairs"] == 8 * 64 * 512 and r["copied_bytes"] == 8 * 64 * 16
        assert r["mufu_floor_ms"] == pytest.approx(r["pairs"] * 2 / (132 * 16 * 1.98e9) * 1e3)
        assert r["pairs_per_s"] == pytest.approx(r["pairs"] / r["sec_per_call"])
        assert r["mufu_share"] is None and r["parts"] is None and r["launches"] == {}


def test_launch_bounds_name_their_kernels_and_budgets_are_card_only():
    """The ideal rung at the ring's launch bounds (dma-pipeline's blockspec)
    counts under a name of its own, both maths; kernel_budget asks the CUDA
    runtime, so on the CPU it answers None, and it refuses an unknown
    kernel."""
    names = {ce.ladder_name("ideal", m, b) for m in (True, False)
             for b in (ce.LADDER_BLOCKS, ce.RING_BLOCKS)}
    assert len(names) == 4 and names <= set(ce.launch_counts)
    assert ce.ladder_name("ideal") == "entry_ladder_kernel<ideal>"
    cpu = torch.device("cpu")
    assert ce.kernel_budget("ladder", "sel", True, 3, 1024, cpu) is None
    assert ce.kernel_budget("ring", 4, False, 3, 1024, cpu) is None
    with pytest.raises(ValueError, match="kernel"):
        ce.kernel_budget("entries", 0, True, 3, 1024, cpu)


def test_blockspec_runs_the_ideal_rung_at_the_ring_bounds(monkeypatch):
    """dma-pipeline's blockspec mode calls the ideal rung with the ring's
    launch bounds and the probe's CE grid; the rings keep theirs."""
    from nbody_torch.probes import dma_pipeline

    seen = []
    real = ce.entry_ladder_cuda

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(ce, "entry_ladder_cuda", spy)
    run_of, xi0 = dma_pipeline.runners(8, 64, 3, True, torch.device("cpu"))
    out = run_of["blockspec"](xi0)
    assert seen == [{"per_block": ce.CE, "math": True, "min_blocks": ce.RING_BLOCKS}]
    assert torch.equal(out, run_of["manual4"](xi0))
    assert dma_pipeline.kernel_of("manual2", True) == ce.ring_name(2)
    assert dma_pipeline.budget_of("blockspec", True, 3, 64, torch.device("cpu")) is None
