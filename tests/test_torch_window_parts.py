"""The node-mask window's split into parts, on the CPU: window_parts, the
Python mirror of the split that window_eval_nodemask_kernel computes in
the kernel (csrc/group_eval.cu), and the twin evaluated part by part.

Tile t's open bodies are those of its open slots (in_win[t, v]: the
bodies w0[t]*tb + v*S + [0, S) below nj). window_parts gives each tile
tile_parts(their count, P) parts: equal shares of them in slot order,
each a list of source ranges inside runs of open slots. The twin
evaluated over each part's columns and added in part order equals the
whole twin within 1e-5 (float32) or 1e-12 (float64) of each row's sum of
|term| (the same terms summed in other groupings); the twin equals
window_eval_nodemask_pallas in interpret mode within 1e-4 of that sum,
the bound of tests/test_torch_bvh.py (the interpret-mode reciprocal is
about 1e-5 off by itself).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_torch.ops import cuda_group_eval as tge
from nbody_tpu.ops import pallas_group_eval as jpg

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

# (ntiles, tb, window_tiles, S, nj, P): slots of 512 as at 2^20 (one slot
# a tile), 16-body slots, slots that do not divide the window's bodies
# evenly past nj, and a part count above any tile's open bodies
CASES = {
    "2^20-slots": (6, 512, 4, 512, 6 * 512, 4),
    "16-body-slots": (8, 128, 4, 16, 8 * 128, 3),
    "ragged-nj": (7, 96, 3, 32, 7 * 96 - 45, 5),
    "parts-above-bodies": (5, 64, 2, 8, 5 * 64, 1000),
}


def _case(name, seed=0):
    """Seeded (in_win (T, slots) bool, w0 (T,) int32, S, nj, tb, P,
    window_tiles), with tile 1 wholly closed and tile 2 wholly open."""
    ntiles, tb, wt, S, nj, P = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    in_win = rng.random((ntiles, wt * tb // S)) < 0.5
    in_win[1], in_win[2] = False, True
    w0 = rng.integers(0, ntiles - wt + 1, ntiles)
    return (torch.tensor(in_win), torch.tensor(w0, dtype=torch.int32), S, nj, tb, P, wt)


def _open_bodies(in_win, S, nj, w0, tb):
    """Each tile's open bodies in slot order, one by one."""
    out = []
    for t in range(in_win.shape[0]):
        col0 = int(w0[t]) * tb
        out.append([j for v in range(in_win.shape[1]) if in_win[t, v]
                    for j in range(col0 + v * S, min(col0 + (v + 1) * S, nj))])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_parts_partition_the_open_bodies_in_order(name):
    in_win, w0, S, nj, tb, P, _ = _case(name)
    parts = tge.window_parts(in_win, S, nj, w0, tb, P)
    for t, bodies in enumerate(_open_bodies(in_win, S, nj, w0, tb)):
        walked = [j for part in parts[t] for a, b in part for j in range(a, b)]
        assert walked == bodies
        assert len(parts[t]) == tge.tile_parts(len(bodies), P) <= P
        assert all(a < b for part in parts[t] for a, b in part)


@pytest.mark.parametrize("name", list(CASES))
def test_parts_never_visit_a_closed_slot(name):
    in_win, w0, S, nj, tb, P, _ = _case(name)
    for t, tile in enumerate(tge.window_parts(in_win, S, nj, w0, tb, P)):
        col0 = int(w0[t]) * tb
        for a, b in (r for part in tile for r in part):
            assert col0 <= a and b <= min(nj, col0 + in_win.shape[1] * S)
            assert all(in_win[t, (j - col0) // S] for j in range(a, b))


@pytest.mark.parametrize("name", list(CASES))
def test_parts_differ_by_at_most_one_body(name):
    in_win, w0, S, nj, tb, P, _ = _case(name)
    for tile in tge.window_parts(in_win, S, nj, w0, tb, P):
        sizes = [sum(b - a for a, b in part) for part in tile]
        assert not sizes or max(sizes) - min(sizes) <= 1


def test_parts_edge_cases():
    """A last slot cut by nj; a tile with no open slot (no parts); P above
    the open bodies (one part); one part a tile covers every run."""
    in_win = torch.tensor([[True, False, True, True], [False] * 4, [True] * 4])
    w0 = torch.tensor([0, 0, 1], dtype=torch.int32)
    S, tb = 10, 20  # a window of 2 tiles: 4 slots of 10 bodies
    nj = 55  # tile 2's window is bodies 20..59: its last slot is cut at 55
    parts = tge.window_parts(in_win, S, nj, w0, tb, 1000)
    assert parts[0] == [[(0, 10), (20, 40)]]
    assert parts[1] == []
    assert parts[2] == [[(20, 55)]]
    assert tge.window_parts(in_win, S, nj, w0, tb, 1)[0] == [[(0, 10), (20, 40)]]
    # 600 open bodies in 3 parts of 200, cut inside the runs
    wide = tge.window_parts(torch.tensor([[True, True, False, True]]), 200, 800,
                            torch.tensor([0], dtype=torch.int32), 400, 3)
    assert wide == [[[(0, 200)], [(200, 400)], [(600, 800)]]]
    cut = tge.window_parts(torch.tensor([[True, False, True]]), 300, 900,
                           torch.tensor([0], dtype=torch.int32), 900, 2)
    assert cut == [[[(0, 300)], [(600, 900)]]]
    assert tge.tile_parts(0, 8) == 0 and tge.tile_parts(1, 8) == 1
    assert tge.tile_parts(257, 8) == 2 and tge.tile_parts(10**6, 8) == 8


def _bodies(n, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    mj = rng.uniform(0.1, 1.0, n)
    xj = rng.uniform(-1.0, 1.0, (n, dim))
    return torch.tensor(mj, dtype=dtype), torch.tensor(xj, dtype=dtype)


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["16-body-slots", "ragged-nj", "2^20-slots"])
def test_twin_by_parts_equals_the_whole_twin(name, dtype, dim, softening):
    """Each part's columns evaluated through the dense-mask twin, the parts
    added in order, against the whole node-mask twin."""
    in_win, w0, S, nj, tb, P, wt = _case(name, seed=5)
    ntiles = in_win.shape[0]
    mj, xj = _bodies(nj, dim, dtype, seed=7 + dim)
    _, xi = _bodies(ntiles * tb, dim, dtype, seed=8 + dim)
    eps = float(torch.finfo(dtype).eps)
    args = (xi, mj, xj, w0, in_win, eps, wt, S, softening)
    whole = tge.window_eval_nodemask_torch(*args)
    scale = tge.window_eval_nodemask_torch(*args, absolute=True)
    parts = tge.window_parts(in_win, S, nj, w0, tb, P)
    summed = torch.zeros_like(whole)
    for p in range(max(len(tile) for tile in parts)):
        mask = torch.zeros(ntiles, wt * tb, dtype=dtype)
        for t, tile in enumerate(parts):
            for a, b in (tile[p] if p < len(tile) else []):
                col0 = int(w0[t]) * tb
                mask[t, a - col0:b - col0] = 1
        summed += tge.window_eval_dense_torch(xi, mj, xj, w0, mask, eps, wt, softening)
    assert bool(((summed - whole).abs() <= TOL[dtype] * scale).all()), \
        ((summed - whole).abs() / scale.clamp_min(1e-300)).max().item()
    assert not whole[tb:2 * tb].any() and not summed[tb:2 * tb].any()


@pytest.mark.parametrize("softening", ["poly", "sqrt3"])
@pytest.mark.parametrize("dim", [2, 3])
def test_twin_equals_nodemask_pallas_interpret(dim, softening):
    """The twin against window_eval_nodemask_pallas(interpret=True) on the
    same seeded numpy inputs: 16-body slots, a closed and an open tile."""
    in_win, w0, S, nj, tb, _, wt = _case("16-body-slots", seed=11)
    ntiles = in_win.shape[0]
    rng = np.random.default_rng(40 + dim)
    mj = rng.uniform(0.1, 1.0, nj).astype(np.float32)
    xj = rng.uniform(-1.0, 1.0, (nj, dim)).astype(np.float32)
    eps = float(np.finfo(np.float32).eps)
    ref = np.asarray(jpg.window_eval_nodemask_pallas(
        jnp.asarray(xj), jnp.asarray(mj), jnp.asarray(xj.T), jnp.asarray(in_win.numpy()),
        jnp.asarray(w0.numpy()), eps, window_tiles=wt, S=S, interpret=True,
        softening=softening, skip_outside=True))
    args = (torch.tensor(xj), torch.tensor(mj), torch.tensor(xj), w0, in_win, eps, wt, S,
            softening)
    got = tge.window_eval_nodemask_torch(*args)
    scale = tge.window_eval_nodemask_torch(*args, absolute=True)
    assert got.shape == ref.shape == (ntiles * tb, dim)
    err = np.abs(got.numpy().astype(np.float64) - ref)
    assert np.all(err <= 1e-4 * scale.numpy()), float(np.max(err / scale.numpy().clip(1e-30)))
    assert torch.equal(tge.window_eval_nodemask_cuda(*args), got)
