"""The distributed sort of the partitioned trees (the port of
nbody_tpu.parallel.distributed_sort): rows sorted by key across the ranks
of a group, each rank holding a contiguous block of the global order.

Odd-even transposition at rank granularity (distributed_sort.py:1-43):
each rank sorts its own rows, then S compare-exchange phases run; in even
phases ranks (0, 1), (2, 3), ... pair up, in odd phases (1, 2), (3, 4),
...; a pair swaps its whole blocks (mesh.exchange), both sides sort the
2 * nl rows and the lower rank keeps the lower half. After S phases the
blocks, concatenated in rank order, are sorted. The adaptive mode runs
(even, odd) phase pairs until a global check, one all-reduce that every
rank reads, finds every rank boundary ordered.

A key is a list of int64 words, lexicographic, major first, each read as
an unsigned 64-bit value (nbody_tpu's uint32 words fit as they are; a
Hilbert key's 64-bit pattern is one word). A rank's sort is a chain of
stable sorts from the minor word to the major one, each on the word with
its top bit flipped (permutation.sort_rows_by_key's rule), so that ties
keep their order, as lax.sort keeps it on XLA's CPU.

Every rank takes the same branches: the phases' pairs are fixed by the
ranks' numbers, a rank without a partner in a phase sends nothing and
keeps its block (the has_partner gate, distributed_sort.py:108-112), and
the adaptive loop's trip is decided from the all-reduced flag, never from
one rank's data.
"""

from __future__ import annotations

import torch

from nbody_torch.ops.permutation import INT64_MIN
from nbody_torch.parallel.mesh import Mesh, all_reduce_sum, exchange, shift


def local_sort(keys: torch.Tensor, cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of keys (k, K) int64 (lexicographic, major word first, each
    unsigned) and payload cols (k, F), sorted together, ties in input
    order (_merge_sorted, distributed_sort.py:51-56)."""
    perm = None
    for w in reversed(range(keys.shape[1])):
        word = keys[:, w] if perm is None else keys[perm, w]
        order = torch.sort(word ^ INT64_MIN, stable=True).indices
        perm = order if perm is None else perm[order]
    return keys[perm], cols[perm]


def phase_partner(rank: int, world: int, parity: int) -> int | None:
    """rank's partner in an even (parity 0) or odd (1) phase, or None
    (_phase_perm, distributed_sort.py:59-70)."""
    if parity % 2 == 0:
        partner = rank ^ 1
    else:
        partner = rank + 1 if rank % 2 else rank - 1
    return partner if 0 <= partner < world else None


def _one_phase(mesh: Mesh, keys: torch.Tensor, cols: torch.Tensor, parity: int):
    """One compare-exchange phase on locally sorted blocks (_one_phase,
    :73-115). Both sides sort the lower rank's block first: with ties the
    stable sort resolves by position, so the two must sort one sequence or
    their halves would not partition the union."""
    partner = phase_partner(mesh.rank, mesh.world, parity)
    if partner is None:
        return keys, cols
    k_other, c_other = exchange(mesh, partner, keys, cols)
    low = mesh.rank < partner
    mk, mc = local_sort(torch.cat([keys, k_other] if low else [k_other, keys]),
                        torch.cat([cols, c_other] if low else [c_other, cols]))
    nl = keys.shape[0]
    half = slice(0, nl) if low else slice(nl, 2 * nl)
    return mk[half], mc[half]


def _unsigned_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a <= b, lexicographic over the words of two (K,) rows, each word
    unsigned."""
    ok = torch.zeros((), dtype=torch.bool, device=a.device)
    eq = torch.ones((), dtype=torch.bool, device=a.device)
    for wa, wb in zip(a ^ INT64_MIN, b ^ INT64_MIN):
        ok = ok | (eq & (wa < wb))
        eq = eq & (wa == wb)
    return ok | eq


def globally_sorted(mesh: Mesh, keys: torch.Tensor) -> bool:
    """True on every rank iff the blocks in rank order are sorted: each
    rank's first key is at least its left neighbour's last (rank 0's
    neighbour arrives as zeros, which pass), summed over the ranks
    (_globally_sorted, :118-135)."""
    prev_hi, = shift(mesh, -1, keys[-1])
    ok = _unsigned_le(prev_hi, keys[0]).to(torch.int32)
    return int(all_reduce_sum(mesh, ok)) == mesh.world


def distributed_sort_rows(mesh: Mesh, keys: torch.Tensor, cols: torch.Tensor,
                          adaptive: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort rows by key across the ranks of `mesh` (distributed_sort_rows,
    :138-184): keys (nl, K) int64 words, cols (nl, F), the same nl on every
    rank. Returns (keys, cols) with rank r holding rows [r * nl, (r + 1) *
    nl) of the global order. adaptive: stop once the blocks are sorted,
    after at most (S + 1) // 2 + 1 pairs of phases."""
    keys, cols = local_sort(keys, cols)
    if mesh.world == 1:
        return keys, cols
    if not adaptive:
        for parity in range(mesh.world):
            keys, cols = _one_phase(mesh, keys, cols, parity)
        return keys, cols
    n_pairs = (mesh.world + 1) // 2 + 1
    done = globally_sorted(mesh, keys)
    trips = 0
    while not done and trips < n_pairs:
        for parity in (0, 1):
            keys, cols = _one_phase(mesh, keys, cols, parity)
        done = globally_sorted(mesh, keys)
        trips += 1
    return keys, cols
