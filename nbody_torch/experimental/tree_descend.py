"""Supertile sparse descent below the octree fast path's cutoff level L*
(the port of nbody_tpu/experimental/tree_descend.py).

The fast path stops its dense mask traversal at L* and evaluates every
cell still open there exactly. With descend_levels > 0 it instead
descends the open set a few levels below L* through per-level lists:

  supertile  descend_G consecutive body tiles share one descent; the list
             holds the union of the members' open nodes, with a G-bit
             member mask per node;
  MAC        per member tile (the caller's mac_fn), so a node is accepted
             for exactly the tiles whose MAC it passes;
  accept     accepted children become that tile's monopoles: compacted per
             level by one row sort of the node ids carrying the member
             bits along, then gathered by the caller's mono_fn, and
             evaluated by group_shared_masked_eval_cuda;
  open       children open for at least one member survive to the next
             level; after the last level the caller turns the survivors
             into exact entries;
  overflow   any cap overflow (open list, monopole list) sends the
             supertile's member tiles to the exact fallback, so no force
             is ever truncated.

Every accepted monopole passes width / dist < theta with the node's true
extent and the member tile's box, the same conservative group MAC as the
dense stage above L*. Plain torch: ids are int64 here (int32 in
nbody_tpu), with the same values.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

BIG32 = 0x7FFFFFFF  # sort key of an empty slot, past every node id


class DescendResult(NamedTuple):
    mono_mass: torch.Tensor    # (Ts, Mtot), 0 = padding
    mono_com: torch.Tensor     # (Ts, Mtot, dim)
    mono_mask: torch.Tensor    # (Tp, Mtot) per-member-tile accept, as the masses' dtype
    final_ids: torch.Tensor    # (Ts, Kf) node ids at the last level
    final_bits: torch.Tensor   # (Ts, Kf) per-member open bits
    final_valid: torch.Tensor  # (Ts, Kf) bool
    overflow: torch.Tensor     # (Tp,) bool per member tile
    diag: dict                 # open_0, mono_r, open_r: per-level counts


def _compact(ids: torch.Tensor, bits: torch.Tensor, cap: int):
    """Keep the columns with bits != 0, packed left in ascending id order
    and cut to `cap` columns (fewer when the row is narrower), the member
    bits carried along: nbody_tpu's lax.sort with the bits as payload. The
    ids of a row are unique, and every empty slot sorts to BIG32 with
    payload 0, so the ties of the sort cannot reorder anything. Returns
    (ids, bits, count of the nonzero columns before the cut)."""
    valid = bits != 0
    key = torch.where(valid, ids, BIG32)
    pay = torch.where(valid, bits, 0)
    sk, order = torch.sort(key, dim=1)
    sp = torch.gather(pay, 1, order)
    return sk[:, :cap], sp[:, :cap], valid.sum(1)


def fold_bits(member: torch.Tensor) -> torch.Tensor:
    """(Ts, G, K) bool -> (Ts, K) int64 with bit g set where member[:, g]."""
    g = torch.arange(member.shape[1], device=member.device)
    return (member.long() << g[None, :, None]).sum(1)


def unfold_bits(bits: torch.Tensor, G: int) -> torch.Tensor:
    """(Ts, K) member bits -> (Ts, G, K) bool."""
    g = torch.arange(G, device=bits.device)
    return ((bits[:, None, :] >> g[None, :, None]) & 1) > 0


def supertile_descend(open0: torch.Tensor, nbranch: int, levels: int, G: int, k0: int,
                      k_caps: Sequence[int], m_caps: Sequence[int], mac_fn: Callable,
                      mono_fn: Callable) -> DescendResult:
    """Run `levels` sparse refinement levels below the cutoff, from the
    per-tile open mask open0 (T, C0) bool at level 0.

    mac_fn(r, ids) returns, for the children ids (Ts, Kc) at relative
    level r (1-based), a dict with
      accept (Ts, G, Kc) bool  the member tile's MAC passes (or the node
                               holds one body); the descent masks it with
                               the member's openness itself
      alive  (Ts, Kc) bool     the node holds bodies
      forced (Ts, Kc) bool     never accept (stays open); optional
    mono_fn(r, ids) returns (mass (Ts, cap), com (Ts, cap, dim)) of the
    accepted nodes ids. Padded slots of ids may hold garbage: the
    callbacks clip them for their gathers, the descent masks the results."""
    T, C0 = open0.shape
    dev = open0.device
    Ts = -(-T // G)
    Tp = Ts * G
    if Tp != T:
        open0 = torch.nn.functional.pad(open0, (0, 0, 0, Tp - T))
    if C0 * nbranch ** levels > (1 << 31):
        raise ValueError("supertile_descend: node ids overflow int32 "
                         f"(C0={C0}, levels={levels}, nbranch={nbranch})")

    bits0 = fold_bits(open0.view(Ts, G, C0))
    ids0 = torch.arange(C0, device=dev).expand(Ts, C0)
    ids, bits, cnt0 = _compact(ids0, bits0, k0)
    overflow_s = cnt0 > k0
    diag = {"open_0": cnt0.sum()}

    mono_mass, mono_com, mono_bits = [], [], []
    jj = torch.arange(nbranch, device=dev)
    for r in range(1, levels + 1):
        valid = ids != BIG32
        pids = torch.where(valid, ids, 0)
        pbits = torch.where(valid, bits, 0)
        ch = (pids[:, :, None] * nbranch + jj).reshape(Ts, -1)
        chbits = pbits.repeat_interleave(nbranch, dim=1)                 # (Ts, Kc)

        st = mac_fn(r, ch)
        accept = st["accept"]
        alive = st["alive"] & valid.repeat_interleave(nbranch, dim=1)
        if st.get("forced") is not None:
            accept = accept & ~st["forced"][:, None, :]
        memb = unfold_bits(chbits, G) & alive[:, None, :]               # member-open
        accbits = fold_bits(memb & accept)
        openbits = fold_bits(memb & ~accept)

        # this level's monopoles
        mids, mbits, mcnt = _compact(ch, accbits, m_caps[r - 1])
        overflow_s = overflow_s | (mcnt > m_caps[r - 1])
        mvalid = mids != BIG32
        mm, mcom = mono_fn(r, torch.where(mvalid, mids, 0))
        mono_mass.append(torch.where(mvalid, mm, torch.zeros((), dtype=mm.dtype, device=dev)))
        mono_com.append(mcom)
        mono_bits.append(torch.where(mvalid, mbits, 0))
        diag[f"mono_{r}"] = mcnt.sum()

        # the open children: the next level's list, or the final survivors
        ids, bits, ocnt = _compact(ch, openbits, k_caps[r - 1])
        overflow_s = overflow_s | (ocnt > k_caps[r - 1])
        diag[f"open_{r}"] = ocnt.sum()

    mass = torch.cat(mono_mass, dim=1)
    mask = unfold_bits(torch.cat(mono_bits, dim=1), G).to(mass.dtype).reshape(Tp, -1)
    fvalid = ids != BIG32
    return DescendResult(mass, torch.cat(mono_com, dim=1), mask, torch.where(fvalid, ids, 0),
                         torch.where(fvalid, bits, 0), fvalid,
                         overflow_s.repeat_interleave(G), diag)
