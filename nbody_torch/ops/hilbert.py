"""Hilbert keys of the BVH sort (the port of nbody_tpu.ops.hilbert).

The reference's Skilling-transform encoding (vec.h:266-356) as
whole-array integer operations over all bodies at once. Two reference
quirks are kept, because the BVH's body order is user-visible
(--print-state, positions.bin):
  * 3-D runs the undo and Gray-code passes with n = 2 active axes
    (vec.h:328), though the bit interleave uses all three;
  * 2-D uses 32 bits per dimension, 3-D 21 (bvh.h:33).

A key is one int64 per body holding the 64-bit key's bit pattern; 2-D
keys fill all 64 bits, so a key with its top bit set reads as negative
(permutation.sort_rows_by_key sorts them as unsigned). Cells are int64
values below 2^32: torch's uint32 has no shifts, and XOR and AND of two
such values stay below 2^32.
"""

from __future__ import annotations

import torch

HILBERT_BITS = {2: 32, 3: 21}
# cells per dimension: 2^bits - 1 (bvh.h:33: 0xffffffff / 0x1fffff)
HILBERT_CELLS = {2: 0xFFFFFFFF, 3: 0x1FFFFF}
U32_MAX = 0xFFFFFFFF


def quantize(x: torch.Tensor, xmin: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Bucket positions (n, dim) onto the Hilbert grid (bvh.h:32-44):
    cell = uint32((x - min) / cell_size), cell_size = lengths / cells, as
    int64. XLA's float -> uint32 convert saturates, and a body at the
    box's far corner can round to 2^32 in float32 (2-D): the cast goes to
    int64 and is clamped to [0, 2^32 - 1] there, which gives the same
    cells."""
    cells = torch.full((), float(HILBERT_CELLS[x.shape[1]]), dtype=x.dtype, device=x.device)
    cell_size = lengths / cells
    v = (x - xmin[None, :]) / cell_size[None, :]
    return v.clamp_min(0).to(torch.int64).clamp_max(U32_MAX)


def skilling_transform(cols: list[torch.Tensor], dim: int,
                       n_active: int = 2) -> list[torch.Tensor]:
    """The transpose-to-Hilbert pass (vec.h:299-356) on quantized cells,
    one int64 tensor per dimension. n_active = 2 is the reference's
    active axes in both dimensions; n_active = dim gives the true 3-D
    curve."""
    bits = HILBERT_BITS[dim]
    x = list(cols)
    top = 1 << (bits - 1)
    q = top
    while q > 1:  # inverse undo
        p = q - 1
        for i in range(n_active):
            cond = (x[i] & q) != 0
            if i == 0:
                x[0] = torch.where(cond, x[0] ^ p, x[0])
            else:
                t = (x[0] ^ x[i]) & p
                x[0], x[i] = (torch.where(cond, x[0] ^ p, x[0] ^ t),
                              torch.where(cond, x[i], x[i] ^ t))
        q >>= 1
    for i in range(1, n_active):  # Gray encode
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = top
    while q > 1:
        t = torch.where((x[n_active - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(n_active):
        x[i] = x[i] ^ t
    return x


def interleave_bits(cols: list[torch.Tensor], dim: int) -> torch.Tensor:
    """Bit interleave (vec.h:267-293) into one int64 key: bit b of
    coordinate c goes to bit b*dim + (dim - 1 - c), so coordinate 0 is
    the most significant of each bit group."""
    key = torch.zeros_like(cols[0])
    for c in range(dim):
        shift = dim - 1 - c
        for b in range(HILBERT_BITS[dim]):
            key |= ((cols[c] >> b) & 1) << (b * dim + shift)
    return key


def hilbert_keys(cell: torch.Tensor, n_active: int = 2) -> torch.Tensor:
    """Hilbert keys of quantized cells (n, dim) int64 -> (n,) int64 (the
    counterpart of hilbert_key_u32pair, with the key hi << 32 | lo)."""
    dim = cell.shape[1]
    return interleave_bits(skilling_transform([cell[:, d] for d in range(dim)], dim, n_active),
                           dim)
