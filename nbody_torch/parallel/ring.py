"""Ring all-pairs over the ranks (the port of nbody_tpu.parallel.ring).

Each rank keeps its block of nl = npad / world bodies as its i-rows and
adds the force of a (m_j, x_j) block that travels round the ring: its own
first, then rank - 1's, rank - 2's, ..., one ring_shift between two
rotations (ring.py:35-54, lax.ppermute s -> s + 1). Each rotation adds
allpairs_block_cuda(x_i, m_j, x_j, eps), row 2's kernel, in either
precision (ring.py:72-83 takes allpairs_block_pallas), or its plain twin
with --kernel torch; G multiplies the sum once after the last rotation. A
body count the world does not divide is padded with massless bodies at the
origin (ring.py:133-143). The rows are then gathered, so that every rank
holds all n accelerations, as the replicated state needs.

The blocks add in ring order rather than j order, so the sums equal the
single-device engine's up to the order of summation. nbody_tpu rotates
once more after the last block, which brings each block home; the port
leaves that rotation out, and nothing changes.
"""

from __future__ import annotations

from typing import Callable

import torch

from nbody_torch.config import SimConfig
from nbody_torch.ops.cuda_allpairs import allpairs_block_cuda, allpairs_block_torch
from nbody_torch.parallel.mesh import Mesh, all_gather_rows, ring_shift


def make_ring_allpairs(cfg: SimConfig, mesh: Mesh, use_cuda: bool = True) -> Callable:
    """accel(m, x) over the whole (replicated) bodies by the ring on this
    rank's group (make_ring_allpairs, ring.py:57-143): every rank calls it
    with the same m (n,), x (n, dim) and gets all n rows of G * accel."""
    block = allpairs_block_cuda if use_cuda else allpairs_block_torch
    G, eps = cfg.G, cfg.eps

    def accel(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        npad = -(-n // mesh.world) * mesh.world
        mp = torch.nn.functional.pad(m, (0, npad - n))
        xp = torch.nn.functional.pad(x, (0, 0, 0, npad - n))
        r0, nl = mesh.rows(npad)
        x_loc = xp[r0:r0 + nl]
        mj, xj = mp[r0:r0 + nl], x_loc
        acc = torch.zeros_like(x_loc)
        for rotation in range(mesh.world):
            acc = acc + block(x_loc, mj, xj, eps)
            if rotation < mesh.world - 1:
                mj, xj = ring_shift(mesh, mj, xj)
        return all_gather_rows(mesh, G * acc)[:n]

    return accel
