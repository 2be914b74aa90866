"""A frozen plain Barnes-Hut walk that counts the work a step needs.

The octree is stdpar-nbody's (octree.h): a cube around every body (side
max - min + 2 over all coordinates, centred on the midpoint, octree.h:93-112)
split until each leaf holds one body, here down to at most MAX_DEPTH levels.
The walk is its MAC (octree.h:226-255): a leaf is one interaction with its
body; another cell is one interaction when side / distance(body, cell's
centre of mass) < theta, and is opened otherwise; a cell at MAX_DEPTH that
still holds several bodies gives one direct pair per body. A body never
interacts with itself. The count is of the bodies' inputs alone, so every
implementation of the step, and every commit of the program, gets the same
count for the same bodies. Plain numpy; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

MAX_DEPTH = {2: 31, 3: 21}   # levels: 62 / 63 key bits


def morton_keys(x: np.ndarray, depth: int) -> tuple[np.ndarray, float]:
    """Interleaved cell keys at `depth` levels, and the root cube's side."""
    lo, hi = float(x.min()), float(x.max())
    side = hi - lo + 2.0
    q = np.floor((x - (lo - 1.0)) / side * float(1 << depth))
    q = np.clip(q, 0, (1 << depth) - 1).astype(np.uint64)
    dim = x.shape[1]
    keys = np.zeros(x.shape[0], dtype=np.uint64)
    for b in range(depth):
        for c in range(dim):
            keys |= ((q[:, c] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * dim + c)
    return keys, side


class Levels:
    """The cells of each level over the key-sorted bodies: first body,
    count, mass and centre of mass, built on first use."""

    def __init__(self, m: np.ndarray, x: np.ndarray, keys: np.ndarray, depth: int):
        self.m, self.x, self.keys, self.depth = m, x, keys, depth
        self.dim = x.shape[1]
        self._cells: dict[int, tuple] = {}

    def cells(self, level: int):
        if level not in self._cells:
            k = self.keys >> np.uint64(self.dim * (self.depth - level))
            start = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
            count = np.diff(np.r_[start, k.shape[0]])
            mass = np.add.reduceat(self.m, start)
            moment = np.add.reduceat(self.m[:, None] * self.x, start, axis=0)
            centre = np.add.reduceat(self.x, start, axis=0) / count[:, None]
            com = np.where(mass[:, None] > 0, moment / np.where(mass > 0, mass, 1.0)[:, None],
                           centre)
            self._cells[level] = (start, count, com)
        return self._cells[level]


def count_interactions(m: np.ndarray, x: np.ndarray, theta: float, sample: np.ndarray) -> dict:
    """The interactions of the bodies `sample` (indices into m, x): accepted
    cells (a one-body leaf counts as a direct pair) and direct pairs, summed
    over the sample, and the mean per body."""
    m = np.asarray(m, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    depth = MAX_DEPTH[x.shape[1]]
    keys, side = morton_keys(x, depth)
    order = np.argsort(keys, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    levels = Levels(m[order], x[order], keys[order], depth)
    body = rank[np.asarray(sample)]          # the sample's sorted positions
    xb = levels.x[body]
    who = np.arange(body.shape[0])           # frontier: (sample body, cell)
    cell = np.zeros(body.shape[0], dtype=np.int64)
    accepted = direct = 0
    for level in range(depth + 1):
        if who.size == 0:
            break
        start, count, com = levels.cells(level)
        s, c = start[cell], count[cell]
        inside = (body[who] >= s) & (body[who] < s + c)
        leaf = c == 1
        direct += int(np.count_nonzero(leaf & ~inside))
        dist = np.sqrt(np.sum((xb[who] - com[cell]) ** 2, axis=1))
        cell_side = side / float(1 << level)
        accept = ~leaf & (cell_side < theta * dist)
        accepted += int(np.count_nonzero(accept))
        rest = ~leaf & ~accept
        if level == depth:
            direct += int(np.sum(c[rest] - inside[rest]))
            break
        who, s, c = who[rest], s[rest], c[rest]
        nstart = levels.cells(level + 1)[0]
        first = np.searchsorted(nstart, s)
        last = np.searchsorted(nstart, s + c)
        kids = last - first
        who = np.repeat(who, kids)
        cell = np.repeat(first - np.cumsum(kids) + kids, kids) + np.arange(int(kids.sum()))
    per_body = (accepted + direct) / max(1, len(sample))
    return {"accepted": accepted, "direct": direct, "sampled": int(len(sample)),
            "per_body": per_body}


def interactions_per_step(m: np.ndarray, x: np.ndarray, theta: float, sample_size: int,
                          seed: int) -> dict:
    """count_interactions over a sample of `sample_size` bodies drawn from
    `seed` (all bodies if there are fewer), scaled to every body."""
    n = m.shape[0]
    rng = np.random.default_rng([seed, 0x57A1C])
    sample = np.arange(n) if sample_size >= n else np.sort(rng.choice(n, sample_size,
                                                                      replace=False))
    out = count_interactions(m, x, theta, sample)
    out["interactions"] = out["per_body"] * n
    return out
