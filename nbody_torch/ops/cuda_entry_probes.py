"""Wrappers of the entry-cost probes' CUDA kernels (csrc/entry_probes.cu,
see its header for the design) and their plain twins.

  entry_ladder_kernel<rung>  replaces the rung kernels of
                             scripts/probe_entry_overhead.py (run_ideal
                             :188, run_sepmj :197, run_masked :210 with
                             kern_sel / kern_when, run_switch :225); its
                             `ideal` rung on a grid of CE entries per block
                             is also probe_dma_pipeline.py's BlockSpec kernel
                             (run_a :122)
  dma_ring_kernel<nbuf>      replaces probe_dma_pipeline.py's manual NBUF-deep
                             copy ring (run_b :177)

Each entry (tile << 16 | blk) adds the pairs of a row tile of tb <= 512
rows with the S sources blk*S + [0, S), sqrt3 softening (the octree's);
the masked rungs weight source k by 1 inside [lo, hi) (lohi = lo | hi <<
16), else 0. The fixed-tile rungs (ideal, sepmj, sel, when) and the ring
act on one tile, xi (tb, dim), and return its (tb, dim) sums; switch and
noskip act on T tiles, xi (T*tb, dim), and pick each entry's tile from
its id. The sources come packed, as pack_sources(mj, xj) (N, 4), for the
packed rungs (ideal, sel, when, switch) and the ring, and split, a pair
(mj, xj), for sepmj and noskip. math=False is probe_dma_pipeline.py's
control (PROBE_MATH=0): every row gets sum_k block[k, d] per entry
(ideal and the ring only).

On the card both kernels take blocks of per_block (the ring: CE)
consecutive entries, split each into P parts in the kernel (default_parts:
at least RESIDENT parts an SM; ladder_parts mirrors the split), write each
part's partial rows to a slice of a scratch, and parts_sum_kernel
(cuda_group_eval.parts_sum_cuda) adds the slices in part order (on one
tile, each block's parts and then the blocks: two launches). The rungs
are built at launch bounds of LADDER_BLOCKS (5) blocks an SM, at most 48
registers, the entries kernel's; the ring at RING_BLOCKS (4), at most 64,
and so is the ideal rung that dma-pipeline's blockspec runs (min_blocks=
RING_BLOCKS), so that blockspec and the ring differ only in how the
sources arrive. kernel_budget reads a kernel's registers and resident
blocks an SM from the CUDA runtime.

As in ops/cuda_group_eval.py: a wrapper checks its inputs, launches on the
current stream, raises on a CUDA error and adds one to `launch_counts`
for the kernel it launched (ladder_name / ring_name; the second pass
counts under parts_sum_kernel there); it runs the plain twin only when its
tensors lie on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_torch.ops.cuda_allpairs import _on_cpu, _raise_on_error
from nbody_torch.ops.cuda_group_eval import _entries_torch

# rung -> (packed sources, lo/hi lane mask, skip unless hi > lo, tile switching);
# the order is the C interface's rung code
RUNGS = {"ideal": (True, False, False, False), "sepmj": (False, False, False, False),
         "sel": (True, True, False, False), "when": (True, True, True, False),
         "switch": (True, True, False, True), "noskip": (False, True, False, True)}
NBUFS = (2, 4)
CE = 64  # entries per block of the DMA kernels (probe_dma_pipeline.py:40)
EPS = 1e-3  # the probes' softening (probe_entry_overhead.py:102)


LADDER_BLOCKS = 5  # the rungs' launch bounds: 5 blocks an SM, at most 48 registers
RING_BLOCKS = 4  # the ring's: at most 64 registers; also the ideal rung's for blockspec


def ladder_name(rung: str, math: bool = True, min_blocks: int = LADDER_BLOCKS) -> str:
    """The launch_counts key of a rung, e.g. "entry_ladder_kernel<sel>", or
    "entry_ladder_kernel<ideal, math0, min_blocks 4>" for the ideal rung
    built at the ring's launch bounds."""
    return (f"entry_ladder_kernel<{rung}{'' if math else ', math0'}"
            f"{'' if min_blocks == LADDER_BLOCKS else f', min_blocks {min_blocks}'}>")


def ring_name(nbuf: int, math: bool = True) -> str:
    return f"dma_ring_kernel<{nbuf}{'' if math else ', math0'}>"


# Kernel launches since the last reset, by instantiation; the twins never count.
launch_counts = {**{ladder_name(r): 0 for r in RUNGS}, ladder_name("ideal", False): 0,
                 **{ladder_name("ideal", m, RING_BLOCKS): 0 for m in (True, False)},
                 **{ring_name(b, m): 0 for b in NBUFS for m in (True, False)}}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _split(src, packed: bool, dim: int):
    """(mj, xj) of the sources as the rung reads them."""
    if packed:
        if not (isinstance(src, torch.Tensor) and src.ndim == 2 and src.shape[1] == 4):
            raise ValueError("packed sources are an (N, 4) tensor from pack_sources")
        return src[:, 3], src[:, :dim]
    if not (isinstance(src, tuple) and len(src) == 2):
        raise ValueError("split sources are a pair (mj, xj)")
    return src


def _ladder_ranges(rung: str, entries: torch.Tensor, lohis, S: int):
    """Each entry's tile (0 for the fixed-tile rungs) and its sources
    [start, stop): the whole block, or for the masked rungs its lanes
    [lo, min(hi, S))."""
    _, sel, _, switch = RUNGS[rung]
    ent = entries.long()
    base = (ent & 0xFFFF) * S
    tid = ent >> 16 if switch else torch.zeros_like(ent)
    if not sel:
        return tid, base, base + S
    lohi = lohis.long()
    return tid, base + (lohi & 0xFFFF), base + torch.clamp(lohi >> 16, max=S)


def _touch_torch(xi: torch.Tensor, xm: torch.Tensor, entries: torch.Tensor, S: int,
                 absolute: bool) -> torch.Tensor:
    """The math=False control: every row of the tile gets, per entry, the
    block's sum of each coordinate, in float64 and rounded once."""
    dim = xi.shape[1]
    cols = (entries.long() & 0xFFFF)[:, None] * S + torch.arange(S, device=xi.device)
    keep = cols < xm.shape[0]
    x = xm[cols.clamp_max(xm.shape[0] - 1), :dim].double() * keep[..., None]
    total = (x.abs() if absolute else x).sum(dim=(0, 1))
    return total.to(xi.dtype).expand(xi.shape[0], dim).clone()


def entry_ladder_torch(rung: str, xi: torch.Tensor, src, entries: torch.Tensor, lohis, S: int,
                       eps: float = EPS, tb: int | None = None, math: bool = True,
                       absolute: bool = False) -> torch.Tensor:
    """The plain twin of entry_ladder_kernel<rung> (and of the ring, whose
    function is the ideal rung's). Raises on a switch / noskip list that
    is not sorted by tile, the precondition of the kernel's writes."""
    packed, sel, _, switch = RUNGS[rung]
    tb = xi.shape[0] if tb is None else tb
    if not math:
        return _touch_torch(xi, src, entries, S, absolute)
    mj, xj = _split(src, packed, xi.shape[1])
    tid, start, stop = _ladder_ranges(rung, entries, lohis, S)
    if switch and tid.numel() > 1 and bool((tid[1:] < tid[:-1]).any()):
        raise ValueError("entries must be sorted by tile")
    return _entries_torch(xi, mj, xj, tid, start, stop, xi.shape[0] // tb, eps, "sqrt3", absolute)


def dma_ring_torch(xi: torch.Tensor, xm: torch.Tensor, entries: torch.Tensor, S: int,
                   eps: float = EPS, math: bool = True, absolute: bool = False) -> torch.Tensor:
    """The plain twin of dma_ring_kernel: the ideal rung's function."""
    return entry_ladder_torch("ideal", xi, xm, entries, None, S, eps, math=math, absolute=absolute)


def _check(xi: torch.Tensor, tb: int, entries: torch.Tensor, lohis, sel: bool) -> None:
    if xi.ndim != 2 or xi.shape[1] not in (2, 3) or xi.dtype != torch.float32:
        raise ValueError(f"rows must be float32 (n, 2) or (n, 3), got {xi.dtype} "
                         f"{tuple(xi.shape)}")
    if not 0 < tb <= 512 or xi.shape[0] % tb:
        raise ValueError(f"{xi.shape[0]} rows are not tiles of 1 to 512 rows (tb {tb})")
    if entries.ndim != 1 or entries.dtype != torch.int32:
        raise ValueError(f"entries must be 1-D int32, got {entries.dtype} {tuple(entries.shape)}")
    if sel and (lohis is None or lohis.shape != entries.shape or lohis.dtype != torch.int32):
        raise ValueError("the masked rungs take int32 lohis shaped like the entries")
    if not all(t.is_contiguous() for t in (xi, entries, *((lohis,) if sel else ()))):
        raise ValueError("the kernels take contiguous tensors")


def _sources(src, packed: bool, xi: torch.Tensor):
    """The (xm, mj, xj) pointers (0 where the rung reads none), nj, and the
    source tensors, checked."""
    mj, xj = _split(src, packed, xi.shape[1])
    if packed:
        if src.dtype != torch.float32 or not src.is_contiguous():
            raise ValueError("packed sources must be contiguous float32")
        return (src.data_ptr(), 0, 0), src.shape[0], (src,)
    if (mj.dtype != torch.float32 or xj.dtype != torch.float32 or mj.ndim != 1
            or xj.shape != (mj.shape[0], xi.shape[1])
            or not (mj.is_contiguous() and xj.is_contiguous())):
        raise ValueError(f"split sources must be contiguous float32 (N,), (N, {xi.shape[1]})")
    return (0, mj.data_ptr(), xj.data_ptr()), mj.shape[0], (mj, xj)


def ladder_parts(E: int, per_block: int, P: int, tiles=None,
                 ntiles: int | None = None) -> list[list[tuple[int, int, int]]]:
    """Python mirror of the kernels' grid (csrc/entry_probes.cu): CUDA
    block q = b * P + p -> the pieces (tile, first entry, stop) it sums,
    in order. Block b holds the entries [b * per_block, (b + 1) *
    per_block) of E. With tiles None (the fixed-tile rungs and the ring),
    part p of a block of n entries takes [n * p / np, n * (p + 1) / np),
    np = min(n, P), as one piece of tile 0 (none for p >= np). With
    `tiles`, the sorted tile id of each entry (switch and noskip), part p
    takes the p-th share, cut the same way, of every run of one tile inside
    its block, up to the first run whose tile is ntiles or more."""
    if E < 0 or per_block <= 0 or P <= 0:
        raise ValueError(f"E {E}, per_block {per_block} and P {P}: E >= 0, the others positive")
    tiles = None if tiles is None else [int(t) for t in tiles]
    out = []
    for b in range(-(-E // per_block)):
        e0, e1 = b * per_block, min(E, (b + 1) * per_block)
        runs = [(0, e0, e1)]
        if tiles is not None:
            cuts = [e0] + [e for e in range(e0 + 1, e1) if tiles[e] != tiles[e - 1]] + [e1]
            runs = [(tiles[a], a, c) for a, c in zip(cuts, cuts[1:])]
            live = [r[0] < ntiles for r in runs] + [False]
            runs = runs[:live.index(False)]
        for p in range(P):
            pieces = []
            for tile, a, c in runs:
                np_ = min(c - a, P)
                if p < np_:
                    pieces.append((tile, a + (c - a) * p // np_, a + (c - a) * (p + 1) // np_))
            out.append(pieces)
    return out


RESIDENT = 4  # the grid's least blocks an SM at the default P (5 fit at 48 registers)


def default_parts(E: int, per_block: int, sm_count: int) -> int:
    """P of a call: the least power of two that gives the grid of
    ceil(E / per_block) blocks RESIDENT * sm_count parts or more, at most
    per_block (a part past a block's entries has nothing to do). At E =
    8,192 in blocks of 64 on 132 SMs: 8, 1,024 parts."""
    blocks = max(1, -(-E // per_block))
    P = 1
    while blocks * P < RESIDENT * sm_count and P < per_block:
        P *= 2
    return max(1, min(P, per_block))


SHARED_PER_BLOCK = 232_448  # bytes of shared memory a block may take on an H100 (227 KB)
RING_OWN_SHARED = 4096  # at most this many of them the ring kernel takes beside its slots


def ring_shared_bytes(nbuf: int, S: int) -> int:
    """The ring's dynamic shared memory: nbuf slots of S 16-byte rows."""
    return nbuf * S * 16


def _parts_of(xi: torch.Tensor, n: int, per_block: int, parts: int | None) -> int:
    """P of a launch: `parts`, or default_parts on xi's card. The kernels
    split in 32-bit arithmetic: per_block * P must stay below 2^31."""
    if parts is None:
        from nbody_torch.ops.cuda_allpairs import sm_count_of

        parts = default_parts(n, per_block, sm_count_of(xi.device.index))
    if per_block * parts >= 2**31:
        raise ValueError(f"per_block {per_block} times parts {parts} must stay below 2^31")
    return parts


def _sum_parts(scratch: torch.Tensor, nparts: int, ntiles: int) -> torch.Tensor:
    """parts_sum_kernel over scratch (ntiles * nparts, tb, dim): each tile's
    slices added in part order."""
    from nbody_torch.ops.cuda_group_eval import parts_sum_cuda

    counts = torch.full((ntiles,), nparts, dtype=torch.int32, device=scratch.device)
    return parts_sum_cuda(scratch, counts, nparts)


def _sum_blocks(scratch: torch.Tensor, P: int) -> torch.Tensor:
    """A fixed-tile call's rows from its (blocks * P, tb, dim) slices: each
    block's P parts added in part order, then the blocks in block order
    (two parts_sum_kernel launches: one chain of blocks * P adds would
    leave each thread ~1,000 dependent loads)."""
    tb, dim = scratch.shape[1:]
    blocks = _sum_parts(scratch, P, scratch.shape[0] // P)
    return _sum_parts(blocks.view(-1, tb, dim), blocks.shape[0] // tb, 1)


def entry_ladder_cuda(rung: str, xi: torch.Tensor, src, entries: torch.Tensor, lohis, S: int,
                      eps: float = EPS, tb: int | None = None, per_block: int | None = None,
                      math: bool = True, parts: int | None = None,
                      min_blocks: int = LADDER_BLOCKS) -> torch.Tensor:
    """One rung of the entry-overhead ladder on E entries: blocks of
    per_block consecutive entries (default ceil(E / 128)), each split into
    `parts` parts in the kernel (default_parts by default; ladder_parts
    mirrors the split), whose partial rows parts_sum_kernel adds in part
    order (a fixed-tile call's per block, then over the blocks, _sum_blocks).
    The fixed-tile rungs (xi (tb, dim)) return the tile's sums; switch and
    noskip (xi (T*tb, dim), entries sorted by tile, tile ids below T) the
    tile rows, zeros for a tile without entries. math=False (ideal only)
    is the touch-only control. min_blocks picks the kernel's launch
    bounds: LADDER_BLOCKS, or for the ideal rung RING_BLOCKS, the ring's
    (dma-pipeline's blockspec, so that it and the ring run at one register
    budget)."""
    if rung not in RUNGS:
        raise ValueError(f"rung must be one of {tuple(RUNGS)}, got {rung!r}")
    packed, sel, _, switch = RUNGS[rung]
    if not math and rung != "ideal":
        raise ValueError("math=False is the ideal rung's control only")
    if min_blocks != LADDER_BLOCKS and (rung, min_blocks) != ("ideal", RING_BLOCKS):
        raise ValueError(f"min_blocks {min_blocks}: the rungs are built at {LADDER_BLOCKS}, "
                         f"the ideal rung also at {RING_BLOCKS}")
    tb = xi.shape[0] if tb is None else tb
    _check(xi, tb, entries, lohis, sel)
    if not switch and xi.shape[0] != tb:
        raise ValueError(f"the {rung} rung acts on one tile of {tb} rows, got {xi.shape[0]}")
    if S <= 0 or (per_block is not None and per_block <= 0) or (parts is not None and parts <= 0):
        raise ValueError(f"S {S}, per_block {per_block} and parts {parts} must be positive")
    ptrs, nj, sources = _sources(src, packed, xi)
    if _on_cpu(xi, *sources, entries, *((lohis,) if sel else ())):
        return entry_ladder_torch(rung, xi, src, entries, lohis, S, eps, tb, math)
    from nbody_torch._build import load_library

    n = entries.shape[0]
    if n == 0:
        return torch.zeros_like(xi)
    per_block = per_block or -(-n // 128)
    P = _parts_of(xi, n, per_block, parts)
    ntiles = xi.shape[0] // tb
    if switch:
        scratch = torch.zeros(ntiles * P, tb, xi.shape[1], dtype=xi.dtype, device=xi.device)
    else:
        scratch = torch.empty(-(-n // per_block) * P, tb, xi.shape[1], dtype=xi.dtype,
                              device=xi.device)
    name = ladder_name(rung, math, min_blocks)
    err = load_library().nbody_entry_ladder(
        xi.device.index, xi.shape[1], list(RUNGS).index(rung), int(math), min_blocks,
        xi.data_ptr(), tb,
        ntiles, *ptrs, nj, entries.data_ptr(), lohis.data_ptr() if sel else 0, n, per_block, P,
        int(S), float(eps), scratch.data_ptr(), torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return _sum_parts(scratch, P, ntiles) if switch else _sum_blocks(scratch, P)


def dma_ring_cuda(xi: torch.Tensor, xm: torch.Tensor, entries: torch.Tensor, S: int, nbuf: int,
                  eps: float = EPS, math: bool = True, parts: int | None = None) -> torch.Tensor:
    """probe_dma_pipeline.py's manual kernel: blocks of CE consecutive
    entries on the one tile xi (tb, dim), each split into `parts` parts
    (default_parts by default) as entry_ladder_cuda("ideal", ...,
    per_block=CE) splits them; each part's entries come through a ring of
    nbuf (2 or 4) shared-memory slots of S rows of the packed sources xm
    (N, 4), filled by bulk copies. The parts' partial rows are added in
    order, so the result equals the ideal rung's on the same grid bit for
    bit. Raises ValueError for a ring of more shared memory than a block
    may have."""
    if nbuf not in NBUFS:
        raise ValueError(f"nbuf must be one of {NBUFS}, got {nbuf}")
    _check(xi, xi.shape[0], entries, None, False)
    if S <= 0 or (parts is not None and parts <= 0):
        raise ValueError(f"S {S} and parts {parts} must be positive")
    if ring_shared_bytes(nbuf, S) + RING_OWN_SHARED > SHARED_PER_BLOCK:
        raise ValueError(f"a ring of {nbuf} slots of S = {S} rows takes "
                         f"{ring_shared_bytes(nbuf, S)} bytes of shared memory; a block may take "
                         f"{SHARED_PER_BLOCK - RING_OWN_SHARED} beside the kernel's own")
    (xm_ptr, _, _), nj, _ = _sources(xm, True, xi)
    if _on_cpu(xi, xm, entries):
        return dma_ring_torch(xi, xm, entries, S, eps, math)
    from nbody_torch._build import load_library

    n = entries.shape[0]
    if n == 0:
        return torch.zeros_like(xi)
    if xm.data_ptr() % 16:
        raise ValueError("the ring's bulk copies take 16-byte aligned sources")
    P = _parts_of(xi, n, CE, parts)
    scratch = torch.empty(-(-n // CE) * P, *xi.shape, dtype=xi.dtype, device=xi.device)
    name = ring_name(nbuf, math)
    err = load_library().nbody_dma_ring(
        xi.device.index, xi.shape[1], nbuf, int(math), xi.data_ptr(), xi.shape[0], xm_ptr, nj,
        entries.data_ptr(), n, CE, P, int(S), float(eps), scratch.data_ptr(),
        torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return _sum_blocks(scratch, P)


def kernel_budget(kernel: str, variant, math: bool, dim: int, S: int, device: torch.device,
                  min_blocks: int = LADDER_BLOCKS) -> dict | None:
    """What the CUDA runtime reports of a probe kernel on `device`: registers a
    thread, spill (local) bytes a thread, static and dynamic shared bytes,
    and resident blocks of 256 threads an SM (cudaOccupancyMaxActiveBlocks
    PerMultiprocessor). kernel "ladder" takes a rung and min_blocks as
    entry_ladder_cuda does, "ring" an nbuf and S. None on the CPU."""
    if kernel not in ("ladder", "ring"):
        raise ValueError(f"kernel must be 'ladder' or 'ring', got {kernel!r}")
    if device.type != "cuda":
        return None
    from nbody_torch._build import load_library

    code = list(RUNGS).index(variant) if kernel == "ladder" else int(variant)
    out = (ctypes.c_int * 5)()
    err = load_library().nbody_entry_probe_budget(
        device.index or 0, dim, int(kernel == "ring"), code, int(math), min_blocks, int(S),
        ctypes.addressof(out))
    _raise_on_error(f"nbody_entry_probe_budget({kernel}, {variant})", err)
    return dict(zip(("registers", "spill_bytes", "static_shared", "dynamic_shared",
                     "blocks_an_sm"), out))
