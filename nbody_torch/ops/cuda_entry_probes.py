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

As in ops/cuda_group_eval.py: a wrapper checks its inputs, launches on the
current stream, raises on a CUDA error and adds one to `launch_counts`
for the kernel it launched (ladder_name / ring_name); it runs the plain
twin only when its tensors lie on the CPU.
"""

from __future__ import annotations

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


def ladder_name(rung: str, math: bool = True) -> str:
    """The launch_counts key of a rung, e.g. "entry_ladder_kernel<sel>"."""
    return f"entry_ladder_kernel<{rung}{'' if math else ', math0'}>"


def ring_name(nbuf: int, math: bool = True) -> str:
    return f"dma_ring_kernel<{nbuf}{'' if math else ', math0'}>"


# Kernel launches since the last reset, by instantiation; the twins never count.
launch_counts = {**{ladder_name(r): 0 for r in RUNGS}, ladder_name("ideal", False): 0,
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


def entry_ladder_cuda(rung: str, xi: torch.Tensor, src, entries: torch.Tensor, lohis, S: int,
                      eps: float = EPS, tb: int | None = None, per_block: int | None = None,
                      math: bool = True) -> torch.Tensor:
    """One rung of the entry-overhead ladder on E entries: blocks of
    per_block consecutive entries (default ceil(E / 128), one wave of 128
    blocks on the card). The fixed-tile rungs
    (xi (tb, dim)) sum the blocks' (tb, dim) partials in block order;
    switch and noskip (xi (T*tb, dim), entries sorted by tile, tile ids
    below T) write the tile rows, zeros for a tile without entries.
    math=False (ideal only) is the touch-only control."""
    if rung not in RUNGS:
        raise ValueError(f"rung must be one of {tuple(RUNGS)}, got {rung!r}")
    packed, sel, _, switch = RUNGS[rung]
    if not math and rung != "ideal":
        raise ValueError("math=False is the ideal rung's control only")
    tb = xi.shape[0] if tb is None else tb
    _check(xi, tb, entries, lohis, sel)
    if not switch and xi.shape[0] != tb:
        raise ValueError(f"the {rung} rung acts on one tile of {tb} rows, got {xi.shape[0]}")
    if S <= 0 or (per_block is not None and per_block <= 0):
        raise ValueError(f"S {S} and per_block {per_block} must be positive")
    ptrs, nj, sources = _sources(src, packed, xi)
    if _on_cpu(xi, *sources, entries, *((lohis,) if sel else ())):
        return entry_ladder_torch(rung, xi, src, entries, lohis, S, eps, tb, math)
    from nbody_torch._build import load_library

    n = entries.shape[0]
    if n == 0:
        return torch.zeros_like(xi)
    per_block = per_block or -(-n // 128)
    if switch:
        out = torch.zeros_like(xi)
    else:
        out = torch.empty(-(-n // per_block), tb, xi.shape[1], dtype=xi.dtype, device=xi.device)
    name = ladder_name(rung, math)
    err = load_library().nbody_entry_ladder(
        xi.device.index, xi.shape[1], list(RUNGS).index(rung), int(math), xi.data_ptr(), tb,
        xi.shape[0] // tb, *ptrs, nj, entries.data_ptr(), lohis.data_ptr() if sel else 0, n,
        per_block, int(S), float(eps), out.data_ptr(),
        torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return out if switch else out.sum(0)


def dma_ring_cuda(xi: torch.Tensor, xm: torch.Tensor, entries: torch.Tensor, S: int, nbuf: int,
                  eps: float = EPS, math: bool = True) -> torch.Tensor:
    """probe_dma_pipeline.py's manual kernel: blocks of CE consecutive
    entries on the one tile xi (tb, dim), each entry's block of the packed
    sources xm (N, 4) copied through a ring of nbuf (2 or 4) shared-memory
    slots; the blocks' (tb, dim) partials are summed in block order, as
    entry_ladder_cuda("ideal", ..., per_block=CE) sums them."""
    if nbuf not in NBUFS:
        raise ValueError(f"nbuf must be one of {NBUFS}, got {nbuf}")
    _check(xi, xi.shape[0], entries, None, False)
    if S <= 0:
        raise ValueError(f"S must be positive, got {S}")
    (xm_ptr, _, _), nj, _ = _sources(xm, True, xi)
    if _on_cpu(xi, xm, entries):
        return dma_ring_torch(xi, xm, entries, S, eps, math)
    from nbody_torch._build import load_library

    n = entries.shape[0]
    if n == 0:
        return torch.zeros_like(xi)
    out = torch.empty(-(-n // CE), *xi.shape, dtype=xi.dtype, device=xi.device)
    name = ring_name(nbuf, math)
    err = load_library().nbody_dma_ring(
        xi.device.index, xi.shape[1], nbuf, int(math), xi.data_ptr(), xi.shape[0], xm_ptr, nj,
        entries.data_ptr(), n, CE, int(S), float(eps), out.data_ptr(),
        torch.cuda.current_stream(xi.device).cuda_stream)
    _raise_on_error(name, err)
    launch_counts[name] += 1
    return out.sum(0)
