"""Build and load the hand-written CUDA kernels (nbody_torch/csrc/*.cu).

nvcc compiles each source into an object, all of them at once in parallel
processes, and links the objects into one shared library with a plain C
interface, which ctypes loads; nothing includes PyTorch's headers, so a
build takes seconds. The library goes to .build/nbody_torch/ at the root
of the checkout, under a name that carries a hash of the sources, the
headers they include (csrc/*.cuh) and the flags, so an edited source or
header is rebuilt and an unchanged one is not. The build happens at first
use (each kernel wrapper calls load_library before its first launch),
never at import.

Flags: sm_90a code for Hopper, and no --use_fast_math: nvcc's defaults
keep IEEE division and square root (-prec-div, -prec-sqrt) and denormals
wherever a source writes / or sqrt, as the IEEE instantiations (exact=True)
and group_eval.cu's two ablation kernels do. The all-pairs kernels' default
chain and every other gravity kernel (group_eval.cu's, entry_probes.cu's)
take their approximations explicitly (rsqrt.approx, rcp.approx and their
refinement, csrc/pair.cuh), so a flag changes neither form.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build" / "nbody_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnbody_torch_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the PATH, or /usr/local/cuda; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the PATH); "
                       "it is needed to build nbody_torch/csrc")


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel processes; raise if any fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
          for src, obj in zip(sources(), objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


i, p, f64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
# The C interface of csrc/allpairs.cu, csrc/allpairs_mxu.cu, csrc/group_eval.cu,
# csrc/entry_probes.cu, csrc/tile_decide.cu and csrc/tree_walk.cu: each function's argument types (a pointer must
# be c_void_p: ctypes passes an undeclared one as a 32-bit int); each
# returns an int, its cudaError_t.
SIGNATURES = (
    # (device, dtype, dim, kind, sqrt3, exact, xi, ni, mj, xj, nj, blocks, splits,
    #  split_len, eps, scale, mi, out, stream)
    ("nbody_allpairs_rows", [i, i, i, i, i, i, p, i, p, p, i, i, i, i, f64, f64, p, p, p]),
    # (device, dtype, parts, splits, count, width, scale, mi, out, stream)
    ("nbody_split_sum", [i, i, p, i, i, i, f64, p, p, p]),
    # (device, dim, x, m, n, blocks, splits, split_len, table, tile_i, tile_j, ntj, eps,
    #  scale, out, stream)
    ("nbody_allpairs_fast", [i, i, p, p, i, i, i, i, p, i, i, i, f64, f64, p, p]),
    # (device, dim, fast, x, m, n, npad, tile_i, tile_j, table, stats, eps, scale, out,
    #  stream)
    ("nbody_allpairs_mxu", [i, i, i, p, p, i, i, i, i, p, p, f64, f64, p, p]),
    # (device, dim, x, n, npad, tile_i, tile_j, inv_i, inv_j, means, stats, stream)
    ("nbody_tile_stats", [i, i, p, i, i, i, i, f64, f64, i, p, p]),
    # (device, dim, mode, x, n, npad, tile_i, tile_j, stats, near_coef, thresh, table,
    #  work, stream)
    ("nbody_tile_decide", [i, i, i, p, i, i, i, i, p, f64, f64, p, p, p]),
    # (device, dim, xi, ntiles, tb, ...) as in ops/cuda_group_eval._launch
    # the far field: (..., mj, xj, W, words, nw, tile_group, sqrt3, eps, out, stream)
    ("nbody_masked_eval_bits", [i, i, p, i, i, p, p, i, p, i, i, i, f64, p, p]),
    # the interval window: (..., w0, lo, hi, window_tiles, full, sqrt3, eps, P, nparts,
    #  parts, stream)
    ("nbody_window_eval_interval", [i, i, p, i, i, p, p, i, p, p, p, i, i, i, f64, i, p, p, p]),
    # the node-mask window: (..., w0, in_win, wnodes, S, full, sqrt3, eps, P, nparts, parts,
    #  stream)
    ("nbody_window_eval_nodemask", [i, i, p, i, i, p, p, i, p, p, i, i, i, i, f64, i, p, p, p]),
    # the dense-mask window: (..., w0, mask, wb, sqrt3, eps, P, nparts, parts, stream)
    ("nbody_window_eval_dense", [i, i, p, i, i, p, p, i, p, p, i, i, f64, i, p, p, p]),
    # the entries kernels: (device, dim, xi, ntiles, tb, mj, xj, xm, sqrt3, eps, cum,
    #  start, tile, e0, e1, u0, u1, keep_lo, keep_hi, blocks, parts, stream)
    ("nbody_entries_eval", [i, i, p, i, i, p, p, p, i, f64, p, p, p, p, p, p, p, p, p, i, p, p]),
    # (device, dim, parts, part_start, ntiles, tb, out, stream)
    ("nbody_entries_sum", [i, i, p, p, i, i, p, p]),
    ("nbody_masked_eval", [i, i, p, i, i, p, p, i, p, i, f64, p, p]),
    ("nbody_group_shared_masked_eval", [i, i, p, i, i, p, p, i, i, p, i, f64, p, p]),
    # (device, dtype, dim, xi, ntiles, tb, mj, xj, L, split, n0, n1, sqrt3, eps, P, nparts,
    #  parts, stream)
    ("nbody_group_eval", [i, i, i, p, i, i, p, p, i, i, p, p, i, f64, i, p, p, p]),
    # (device, dtype, dim, parts, nparts, P, ntiles, tb, out, stream)
    ("nbody_parts_sum", [i, i, i, p, p, i, i, i, p, p]),
    # (device, dim, rung, math, min_blocks, xi, tb, ntiles, xm, mj, xj, nj, entries, lohis,
    #  E, per_block, P, S, eps, parts, stream)
    ("nbody_entry_ladder", [i, i, i, i, i, p, i, i, p, p, p, i, p, p, i, i, i, i, f64, p, p]),
    # (device, dim, nbuf, math, xi, tb, xm, nj, entries, E, ce, P, S, eps, parts, stream)
    ("nbody_dma_ring", [i, i, i, i, p, i, p, i, p, i, i, i, i, f64, p, p]),
    # (device, dim, kernel, variant, math, min_blocks, S, out (5,) int32)
    ("nbody_entry_probe_budget", [i, i, i, i, i, i, i, p]),
    # csrc/tree_walk.cu: (device, dtype, dim, nodes, mm, nlevels, bodies, n, rows, nrows,
    #  theta2, eps, G, out, stream)
    ("nbody_bvh_walk", [i, i, i, p, p, i, p, i, p, i, f64, f64, f64, p, p]),
    # (device, dtype, dim, mass, com, start, count, child_start, child_count, parent,
    #  offsets (host), depth, total, ms, xs, n, nodes, fnodes, bodies, stream)
    ("nbody_octree_pack", [i, i, i, p, p, p, p, p, p, p, p, i, i, p, p, i, p, p, p, p]),
    # (device, dtype, dim, nodes, fnodes, offsets (host), depth, total, bodies, n,
    #  root_side, rows, nrows, theta, eps, G, out, stream)
    ("nbody_octree_walk", [i, i, i, p, p, p, i, i, p, i, p, p, i, f64, f64, f64, p, p]),
)
del i, p, f64


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C interface
    (SIGNATURES)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.nbody_error_string.argtypes = [ctypes.c_int]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib
