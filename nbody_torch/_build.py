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

Flags: sm_90a code for Hopper, and no --use_fast_math -- nvcc's defaults
keep IEEE division and square root (-prec-div, -prec-sqrt) and denormals,
which the close-pair softening terms need.
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


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C interface
    of csrc/allpairs.cu and csrc/group_eval.cu (a pointer must be
    c_void_p: ctypes passes an undeclared one as a 32-bit int)."""
    lib = ctypes.CDLL(str(build()))
    i, p, f64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    for name, args in (
        ("nbody_allpairs_block", [i, i, i, i, p, i, p, p, i, f64, f64, p, p]),
        ("nbody_potential_rowsums", [i, i, i, p, p, i, f64, p, p]),
        # (device, dim, xi, ntiles, tb, ...) as in ops/cuda_group_eval._launch
        ("nbody_masked_eval_bits", [i, i, p, i, i, p, p, i, p, i, i, f64, p, p]),
        ("nbody_window_eval_interval", [i, i, p, i, i, p, p, i, p, p, p, i, f64, p, p]),
        ("nbody_window_eval_nodemask", [i, i, p, i, i, p, p, i, p, p, i, i, i, f64, p, p]),
        ("nbody_window_eval_dense", [i, i, p, i, i, p, p, i, p, p, i, i, f64, p, p]),
        ("nbody_entries_lohi_eval", [i, i, p, i, i, p, p, i, p, p, p, p, i, i, f64, p, p]),
        # (device, dtype, dim, xi, ntiles, tb, mj, xj, L, split, n0, n1, sqrt3, eps, out, stream)
        ("nbody_group_eval", [i, i, i, p, i, i, p, p, i, i, p, p, i, f64, p, p]),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    lib.nbody_error_string.argtypes = [i]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib
