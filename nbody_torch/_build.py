"""Build and load the hand-written CUDA kernels (nbody_torch/csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface, which ctypes loads; nothing includes PyTorch's headers, so a
build takes seconds. The library goes to .build/nbody_torch/ at the root
of the checkout, under a name that carries a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is not. The
build happens at first use (ops.cuda_allpairs calls load_library before
its first launch), never at import.

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
              "-shared", "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
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


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C interface
    of csrc/allpairs.cu."""
    lib = ctypes.CDLL(str(build()))
    i, p, f64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
    lib.nbody_allpairs_block.argtypes = [i, i, i, i, p, i, p, p, i, f64, f64, p, p]
    lib.nbody_allpairs_block.restype = i
    lib.nbody_potential_rowsums.argtypes = [i, i, i, p, p, i, f64, p, p]
    lib.nbody_potential_rowsums.restype = i
    lib.nbody_error_string.argtypes = [i]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib
