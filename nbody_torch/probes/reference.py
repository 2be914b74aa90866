"""The stdpar-nbody reference binary as a cross-implementation oracle, for
the accuracy study's reference legs and the NASA pipeline (the port's
copy of tests/ref_oracle.py's reference_available, run_reference and
read_positions).

The reference builds sequentially with plain g++: with -DSEQUENTIAL both
execution policies become std::execution::seq, so no TBB is needed, and
-DFMT_FORMAT_WORKAROUND routes std::format through a header-only fmt,
taken from the torch installation's include directory. The caller names
the reference's src/main.cpp; the port ships no copy of it and looks for
none, so without one the legs that need it are skipped, for the reason
that reference_problem gives.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np


def _fmt_include() -> str | None:
    """The include directory of the fmt headers that torch ships, or None."""
    import torch

    inc = os.path.join(os.path.dirname(torch.__file__), "include")
    return inc if os.path.exists(os.path.join(inc, "fmt", "core.h")) else None


def reference_problem(src: str | None) -> str | None:
    """Why the reference binary cannot be built from `src` (its
    src/main.cpp) here, or None when it can."""
    if not src:
        return "no reference source given (--reference PATH: the reference's src/main.cpp)"
    if not os.path.exists(src):
        return f"the reference source {src} does not exist"
    if shutil.which("g++") is None:
        return "g++ is not on PATH"
    if _fmt_include() is None:
        return "the torch installation ships no fmt headers"
    return None


def reference_available(src: str | None) -> bool:
    return reference_problem(src) is None


def build_reference(dim: int, src: str, build_dir: str) -> str:
    """The sequential reference binary for `dim`, compiled into build_dir
    once (about 12 s) and reused."""
    exe = os.path.join(build_dir, f"nbody_ref_d{dim}")
    if os.path.exists(exe):
        return exe
    os.makedirs(build_dir, exist_ok=True)
    subprocess.run(["g++", "-std=c++23", "-O2", "-DSEQUENTIAL", f"-DDIM_SIZE={dim}",
                    "-DFMT_FORMAT_WORKAROUND", f"-I{_fmt_include()}", "-o", exe, src],
                   check=True, capture_output=True, text=True, timeout=300)
    return exe


def run_reference(dim: int, args: list[str], src: str, build_dir: str, cwd=None) -> str:
    """Run the reference binary with `args` in `cwd`; returns its stdout,
    raises with its stderr if it fails."""
    proc = subprocess.run([build_reference(dim, src, build_dir), *args], capture_output=True,
                          text=True, timeout=600, cwd=cwd)
    if proc.returncode != 0:
        raise RuntimeError(f"the reference binary failed: {proc.stderr or proc.stdout}")
    return proc.stdout


def read_positions(path: str) -> np.ndarray:
    """A positions.bin trajectory (the header u32 {nbodies, nsteps,
    sizeof(T), dim}, then the frames) as (frames, nbodies, dim), every
    frame written."""
    with open(path, "rb") as f:
        nbodies, _, tsize, dim = (int(v) for v in np.fromfile(f, dtype=np.uint32, count=4))
        data = np.fromfile(f, dtype=np.float64 if tsize == 8 else np.float32)
    return data.reshape(-1, nbodies, dim)
