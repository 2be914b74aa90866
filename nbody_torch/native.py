"""ctypes bridge to the native C++ runtime (native/nbody_native.cpp).

Loads (building on demand through native/build.py) libnbody_native.so and
exposes the workload builders. The library and its build script live at
the repo's top level, outside both packages, and import no framework.
Every entry point has a pure-Python fallback in
nbody_torch.models.builders / nbody_torch.rng that produces bit-identical
output; the native path exists because the reference also does its model
construction in native code (src/models.h) and the Plummer rejection loop
is sequential -- Python pays ~10us per draw, C++ ~10ns.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import os
import subprocess

import numpy as np

_BUILD_SCRIPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "build.py"
)


@functools.cache
def _load():
    """The loaded library, or None when it cannot be built or loaded (no
    compiler, no source): callers then take the pure-Python builders."""
    try:
        spec = importlib.util.spec_from_file_location("_nbody_native_build", _BUILD_SCRIPT)
        build_mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build_mod)
        lib = ctypes.CDLL(build_mod.build())
    except (OSError, ImportError, subprocess.CalledProcessError):
        return None
    u32 = ctypes.c_uint32
    dbl = ctypes.c_double
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pu = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.build_uniform.argtypes = [u32, u32, pd, pd, pd]
    lib.build_plummer.argtypes = [u32, pd, pd, pd]
    lib.build_galaxy.argtypes = [u32, u32, dbl, dbl, pd, pd, pd, ctypes.POINTER(u32)]
    lib.mt19937_raw.argtypes = [u32, u32, pu]
    lib.mt19937_canonical.argtypes = [u32, u32, pd]
    for fn in (lib.build_uniform, lib.build_plummer, lib.build_galaxy,
               lib.mt19937_raw, lib.mt19937_canonical):
        fn.restype = None
    return lib


def available() -> bool:
    return _load() is not None


def build_uniform(n: int, dim: int):
    m = np.empty(n, np.float64)
    x = np.empty((n, dim), np.float64)
    v = np.empty((n, dim), np.float64)
    _load().build_uniform(n, dim, m, x, v)
    return m, x, v


def build_plummer(n: int):
    m = np.empty(n, np.float64)
    x = np.empty((n, 3), np.float64)
    v = np.empty((n, 3), np.float64)
    _load().build_plummer(n, m, x, v)
    return m, x, v


def build_galaxy(n: int, dim: int, G: float, eps: float):
    size = int(2 * (n / 2.0))
    m = np.empty(size, np.float64)
    x = np.empty((size, dim), np.float64)
    v = np.empty((size, dim), np.float64)
    filled = ctypes.c_uint32(0)
    _load().build_galaxy(n, dim, G, eps, m, x, v, ctypes.byref(filled))
    return m, x, v


def mt19937_raw(seed: int, count: int) -> np.ndarray:
    out = np.empty(count, np.uint32)
    _load().mt19937_raw(seed, count, out)
    return out


def mt19937_canonical(seed: int, count: int) -> np.ndarray:
    out = np.empty(count, np.float64)
    _load().mt19937_canonical(seed, count, out)
    return out
