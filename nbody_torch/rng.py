"""Bit-exact replication of std::mt19937 + libstdc++ uniform_real_distribution.

The reference seeds a fixed mt19937{42} and draws through three
uniform_real_distribution<double> objects (src/system.h:22-25); every
workload generator consumes that single stream in a documented order
(src/models.h). To reproduce the reference's initial conditions exactly we
re-implement, on the host:

  * MT19937 with init_genrand seeding (what std::mt19937{seed} does),
    vectorized over the 624-word block twist in numpy;
  * libstdc++'s generate_canonical<double, 53>: two 32-bit draws g1, g2
    combined as (g1 + g2 * 2^32) / 2^64;
  * uniform_real_distribution: a + canonical * (b - a).

Same code as nbody_tpu.rng, which tests/test_rng.py holds against g++
golden values; tests/test_torch_models.py holds this copy against it.

This is host-side model-construction code (the reference also builds models
serially on the host, src/main.cpp:45-57); nothing here runs on the GPU.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)
_TWO32 = float(2**32)
_TWO64 = float(2**64)


class MT19937:
    """std::mt19937 with block-vectorized twist."""

    def __init__(self, seed: int = 5489):
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            prev = int(mt[i - 1])
            mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._buf = np.empty(0, dtype=np.uint32)
        self._pos = 0

    def _twist(self) -> np.ndarray:
        # The scalar algorithm updates mt[] in place, so positions past the
        # dependency distance read freshly-twisted values. The dependency
        # distance is min(N-M, M) = 227, so three 227-wide chunks plus the
        # final wrapped element reproduce it exactly.
        mt = self._mt
        new = np.empty(_N, dtype=np.uint32)

        def tw(cur, nxt, src):
            y = (cur & _UPPER_MASK) | (nxt & _LOWER_MASK)
            mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
            return src ^ (y >> np.uint32(1)) ^ mag

        new[0:227] = tw(mt[0:227], mt[1:228], mt[_M : _M + 227])
        new[227:454] = tw(mt[227:454], mt[228:455], new[0:227])
        new[454:623] = tw(mt[454:623], mt[455:624], new[227:396])
        new[623] = tw(mt[623:624], new[0:1], new[396:397])[0]
        self._mt = new
        out = new.copy()
        # temper
        out ^= out >> np.uint32(11)
        out ^= (out << np.uint32(7)) & np.uint32(0x9D2C5680)
        out ^= (out << np.uint32(15)) & np.uint32(0xEFC60000)
        out ^= out >> np.uint32(18)
        return out

    def raw(self, count: int) -> np.ndarray:
        """`count` tempered 32-bit outputs, identical to calling gen() count times."""
        while self._buf.size - self._pos < count:
            self._buf = np.concatenate([self._buf[self._pos:], self._twist()])
            self._pos = 0
        out = self._buf[self._pos : self._pos + count]
        self._pos += count
        return out

    def canonical(self, count: int) -> np.ndarray:
        """libstdc++ generate_canonical<double,53>: 2 draws per value,
        (g1 + g2*2^32) / 2^64, g1 drawn first."""
        r = self.raw(2 * count).astype(np.float64)
        return (r[0::2] + r[1::2] * _TWO32) / _TWO64

    def uniform(self, a: float, b: float, count: int) -> np.ndarray:
        """std::uniform_real_distribution<double>{a, b} over this stream."""
        return self.canonical(count) * (b - a) + a


class ReferenceDistributions:
    """The three distributions owned by the reference System
    (src/system.h:22-25), all sharing one mt19937{42} stream."""

    def __init__(self, seed: int = 42):
        self.gen = MT19937(seed)

    def angle(self, count: int = 1) -> np.ndarray:
        """angle_dis: U[0, 2*pi)."""
        return self.gen.uniform(0.0, 2.0 * np.pi, count)

    def unit(self, count: int = 1) -> np.ndarray:
        """unit_dis: U[0, 1)."""
        return self.gen.uniform(0.0, 1.0, count)

    def sym(self, count: int = 1) -> np.ndarray:
        """sym_dis: U[-1, 1)."""
        return self.gen.uniform(-1.0, 1.0, count)
