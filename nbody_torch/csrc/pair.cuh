// The per-pair arithmetic of every gravity kernel in nbody_torch/csrc, in
// one place so that all of them round alike.
//
// One source body j acting on one row i adds  w * (x_j - x_i)  with
//     w = m_j / t
//     poly:  t = d2 * sqrt(d2) + eps        (vec.h:249-252; all-pairs, bvh)
//     sqrt3: t = (sqrt(d2) + eps)^3          (the octree quirk, octree.h:156-160)
// where d2 = |x_j - x_i|^2. Division and square root are IEEE (nvcc's
// defaults -prec-div=true -prec-sqrt=true; the build never passes
// --use_fast_math): the softening adds eps ~ 1.19e-7 to a tiny d2*sqrt(d2),
// and approximate division changes exactly those close-pair terms. The
// Pallas kernels used an approximate reciprocal plus one Newton step, which
// lies within 1 ulp of the division.
#pragma once

#include <cuda_runtime.h>

namespace nbody {

__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }

template <typename T, bool SQRT3>
__device__ __forceinline__ T pair_weight(T m, T d2, T eps) {
  T t;
  if constexpr (SQRT3) {
    const T s = root(d2) + eps;
    t = s * s * s;
  } else {
    t = d2 * root(d2) + eps;
  }
  return m / t;
}

}  // namespace nbody
