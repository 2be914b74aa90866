// The per-pair arithmetic of every gravity kernel in nbody_torch/csrc, and
// the row sum and block reduction that the all-pairs kernels share, in one
// place so that all of them round alike.
//
// One source body j acting on one row i adds  w * (x_j - x_i)  with
//     w = m_j / t
//     poly:  t = d2 * sqrt(d2) + eps        (vec.h:249-252; all-pairs, bvh)
//     sqrt3: t = (sqrt(d2) + eps)^3          (the octree quirk, octree.h:156-160)
// where d2 = |x_j - x_i|^2. pair_weight divides and takes the root in IEEE
// (nvcc's defaults -prec-div=true -prec-sqrt=true; the build never passes
// --use_fast_math); only the all-pairs kernel's exact=True instantiation
// (allpairs.cu, SoftenedWeight) uses it. The Pallas kernels take the
// approximate reciprocal plus one Newton step (pallas_allpairs.py:79-84,
// their default exact=False; pallas_group_eval.py:143-144 and :877-878 in
// the group kernels), within 1 ulp of the division: newton_recip below. A
// bare rcp.approx, without the Newton step, would lose bits of the
// close-pair terms, whose t is eps plus a tiny d2*sqrt(d2); the step
// restores them. The all-pairs kernels (allpairs.cu) by default, every
// kernel of group_eval.cu (the entries and list kernels, the three far
// fields, the node-mask, interval and dense-mask windows) and the
// entry-cost probes' ladder and ring (entry_probes.cu) run the Newton form
// in ChainWeight below, as nbody_tpu's CLI does.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

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

// The Pallas kernels' reciprocal, float32 (pallas_allpairs.py:79-84): the
// hardware's approximate reciprocal, then one Newton step, within 1 ulp of
// IEEE division. The Pallas kernel was float32-only; allpairs.cu refines
// its own float64 seeds.
__device__ __forceinline__ float newton_recip(float t) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t));
  return r * (2.0f - t * r);
}

// The IEEE force weight w(m, d2) (exact=True).
template <typename T, bool SQRT3>
struct SoftenedWeight {
  T eps;
  __device__ __forceinline__ T operator()(T m, T d2) const { return pair_weight<T, SQRT3>(m, d2, eps); }
};

// The two-MUFU chain, which the all-pairs kernels (allpairs.cu), every
// kernel of group_eval.cu and the entry-cost probes (entry_probes.cu)
// share: a root and a reciprocal a pair, each one MUFU seed (refined in
// float64), against the IEEE pair_weight's sqrt and division with their
// slow-path checks (38.25 SASS instructions a 3-D float32 pair against
// 17.75 on an H100, PERF.md).
//
// The least normal number. The chain sums d2 from it instead of from 0, so
// that its MUFU seeds see a normal input and a coincident pair (dx = 0)
// gets a finite weight and a zero term, not 0 * inf. That changes no d2
// above 2^-102 (float32) or 2^-969 (float64), pairs closer than ~1e-15,
// and costs no instruction: the first square becomes a fused multiply-add
// (a clamp, fmax(d2, least), costs one a pair).
__device__ __forceinline__ float least_normal(float) { return FLT_MIN; }
__device__ __forceinline__ double least_normal(double) { return DBL_MIN; }

// d2 = start + sum_d dx[d]^2 in dimension order.
template <typename T, int DIM>
__device__ __forceinline__ T sep2_from(T start, const T* dx) {
  T d2 = start;
#pragma unroll
  for (int d = 0; d < DIM; ++d) d2 += dx[d] * dx[d];
  return d2;
}

// sqrt(v) and m / t for normal v > 0 and t > 0. float32: one MUFU each,
// the reciprocal refined by one Newton step as pallas_allpairs.py:79-84 does.
__device__ __forceinline__ float chain_root(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return v * r;
}
__device__ __forceinline__ float chain_div(float m, float t) { return m * newton_recip(t); }

// float64: the MUFU seeds (relative error e ~ 2^-20), each refined by two
// residual corrections that multiply the error by e: e^3 < 2^-53.
__device__ __forceinline__ double chain_root(double v) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(v));
  const double hy = 0.5 * y;
  double s = v * y;
  s = fma(hy, fma(-s, s, v), s);
  return fma(hy, fma(-s, s, v), s);
}
__device__ __forceinline__ double chain_div(double m, double t) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(t));
  double q = m * y;
  q = fma(y, fma(-t, q, m), q);
  return fma(y, fma(-t, q, m), q);
}

// The force weight w(m, d2) of a pair by the chain (exact=False), for d2 >=
// the least normal number; nbody::SoftenedWeight is the IEEE one (exact=True).
template <typename T, bool SQRT3>
struct ChainWeight {
  T eps;
  __device__ __forceinline__ T operator()(T m, T d2) const {
    const T s = chain_root(d2);
    T t;
    if constexpr (SQRT3) {
      const T u = s + eps;
      t = u * u * u;
    } else {
      t = d2 * s + eps;
    }
    return chain_div(m, t);
  }
};

// The all-pairs kernels sum each row's terms over a staged tile of at most
// kPartBodies bodies into a partial and add the partial to the row's total
// -- the analog of the Pallas kernels' per-j-tile jnp.sum followed by
// out_ref +=. A single running sum over 2^20 same-signed terms would lose
// ~sqrt(n) ulps; partials of at most kPartBodies keep the error near
// sqrt(kPartBodies) + sqrt(n / kPartBodies) ulps of the sum of |term|.
constexpr int kPartBodies = 256;

struct Sum {
  __device__ static float identity() { return 0.0f; }
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ static float identity() { return -INFINITY; }
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Min {
  __device__ static float identity() { return INFINITY; }
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// op over the block, returned to every thread. blockDim.x is a multiple of
// 32, at most 1024; s_red holds 32 floats.
template <typename Op>
__device__ float block_reduce(float v, float* s_red, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  if (lane == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? s_red[lane] : Op::identity();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // s_red may be written again
  return v;
}

}  // namespace nbody
