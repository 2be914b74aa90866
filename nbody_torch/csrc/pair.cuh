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
// --use_fast_math); the tree kernels of group_eval.cu and the all-pairs
// kernel's exact=True instantiation use it. The Pallas kernels take the
// approximate reciprocal plus one Newton step (pallas_allpairs.py:79-84,
// their default exact=False), within 1 ulp of the division: newton_recip
// below. A bare rcp.approx, without the Newton step, would lose bits of
// the close-pair terms, whose t is eps plus a tiny d2*sqrt(d2); the step
// restores them. The all-pairs kernels (allpairs.cu) run the Newton form
// by default, as nbody_tpu's CLI does.
#pragma once

#include <cuda_runtime.h>
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

// The poly weight m / (d2 * sqrt(d2) + eps) with the Newton reciprocal in
// place of the division (pallas_allpairs.py:77-84, exact=False).
__device__ __forceinline__ float pair_weight_newton(float m, float d2, float eps) {
  return m * newton_recip(d2 * sqrtf(d2) + eps);
}

// The far-tile weight of the fast variant, m * rsqrt(d2)^3, the softening
// dropped (pallas_allpairs.py:98-101): on a tile whose every d2 exceeds
// (eps / tol)^(2/3) it changes each weight by less than tol relative.
__device__ __forceinline__ float far_weight(float m, float d2) {
  const float r = rsqrtf(d2);
  return (m * r) * (r * r);
}

// d2 = |dx|^2 summed in dimension order: every pass that recomputes a
// pair's d2 (a tile's minimum, then its weights) rounds alike.
template <typename T, int DIM>
__device__ __forceinline__ T sep2(const T* dx) {
  T d2 = T(0);
#pragma unroll
  for (int d = 0; d < DIM; ++d) d2 += dx[d] * dx[d];
  return d2;
}

// The weights of add_row_part, w(m, d2).
template <typename T, bool SQRT3>
struct SoftenedWeight {
  T eps;
  __device__ __forceinline__ T operator()(T m, T d2) const { return pair_weight<T, SQRT3>(m, d2, eps); }
};
struct NewtonWeight {
  float eps;
  __device__ __forceinline__ float operator()(float m, float d2) const {
    return pair_weight_newton(m, d2, eps);
  }
};
struct FarWeight {
  __device__ __forceinline__ float operator()(float m, float d2) const { return far_weight(m, d2); }
};

// One row's sum over the bodies [k0, k1) of a tile staged in shared memory
// (masses s_m, positions s_x[d * stride + k]), kept in a partial sum that
// is added to the row total acc at the end -- the analog of the Pallas
// kernels' per-j-tile jnp.sum followed by out_ref +=. A single running sum
// over 2^20 same-signed terms would lose ~sqrt(n) ulps; partials of at most
// kPartBodies keep the error near sqrt(kPartBodies) + sqrt(n / kPartBodies)
// ulps of the sum of |term|. No d2 > 0 guard is needed: a pair at d2 = 0
// has dx = 0, which zeroes its term.
constexpr int kPartBodies = 256;

template <typename T, int DIM, typename Weight>
__device__ __forceinline__ void add_row_part(const T* p, const T* s_m, const T* s_x, int stride,
                                             int k0, int k1, Weight weight, T* acc) {
  T part[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) part[d] = T(0);
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    T dx[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dx[d] = s_x[d * stride + k] - p[d];
    const T w = weight(s_m[k], sep2<T, DIM>(dx));
#pragma unroll
    for (int d = 0; d < DIM; ++d) part[d] += w * dx[d];
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[d] += part[d];
}

// One row's sum over a whole staged tile of len bodies (stride len), in
// partials of kPartBodies.
template <typename T, int DIM, typename Weight>
__device__ __forceinline__ void add_row_tile(const T* p, const T* s_m, const T* s_x, int len,
                                             Weight weight, T* acc) {
  for (int k0 = 0; k0 < len; k0 += kPartBodies) {
    add_row_part<T, DIM>(p, s_m, s_x, len, k0, min(len, k0 + kPartBodies), weight, acc);
  }
}

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
