// The staged loop of the chain's kernels (group_eval.cu: the entries, list,
// far-field and window kernels; entry_probes.cu: the entry-cost probes):
// source bodies staged in shared memory as (x, y, z | 0, m), kChunk at a
// time, read by every thread as broadcasts and added to its rows by the
// two-MUFU chain (pair.cuh ChainWeight) in groups of kGroup terms, each
// group added to its stage's sum and each stage's sum to the rows' total.
// Every kernel that sums the same staged values through add_stage sums
// them in the same order, so two of them agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "pair.cuh"
#include "tiles.cuh"

namespace nbody {

constexpr int kChunk = kThreads;  // bodies per shared stage

// Where a kernel reads source body j: masses and positions in two arrays
// (m[j], x[j * DIM + d]) ...
template <typename T, int DIM>
struct SplitSource {
  const T* __restrict__ m;
  const T* __restrict__ x;

  __device__ __forceinline__ void load(int j, T& mj, T (&xj)[DIM]) const {
    mj = m[j];
#pragma unroll
    for (int d = 0; d < DIM; ++d) xj[d] = x[static_cast<size_t>(j) * DIM + d];
  }
};

// ... or both in one float4 per body, (x, y, z | 0, m): one 16-byte load.
template <int DIM>
struct PackedSource {
  const float4* __restrict__ xm;
};

// A body as the chain's kernels stage it, (x, y, z | 0, m) of type T: one
// 16-byte float4 in float32, two 16-byte halves in float64; each thread
// reads a staged body as one broadcast (one or two 16-byte shared loads).
struct alignas(32) Double4 {
  double x, y, z, w;
};
template <typename T>
struct StagedOf;
template <>
struct StagedOf<float> {
  using type = float4;
};
template <>
struct StagedOf<double> {
  using type = Double4;
};
template <typename T>
using Staged = typename StagedOf<T>::type;

// Body j as the chain's kernels stage it, (x, y, z | 0, m), from either
// layout: the same values, so the two layouts sum alike.
template <typename T, int DIM>
__device__ __forceinline__ Staged<T> staged(const SplitSource<T, DIM>& src, int j) {
  const T* x = src.x + static_cast<size_t>(j) * DIM;
  return Staged<T>{x[0], x[1], DIM == 3 ? x[2] : T(0), src.m[j]};
}
template <int DIM>
__device__ __forceinline__ float4 staged(const PackedSource<DIM>& src, int j) {
  return src.xm[j];
}

// One staged body v = (x, y, z | 0, m) acting on all rows of the thread,
// by the chain.
template <typename T, int DIM, bool SQRT3, int R>
__device__ __forceinline__ void add_staged(const T (&p)[R][DIM], const Staged<T>& v,
                                           const ChainWeight<T, SQRT3>& weight,
                                           T (&part)[R][DIM]) {
  const T x[3] = {v.x, v.y, v.z};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T dx[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dx[d] = x[d] - p[r][d];
    const T w = weight(v.w, sep2_from<T, DIM>(least_normal(T(0)), dx));
#pragma unroll
    for (int d = 0; d < DIM; ++d) part[r][d] += w * dx[d];
  }
}

// One stage: the staged bodies s[0, len), len <= kChunk, in shared memory,
// added to rows.acc as one stage's sum of kGroup-term groups. Every thread
// reads each body as a broadcast; the caller makes s readable first.
template <typename T, int DIM, bool SQRT3, int R>
__device__ __forceinline__ void add_stage(Rows<T, DIM, R>& rows, const Staged<T>* s, int len,
                                          const ChainWeight<T, SQRT3>& weight) {
  T part[R][DIM];
  zero(part);
  for (int k0 = 0; k0 < len; k0 += kGroup) {
    T group[R][DIM];
    zero(group);
    const int k1 = min(len, k0 + kGroup);
#pragma unroll 4
    for (int k = k0; k < k1; ++k) add_staged<T, DIM, SQRT3>(rows.p, s[k], weight, group);
    add_to(part, group);
  }
  add_to(rows.acc, part);
}

// The staged loop: the bodies u in [u0, u1) of a block-uniform order,
// fetch(u) giving body u staged, added to rows.acc by the chain. Each
// thread fetches one body of a stage of kChunk; the stage is then summed
// by add_stage. SKIP_ZERO skips a stage whose staged masses are all zero
// (block-uniform, __syncthreads_or); that changes no bit, since each of its
// terms is 0 * dx / t with a finite t and a row's sum never becomes -0.
// Called by every thread of the block with the same u0, u1.
template <bool SKIP_ZERO = false, typename T, int DIM, bool SQRT3, int R, typename Fetch>
__device__ __forceinline__ void add_staged_run(Rows<T, DIM, R>& rows, long long u0, long long u1,
                                               const ChainWeight<T, SQRT3>& weight,
                                               Staged<T>* s_body, const Fetch& fetch) {
  for (long long j0 = u0; j0 < u1; j0 += kChunk) {
    const int len = static_cast<int>(min(static_cast<long long>(kChunk), u1 - j0));
    [[maybe_unused]] bool live = false;
    if (threadIdx.x < len) {
      const Staged<T> v = fetch(j0 + threadIdx.x);
      s_body[threadIdx.x] = v;
      live = v.w != T(0);
    }
    if constexpr (SKIP_ZERO) {
      if (!__syncthreads_or(live)) continue;  // every staged mass is zero
    } else {
      __syncthreads();
    }
    add_stage(rows, s_body, len, weight);
    __syncthreads();
  }
}

}  // namespace nbody
