// The row side of the tree-evaluation and entry-probe kernels
// (group_eval.cu, entry_probes.cu): a block of kThreads threads holds up to
// kRowsPerBlock rows of one row tile, two per thread, and every source it
// stages acts on both rows of a thread. Sums are kept in kGroup-term
// running sums added to longer partials (group_eval.cu's header says why).
#pragma once

#include <cuda_runtime.h>

#include "pair.cuh"

namespace nbody {

constexpr int kThreads = 256;                              // threads per block
constexpr int kRows = 2;                                   // rows per thread
constexpr int kRowsPerBlock = kThreads * kRows;            // 512
constexpr int kGroup = 32;                                 // terms per innermost running sum

// A block's rows: tile t's rows [t*tb + sub*kRowsPerBlock, (t+1)*tb), two
// per thread; row[r] is -1 past the tile's end.
template <typename T, int DIM>
struct Rows {
  T p[kRows][DIM];
  T acc[kRows][DIM];
  int row[kRows];

  // tile blockIdx.x, its part blockIdx.y
  __device__ __forceinline__ Rows(const T* __restrict__ xi, int tb) { load(xi, tb, blockIdx.x, blockIdx.y); }
  // tile t, its part `sub` of kRowsPerBlock rows (the first by default)
  __device__ __forceinline__ Rows(const T* __restrict__ xi, int tb, int t, int sub = 0) {
    load(xi, tb, t, sub);
  }

  // Take the rows of tile t, part `sub`, with zero sums.
  __device__ __forceinline__ void load(const T* __restrict__ xi, int tb, int t, int sub) {
    const int row0 = t * tb + sub * kRowsPerBlock;
    const int row_end = (t + 1) * tb;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row0 + r * kThreads + threadIdx.x;
      row[r] = i < row_end ? i : -1;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        p[r][d] = row[r] >= 0 ? xi[static_cast<size_t>(i) * DIM + d] : T(0);
        acc[r][d] = T(0);
      }
    }
  }

  __device__ __forceinline__ void store(T* __restrict__ out) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row[r] < 0) continue;
#pragma unroll
      for (int d = 0; d < DIM; ++d) out[static_cast<size_t>(row[r]) * DIM + d] = acc[r][d];
    }
  }

  // store() for rows whose tile other blocks also add to: out starts at 0.
  __device__ __forceinline__ void store_add(T* __restrict__ out) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row[r] < 0) continue;
#pragma unroll
      for (int d = 0; d < DIM; ++d) atomicAdd(out + static_cast<size_t>(row[r]) * DIM + d, acc[r][d]);
    }
  }
};

template <typename T, int DIM>
__device__ __forceinline__ void zero(T (&v)[kRows][DIM]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) v[r][d] = T(0);
}

template <typename T, int DIM>
__device__ __forceinline__ void add_to(T (&dst)[kRows][DIM], const T (&src)[kRows][DIM]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) dst[r][d] += src[r][d];
}

// One source (m, x) acting on both rows of the thread.
template <typename T, int DIM, bool SQRT3>
__device__ __forceinline__ void add_source(const T (&p)[kRows][DIM], T m, const T (&x)[DIM], T eps,
                                           T (&part)[kRows][DIM]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    T dx[DIM];
    T d2 = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      dx[d] = x[d] - p[r][d];
      d2 += dx[d] * dx[d];
    }
    const T w = pair_weight<T, SQRT3>(m, d2, eps);
#pragma unroll
    for (int d = 0; d < DIM; ++d) part[r][d] += w * dx[d];
  }
}

}  // namespace nbody
