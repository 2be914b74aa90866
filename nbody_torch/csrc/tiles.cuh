// The row side of the tree-evaluation and entry-probe kernels
// (group_eval.cu, entry_probes.cu): a block of kThreads threads holds up to
// kThreads * R rows of one row tile, R per thread (kRows = 2 but for the
// float64 list kernel's 1), and every source it stages acts on all R rows
// of a thread. Sums are kept in kGroup-term running sums added to longer
// partials (group_eval.cu's header says why).
#pragma once

#include <cuda_runtime.h>

namespace nbody {

constexpr int kThreads = 256;                              // threads per block
constexpr int kRows = 2;                                   // rows per thread
constexpr int kRowsPerBlock = kThreads * kRows;            // 512
constexpr int kGroup = 32;                                 // terms per innermost running sum

// A block's rows: tile t's rows [t*tb + sub*kThreads*R, (t+1)*tb), R
// per thread; row[r] is -1 past the tile's end.
template <typename T, int DIM, int R = kRows>
struct Rows {
  static constexpr int kPerBlock = kThreads * R;
  T p[R][DIM];
  T acc[R][DIM];
  int row[R];

  // tile blockIdx.x, its part blockIdx.y
  __device__ __forceinline__ Rows(const T* __restrict__ xi, int tb) { load(xi, tb, blockIdx.x, blockIdx.y); }
  // tile t, its part `sub` of kPerBlock rows (the first by default)
  __device__ __forceinline__ Rows(const T* __restrict__ xi, int tb, int t, int sub = 0) {
    load(xi, tb, t, sub);
  }

  // Take the rows of tile t, part `sub`, with zero sums.
  __device__ __forceinline__ void load(const T* __restrict__ xi, int tb, int t, int sub) {
    const int row0 = t * tb + sub * kPerBlock;
    const int row_end = (t + 1) * tb;
#pragma unroll
    for (int r = 0; r < R; ++r) {
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
    for (int r = 0; r < R; ++r) {
      if (row[r] < 0) continue;
#pragma unroll
      for (int d = 0; d < DIM; ++d) out[static_cast<size_t>(row[r]) * DIM + d] = acc[r][d];
    }
  }

  // store() for rows whose tile other blocks also add to: out starts at 0.
  __device__ __forceinline__ void store_add(T* __restrict__ out) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row[r] < 0) continue;
#pragma unroll
      for (int d = 0; d < DIM; ++d) atomicAdd(out + static_cast<size_t>(row[r]) * DIM + d, acc[r][d]);
    }
  }
};

template <typename T, int R, int DIM>
__device__ __forceinline__ void zero(T (&v)[R][DIM]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) v[r][d] = T(0);
}

template <typename T, int R, int DIM>
__device__ __forceinline__ void add_to(T (&dst)[R][DIM], const T (&src)[R][DIM]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < DIM; ++d) dst[r][d] += src[r][d];
}

}  // namespace nbody
