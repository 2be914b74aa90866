// Tree-evaluation kernels of the octree and BVH fast and list paths for
// Hopper (sm_90a), with a plain C interface that nbody_torch/ops/cuda_group_eval.py
// loads through ctypes. Each evaluates T row tiles of `tb` consecutive
// sorted bodies against a set of sources and writes the raw (G-less)
// accelerations
//     out_i = sum_j m_j * (x_j - x_i) / t,
// with pair.cuh's softening: t = (sqrt(d2) + eps)^3 (sqrt3, the octree's)
// or t = d2 * sqrt(d2) + eps (poly, the BVH's). The far and entries
// and list kernels are templated on it (SQRT3); the octree's interval
// window is sqrt3 only and the BVH's two windows take both.
//
// masked_eval_bits_kernel<DIM, SQRT3> replaces masked_eval_bits_pallas
// (nbody_tpu/ops/pallas_group_eval.py:310, body _masked_bits_kernel): the
// far field. Every tile sees the same W heap nodes (mass, COM); a packed
// accept bit per (tile, node) gates each node (word l / 32, bit l % 32).
// The mask belongs to the tile, so it is the same for every thread of the
// block: the block stages kNodeChunk nodes and their mask words in shared
// memory, skips a chunk whose words are all zero, and walks the set bits
// with a block-uniform loop. An unset node is skipped outright; that is
// exact, since its Pallas weight is 0 * m / t with t >= eps > 0 (t >=
// eps^3 under sqrt3).
//
// window_eval_interval_kernel<DIM> replaces window_eval_interval_pallas
// (:502, body _window_interval_kernel): the octree's near window. Tile t
// sees the sorted bodies [max(lo, w0*tb), min(hi, (w0 + window_tiles)*tb)),
// the cell-snapped interval inside its window. Only those columns are
// visited, which is nbody_tpu's skip_outside carried to the column.
//
// window_eval_nodemask_kernel<DIM, SQRT3> replaces
// window_eval_nodemask_pallas (:614, body _window_nodemask_kernel): the
// BVH's near window. Tile t's window is the window_tiles*tb bodies from
// w0*tb, cut into wnodes slots of S bodies; slot v counts when its node is
// open for the tile (in_win[t, v], one byte). The block walks the slots
// with a block-uniform loop and adds each run of consecutive open slots
// as one range of bodies; a closed slot is skipped outright, which is
// exact for the reason above and is nbody_tpu's skip_outside carried to
// the slot. The TPU's limit of 64 slots per block (unrolled selects) does
// not apply.
//
// window_eval_dense_kernel<DIM, SQRT3> replaces window_eval_pallas (:383,
// body _masked_eval_kernel): the same window with a dense float32 weight
// per (tile, column), mask[t, c], that multiplies m_j. The BVH takes it
// where a window block would hold more than 64 slots (only tiny systems).
//
// entries_lohi_kernel<DIM, SQRT3> replaces entries_lohi_eval_pallas (:963,
// body _entries_lohi_kernel): the near-field exact entries (the octree's
// near field, the BVH's residual). The entry list
// (tile << 16 | blk, lo | hi << 16) is sorted by tile; the wrapper finds each
// tile's run [first, last) on the device. One block per tile walks its run,
// visits the bodies blk*S + [lo, hi) of each entry exactly, and writes its
// rows once: no zeroing on a tile's first entry, no atomics, no chunk loop,
// and a tile with no entries writes zeros.
//
// group_eval_kernel<T, DIM, SQRT3> computes group_eval_pallas's function
// (:83, body _group_eval_kernel): the list paths' evaluation, the octree's
// (sqrt3) and the BVH's (poly). nbody_tpu reaches group_eval_pallas only
// through compute_force_grouped(use_pallas=...); its float64 runs take the
// jnp evaluation (octree_group.py:375-416, bvh_group.py:295-331), and this
// kernel stands there on the port's float64 path. Float32 lists reach it
// through the list_path branch of the step functions (float32 CLI runs
// take the fast paths). Tile t's rows see the tile's own gathered list, mj[t, :]
// and xj[t, :, :] (accepted monopoles, then opened leaf bodies). The list
// holds two segments, nodes [0, split) and leaf bodies [split, L), each
// padded with mass-0 entries; the block visits only each segment's live
// head, [0, n0[t]) and [split, split + n1[t]), which is exact: a padding
// entry adds 0 * dx / t = 0. The TPU's padding of L to 1,024 lanes is not
// carried over. Unlike the other kernels here it is templated on T in
// {float, double}, as allpairs.cu is; on an H100 float64 issue (its
// division and square root) is what bounds it.
//
// What bounds them on an H100: as for allpairs_block_kernel (PERF.md), FP32
// and SFU issue per pair -- the IEEE sqrt and division of pair_weight --
// not bytes: the sources are staged once per block through shared memory
// and read as broadcasts. The design keeps the per-pair work minimal and
// halves the shared loads per pair: each thread holds two rows (256 threads,
// 512 rows per block, one default tile), and every staged source is used
// for both. A tile of more than 512 rows gets several blocks.
//
// Summation: a thread sums groups of kGroup = 32 terms, adds each group to
// its shared stage's sum (kChunk bodies, or one kNodeChunk node stage),
// each stage to the entry's (entries kernel) and then to the row total.
// A single running sum over a 256-body stage lost up to ~150 ulps of the
// row's sum of |term| where the terms share a sign (measured on an H100:
// 8.7e-6 against float64 at the 2^20 window, ~13x the twin's error). The
// longest running sums left are a row's over its stages or its entries.

#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

constexpr int kThreads = 256;                              // threads per block
constexpr int kRows = 2;                                   // rows per thread
constexpr int kRowsPerBlock = kThreads * kRows;            // 512
constexpr int kChunk = kThreads;                           // bodies per shared stage
constexpr int kNodeChunk = 1024;                           // far-field nodes per stage
constexpr int kGroup = 32;                                 // terms per innermost running sum

// The block's rows: tile t's rows [row0, row_end), two per thread.
template <typename T, int DIM>
struct Rows {
  T p[kRows][DIM];
  T acc[kRows][DIM];
  int row[kRows];

  __device__ __forceinline__ Rows(const T* __restrict__ xi, int tb) {
    const int t = blockIdx.x;
    const int row0 = t * tb + blockIdx.y * kRowsPerBlock;
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
    const T w = nbody::pair_weight<T, SQRT3>(m, d2, eps);
#pragma unroll
    for (int d = 0; d < DIM; ++d) part[r][d] += w * dx[d];
  }
}

// The contiguous sorted bodies [a, b), staged kChunk at a time, added to
// `sum` stage by stage. Called by every thread with block-uniform a, b.
// With `weight`, body j's mass is scaled by weight[j - a].
template <typename T, int DIM, bool SQRT3>
__device__ __forceinline__ void add_range(const Rows<T, DIM>& rows, const T* __restrict__ mj,
                                          const T* __restrict__ xj, int a, int b, T eps, T* s_m,
                                          T (*s_x)[kChunk], T (&sum)[kRows][DIM],
                                          const T* __restrict__ weight = nullptr) {
  for (int j0 = a; j0 < b; j0 += kChunk) {
    const int len = min(kChunk, b - j0);
    if (threadIdx.x < len) {
      const int j = j0 + threadIdx.x;
      s_m[threadIdx.x] = weight == nullptr ? mj[j] : mj[j] * weight[j - a];
#pragma unroll
      for (int d = 0; d < DIM; ++d) s_x[d][threadIdx.x] = xj[static_cast<size_t>(j) * DIM + d];
    }
    __syncthreads();
    T part[kRows][DIM];
    zero(part);
    for (int k0 = 0; k0 < len; k0 += kGroup) {
      T group[kRows][DIM];
      zero(group);
      const int k1 = min(len, k0 + kGroup);
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        T x[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) x[d] = s_x[d][k];
        add_source<T, DIM, SQRT3>(rows.p, s_m[k], x, eps, group);
      }
      add_to(part, group);
    }
    add_to(sum, part);
    __syncthreads();
  }
}

template <int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads)
masked_eval_bits_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                        const float* __restrict__ xj, int W, const unsigned* __restrict__ words,
                        int nw, float eps, float* __restrict__ out) {
  __shared__ float s_m[kNodeChunk];
  __shared__ float s_x[DIM][kNodeChunk];
  __shared__ unsigned s_w[kNodeChunk / 32];

  Rows<float, DIM> rows(xi, tb);
  const unsigned* tile_words = words + static_cast<size_t>(blockIdx.x) * nw;
  for (int c0 = 0; c0 < W; c0 += kNodeChunk) {
    const int len = min(kNodeChunk, W - c0);
    const int nwc = (len + 31) / 32;
    unsigned any = 0;
    for (int k = threadIdx.x; k < nwc; k += kThreads) {
      const unsigned v = tile_words[c0 / 32 + k];
      s_w[k] = v;
      any |= v;
    }
    if (!__syncthreads_or(any != 0)) continue;  // no node of this stage is accepted
    for (int k = threadIdx.x; k < len; k += kThreads) {
      s_m[k] = mj[c0 + k];
#pragma unroll
      for (int d = 0; d < DIM; ++d) s_x[d][k] = xj[static_cast<size_t>(c0 + k) * DIM + d];
    }
    __syncthreads();
    float part[kRows][DIM];
    zero(part);
    for (int wi = 0; wi < nwc; ++wi) {
      unsigned bits = s_w[wi];  // the same word for every thread: a uniform loop
      if (!bits) continue;
      float group[kRows][DIM];  // one word's nodes: a group of at most kGroup
      zero(group);
      while (bits) {
        const int k = wi * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        float x[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) x[d] = s_x[d][k];
        add_source<float, DIM, SQRT3>(rows.p, s_m[k], x, eps, group);
      }
      add_to(part, group);
    }
    add_to(rows.acc, part);
    __syncthreads();
  }
  rows.store(out);
}

template <int DIM>
__global__ void __launch_bounds__(kThreads)
window_eval_interval_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                            const float* __restrict__ xj, int nj, const int* __restrict__ w0,
                            const int* __restrict__ lo, const int* __restrict__ hi,
                            int window_tiles, float eps, float* __restrict__ out) {
  __shared__ float s_m[kChunk];
  __shared__ float s_x[DIM][kChunk];

  Rows<float, DIM> rows(xi, tb);
  const int t = blockIdx.x;
  const int col0 = w0[t] * tb;
  const int a = max(lo[t], col0);
  const int b = min(min(hi[t], col0 + window_tiles * tb), nj);
  add_range<float, DIM, true>(rows, mj, xj, a, b, eps, s_m, s_x, rows.acc);
  rows.store(out);
}

template <int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads)
window_eval_nodemask_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                            const float* __restrict__ xj, int nj, const int* __restrict__ w0,
                            const unsigned char* __restrict__ in_win, int wnodes, int S, float eps,
                            float* __restrict__ out) {
  __shared__ float s_m[kChunk];
  __shared__ float s_x[DIM][kChunk];

  Rows<float, DIM> rows(xi, tb);
  const int t = blockIdx.x;
  const int col0 = w0[t] * tb;
  const unsigned char* slot_open = in_win + static_cast<size_t>(t) * wnodes;
  // the same slots for every thread: a block-uniform walk over the runs of
  // open slots, each run one contiguous range of bodies
  int v = 0;
  while (v < wnodes) {
    if (!slot_open[v]) {
      ++v;
      continue;
    }
    int v1 = v + 1;
    while (v1 < wnodes && slot_open[v1]) ++v1;
    const int a = col0 + v * S;
    const int b = min(col0 + v1 * S, nj);
    if (a < b) add_range<float, DIM, SQRT3>(rows, mj, xj, a, b, eps, s_m, s_x, rows.acc);
    v = v1;
  }
  rows.store(out);
}

template <int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads)
window_eval_dense_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                         const float* __restrict__ xj, int nj, const int* __restrict__ w0,
                         const float* __restrict__ mask, int wb, float eps,
                         float* __restrict__ out) {
  __shared__ float s_m[kChunk];
  __shared__ float s_x[DIM][kChunk];

  Rows<float, DIM> rows(xi, tb);
  const int t = blockIdx.x;
  const int a = w0[t] * tb;
  const int b = min(a + wb, nj);
  add_range<float, DIM, SQRT3>(rows, mj, xj, a, b, eps, s_m, s_x, rows.acc,
                        mask + static_cast<size_t>(t) * wb);
  rows.store(out);
}

template <int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads)
entries_lohi_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                    const float* __restrict__ xj, int nj, const int* __restrict__ entries,
                    const int* __restrict__ lohis, const int* __restrict__ first,
                    const int* __restrict__ last, int S, float eps, float* __restrict__ out) {
  __shared__ float s_m[kChunk];
  __shared__ float s_x[DIM][kChunk];

  Rows<float, DIM> rows(xi, tb);
  const int t = blockIdx.x;
  for (int e = first[t]; e < last[t]; ++e) {
    const int base = (entries[e] & 0xFFFF) * S;
    const int lohi = lohis[e];
    const int a = base + (lohi & 0xFFFF);
    const int b = min(base + ((lohi >> 16) & 0xFFFF), nj);
    if (a >= b) continue;  // a lo == hi sentinel or padding entry
    float ent[kRows][DIM];
    zero(ent);
    add_range<float, DIM, SQRT3>(rows, mj, xj, a, b, eps, s_m, s_x, ent);
    add_to(rows.acc, ent);
  }
  rows.store(out);
}

template <typename T, int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads)
group_eval_kernel(const T* __restrict__ xi, int tb, const T* __restrict__ mj,
                  const T* __restrict__ xj, int L, int split, const int* __restrict__ n0,
                  const int* __restrict__ n1, T eps, T* __restrict__ out) {
  __shared__ T s_m[kChunk];
  __shared__ T s_x[DIM][kChunk];

  Rows<T, DIM> rows(xi, tb);
  const int t = blockIdx.x;
  const T* tile_m = mj + static_cast<size_t>(t) * L;
  const T* tile_x = xj + static_cast<size_t>(t) * L * DIM;
  // the live head of each segment: nodes [0, n0), leaf bodies [split, split + n1)
  add_range<T, DIM, SQRT3>(rows, tile_m, tile_x, 0, min(max(n0[t], 0), split), eps, s_m, s_x,
                           rows.acc);
  add_range<T, DIM, SQRT3>(rows, tile_m, tile_x, split, split + min(max(n1[t], 0), L - split), eps,
                           s_m, s_x, rows.acc);
  rows.store(out);
}

inline dim3 grid_for(int ntiles, int tb) {
  return dim3(static_cast<unsigned>(ntiles), static_cast<unsigned>((tb + kRowsPerBlock - 1) / kRowsPerBlock));
}

// The instantiation for the runtime dim (and softening), or nullptr.
template <typename Fn>
Fn pick(int dim, Fn d2, Fn d3) {
  return dim == 2 ? d2 : dim == 3 ? d3 : nullptr;
}

template <typename Fn>
Fn pick(int dim, int sqrt3, Fn poly2, Fn sqrt3_2, Fn poly3, Fn sqrt3_3) {
  if (sqrt3 != 0 && sqrt3 != 1) return nullptr;
  return pick(dim, sqrt3 ? sqrt3_2 : poly2, sqrt3 ? sqrt3_3 : poly3);
}

cudaError_t prepare(int device, int ntiles, int tb) {
  if (ntiles <= 0 || tb <= 0) return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

template <typename T>
cudaError_t launch_group_eval(int dim, int sqrt3, const void* xi, int ntiles, int tb, const void* mj,
                              const void* xj, int L, int split, const void* n0, const void* n1,
                              double eps, void* out, cudaStream_t stream) {
  const auto kernel = pick(dim, sqrt3, group_eval_kernel<T, 2, false>, group_eval_kernel<T, 2, true>,
                           group_eval_kernel<T, 3, false>, group_eval_kernel<T, 3, true>);
  if (kernel == nullptr || L < 0 || split < 0 || split > L) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, stream>>>(
      static_cast<const T*>(xi), tb, static_cast<const T*>(mj), static_cast<const T*>(xj), L, split,
      static_cast<const int*>(n0), static_cast<const int*>(n1), static_cast<T>(eps), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Each tile's own list: mj (ntiles, L) and xj (ntiles, L, dim) of `dtype`
// (0 float32, 1 float64), the same type as the rows xi (ntiles*tb, dim);
// n0 and n1 are int32 (ntiles,) live lengths of the list's two segments
// [0, split) and [split, L). Returns the cudaError_t of the launch.
extern "C" int nbody_group_eval(int device, int dtype, int dim, const void* xi, int ntiles, int tb,
                                const void* mj, const void* xj, int L, int split, const void* n0,
                                const void* n1, int sqrt3, double eps, void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_group_eval<float>(dim, sqrt3, xi, ntiles, tb, mj, xj, L, split, n0, n1, eps, out, s);
  if (dtype == 1) return launch_group_eval<double>(dim, sqrt3, xi, ntiles, tb, mj, xj, L, split, n0, n1, eps, out, s);
  return cudaErrorInvalidValue;
}

// Float32 only. Pointers are device pointers to contiguous arrays: xi
// (ntiles*tb, dim) rows, mj (nj,) and xj (nj, dim) sources, int32 index
// arrays. `sqrt3` picks the softening: 1 sqrt3, 0 poly. Each returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and nothing here synchronises.
extern "C" int nbody_masked_eval_bits(int device, int dim, const void* xi, int ntiles,
                                      int tb, const void* mj, const void* xj, int W,
                                      const void* words, int nw, int sqrt3, double eps,
                                      void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, sqrt3, masked_eval_bits_kernel<2, false>, masked_eval_bits_kernel<2, true>,
                           masked_eval_bits_kernel<3, false>, masked_eval_bits_kernel<3, true>);
  if (kernel == nullptr || W < 0 || nw != (W + 31) / 32) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), W,
      static_cast<const unsigned*>(words), nw, static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" int nbody_window_eval_interval(int device, int dim, const void* xi, int ntiles,
                                          int tb, const void* mj, const void* xj, int nj,
                                          const void* w0, const void* lo, const void* hi,
                                          int window_tiles, double eps, void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, window_eval_interval_kernel<2>, window_eval_interval_kernel<3>);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), nj,
      static_cast<const int*>(w0), static_cast<const int*>(lo), static_cast<const int*>(hi), window_tiles,
      static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" int nbody_window_eval_nodemask(int device, int dim, const void* xi, int ntiles,
                                          int tb, const void* mj, const void* xj, int nj,
                                          const void* w0, const void* in_win, int wnodes, int S,
                                          int sqrt3, double eps, void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, sqrt3, window_eval_nodemask_kernel<2, false>,
                           window_eval_nodemask_kernel<2, true>, window_eval_nodemask_kernel<3, false>,
                           window_eval_nodemask_kernel<3, true>);
  if (kernel == nullptr || wnodes <= 0 || S <= 0) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), nj,
      static_cast<const int*>(w0), static_cast<const unsigned char*>(in_win), wnodes, S,
      static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" int nbody_window_eval_dense(int device, int dim, const void* xi, int ntiles, int tb,
                                       const void* mj, const void* xj, int nj, const void* w0,
                                       const void* mask, int wb, int sqrt3, double eps, void* out,
                                       void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, sqrt3, window_eval_dense_kernel<2, false>, window_eval_dense_kernel<2, true>,
                           window_eval_dense_kernel<3, false>, window_eval_dense_kernel<3, true>);
  if (kernel == nullptr || wb <= 0) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), nj,
      static_cast<const int*>(w0), static_cast<const float*>(mask), wb, static_cast<float>(eps),
      static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" int nbody_entries_lohi_eval(int device, int dim, const void* xi, int ntiles,
                                       int tb, const void* mj, const void* xj, int nj,
                                       const void* entries, const void* lohis, const void* first,
                                       const void* last, int S, int sqrt3, double eps, void* out,
                                       void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, sqrt3, entries_lohi_kernel<2, false>, entries_lohi_kernel<2, true>,
                           entries_lohi_kernel<3, false>, entries_lohi_kernel<3, true>);
  if (kernel == nullptr || S <= 0) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), nj,
      static_cast<const int*>(entries), static_cast<const int*>(lohis), static_cast<const int*>(first),
      static_cast<const int*>(last), S, static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}
