// All-pairs gravity kernels for Hopper (sm_90a), with a plain C interface
// that nbody_torch/ops/cuda_allpairs.py loads through ctypes.
//
// What they replace (nbody_tpu/ops/pallas_allpairs.py):
//   allpairs_block_kernel<T, DIM, R, Weight>  allpairs_accel_pallas (:113) and
//       allpairs_block_pallas (:181), whose body is _allpairs_kernel (:44-110):
//       raw accelerations of ni query rows xi against nj bodies (mj, xj),
//       times `scale` (G for the square force, 1 for a block),
//           out_i = scale * sum_j m_j * (x_j - x_i) / t,
//       t the poly (d2 sqrt(d2) + eps) or sqrt3 ((sqrt(d2) + eps)^3) softening;
//   potential_rowsums_kernel<T, DIM, R>  potential_rowsums_pallas (:255,
//       body _pe_kernel :224-250): pe_i = m_i * sum_{j != i} m_j / (sqrt(d2) + eps);
//   allpairs_fast_kernel<DIM>  allpairs_accel_pallas(fast=True) (:93-105);
//   split_sum_kernel<T>  the Pallas grid's sequential j axis, which adds each
//       j-tile into the same output block (out_ref +=, :107-108, :250).
//
// What bounds the force and the potential on an H100: operations, not bytes
// (each body is read once per row block; 2^20 bodies are 16 MB). Two floors:
//   - FLOPs: 5*dim + 3 a force pair (+1 under sqrt3), 3*dim + 3 a potential
//     pair, over 67 TFLOP/s (float32) or 34 (float64): 295 ms for the 2^20
//     3-D float32 force;
//   - the multi-function unit (MUFU), 16 operations a clock on each SM against
//     128 FP32 lanes: a pair needs a square root and a reciprocal, so at least
//     two MUFU operations, 1.0995e12 pairs * 2 / (132 * 16 * 1.98e9 /s) = 0.53 s
//     at 2^20, above the FLOP floor.
// The IEEE chain takes ~38 instructions a 3-D pair in SASS, most of them
// the sqrt and the division with their slow-path checks; one row a thread
// that reads a body's mass and each coordinate apart issues four shared
// loads a pair. This design:
//   - the two-MUFU chain (pair.cuh ChainWeight, which the entries, list and
//     window kernels of group_eval.cu share): d2 summed from the least normal
//     number (so a coincident pair has a finite weight and dx = 0, not
//     0 * inf), s = d2 * rsqrt.approx(d2), t = d2 * s + eps (poly) or
//     (s + eps)^3 (sqrt3), w = m * newton_recip(t): the approximate
//     reciprocal and one Newton step of pallas_allpairs.py:79-84
//     (exact=False, what nbody_tpu's CLI runs). 14 FP32 instructions and 2
//     MUFU a 3-D poly pair; the potential, w = m * newton_recip(s + eps),
//     12 and 2. In float64 (JAX's float64 paths divide exactly in jnp) the
//     MUFU seeds rsqrt.approx.f64 and rcp.approx.f64 (~20 bits) are
//     refined to within an ulp or two of IEEE sqrt and division: two
//     residual corrections of the root, s <- s + (y/2)(d2 - s^2), and two
//     of the quotient, q <- q + y (m - t q), each multiplying the relative
//     error by the seed's: 21 DP operations a 3-D poly pair. The IEEE
//     weight (pair.cuh SoftenedWeight) is an instantiation of the same
//     body, for exact=True;
//   - R rows a thread (kRows: float32 2, float64 1, the fastest of 2, 4, 8
//     and 1, 2, 4 on an H100, PERF.md), strided by blockDim.x so that row
//     loads and stores coalesce: each staged body feeds R pairs, and the R
//     chains are independent work;
//   - packed staging: a body is one 16-byte record, (x, y, z, m) or
//     (x, y, m, 0) (two 16-byte halves in float64), so one broadcast shared
//     load feeds a pair's operands;
//   - bodies split over blocks: blockIdx.y takes the bodies
//     [y * split_len, (y + 1) * split_len), so that a call with few rows (an
//     exact fallback of a few tiles) still fills the card. Each split writes
//     its rows' partial sums to its own slice of a scratch, and
//     split_sum_kernel adds the slices in split order: no atomics, so two
//     launches give the same bits. The wrapper's block_plan picks the row
//     blocks and the splits (one split for the 2^20 square call);
//   - the potential's diagonal: only a body tile that overlaps the block's
//     own rows takes the masked loop, as a branch uniform over the block.
// The potential takes the chain too, w = m * newton_recip(s + eps), although
// nbody_tpu's _pe_kernel takes an IEEE sqrt and a true division
// (pallas_allpairs.py:243-244): a departure from nbody_tpu's numerics, so
// that the potential runs at the force's MUFU floor; its error stays within
// the kernels' tolerance of the IEEE twin (1e-5 of |pe| in float32).
// Each row sums a staged tile of kPartBodies bodies into a partial and adds
// the partial to its total, as pair.cuh add_row_part argues. The ragged
// edges are masked, not padded: rows past ni compute but do not store, and
// the last tile of a split loops over the bodies that exist.

#include <cuda_runtime.h>
#include <math.h>

#include "pair.cuh"

namespace {

// ---------------------------------------------------------------------------
// the FAST variant (row 1f), one block per JAX i-tile

constexpr int kFastMaxRows = 512;  // the largest i-tile: 256 threads of 2 rows

// The FAST body: this block's i-tile of 2 * blockDim.x rows of x against
// every j-tile of the padded bodies [0, npad). counts: null, or two ints
// per i-tile, [softened, far] j-tiles, written by this block alone.
template <int DIM>
__device__ void fast_tiles(const float* __restrict__ x, const float* __restrict__ m, int n,
                           int npad, int tile_j, float eps, float far_thresh, float scale,
                           float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ float s_tile[];  // s_m[tile_j], then s_x[DIM][tile_j]
  __shared__ float s_red[32];
  float* s_m = s_tile;
  float* s_x = s_tile + tile_j;
  const int nt = blockDim.x;
  const int rows[2] = {static_cast<int>(blockIdx.x) * 2 * nt + static_cast<int>(threadIdx.x),
                       static_cast<int>(blockIdx.x) * 2 * nt + nt + static_cast<int>(threadIdx.x)};
  float p[2][DIM], acc[2][DIM];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      p[r][d] = rows[r] < n ? x[static_cast<size_t>(rows[r]) * DIM + d] : 0.0f;
      acc[r][d] = 0.0f;
    }
  }
  for (int j0 = 0; j0 < npad; j0 += tile_j) {
    for (int k = threadIdx.x; k < tile_j; k += nt) {
      const int j = j0 + k;
      const bool real = j < n;
      s_m[k] = real ? m[j] : 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) s_x[d * tile_j + k] = real ? x[static_cast<size_t>(j) * DIM + d] : 0.0f;
    }
    __syncthreads();
    float dmin = INFINITY;
    for (int k = 0; k < tile_j; ++k) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float dx[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) dx[d] = s_x[d * tile_j + k] - p[r][d];
        dmin = fminf(dmin, nbody::sep2<float, DIM>(dx));
      }
    }
    const bool far = nbody::block_reduce(dmin, s_red, nbody::Min()) > far_thresh;
    if (counts != nullptr && threadIdx.x == 0) counts[2 * blockIdx.x + (far ? 1 : 0)] += 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (far) {
        nbody::add_row_tile<float, DIM>(p[r], s_m, s_x, tile_j, nbody::FarWeight(), acc[r]);
      } else {
        nbody::add_row_tile<float, DIM>(p[r], s_m, s_x, tile_j, nbody::NewtonWeight{eps}, acc[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < n) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) out[static_cast<size_t>(rows[r]) * DIM + d] = scale * acc[r][d];
    }
  }
}

template <int DIM>
__global__ void __launch_bounds__(kFastMaxRows / 2)
allpairs_fast_kernel(const float* __restrict__ x, const float* __restrict__ m, int n, int npad,
                     int tile_j, float eps, float far_thresh, float scale,
                     float* __restrict__ out, int* __restrict__ counts) {
  fast_tiles<DIM>(x, m, n, npad, tile_j, eps, far_thresh, scale, out, counts);
}

// ---------------------------------------------------------------------------
// the force and the potential: one body over an interaction policy

constexpr int kRowThreads = 256;               // threads a block
constexpr int kTile = nbody::kPartBodies;      // bodies staged at once, one partial sum
// Rows a thread: R, the wrapper's ROWS (cuda_allpairs.py).
template <typename T>
constexpr int kRows = sizeof(T) == 4 ? 2 : 1;

// One staged body: (x, y, z, m) in 3-D, (x, y, m, 0) in 2-D.
template <typename T>
struct alignas(16) Body {
  T c[4];
};

template <typename T, int DIM>
__device__ __forceinline__ Body<T> load_body(const T* __restrict__ m, const T* __restrict__ x,
                                             int j) {
  Body<T> b;
#pragma unroll
  for (int d = 0; d < DIM; ++d) b.c[d] = x[static_cast<size_t>(j) * DIM + d];
  b.c[DIM] = m[j];
  if constexpr (DIM == 2) b.c[3] = T(0);
  return b;
}

using nbody::chain_div;
using nbody::chain_root;
using nbody::ChainWeight;
using nbody::least_normal;
using nbody::sep2_from;

// Where a weight's d2 sum starts: the chain's at the least normal number,
// the IEEE weight's at 0, as every kernel of csrc/ sums it.
template <typename T, bool SQRT3>
__device__ __forceinline__ T d2_start(const ChainWeight<T, SQRT3>&) { return least_normal(T(0)); }
template <typename T, bool SQRT3>
__device__ __forceinline__ T d2_start(const nbody::SoftenedWeight<T, SQRT3>&) { return T(0); }

// The interaction policies: kWidth accumulators a row; kSkipsSelf masks
// the pair j == i (on the tiles that hold the block's own rows).
template <typename T, int DIM, class Weight>
struct ForcePair {
  static constexpr int kWidth = DIM;
  static constexpr bool kSkipsSelf = false;
  Weight weight;
  __device__ __forceinline__ void add(const T* p, const Body<T>& b, bool, T* part) const {
    T dx[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dx[d] = b.c[d] - p[d];
    const T w = weight(b.c[DIM], sep2_from<T, DIM>(d2_start(weight), dx));
#pragma unroll
    for (int d = 0; d < DIM; ++d) part[d] += w * dx[d];
  }
};

template <typename T, int DIM>
struct PotentialPair {
  static constexpr int kWidth = 1;
  static constexpr bool kSkipsSelf = true;
  T eps;
  __device__ __forceinline__ void add(const T* p, const Body<T>& b, bool self, T* part) const {
    T dx[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dx[d] = b.c[d] - p[d];
    const T w = chain_div(b.c[DIM], chain_root(sep2_from<T, DIM>(least_normal(T(0)), dx)) + eps);
    part[0] += self ? T(0) : w;
  }
};

template <typename T>
struct RowArgs {
  const T* xi;
  int ni;
  const T* mj;
  const T* xj;
  int nj;
  int split_len;  // bodies a split (blockIdx.y); a multiple of kTile
  T eps;
  T scale;        // out = scale * sum, or, with mi, mi[i] * sum
  const T* mi;
  T* out;         // (gridDim.y, ni, kWidth): split y writes slice y
};

// One staged tile of len bodies (global index j0 + k) into the R rows'
// partials, then into their totals. MASKED skips j0 + k == row[r].
template <typename T, int DIM, int R, bool MASKED, class Pair>
__device__ __forceinline__ void add_tile(const T (&p)[R][DIM], const Body<T>* s_body, int len,
                                         int j0, const int (&row)[R], const Pair& pair,
                                         T (&acc)[R][Pair::kWidth]) {
  constexpr int W = Pair::kWidth;
  T part[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int w = 0; w < W; ++w) part[r][w] = T(0);
  }
#pragma unroll 2
  for (int k = 0; k < len; ++k) {
    const Body<T> b = s_body[k];
#pragma unroll
    for (int r = 0; r < R; ++r) pair.add(p[r], b, MASKED && j0 + k == row[r], part[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[r][w] += part[r][w];
  }
}

// This block's R * kRowThreads rows against its split's bodies.
template <typename T, int DIM, int R, class Pair>
__device__ __forceinline__ void row_block(const RowArgs<T>& a, const Pair& pair) {
  constexpr int W = Pair::kWidth;
  __shared__ Body<T> s_body[kTile];
  const int first = static_cast<int>(blockIdx.x) * R * kRowThreads;
  int row[R];
  T p[R][DIM];
  T acc[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = first + r * kRowThreads + static_cast<int>(threadIdx.x);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      p[r][d] = row[r] < a.ni ? a.xi[static_cast<size_t>(row[r]) * DIM + d] : T(0);
    }
#pragma unroll
    for (int w = 0; w < W; ++w) acc[r][w] = T(0);
  }
  const int j_begin = static_cast<int>(blockIdx.y) * a.split_len;
  const int j_end = min(a.nj, j_begin + a.split_len);
  for (int j0 = j_begin; j0 < j_end; j0 += kTile) {
    const int len = min(kTile, j_end - j0);
    for (int k = threadIdx.x; k < len; k += kRowThreads) {
      s_body[k] = load_body<T, DIM>(a.mj, a.xj, j0 + k);
    }
    __syncthreads();
    if constexpr (Pair::kSkipsSelf) {
      if (j0 < first + R * kRowThreads && first < j0 + len) {  // uniform over the block
        add_tile<T, DIM, R, true>(p, s_body, len, j0, row, pair, acc);
      } else {
        add_tile<T, DIM, R, false>(p, s_body, len, j0, row, pair, acc);
      }
    } else {
      add_tile<T, DIM, R, false>(p, s_body, len, j0, row, pair, acc);
    }
    __syncthreads();
  }
  T* out = a.out + static_cast<size_t>(blockIdx.y) * a.ni * W;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row[r] < a.ni) {
      const T f = a.mi != nullptr ? a.mi[row[r]] : a.scale;
#pragma unroll
      for (int w = 0; w < W; ++w) out[static_cast<size_t>(row[r]) * W + w] = f * acc[r][w];
    }
  }
}

template <typename T, int DIM, int R, class Weight>
__global__ void __launch_bounds__(kRowThreads) allpairs_block_kernel(RowArgs<T> a) {
  row_block<T, DIM, R>(a, ForcePair<T, DIM, Weight>{Weight{a.eps}});
}

template <typename T, int DIM, int R>
__global__ void __launch_bounds__(kRowThreads) potential_rowsums_kernel(RowArgs<T> a) {
  row_block<T, DIM, R>(a, PotentialPair<T, DIM>{a.eps});
}

// out[k] = f * sum_{s < splits} parts[s * count + k], the splits added in
// order; f = mi[k / width] with mi, else scale.
template <typename T>
__global__ void split_sum_kernel(const T* __restrict__ parts, int splits, int count, int width,
                                 T scale, const T* __restrict__ mi, T* __restrict__ out) {
  const int k = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (k >= count) return;
  T v = parts[k];
  for (int s = 1; s < splits; ++s) v += parts[static_cast<size_t>(s) * count + k];
  out[k] = (mi != nullptr ? mi[k / width] : scale) * v;
}

// ---------------------------------------------------------------------------
// launches

template <typename T, int DIM>
cudaError_t launch_rows(int kind, int sqrt3, int exact, int blocks, int splits,
                        const RowArgs<T>& a, cudaStream_t stream) {
  using nbody::SoftenedWeight;
  constexpr int R = kRows<T>;
  const dim3 grid(blocks, splits);
  if (kind == 1) {
    potential_rowsums_kernel<T, DIM, R><<<grid, kRowThreads, 0, stream>>>(a);
  } else if (exact && sqrt3) {
    allpairs_block_kernel<T, DIM, R, SoftenedWeight<T, true>><<<grid, kRowThreads, 0, stream>>>(a);
  } else if (exact) {
    allpairs_block_kernel<T, DIM, R, SoftenedWeight<T, false>><<<grid, kRowThreads, 0, stream>>>(a);
  } else if (sqrt3) {
    allpairs_block_kernel<T, DIM, R, ChainWeight<T, true>><<<grid, kRowThreads, 0, stream>>>(a);
  } else {
    allpairs_block_kernel<T, DIM, R, ChainWeight<T, false>><<<grid, kRowThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// The row blocks must cover [0, ni) with none empty: ceil(ni / (R * 256)).
template <typename T>
cudaError_t rows_call(int dim, int kind, int sqrt3, int exact, const void* xi, int ni,
                      const void* mj, const void* xj, int nj, int blocks, int splits,
                      int split_len, double eps, double scale, const void* mi, void* out,
                      cudaStream_t stream) {
  if (blocks != (ni + kRows<T> * kRowThreads - 1) / (kRows<T> * kRowThreads)) {
    return cudaErrorInvalidValue;
  }
  const RowArgs<T> a{static_cast<const T*>(xi), ni, static_cast<const T*>(mj),
                     static_cast<const T*>(xj), nj, split_len, static_cast<T>(eps),
                     static_cast<T>(scale), static_cast<const T*>(mi), static_cast<T*>(out)};
  if (dim == 2) return launch_rows<T, 2>(kind, sqrt3, exact, blocks, splits, a, stream);
  if (dim == 3) return launch_rows<T, 3>(kind, sqrt3, exact, blocks, splits, a, stream);
  return cudaErrorInvalidValue;
}

// float32 poly, square (x against itself), fast=True over JAX's tiles
// (npad / tile_i blocks of tile_i / 2 threads, a j-tile in shared memory).
template <int DIM>
cudaError_t launch_fast(const float* x, const float* m, int n, int npad, int tile_i, int tile_j,
                        float eps, float far_thresh, float scale, float* out, int* counts,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile_j) * (DIM + 1) * sizeof(float);
  if (tile_i < 64 || tile_i > kFastMaxRows || tile_i % 64 != 0 || tile_j <= 0 ||
      smem > 48 * 1024 || npad < n || npad % tile_i != 0 || npad % tile_j != 0) {
    return cudaErrorInvalidValue;
  }
  allpairs_fast_kernel<DIM>
      <<<static_cast<unsigned>(npad / tile_i), static_cast<unsigned>(tile_i / 2), smem, stream>>>(
          x, m, n, npad, tile_j, eps, far_thresh, scale, out, counts);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64; kind: 0 = force, 1 = potential (xi = xj,
// ni = nj; sqrt3 and exact ignored); exact: 1 = IEEE weight, 0 = the chain.
// The grid is `blocks` row blocks of R * 256 rows (R = 2 in float32, 1 in
// float64; blocks must be ceil(ni / (R * 256))) by `splits` body ranges of
// split_len bodies (a multiple of 256 covering nj). out: (splits, ni, width) with width = dim
// (force) or 1 (potential); each value is f * sum, f = mi[i] with mi,
// else scale. Pointers are device pointers to contiguous row-major arrays.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream` and nothing here synchronises.
extern "C" int nbody_allpairs_rows(int device, int dtype, int dim, int kind, int sqrt3,
                                   int exact, const void* xi, int ni, const void* mj,
                                   const void* xj, int nj, int blocks, int splits,
                                   int split_len, double eps, double scale, const void* mi,
                                   void* out, void* stream) {
  if (ni <= 0 || nj < 0 || splits < 1 || splits > 65535 ||
      split_len < kTile || split_len % kTile != 0 ||
      static_cast<long long>(splits) * split_len < nj ||
      (splits > 1 && static_cast<long long>(splits - 1) * split_len >= nj)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return rows_call<float>(dim, kind, sqrt3, exact, xi, ni, mj, xj, nj, blocks, splits,
                            split_len, eps, scale, mi, out, s);
  }
  if (dtype == 1) {
    return rows_call<double>(dim, kind, sqrt3, exact, xi, ni, mj, xj, nj, blocks, splits,
                             split_len, eps, scale, mi, out, s);
  }
  return cudaErrorInvalidValue;
}

// out[k] = f * sum_{s < splits} parts[s * count + k] in split order, f =
// mi[k / width] with mi, else scale (parts: splits * count values).
// Returns the launch's cudaError_t, as nbody_allpairs_rows.
extern "C" int nbody_split_sum(int device, int dtype, const void* parts, int splits, int count,
                               int width, double scale, const void* mi, void* out,
                               void* stream) {
  if (splits < 1 || count <= 0 || width < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  if (dtype == 0) {
    split_sum_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(parts), splits, count, width, static_cast<float>(scale),
        static_cast<const float*>(mi), static_cast<float*>(out));
  } else if (dtype == 1) {
    split_sum_kernel<double><<<blocks, 256, 0, s>>>(
        static_cast<const double*>(parts), splits, count, width, scale,
        static_cast<const double*>(mi), static_cast<double*>(out));
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// fast=True of the float32 square evaluation, x: n rows of dim values, m:
// n masses. npad is JAX's padded count (a multiple of tile_i and tile_j);
// counts: null, or npad / tile_i pairs of zeroed ints, which get each
// i-tile's [softened, far] j-tiles. Returns the launch's cudaError_t.
extern "C" int nbody_allpairs_fast(int device, int dim, const void* x, const void* m, int n,
                                   int npad, int tile_i, int tile_j, double eps,
                                   double far_thresh, double scale, void* out, void* counts,
                                   void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int* c = static_cast<int*>(counts);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(m);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps), ft = static_cast<float>(far_thresh);
  const float sc = static_cast<float>(scale);
  if (dim == 2) return launch_fast<2>(xf, mf, n, npad, tile_i, tile_j, e, ft, sc, o, c, s);
  if (dim == 3) return launch_fast<3>(xf, mf, n, npad, tile_i, tile_j, e, ft, sc, o, c, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* nbody_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
