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
//   allpairs_block_kernel<float, DIM, 2, TableWeight>  ("<float32, fast>")
//       allpairs_accel_pallas(fast=True) (:93-105): each (i-tile, j-tile)
//       pair of JAX's tiling takes m rsqrt(d2)^3 where its least d2 exceeds
//       far_thresh, else the softened weight;
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
// the partial to its total, as pair.cuh kPartBodies argues. The ragged
// edges are masked, not padded: rows past ni compute but do not store, and
// the last tile of a split loops over the bodies that exist.
//
// The fast variant is a weight policy of the same body (TableWeight). A
// block-for-block port of the Pallas body takes each tile pair's least d2
// in a pass over all its pairs before the sum (~7 operations a pair over
// every pair; 1.23 s at 2^20 on an H100 with IEEE division on the softened
// tiles). Here tile_decide.cu decides every tile pair before the launch
// (an (ni, nj) int8 table: 0 softened, 1 far; the boxes settle most of
// them, an exact pass the rest), and each 256-body stage looks its rows'
// branches up: a stage lies inside one j-tile (a
// stage ends where a j-tile does) and a warp's 32 rows inside one i-tile
// (tile_i a multiple of 32), so the policy is uniform over a warp, and over
// the block at tile_i a multiple of 256 (JAX's 512: a block of 2 rows a
// thread is one i-tile). Softened stages take ChainWeight, the two-MUFU
// Newton chain that exact=False JAX runs (:79-84); far stages take FarWeight,
// (m r) (r r) with r = rsqrt.approx(d2) in JAX's product order (:101): one
// MUFU a pair, and no clamp (a far tile's every d2 exceeds far_thresh > 0).
// Splits, partials and packed staging are the Newton kernel's; its own
// instantiations do not change.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "pair.cuh"

namespace {

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
  static constexpr bool kTable = false;
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
  static constexpr bool kTable = false;
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
  // the fast variant (TableWeight) only: the (ni / tile_i, ntj) branches
  const signed char* table;
  int tile_i;
  int tile_j;
  int ntj;
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

// The fast variant's far weight, m rsqrt(d2)^3 in JAX's order (m r) (r r)
// (pallas_allpairs.py:98-101), r by one MUFU operation; d2 > far_thresh > 0.
struct FarWeight {
  float eps;  // unused: the far branch drops the softening
  __device__ __forceinline__ float operator()(float m, float d2) const {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d2));
    return (m * r) * (r * r);
  }
};
__device__ __forceinline__ float d2_start(const FarWeight&) { return 0.0f; }

// The fast variant (allpairs_accel_pallas(fast=True)): each stage's weight
// from the decision table (tile_decide.cu), per row; row_block calls
// table_stage in place of add_tile.
struct TableWeight {};
template <int DIM>
struct TablePair {
  static constexpr int kWidth = DIM;
  static constexpr bool kSkipsSelf = false;
  static constexpr bool kTable = true;
};

// One stage (inside one j-tile) by the branch of each row's tile pair: the
// R rows together where their branches agree (always where tile_i is a
// multiple of R * 256, JAX's 512 among them), else row by row. Every
// branch is uniform over a warp.
template <int DIM, int R>
__device__ __forceinline__ void table_stage(const RowArgs<float>& a, const float (&p)[R][DIM],
                                            const Body<float>* s_body, int len, int j0,
                                            const int (&row)[R], float (&acc)[R][DIM]) {
  const ForcePair<float, DIM, ChainWeight<float, false>> soft{{a.eps}};
  const ForcePair<float, DIM, FarWeight> far{{a.eps}};
  const signed char* col = a.table + j0 / a.tile_j;
  bool is_far[R];
  bool same = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // rows past ni compute and are not stored: any tile pair's branch will do
    is_far[r] = col[static_cast<size_t>(min(row[r], a.ni - 1) / a.tile_i) * a.ntj] != 0;
    same = same && is_far[r] == is_far[0];
  }
  if (same) {
    if (is_far[0]) {
      add_tile<float, DIM, R, false>(p, s_body, len, j0, row, far, acc);
    } else {
      add_tile<float, DIM, R, false>(p, s_body, len, j0, row, soft, acc);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float(&pr)[1][DIM] = reinterpret_cast<const float(&)[1][DIM]>(p[r]);
    float(&ar)[1][DIM] = reinterpret_cast<float(&)[1][DIM]>(acc[r]);
    const int(&rr)[1] = reinterpret_cast<const int(&)[1]>(row[r]);
    if (is_far[r]) {
      add_tile<float, DIM, 1, false>(pr, s_body, len, j0, rr, far, ar);
    } else {
      add_tile<float, DIM, 1, false>(pr, s_body, len, j0, rr, soft, ar);
    }
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
  for (int j0 = j_begin; j0 < j_end;) {
    int len = min(kTile, j_end - j0);
    if constexpr (Pair::kTable) len = min(len, a.tile_j - j0 % a.tile_j);  // one j-tile a stage
    for (int k = threadIdx.x; k < len; k += kRowThreads) {
      s_body[k] = load_body<T, DIM>(a.mj, a.xj, j0 + k);
    }
    __syncthreads();
    if constexpr (Pair::kTable) {
      table_stage<DIM, R>(a, p, s_body, len, j0, row, acc);
    } else if constexpr (Pair::kSkipsSelf) {
      if (j0 < first + R * kRowThreads && first < j0 + len) {  // uniform over the block
        add_tile<T, DIM, R, true>(p, s_body, len, j0, row, pair, acc);
      } else {
        add_tile<T, DIM, R, false>(p, s_body, len, j0, row, pair, acc);
      }
    } else {
      add_tile<T, DIM, R, false>(p, s_body, len, j0, row, pair, acc);
    }
    __syncthreads();
    j0 += Pair::kTable ? len : kTile;
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
  if constexpr (std::is_same_v<Weight, TableWeight>) {
    row_block<T, DIM, R>(a, TablePair<DIM>{});
  } else {
    row_block<T, DIM, R>(a, ForcePair<T, DIM, Weight>{Weight{a.eps}});
  }
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
                     static_cast<T>(scale), static_cast<const T*>(mi), static_cast<T*>(out),
                     nullptr, 0, 0, 0};
  if (dim == 2) return launch_rows<T, 2>(kind, sqrt3, exact, blocks, splits, a, stream);
  if (dim == 3) return launch_rows<T, 3>(kind, sqrt3, exact, blocks, splits, a, stream);
  return cudaErrorInvalidValue;
}

// float32, the fast variant: ni rows of x against the nj = ni bodies by the
// table's branches (RowArgs::table).
template <int DIM>
cudaError_t launch_fast(int blocks, int splits, const RowArgs<float>& a, cudaStream_t stream) {
  allpairs_block_kernel<float, DIM, kRows<float>, TableWeight>
      <<<dim3(blocks, splits), kRowThreads, 0, stream>>>(a);
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

// fast=True of the float32 square evaluation (x: n rows of dim values, m:
// n masses) over the plan of nbody_allpairs_rows (blocks of 512 rows by
// splits; out as there, scale G). table: the (npad / tile_i, ntj) int8
// branches of JAX's tiles (nbody_tile_decide, fast mode: 0 softened, 1
// far); tile_i a multiple of 32. Returns the launch's cudaError_t.
extern "C" int nbody_allpairs_fast(int device, int dim, const void* x, const void* m, int n,
                                   int blocks, int splits, int split_len, const void* table,
                                   int tile_i, int tile_j, int ntj, double eps, double scale,
                                   void* out, void* stream) {
  if (n <= 0 || splits < 1 || splits > 65535 || split_len < kTile || split_len % kTile != 0 ||
      static_cast<long long>(splits) * split_len < n ||
      (splits > 1 && static_cast<long long>(splits - 1) * split_len >= n) ||
      blocks != (n + kRows<float> * kRowThreads - 1) / (kRows<float> * kRowThreads) ||
      tile_i <= 0 || tile_i % 32 != 0 || tile_j <= 0 ||
      static_cast<long long>(ntj) * tile_j < n) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(x);
  const RowArgs<float> a{xf, n, static_cast<const float*>(m), xf, n, split_len,
                         static_cast<float>(eps), static_cast<float>(scale), nullptr,
                         static_cast<float*>(out), static_cast<const signed char*>(table),
                         tile_i, tile_j, ntj};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) return launch_fast<2>(blocks, splits, a, s);
  if (dim == 3) return launch_fast<3>(blocks, splits, a, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* nbody_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
