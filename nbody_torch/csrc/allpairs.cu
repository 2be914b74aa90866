// All-pairs gravity kernels for Hopper (sm_90a), with a plain C interface
// that nbody_torch/ops/cuda_allpairs.py loads through ctypes.
//
// allpairs_block_kernel<T, DIM, SQRT3> replaces the Pallas functions
// allpairs_accel_pallas and allpairs_block_pallas
// (nbody_tpu/ops/pallas_allpairs.py, both run the body _allpairs_kernel).
// It computes raw accelerations of `ni` query rows xi against `nj` bodies
// (mj, xj), times `scale` (G for the square all-pairs force, 1 for a block):
//     out_i = scale * sum_j m_j * (x_j - x_i) / t
// with t the poly or sqrt3 softening of pair.cuh, whose pair_weight every
// kernel of csrc/ shares. The diagonal needs no mask: its numerator
// x_j - x_i is exactly zero.
//
// potential_rowsums_kernel<T, DIM> replaces potential_rowsums_pallas (body
// _pe_kernel): pe_i = m_i * sum_{j != i} m_j / (sqrt(d2) + eps). Here the
// diagonal term m_i / eps is not zero, so it is masked by global index.
//
// What bounds them on an H100: not bytes. Each pair costs ~20 FP32
// instructions plus two multi-function-unit operations (the reciprocal and
// square-root seeds of IEEE division and sqrt), against (DIM+1) values read
// once per block from device memory; the j-bodies are staged through shared
// memory and every thread reads the same shared word (a broadcast), so the
// kernel is bound by FP32 and SFU issue. The design keeps the per-pair work
// minimal: one thread per row, the row's position and its accumulators in
// registers, no cross-block reduction. Division and sqrt stay IEEE (no
// --use_fast_math): the softening adds eps ~ 1.19e-7 to d2*sqrt(d2), and
// approximate division changes exactly those close-pair terms.
//
// Summation: each thread sums one shared tile (kThreads bodies) into a
// tile-local partial and adds it to the row total after the tile
// (pair.cuh add_row_part, which the FAST body and allpairs_mxu.cu's near
// branch share).
//
// The ragged edges are masked here, not padded: rows past ni compute but do
// not store (they still take part in the tile loads and barriers), and the
// last tile loops only over the bodies that exist.
//
// Two template flags give the Pallas kernel's other variants, float32 only
// (the Pallas kernel was float32-only, pallas_allpairs.py:127-128):
//   NEWTON  the softened weight by the approximate reciprocal plus one
//           Newton step (exact=False, :79-84; pair.cuh newton_recip);
//   FAST    fast=True (:93-105): one decision per (i-tile, j-tile) pair. If
//           the least d2 over the tile's pairs exceeds far_thresh =
//           (eps / fast_tol)^(2/3), the tile takes the shorter rsqrt^3
//           chain without the softening, else the Newton-softened chain.
//           The tile is JAX's, tile_i rows by tile_j bodies, over the
//           square evaluation padded as allpairs_accel_pallas pads it
//           (bodies at the origin with m = 0, the padding virtual here: an
//           index past the array reads as 0).
//           Padded rows and bodies enter the tile's minimum, as they enter
//           JAX's jnp.min(d2), so kernel, twin and JAX take the same branch
//           on every tile. One block per i-tile, two rows per thread
//           (blockDim = tile_i / 2); each j-tile is staged whole in dynamic
//           shared memory; a first pass computes only d2 and a block-wide
//           minimum, a second the chosen chain. A unit of decision cheaper
//           than JAX's tile (a warp's rows against a shared chunk) would
//           take the short chain on more pairs; that is for a later change.

#include <cuda_runtime.h>
#include <math.h>

#include "pair.cuh"

namespace {

using nbody::root;

constexpr int kThreads = 256;  // rows per block, and bodies per shared tile

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

// The IEEE and NEWTON body: one thread per row, kThreads bodies per shared tile.
template <typename T, int DIM, bool SQRT3, bool NEWTON>
__device__ void row_sums(const T* __restrict__ xi, int ni, const T* __restrict__ mj,
                         const T* __restrict__ xj, int nj, T eps, T scale, T* __restrict__ out) {
  __shared__ T s_m[kThreads];
  __shared__ T s_x[DIM][kThreads];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < ni;
  T p[DIM];
  T acc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    p[d] = live ? xi[static_cast<size_t>(i) * DIM + d] : T(0);
    acc[d] = T(0);
  }

  for (int j0 = 0; j0 < nj; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < nj) {
      s_m[threadIdx.x] = mj[j];
#pragma unroll
      for (int d = 0; d < DIM; ++d) s_x[d][threadIdx.x] = xj[static_cast<size_t>(j) * DIM + d];
    }
    __syncthreads();

    const int len = min(kThreads, nj - j0);
    if constexpr (NEWTON) {
      static_assert(sizeof(T) == 4 && !SQRT3, "NEWTON is float32 and poly");
      nbody::add_row_part<T, DIM>(p, s_m, &s_x[0][0], kThreads, 0, len, nbody::NewtonWeight{eps},
                                  acc);
    } else {
      nbody::add_row_part<T, DIM>(p, s_m, &s_x[0][0], kThreads, 0, len,
                                  nbody::SoftenedWeight<T, SQRT3>{eps}, acc);
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) out[static_cast<size_t>(i) * DIM + d] = scale * acc[d];
  }
}

template <typename T, int DIM, bool SQRT3, bool NEWTON, bool FAST>
__global__ void __launch_bounds__(kThreads)
allpairs_block_kernel(const T* __restrict__ xi, int ni,
                      const T* __restrict__ mj, const T* __restrict__ xj, int nj,
                      T eps, T scale, T* __restrict__ out, int njp, int tile_j, T far_thresh,
                      int* __restrict__ counts) {
  if constexpr (FAST) {  // square: xi = xj, ni = nj, and njp the padded count
    static_assert(sizeof(T) == 4 && NEWTON && !SQRT3, "FAST is float32, Newton, poly");
    fast_tiles<DIM>(xi, mj, ni, njp, tile_j, eps, far_thresh, scale, out, counts);
  } else {
    row_sums<T, DIM, SQRT3, NEWTON>(xi, ni, mj, xj, nj, eps, scale, out);
  }
}

template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads)
potential_rowsums_kernel(const T* __restrict__ m, const T* __restrict__ x, int n,
                         T eps, T* __restrict__ out) {
  __shared__ T s_m[kThreads];
  __shared__ T s_x[DIM][kThreads];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  T p[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) p[d] = live ? x[static_cast<size_t>(i) * DIM + d] : T(0);
  T acc = T(0);

  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < n) {
      s_m[threadIdx.x] = m[j];
#pragma unroll
      for (int d = 0; d < DIM; ++d) s_x[d][threadIdx.x] = x[static_cast<size_t>(j) * DIM + d];
    }
    __syncthreads();

    const int len = min(kThreads, n - j0);
    T part = T(0);
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      T d2 = T(0);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const T dx = s_x[d][k] - p[d];
        d2 += dx * dx;
      }
      const T w = s_m[k] / (root(d2) + eps);
      part += (j0 + k == i) ? T(0) : w;  // global-index diagonal mask
    }
    acc += part;
    __syncthreads();
  }

  if (live) out[i] = m[i] * acc;
}

inline unsigned blocks_for(int rows) { return static_cast<unsigned>((rows + kThreads - 1) / kThreads); }

template <typename T, int DIM, bool SQRT3>
cudaError_t launch_block(const void* xi, int ni, const void* mj, const void* xj, int nj,
                         double eps, double scale, void* out, cudaStream_t stream) {
  allpairs_block_kernel<T, DIM, SQRT3, false, false><<<blocks_for(ni), kThreads, 0, stream>>>(
      static_cast<const T*>(xi), ni, static_cast<const T*>(mj), static_cast<const T*>(xj), nj,
      static_cast<T>(eps), static_cast<T>(scale), static_cast<T*>(out), nj, 0, T(0), nullptr);
  return cudaGetLastError();
}

// float32 poly, square (x against itself): NEWTON over kThreads-row
// blocks, or FAST over JAX's tiles (npad / tile_i blocks of tile_i / 2
// threads, a j-tile in shared memory).
template <int DIM>
cudaError_t launch_variant(int fast, const float* x, const float* m, int n, int npad, int tile_i,
                           int tile_j, float eps, float far_thresh, float scale, float* out,
                           int* counts, cudaStream_t stream) {
  if (!fast) {
    allpairs_block_kernel<float, DIM, false, true, false><<<blocks_for(n), kThreads, 0, stream>>>(
        x, n, m, x, n, eps, scale, out, n, 0, 0.0f, nullptr);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(tile_j) * (DIM + 1) * sizeof(float);
  if (tile_i < 64 || tile_i > 2 * kThreads || tile_i % 64 != 0 || tile_j <= 0 ||
      smem > 48 * 1024 || npad < n || npad % tile_i != 0 || npad % tile_j != 0) {
    return cudaErrorInvalidValue;
  }
  allpairs_block_kernel<float, DIM, false, true, true>
      <<<static_cast<unsigned>(npad / tile_i), static_cast<unsigned>(tile_i / 2), smem, stream>>>(
          x, n, m, x, n, eps, scale, out, npad, tile_j, far_thresh, counts);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_block(int dim, int sqrt3, const void* xi, int ni, const void* mj,
                           const void* xj, int nj, double eps, double scale, void* out,
                           cudaStream_t stream) {
  if (dim == 2 && !sqrt3) return launch_block<T, 2, false>(xi, ni, mj, xj, nj, eps, scale, out, stream);
  if (dim == 2 && sqrt3) return launch_block<T, 2, true>(xi, ni, mj, xj, nj, eps, scale, out, stream);
  if (dim == 3 && !sqrt3) return launch_block<T, 3, false>(xi, ni, mj, xj, nj, eps, scale, out, stream);
  if (dim == 3 && sqrt3) return launch_block<T, 3, true>(xi, ni, mj, xj, nj, eps, scale, out, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_potential(int dim, const void* m, const void* x, int n, double eps,
                               void* out, cudaStream_t stream) {
  const T* mt = static_cast<const T*>(m);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (dim == 2) {
    potential_rowsums_kernel<T, 2><<<blocks_for(n), kThreads, 0, stream>>>(mt, xt, n, static_cast<T>(eps), ot);
  } else if (dim == 3) {
    potential_rowsums_kernel<T, 3><<<blocks_for(n), kThreads, 0, stream>>>(mt, xt, n, static_cast<T>(eps), ot);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Pointers are device pointers to
// contiguous row-major arrays (x: n rows of dim values). Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and nothing here synchronises.
extern "C" int nbody_allpairs_block(int device, int dtype, int dim, int sqrt3,
                                    const void* xi, int ni, const void* mj, const void* xj,
                                    int nj, double eps, double scale, void* out, void* stream) {
  if (ni <= 0 || nj < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_block<float>(dim, sqrt3, xi, ni, mj, xj, nj, eps, scale, out, s);
  if (dtype == 1) return dispatch_block<double>(dim, sqrt3, xi, ni, mj, xj, nj, eps, scale, out, s);
  return cudaErrorInvalidValue;
}

// The float32 variants of the square evaluation (fast = 0: NEWTON, 1:
// FAST), x: n rows of dim values, m: n masses. npad is JAX's padded count
// (a multiple of tile_i and tile_j); only FAST reads it, the tiles and
// `counts`: null, or npad / tile_i pairs of zeroed ints, which get each
// i-tile's [softened, far] j-tiles. Returns the launch's cudaError_t, as
// nbody_allpairs_block.
extern "C" int nbody_allpairs_variant(int device, int dim, int fast, const void* x, const void* m,
                                      int n, int npad, int tile_i, int tile_j, double eps,
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
  if (dim == 2) return launch_variant<2>(fast, xf, mf, n, npad, tile_i, tile_j, e, ft, sc, o, c, s);
  if (dim == 3) return launch_variant<3>(fast, xf, mf, n, npad, tile_i, tile_j, e, ft, sc, o, c, s);
  return cudaErrorInvalidValue;
}

extern "C" int nbody_potential_rowsums(int device, int dtype, int dim, const void* m,
                                       const void* x, int n, double eps, void* out,
                                       void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_potential<float>(dim, m, x, n, eps, out, s);
  if (dtype == 1) return dispatch_potential<double>(dim, m, x, n, eps, out, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* nbody_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
