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
// tile-local accumulator and adds it to the row total after the tile --
// the analog of the Pallas kernel's per-j-tile jnp.sum followed by
// out_ref +=. A single running sum over 2^20 same-signed terms would lose
// ~sqrt(n) ulps; two levels keep the error near sqrt(kThreads) +
// sqrt(n / kThreads) ulps of the sum of |term|.
//
// The ragged edges are masked here, not padded: rows past ni compute but do
// not store (they still take part in the tile loads and barriers), and the
// last tile loops only over the bodies that exist.

#include <cuda_runtime.h>

#include "pair.cuh"

namespace {

using nbody::root;

constexpr int kThreads = 256;  // rows per block, and bodies per shared tile

template <typename T, int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads)
allpairs_block_kernel(const T* __restrict__ xi, int ni,
                      const T* __restrict__ mj, const T* __restrict__ xj, int nj,
                      T eps, T scale, T* __restrict__ out) {
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
    T part[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) part[d] = T(0);
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      T dx[DIM];
      T d2 = T(0);
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        dx[d] = s_x[d][k] - p[d];
        d2 += dx[d] * dx[d];
      }
      const T w = nbody::pair_weight<T, SQRT3>(s_m[k], d2, eps);
#pragma unroll
      for (int d = 0; d < DIM; ++d) part[d] += w * dx[d];
    }
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc[d] += part[d];
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) out[static_cast<size_t>(i) * DIM + d] = scale * acc[d];
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
  allpairs_block_kernel<T, DIM, SQRT3><<<blocks_for(ni), kThreads, 0, stream>>>(
      static_cast<const T*>(xi), ni, static_cast<const T*>(mj), static_cast<const T*>(xj), nj,
      static_cast<T>(eps), static_cast<T>(scale), static_cast<T*>(out));
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
