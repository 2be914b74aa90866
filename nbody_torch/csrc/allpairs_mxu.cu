// The hybrid all-pairs kernel for Hopper (sm_90a): the two contractions of
// far tile pairs on the tensor cores, with a plain C interface that
// nbody_torch/ops/cuda_allpairs_mxu.py loads through ctypes.
//
// allpairs_mxu_kernel<DIM, FAST> replaces allpairs_accel_mxu
// (nbody_tpu/ops/pallas_allpairs_mxu.py:207, body _mxu_kernel :86-201) and
// computes its function, float32 only. Per (i-tile, j-tile) pair, over
// arrays padded as JAX pads them (npad bodies; those past n sit at the
// origin with m = 0, virtually: an index past the array reads as 0):
//   * the frame c = (mean(xi tile) + mean(xj tile)) / 2, the means over the
//     padded tiles (:103-108); y = x - c, z = |y|^2;
//   * d2 = zi + zj - 2 yi.yj, the augmented quadratic form (:116-128), in
//     FP32 FMA on the CUDA cores: JAX asks for Precision.HIGHEST there, and
//     TF32 or bf16 would lose the digits that the near test and the close
//     pairs depend on;
//   * near when min d2 <= near_factor * eps * (max zi + max zj) (:129-133):
//     the exact per-dimension chain on the RAW coordinates with the Newton
//     reciprocal (:135-159), in allpairs.cu's partial sums (pair.cuh
//     add_row_tile); JAX's d2 > 0 guard is implicit there, as a pair at
//     d2 = 0 has dx = 0;
//   * far otherwise: w = 1 / (d2^1.5 + eps) from the quadratic-form d2
//     (d2 clamped at 0, w = 0 where d2 = 0), the contraction
//     S = W @ [m yj, m] and the per-tile finalize a += S[:, :dim] - yi S[:, dim]
//     (:160-177);
//   * under FAST, far tiles with min d2 > far_thresh drop eps:
//     w = rsqrt(d2)^3, with W and [m yj, m] rounded to bf16 (:183-201).
//
// Precision of the contraction. JAX splits only W (_split_f32, :76-83) and
// hands [m yj, m] as float32 to a DEFAULT-precision product, which the TPU
// rounds to bf16 in one pass and the CPU's interpret mode does not. One
// bf16 pass on [m yj, m] costs ~2^-9 per element, above the accuracy that
// tests/test_mxu_kernel.py pins (max(4 err32, 6e-5) against float64). So
// both operands are split, W = Wh + Wl and B = Bh + Bl (each half bf16,
// the high half round-to-nearest-even as JAX's astype), and the far branch
// issues three MMAs, Wh Bh + Wh Bl + Wl Bh ("bf16x3"; the dropped Wl Bl is
// ~2^-16 relative). Under FAST one MMA of bf16(W) and bf16(B) is JAX's
// function exactly.
//
// Design (right and simple; wgmma, TMA and a pipeline are for a later
// change). One block per i-tile, tile_i / 2 threads: thread t owns rows t
// and t + tile_i / 2 (their positions and sums in registers), and warp w
// owns the four 16-row MMA groups of rows [64 w, 64 w + 64). A j-tile of
// positions and masses is staged in shared memory; the frame, z and the
// maxima come from block reductions, O(tile_i + tile_j) per tile pair. A
// first pass over the pairs takes the least d2; the near branch runs the
// exact chain per row owner; the far branch runs
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, each lane computing
// w for its A fragment's (row, body) slots in registers, the B operand
// [m yj, m] (dim + 1 columns, padded to 8 with zeros) built from shared
// memory, S accumulated in the MMA's float32 registers, then written to
// shared memory and finalized by the row owners.
//
// What bounds it on an H100: the scalar chain. Every pair costs the
// quadratic form twice (the minimum, then w), a square root, the
// reciprocal and its Newton step and the split: ~25 FP32 operations,
// against 48 bf16 tensor-core FLOPs as issued (three m16n8k16 products per
// 16 x 16 slots, n padded to 8): the FP32 rate (67 TFLOP/s) binds long
// before the tensor cores (989 TFLOP/s).
//
// fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A (16 x 16, row): a0,a1 (row g, k 2t, 2t+1), a2,a3 (row g+8, k 2t, 2t+1),
//                     a4,a5 (row g, k 2t+8, 2t+9), a6,a7 (row g+8, k 2t+8, 2t+9)
//   B (16 x 8, col):  b0,b1 (k 2t, 2t+1; n g), b2,b3 (k 2t+8, 2t+9; n g)
//   C (16 x 8):       c0,c1 (row g, n 2t, 2t+1), c2,c3 (row g+8, n 2t, 2t+1)
// each pair of bf16 in one 32-bit register, the lower index in the low half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair.cuh"

namespace {

constexpr int kMaxThreads = 512;  // tile_i <= 1024
constexpr int kGroupsPerWarp = 4;  // 16-row MMA groups per warp: 64 rows, tile_i / 2 threads

using nbody::block_reduce;
using nbody::Max;
using nbody::Min;
using nbody::Sum;

// d2 by the quadratic form in the tile pair's frame; one function for the
// minimum and for w, so both round alike.
template <int DIM>
__device__ __forceinline__ float quad_d2(const float* yi, float zi, const float* s_y, float zj,
                                         int k, int tile_j) {
  float d2 = zi + zj;
#pragma unroll
  for (int d = 0; d < DIM; ++d) d2 = fmaf(yi[d], -2.0f * s_y[d * tile_j + k], d2);
  return d2;
}

// w of a far pair: 1 / (d2^1.5 + eps) with d2 clamped at 0 and w = 0 at
// d2 = 0 (compute_w, :135-141); under FAR_FAST rsqrt(d2)^3 (:189-190).
template <bool FAR_FAST>
__device__ __forceinline__ float far_w(float d2, float eps) {
  if constexpr (FAR_FAST) {
    const float r = rsqrtf(d2);
    return r * r * r;
  } else {
    const float d2c = fmaxf(d2, 0.0f);
    const float r = nbody::newton_recip(d2c * sqrtf(d2c) + eps);
    return d2c > 0.0f ? r : 0.0f;
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// v = hi + lo, each rounded to bf16 (hi as _split_f32's astype, RNE)
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The far branch of one tile pair: this warp's four row groups against the
// staged j-tile, S written to s_S[row][8].
template <int DIM, bool FAR_FAST>
__device__ void far_contract(const float* s_m, const float* s_y, const float* s_z,
                             const float* s_yi, const float* s_zi, float* s_S, int tile_i,
                             int tile_j, float eps) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int base = (threadIdx.x >> 5) * kGroupsPerWarp * 16;
  float yr[kGroupsPerWarp][2][DIM], zr[kGroupsPerWarp][2];
  float c[kGroupsPerWarp][4];
#pragma unroll
  for (int q = 0; q < kGroupsPerWarp; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = base + q * 16 + g + 8 * h;
#pragma unroll
      for (int d = 0; d < DIM; ++d) yr[q][h][d] = s_yi[d * tile_i + row];
      zr[q][h] = s_zi[row];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[q][e] = 0.0f;
  }
  for (int kk = 0; kk < tile_j; kk += 16) {
    const int ks[4] = {kk + 2 * t, kk + 2 * t + 1, kk + 2 * t + 8, kk + 2 * t + 9};
    // B: column g of [m yj, m, 0...] at this lane's four bodies
    __nv_bfloat16 bh[4], bl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = ks[e];
      float bv = 0.0f;
      if (g < DIM) {
        bv = s_y[g * tile_j + k] * s_m[k];
      } else if (g == DIM) {
        bv = s_m[k];
      }
      split(bv, bh[e], bl[e]);
    }
    const uint32_t Bh[2] = {pack(bh[0], bh[1]), pack(bh[2], bh[3])};
    const uint32_t Bl[2] = {pack(bl[0], bl[1]), pack(bl[2], bl[3])};
#pragma unroll
    for (int q = 0; q < kGroupsPerWarp; ++q) {
      // w at (row g + 8h, body ks[e]); fragment register r holds
      // (h = r & 1, bodies ks[2 (r >> 1)], ks[2 (r >> 1) + 1])
      __nv_bfloat16 wh[2][4], wl[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = far_w<FAR_FAST>(
              quad_d2<DIM>(yr[q][h], zr[q][h], s_y, s_z[ks[e]], ks[e], tile_j), eps);
          if constexpr (FAR_FAST) {
            wh[h][e] = __float2bfloat16_rn(w);
          } else {
            split(w, wh[h][e], wl[h][e]);
          }
        }
      }
      const uint32_t Ah[4] = {pack(wh[0][0], wh[0][1]), pack(wh[1][0], wh[1][1]),
                              pack(wh[0][2], wh[0][3]), pack(wh[1][2], wh[1][3])};
      mma_bf16(c[q], Ah, Bh);
      if constexpr (!FAR_FAST) {
        const uint32_t Al[4] = {pack(wl[0][0], wl[0][1]), pack(wl[1][0], wl[1][1]),
                                pack(wl[0][2], wl[0][3]), pack(wl[1][2], wl[1][3])};
        mma_bf16(c[q], Ah, Bl);
        mma_bf16(c[q], Al, Bh);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kGroupsPerWarp; ++q) {
    const int row = base + q * 16 + g;
    s_S[row * 8 + 2 * t] = c[q][0];
    s_S[row * 8 + 2 * t + 1] = c[q][1];
    s_S[(row + 8) * 8 + 2 * t] = c[q][2];
    s_S[(row + 8) * 8 + 2 * t + 1] = c[q][3];
  }
}

size_t smem_bytes(int dim, int tile_i, int tile_j) {
  return sizeof(float) * (static_cast<size_t>(2 * dim + 2) * tile_j +
                          static_cast<size_t>(dim + 1 + 8) * tile_i);
}

template <int DIM, bool FAST>
__global__ void __launch_bounds__(kMaxThreads)
allpairs_mxu_kernel(const float* __restrict__ x, const float* __restrict__ m, int n, int npad,
                    int tile_i, int tile_j, float eps, float near_coef, float far_thresh,
                    float scale, float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ float smem[];
  __shared__ float s_red[32];
  float* s_x = smem;                 // [DIM][tile_j] raw positions
  float* s_m = s_x + DIM * tile_j;   // [tile_j]
  float* s_y = s_m + tile_j;         // [DIM][tile_j] in the frame
  float* s_z = s_y + DIM * tile_j;   // [tile_j]
  float* s_yi = s_z + tile_j;        // [DIM][tile_i]
  float* s_zi = s_yi + DIM * tile_i; // [tile_i]
  float* s_S = s_zi + tile_i;        // [tile_i][8]

  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lrow[2] = {tid, tid + nt};
  const int row0 = blockIdx.x * tile_i;
  float p[2][DIM], acc[2][DIM];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + lrow[r];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      p[r][d] = i < n ? x[static_cast<size_t>(i) * DIM + d] : 0.0f;
      acc[r][d] = 0.0f;
    }
  }
  float ci[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) ci[d] = block_reduce(p[0][d] + p[1][d], s_red, Sum()) / tile_i;

  for (int j0 = 0; j0 < npad; j0 += tile_j) {
    float sx[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) sx[d] = 0.0f;
    for (int k = tid; k < tile_j; k += nt) {
      const int j = j0 + k;
      const bool real = j < n;
      s_m[k] = real ? m[j] : 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float v = real ? x[static_cast<size_t>(j) * DIM + d] : 0.0f;
        s_x[d * tile_j + k] = v;
        sx[d] += v;
      }
    }
    float cen[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      cen[d] = 0.5f * (ci[d] + block_reduce(sx[d], s_red, Sum()) / tile_j);
    }
    // the frame: yj, zj (s_x is visible: block_reduce synchronised)
    float zj_max = 0.0f;
    for (int k = tid; k < tile_j; k += nt) {
      float z = 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float y = s_x[d * tile_j + k] - cen[d];
        s_y[d * tile_j + k] = y;
        z += y * y;
      }
      s_z[k] = z;
      zj_max = fmaxf(zj_max, z);
    }
    float yi[2][DIM], zi[2];
    float zi_max = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      zi[r] = 0.0f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        yi[r][d] = p[r][d] - cen[d];
        s_yi[d * tile_i + lrow[r]] = yi[r][d];
        zi[r] += yi[r][d] * yi[r][d];
      }
      s_zi[lrow[r]] = zi[r];
      zi_max = fmaxf(zi_max, zi[r]);
    }
    const float near_lim =
        near_coef * (block_reduce(zi_max, s_red, Max()) + block_reduce(zj_max, s_red, Max()));
    // pass 1: the least d2 of the tile pair
    float dmin = INFINITY;
    for (int k = 0; k < tile_j; ++k) {
      const float zj = s_z[k];
#pragma unroll
      for (int r = 0; r < 2; ++r) dmin = fminf(dmin, quad_d2<DIM>(yi[r], zi[r], s_y, zj, k, tile_j));
    }
    dmin = block_reduce(dmin, s_red, Min());
    const int branch = dmin <= near_lim ? 0 : (FAST && dmin > far_thresh ? 2 : 1);
    if (counts != nullptr && tid == 0) counts[3 * blockIdx.x + branch] += 1;
    if (branch == 0) {  // the exact chain on raw coordinates (pair.cuh add_row_tile)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        nbody::add_row_tile<float, DIM>(p[r], s_m, s_x, tile_j, nbody::NewtonWeight{eps}, acc[r]);
      }
    } else {
      if (branch == 2) {
        far_contract<DIM, true>(s_m, s_y, s_z, s_yi, s_zi, s_S, tile_i, tile_j, eps);
      } else {
        far_contract<DIM, false>(s_m, s_y, s_z, s_yi, s_zi, s_S, tile_i, tile_j, eps);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* S = s_S + lrow[r] * 8;
#pragma unroll
        for (int d = 0; d < DIM; ++d) acc[r][d] += S[d] - yi[r][d] * S[DIM];
      }
    }
    __syncthreads();  // the next tile overwrites the shared arrays
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + lrow[r];
    if (i < n) {
#pragma unroll
      for (int d = 0; d < DIM; ++d) out[static_cast<size_t>(i) * DIM + d] = scale * acc[r][d];
    }
  }
}

template <int DIM, bool FAST>
cudaError_t launch(const float* x, const float* m, int n, int npad, int tile_i, int tile_j,
                   float eps, float near_coef, float far_thresh, float scale, float* out,
                   int* counts, cudaStream_t stream) {
  const size_t smem = smem_bytes(DIM, tile_i, tile_j);
  cudaError_t err = cudaFuncSetAttribute(allpairs_mxu_kernel<DIM, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  allpairs_mxu_kernel<DIM, FAST>
      <<<static_cast<unsigned>(npad / tile_i), static_cast<unsigned>(tile_i / 2), smem, stream>>>(
          x, m, n, npad, tile_i, tile_j, eps, near_coef, far_thresh, scale, out, counts);
  return cudaGetLastError();
}

}  // namespace

// x: n rows of dim float32 values, m: n masses, out: n rows; device
// pointers. npad is JAX's padded count, a multiple of tile_i and tile_j;
// tile_i a multiple of 64 up to 1024, tile_j a multiple of 16. near_coef
// is near_factor * eps, rounded to float32 as JAX does. counts: null, or
// npad / tile_i triples of zeroed ints, which get each i-tile's near, far
// and far-fast j-tiles. Returns the launch's cudaError_t; nothing here synchronises.
extern "C" int nbody_allpairs_mxu(int device, int dim, int fast, const void* x, const void* m,
                                  int n, int npad, int tile_i, int tile_j, double eps,
                                  double near_coef, double far_thresh, double scale, void* out,
                                  void* counts, void* stream) {
  if (n <= 0 || tile_i < 64 || tile_i > 2 * kMaxThreads || tile_i % 64 != 0 || tile_j < 16 ||
      tile_j % 16 != 0 || npad < n || npad % tile_i != 0 || npad % tile_j != 0 ||
      smem_bytes(dim, tile_i, tile_j) > 227 * 1024) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(m);
  float* o = static_cast<float*>(out);
  int* c = static_cast<int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps), nc = static_cast<float>(near_coef);
  const float ft = static_cast<float>(far_thresh), sc = static_cast<float>(scale);
  if (dim == 2 && !fast) return launch<2, false>(xf, mf, n, npad, tile_i, tile_j, e, nc, ft, sc, o, c, s);
  if (dim == 2 && fast) return launch<2, true>(xf, mf, n, npad, tile_i, tile_j, e, nc, ft, sc, o, c, s);
  if (dim == 3 && !fast) return launch<3, false>(xf, mf, n, npad, tile_i, tile_j, e, nc, ft, sc, o, c, s);
  if (dim == 3 && fast) return launch<3, true>(xf, mf, n, npad, tile_i, tile_j, e, nc, ft, sc, o, c, s);
  return cudaErrorInvalidValue;
}
