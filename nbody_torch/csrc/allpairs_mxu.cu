// The hybrid all-pairs kernel for Hopper (sm_90a): the two contractions of
// far tile pairs on the tensor cores, with a plain C interface that
// nbody_torch/ops/cuda_allpairs_mxu.py loads through ctypes.
//
// allpairs_mxu_kernel<DIM, FAST> replaces allpairs_accel_mxu
// (nbody_tpu/ops/pallas_allpairs_mxu.py:207, body _mxu_kernel :86-201) and
// computes its function, float32 only. Per (i-tile, j-tile) pair, over
// arrays padded as JAX pads them (npad bodies; those past n sit at the
// origin with m = 0):
//   * the frame c = (mean(xi tile) + mean(xj tile)) / 2, the means over the
//     padded tiles (:103-108); y = x - c, z = |y|^2;
//   * d2 = zi + zj - 2 yi.yj, the augmented quadratic form (:116-128), in
//     FP32 FMA on the CUDA cores: JAX asks for Precision.HIGHEST there, and
//     TF32 or bf16 would lose the digits that the close pairs depend on;
//   * near when min d2 <= near_factor * eps * (max zi + max zj) (:129-133):
//     the two-MUFU chain on the RAW coordinates (:135-159; pair.cuh
//     ChainWeight, as the Newton all-pairs kernel); JAX's d2 > 0 guard is
//     implicit there, as d2 starts at the least normal number;
//   * far otherwise: w = 1 / (d2^1.5 + eps) from the quadratic-form d2, the
//     contraction S = W @ [m yj, m] and the per-tile finalize a += S[:, :dim]
//     - yi S[:, dim] (:160-177);
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
// What bounds it on an H100: the scalar chain, not the tensor cores. A far
// pair needs the form (an add and dim FMAs), the root and the reciprocal
// (2 MUFU) with the Newton step, and the split: ~12 FP32-pipe instructions
// and 2 MUFU, so the MUFU floor, 1.1e12 pairs * 2 / (132 * 16 * 1.98e9 /s)
// = 0.53 s at 2^20, binds; a far-fast pair ~7 and one MUFU (floor 0.26 s);
// the MMAs, three m16n8k16 per 16 x 16 pairs (one under far-fast), stay
// well below the tensor cores' rate. What a block-for-block port of the
// Pallas body pays on top (measured 2.18 s at 2^20 on an H100): the
// quadratic form twice a pair (the minimum, then w), an IEEE sqrt, a clamp
// and a select a pair, dim + 3 block reductions and an S round trip
// through shared memory on every j-tile, two float-to-bf16 conversions an
// element, and 105-128 registers with spills. This design:
//   - the branch of each tile pair comes from tile_decide.cu's table, and
//     the frame's means from its per-tile statistics, computed once: no pass
//     over the pairs and no block reduction here;
//   - one block of 32 rows a warp (two 16-row MMA groups a warp), as many
//     rows as gcd(tile_i, 256), so a block lies inside one i-tile and its
//     branch and frame are uniform; a j-tile is staged 256 bodies at a time,
//     as (y, z) in the frame and the B operand already split into bf16
//     columns (far), or as raw (x, m) (near);
//   - the lane's rows in registers as -2 y (the -2 is a power of two:
//     exact) and z, so d2 = zi + zj + sum_d (-2 yi_d) yj_d is an add and dim
//     FMAs; far w by the chain (s = d2 rsqrt.approx(d2), t = d2 s + eps,
//     w = newton_recip(t)) with no clamp and no select (a far tile's every
//     d2 exceeds the near limit, > 0); far-fast w = r r r, r =
//     rsqrt.approx(d2), JAX's (r r) r;
//   - W split two values an instruction (cvt.rn.bf16x2.f32), the low halves
//     from the high halves read back as float32 (a shift or a mask);
//   - the finalize from the MMA's C fragments in registers: the S0 column
//     comes to the lane that holds the S1 columns by one quad shuffle, and
//     each row's sums live in shared memory (the near chain adds to the same
//     row there; sums are written once at the end).
// mma.sync m16n8k16 stays: the tensor cores are not the limit.
//
// fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), lane = 4 g + t:
//   A (16 x 16, row): a0,a1 (row g, k 2t, 2t+1), a2,a3 (row g+8, k 2t, 2t+1),
//                     a4,a5 (row g, k 2t+8, 2t+9), a6,a7 (row g+8, k 2t+8, 2t+9)
//   B (16 x 8, col):  b0,b1 (k 2t, 2t+1; n g), b2,b3 (k 2t+8, 2t+9; n g)
//   C (16 x 8):       c0,c1 (row g, n 2t, 2t+1), c2,c3 (row g+8, n 2t, 2t+1)
// each pair of bf16 in one 32-bit register, the lower index in the low half.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair.cuh"

namespace {

constexpr int kMaxRows = 256;              // rows a block at most: gcd(tile_i, 256)
constexpr int kStage = nbody::kPartBodies;  // bodies staged at once
constexpr int kCols = 8;                   // the MMA's n: [m yj, m] and zero columns
constexpr int kNear = 0, kFar = 1, kFarFast = 2;

struct MxuArgs {
  const float* x;
  const float* m;
  int n;
  int tile_i;
  int tile_j;
  int ni;                    // i-tiles: stats' first ni rows
  int ntj;                   // j-tiles of the table
  const signed char* table;  // (ni, ntj) branches (tile_decide.cu)
  const float* stats;        // (ni + ntj) x [lo, hi, mean] x DIM (tile_decide.cu)
  float eps;
  float scale;
  float* out;
};

// One staged body: (x, m) raw, or (y, z) in the frame; (x, y, z, m) in 3-D,
// (x, y, m, 0) in 2-D.
struct alignas(16) Vec4 {
  float c[4];
};

// two floats as bf16, rounded to nearest even, in one word: lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ float low_half(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high_half(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (a, b) = hi + lo: hi their bf16 roundings, lo the roundings of the
// (exact) remainders; each pair in one word, a in the low half.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = bf16x2(a, b);
  lo = bf16x2(a - low_half(hi), b - high_half(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// w of a far pair: 1 / (d2^1.5 + eps) by the chain (compute_w, :135-141; no
// clamp, d2 > 0 here); under FAR_FAST rsqrt(d2)^3 (:189-190).
template <bool FAR_FAST>
__device__ __forceinline__ float far_w(float d2, float eps) {
  const float r = rsqrt_approx(d2);
  if constexpr (FAR_FAST) {
    return r * r * r;
  } else {
    return nbody::newton_recip(d2 * (d2 * r) + eps);
  }
}

// The lane's four rows (groups q = 0, 1; g + 8h) in the tile pair's frame.
template <int DIM>
struct FarRows {
  float m2y[2][2][DIM];  // -2 y
  float z[2][2];
};

// One far stage of len bodies into this warp's C fragments.
template <int DIM, bool FAR_FAST>
__device__ __forceinline__ void far_stage(const Vec4* s_body, const uint16_t (*s_bh)[kStage],
                                          const uint16_t (*s_bl)[kStage], int len,
                                          const FarRows<DIM>& rows, float eps,
                                          float (&cf)[2][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < len; kk += 16) {
    const int k0 = kk + 2 * t;
    const uint32_t bh[2] = {*reinterpret_cast<const uint32_t*>(&s_bh[g][k0]),
                            *reinterpret_cast<const uint32_t*>(&s_bh[g][k0 + 8])};
    uint32_t bl[2];
    if constexpr (!FAR_FAST) {
      bl[0] = *reinterpret_cast<const uint32_t*>(&s_bl[g][k0]);
      bl[1] = *reinterpret_cast<const uint32_t*>(&s_bl[g][k0 + 8]);
    }
    // bodies k0, k0 + 1, k0 + 8, k0 + 9: the fragment's columns e = 0..3
    const Vec4 b[4] = {s_body[k0], s_body[k0 + 1], s_body[k0 + 8], s_body[k0 + 9]};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float w[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float d2 = rows.z[q][h] + b[e].c[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d) d2 = fmaf(rows.m2y[q][h][d], b[e].c[d], d2);
          w[h][e] = far_w<FAR_FAST>(d2, eps);
        }
      }
      // a0: (row g, bodies e 0, 1), a1: (row g + 8, e 0, 1), a2, a3: e 2, 3
      if constexpr (FAR_FAST) {
        const uint32_t ah[4] = {bf16x2(w[0][0], w[0][1]), bf16x2(w[1][0], w[1][1]),
                                bf16x2(w[0][2], w[0][3]), bf16x2(w[1][2], w[1][3])};
        mma_bf16(cf[q], ah, bh);
      } else {
        uint32_t ah[4], al[4];
        split2(w[0][0], w[0][1], ah[0], al[0]);
        split2(w[1][0], w[1][1], ah[1], al[1]);
        split2(w[0][2], w[0][3], ah[2], al[2]);
        split2(w[1][2], w[1][3], ah[3], al[3]);
        mma_bf16(cf[q], ah, bh);
        mma_bf16(cf[q], ah, bl);
        mma_bf16(cf[q], al, bh);
      }
    }
  }
}

// One near stage: the chain on raw coordinates, the thread's own row p
// against len staged (x, m), a partial then the row's sum.
template <int DIM>
__device__ __forceinline__ void near_stage(const Vec4& p, const Vec4* s_body, int len, float eps,
                                           float* acc) {
  const nbody::ChainWeight<float, false> weight{eps};
  float part[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) part[d] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < len; ++k) {
    const Vec4 b = s_body[k];
    float dx[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dx[d] = b.c[d] - p.c[d];
    const float w = weight(b.c[DIM], nbody::sep2_from<float, DIM>(nbody::least_normal(0.0f), dx));
#pragma unroll
    for (int d = 0; d < DIM; ++d) part[d] += w * dx[d];
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[d] += part[d];
}

// The finalize of a far tile pair, a += S1 - yi S0, from the C fragments:
// lane t holds columns 2t, 2t + 1 of rows g and g + 8 of each group; S0
// (column DIM) comes from lane t = 1 by a quad shuffle. Lane 0 adds
// components 0 and 1, lane 1 component 2 (3-D).
template <int DIM>
__device__ __forceinline__ void finalize(const float (&cf)[2][4], const FarRows<DIM>& rows,
                                         float (*s_acc)[DIM]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int base = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // S0 sits in lane t = 1: its first column in 2-D, its second in 3-D
      const float mine = DIM == 3 ? cf[q][2 * h + 1] : cf[q][2 * h];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      const float s0 = t == 0 ? other : mine;
      float* acc = s_acc[base + 16 * q + g + 8 * h];
      // yi = -m2y / 2, exactly
      if (t == 0) {
        acc[0] += fmaf(0.5f * rows.m2y[q][h][0], s0, cf[q][2 * h]);
        acc[1] += fmaf(0.5f * rows.m2y[q][h][1], s0, cf[q][2 * h + 1]);
      } else if (DIM == 3 && t == 1) {
        acc[2] += fmaf(0.5f * rows.m2y[q][h][DIM - 1], s0, cf[q][2 * h]);
      }
    }
  }
}

template <int DIM, bool FAST>
__global__ void __launch_bounds__(kMaxRows) allpairs_mxu_kernel(MxuArgs a) {
  __shared__ Vec4 s_rows[kMaxRows];         // the block's rows (x, 0)
  __shared__ float s_acc[kMaxRows][DIM];    // their sums
  __shared__ Vec4 s_body[kStage];           // the stage: (x, m) near, (y, z) far
  __shared__ __align__(16) uint16_t s_bh[kCols][kStage];  // B, bf16 high halves
  __shared__ __align__(16) uint16_t s_bl[kCols][kStage];  // and low halves
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * nt;
  const int I = row0 / a.tile_i;
  {
    const int i = row0 + tid;
    Vec4 v{{0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int d = 0; d < DIM; ++d) v.c[d] = i < a.n ? a.x[static_cast<size_t>(i) * DIM + d] : 0.0f;
    s_rows[tid] = v;
#pragma unroll
    for (int d = 0; d < DIM; ++d) s_acc[tid][d] = 0.0f;
    for (int k = tid; k < kStage; k += nt) {
      for (int col = DIM + 1; col < kCols; ++col) s_bh[col][k] = s_bl[col][k] = 0;
    }
  }
  __syncthreads();
  const float* mean_i = a.stats + static_cast<size_t>(I) * 3 * DIM + 2 * DIM;
  const signed char* branches = a.table + static_cast<size_t>(I) * a.ntj;
  const int lane = tid & 31, g = lane >> 2;
  const int base = (tid >> 5) * 32;
  const int ntj_live = (a.n + a.tile_j - 1) / a.tile_j;  // later j-tiles hold padding only
  for (int J = 0; J < ntj_live; ++J) {
    const int branch = branches[J];
    const float* mean_j = a.stats + static_cast<size_t>(a.ni + J) * 3 * DIM + 2 * DIM;
    float c[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) c[d] = 0.5f * (mean_i[d] + mean_j[d]);
    FarRows<DIM> rows;
    float cf[2][4];
    if (branch != kNear) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const Vec4 p = s_rows[base + 16 * q + g + 8 * h];
          float z = 0.0f;
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            const float y = p.c[d] - c[d];
            rows.m2y[q][h][d] = -2.0f * y;
            z = fmaf(y, y, z);
          }
          rows.z[q][h] = z;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) cf[q][e] = 0.0f;
      }
    }
    for (int s0 = 0; s0 < a.tile_j; s0 += kStage) {
      const int j0 = J * a.tile_j + s0;
      if (j0 >= a.n) break;  // padding only: no force (uniform over the block)
      const int len = min(kStage, a.tile_j - s0);
      __syncthreads();  // the previous stage has been read
      for (int k = tid; k < len; k += nt) {
        const int j = j0 + k;
        Vec4 v{{0.0f, 0.0f, 0.0f, 0.0f}};
        if (j < a.n) {
#pragma unroll
          for (int d = 0; d < DIM; ++d) v.c[d] = a.x[static_cast<size_t>(j) * DIM + d];
          v.c[DIM] = a.m[j];
        }
        if (branch == kNear) {
          s_body[k] = v;
          continue;
        }
        const float mj = v.c[DIM];
        float bv[DIM + 1];
        float z = 0.0f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const float y = v.c[d] - c[d];
          v.c[d] = y;
          z = fmaf(y, y, z);
          bv[d] = mj * y;
        }
        v.c[DIM] = z;
        bv[DIM] = mj;
        s_body[k] = v;
#pragma unroll
        for (int col = 0; col <= DIM; ++col) {
          const uint32_t hi = bf16x2(bv[col], 0.0f);
          s_bh[col][k] = static_cast<uint16_t>(hi);
          if (branch == kFar) {
            s_bl[col][k] = static_cast<uint16_t>(bf16x2(bv[col] - low_half(hi), 0.0f));
          }
        }
      }
      __syncthreads();
      if (branch == kNear) {
        near_stage<DIM>(s_rows[tid], s_body, len, a.eps, s_acc[tid]);
      } else if (FAST && branch == kFarFast) {
        far_stage<DIM, true>(s_body, s_bh, s_bl, len, rows, a.eps, cf);
      } else {
        far_stage<DIM, false>(s_body, s_bh, s_bl, len, rows, a.eps, cf);
      }
    }
    if (branch != kNear) finalize<DIM>(cf, rows, s_acc);
  }
  __syncthreads();
  const int i = row0 + tid;
  if (i < a.n) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) a.out[static_cast<size_t>(i) * DIM + d] = a.scale * s_acc[tid][d];
  }
}

template <int DIM, bool FAST>
cudaError_t launch(const MxuArgs& a, int rows, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((a.n + rows - 1) / rows);
  allpairs_mxu_kernel<DIM, FAST><<<blocks, rows, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: n rows of dim float32 values, m: n masses, out: n rows; device
// pointers. npad is JAX's padded count, a multiple of tile_i and tile_j;
// tile_i a multiple of 64 up to 1024, tile_j a multiple of 16. table: the
// (npad / tile_i, npad / tile_j) int8 branches, 0 near, 1 far, 2 far-fast,
// and stats the per-tile [lo, hi, mean] rows, both from nbody_tile_decide
// / nbody_tile_stats (MXU modes, with means). Returns the launch's
// cudaError_t; nothing here synchronises.
extern "C" int nbody_allpairs_mxu(int device, int dim, int fast, const void* x, const void* m,
                                  int n, int npad, int tile_i, int tile_j, const void* table,
                                  const void* stats, double eps, double scale, void* out,
                                  void* stream) {
  if (n <= 0 || tile_i < 64 || tile_i > 1024 || tile_i % 64 != 0 || tile_j < 16 ||
      tile_j % 16 != 0 || npad < n || npad % tile_i != 0 || npad % tile_j != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int rows = kMaxRows;
  while (tile_i % rows != 0) rows >>= 1;  // gcd(tile_i, 256): 64, 128 or 256
  const MxuArgs a{static_cast<const float*>(x), static_cast<const float*>(m), n, tile_i, tile_j,
                  npad / tile_i, npad / tile_j, static_cast<const signed char*>(table),
                  static_cast<const float*>(stats), static_cast<float>(eps),
                  static_cast<float>(scale), static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2 && !fast) return launch<2, false>(a, rows, s);
  if (dim == 2 && fast) return launch<2, true>(a, rows, s);
  if (dim == 3 && !fast) return launch<3, false>(a, rows, s);
  if (dim == 3 && fast) return launch<3, true>(a, rows, s);
  return cudaErrorInvalidValue;
}
