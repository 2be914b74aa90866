// The branch of every (i-tile, j-tile) pair of the all-pairs variants, decided
// before their force kernels run, with a plain C interface that
// nbody_torch/ops/cuda_variant_decide.py loads through ctypes.
//
// What they replace: no kernel of their own. nbody_tpu decides inside each
// variant's body, from the least d2 of the tile pair that the body has just
// computed: pallas_allpairs.py:96-105 (fast=True: far iff min d2 >
// far_thresh, d2 summed in dimension order) and pallas_allpairs_mxu.py:
// 106-133, 186-199 (near iff min d2 <= near_coef * (max zi + max zj), d2 by
// the quadratic form in the midpoint frame of the two tiles' means;
// far-fast iff not near and min d2 > far_thresh). The port's first kernels
// did the same, at the price of a pass over every pair of every tile pair
// before the sum (about 7 operations a pair over all 1.1e12 pairs at
// 2^20). These two kernels give the force kernels the answer instead:
//   tile_stats_kernel<DIM>   each JAX tile's axis-aligned box (its padding
//       bodies at the origin included, as JAX pads) and its mean, summed as
//       a pairwise tree over the tile padded with zeros to a power of two
//       (v[k] += v[k + h], h = P/2, ..., 1) and times the float32 1/T: an
//       order that plain torch repeats exactly; then the box of every
//       16-body sub-tile (kSub), which the exact pass tests first;
//   tile_decide_kernel<DIM, MODE>  the (ni, nj) int8 table: fast 0
//       softened, 1 far; MXU 0 near, 1 far, 2 far-fast (BRANCHES order).
//
// The decision is exact, and bit-equal to its plain version
// (cuda_variant_decide.decide_torch): every d2, z and threshold is
// evaluated with each product and each sum rounded apart (__fmul_rn /
// __fadd_rn, never contracted into a fused multiply-add) in the order plain
// torch evaluates them: d2 = (dx0^2 + dx1^2) + dx2^2 with dx = xj - xi
// (fast); z = (y0^2 + y1^2) + y2^2 with y = x - c, c = 0.5 (mean_i +
// mean_j), and d2 = ((zi + zj) + yi0 (-2 yj0)) + ... (MXU). One block an
// i-tile first decides its tile pairs from the boxes, one thread a j-tile;
// only the tile pairs the boxes leave open take the exact pass. That pass
// tests the tile pair's 16 x 16-body sub-tile pairs from their boxes in the
// same way, now from both sides: a sub-tile pair whose every pair must lie
// within the threshold settles the branch at once, one whose no pair can is
// skipped, and only the rest are evaluated pair by pair, a warp a sub-tile
// pair, until one pair settles the branch.
//
// The margins. Fast: the box gap g_d = max(0, lo_j - hi_i, lo_i - hi_j),
// each difference rounded as dx is, and L = (g0^2 + g1^2) + g2^2 rounded as
// d2 is. Rounding to nearest is monotone, so every pair's rounded |dx_d| >=
// g_d and its rounded d2 >= L: L > far_thresh decides far with no margin
// at all. MXU: the bound of each z over a box, e_d = max(hi_d - c_d, c_d -
// lo_d) rounded, Zb = (e0^2 + e1^2) + e2^2 rounded, bounds every rounded z
// of the tile from above by the same monotonicity, so near_coef * (Zb_i +
// Zb_j) bounds the exact near limit from above. The rounded quadratic form
// is not monotone in the boxes; it differs from the true squared distance
// by at most ~17 u (zi + zj) (u = 2^-24: y rounded, 4 u Z; z, 3 u Z; the
// dim products and dim + 1 sums, 10 u Z), and L from the boxes' true
// distance by 6 u L. So every pair's d2 exceeds L - M with M = 2^-15 (L +
// Zb_i + Zb_j), more than 16 times what the rounding can take: L - M > the
// bounded near limit decides "not near", and L - M > far_thresh, far-fast.
// From above, the spans G_d = max(hi_j - lo_i, hi_i - lo_j) rounded give U
// = (G0^2 + G1^2) + G2^2 >= every rounded d2 (fast, by monotonicity) and U
// + M (MXU): U <= far_thresh (U + M <= the exact near limit, or far_thresh)
// settles "a pair lies within" for a sub-tile pair. Tile pairs within the
// margins take the exact pass; the CPU tests place clusters a few ulps
// either side of each threshold, and show the MXU margin needed.
//
// What bounds them on an H100: little. The bytes are the positions read
// once and the table written once (~14 MB at 2^20: 4 us); the box tests
// cost 20-60 operations a tile pair or sub-tile pair, and the pairs that
// the exact pass evaluates ~10 each. Evaluating every pair of the open
// tile pairs (with an early exit every 64 bodies) took 5.4e10 pairs and 52
// ms for the fast variant at 2^20 Hilbert-sorted on an H100; the sub-tile
// level leaves ~4e8 pairs and 3-4 ms. work[] (optional) returns, per
// i-tile, the tile pairs that took the exact pass and the pairs it
// evaluated.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 4096;        // the largest tile: the sums' tree in shared memory
constexpr int kSub = 16;              // bodies a sub-tile (the exact pass's second level)
constexpr int kSubChunk = kThreads;   // sub-tile pairs tested at once: one a thread
constexpr int kFast = 0, kMxu = 1, kMxuFast = 2;
constexpr int kOpenNotNear = 1 << 30;  // a listed j-tile whose boxes settle "not near"
constexpr float kMargin = 0x1p-15f;    // M = kMargin (v + Z), the MXU modes' rounding margin

using nbody::block_reduce;
using nbody::Max;
using nbody::Min;

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// (v0^2 + v1^2) + v2^2, every operation rounded apart
template <int DIM>
__device__ __forceinline__ float norm2(const float (&v)[DIM]) {
  float s = mul(v[0], v[0]);
#pragma unroll
  for (int d = 1; d < DIM; ++d) s = add(s, mul(v[d], v[d]));
  return s;
}

// stats: (ni + nj) rows of 3 * DIM floats, [lo, hi, mean]: the i-tiles of
// tile_i bodies, then the j-tiles of tile_j; bodies past n read as 0.
// After the ni + nj tiles, npad / kSub rows of the kSub-body sub-tiles
// [lo, hi, 0], written by the i-tiles' blocks (they cover the bodies).
template <int DIM>
__global__ void __launch_bounds__(kThreads)
tile_stats_kernel(const float* __restrict__ x, int n, int ni, int nj, int tile_i, int tile_j,
                  float inv_i, float inv_j, int means, float* __restrict__ stats) {
  __shared__ float s_sum[kMaxTile];
  __shared__ float s_red[32];
  const int b = blockIdx.x;
  const bool is_i = b < ni;
  const int T = is_i ? tile_i : tile_j;
  const int first = is_i ? b * tile_i : (b - ni) * tile_j;
  int P = 1;
  while (P < T) P <<= 1;
  float* out = stats + static_cast<size_t>(b) * 3 * DIM;
  for (int d = 0; d < DIM; ++d) {
    float lo = INFINITY, hi = -INFINITY;
    for (int k = threadIdx.x; k < P; k += kThreads) {
      float v = 0.0f;
      if (k < T) {
        const int j = first + k;
        v = j < n ? x[static_cast<size_t>(j) * DIM + d] : 0.0f;
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      s_sum[k] = v;
    }
    lo = block_reduce(lo, s_red, Min());  // synchronises: s_sum is visible
    hi = block_reduce(hi, s_red, Max());
    if (means) {
      for (int h = P >> 1; h > 0; h >>= 1) {
        for (int k = threadIdx.x; k < h; k += kThreads) s_sum[k] = add(s_sum[k], s_sum[k + h]);
        __syncthreads();
      }
    }
    if (threadIdx.x == 0) {
      out[d] = lo;
      out[DIM + d] = hi;
      out[2 * DIM + d] = means ? mul(s_sum[0], is_i ? inv_i : inv_j) : 0.0f;
    }
    __syncthreads();  // s_sum is written again
  }
  if (!is_i) return;
  for (int s = threadIdx.x; s < tile_i / kSub; s += kThreads) {
    float* sub = stats + (static_cast<size_t>(ni + nj) + first / kSub + s) * 3 * DIM;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      float lo = INFINITY, hi = -INFINITY;
      for (int k = 0; k < kSub; ++k) {
        const int j = first + s * kSub + k;
        const float v = j < n ? x[static_cast<size_t>(j) * DIM + d] : 0.0f;
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      sub[d] = lo;
      sub[DIM + d] = hi;
      sub[2 * DIM + d] = 0.0f;
    }
  }
}

struct DecideArgs {
  const float* x;
  int n;
  int tile_i;
  int tile_j;
  int ni;
  int nj;
  const float* stats;  // tile_stats_kernel's
  float near_coef;     // MXU: near_factor * eps in float32
  float thresh;        // far_thresh
  int8_t* table;       // (ni, nj)
  unsigned long long* work;  // null, or (ni, 2): tile pairs of the exact pass, its pairs
};

template <int DIM>
struct Box {
  float lo[DIM], hi[DIM], mean[DIM];
  __device__ __forceinline__ explicit Box(const float* s) {
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      lo[d] = s[d];
      hi[d] = s[DIM + d];
      mean[d] = s[2 * DIM + d];
    }
  }
};

// The tile pair's frame, c = 0.5 (mean_i + mean_j).
template <int DIM>
__device__ __forceinline__ void frame(const Box<DIM>& bi, const Box<DIM>& bj, float (&c)[DIM]) {
#pragma unroll
  for (int d = 0; d < DIM; ++d) c[d] = mul(0.5f, add(bi.mean[d], bj.mean[d]));
}

// The upper bound of every rounded z = |x - c|^2 over the box.
template <int DIM>
__device__ __forceinline__ float z_bound(const Box<DIM>& b, const float (&c)[DIM]) {
  float e[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) e[d] = fmaxf(sub(b.hi[d], c[d]), sub(c[d], b.lo[d]));
  return norm2<DIM>(e);
}

// The branch that the boxes settle: >= 0, or -1 (open), or -2 (open, but
// not near: MXU far or far-fast).
template <int DIM, int MODE>
__device__ __forceinline__ int box_branch(const Box<DIM>& bi, const Box<DIM>& bj,
                                          float near_coef, float thresh) {
  float g[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    g[d] = fmaxf(0.0f, fmaxf(sub(bj.lo[d], bi.hi[d]), sub(bi.lo[d], bj.hi[d])));
  }
  const float L = norm2<DIM>(g);
  if constexpr (MODE == kFast) {
    return L > thresh ? 1 : -1;
  } else {
    float c[DIM];
    frame<DIM>(bi, bj, c);
    const float zb = add(z_bound<DIM>(bi, c), z_bound<DIM>(bj, c));
    const float lm = sub(L, mul(kMargin, add(L, zb)));  // L - M
    if (!(lm > mul(near_coef, zb))) return -1;
    if constexpr (MODE == kMxu) return 1;
    return lm > thresh ? 2 : -2;
  }
}

// Lower and upper bounds of the rounded squared distance over two boxes
// (lo at b[0..DIM), hi at b[DIM..2 DIM)): the gaps and the spans, each
// difference rounded as dx is, squared and summed as d2 is.
template <int DIM>
__device__ __forceinline__ void box_bounds(const float* bi, const float* bj, float& L, float& U) {
  float g[DIM], G[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    g[d] = fmaxf(0.0f, fmaxf(sub(bj[d], bi[DIM + d]), sub(bi[d], bj[DIM + d])));
    G[d] = fmaxf(sub(bj[DIM + d], bi[d]), sub(bi[DIM + d], bj[d]));
  }
  L = norm2<DIM>(g);
  U = norm2<DIM>(G);
}

// max over a tile's bodies [first, first + T) of z = |x - c|^2 (rounded as
// the plain version rounds it), over the block
template <int DIM>
__device__ __forceinline__ float z_max(const DecideArgs& a, int first, int T,
                                       const float (&c)[DIM], float* s_red) {
  float zmax = -INFINITY;
  for (int k = threadIdx.x; k < T; k += kThreads) {
    const int j = first + k;
    float y[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      y[d] = sub(j < a.n ? a.x[static_cast<size_t>(j) * DIM + d] : 0.0f, c[d]);
    }
    zmax = fmaxf(zmax, norm2<DIM>(y));
  }
  return block_reduce(zmax, s_red, Max());
}

// A body's coordinates (padding at the origin).
template <int DIM>
__device__ __forceinline__ void body(const DecideArgs& a, int j, float (&v)[DIM]) {
#pragma unroll
  for (int d = 0; d < DIM; ++d) v[d] = j < a.n ? a.x[static_cast<size_t>(j) * DIM + d] : 0.0f;
}

// The exact branch of (I, J) by the whole block, in two levels. The tile
// pair's kSub-body sub-tile pairs are tested first from their boxes
// (stats' sub-tile rows): one whose every pair is within the threshold
// settles the branch at once; one whose no pair can be is skipped; the
// rest are scanned pair by pair, a warp a sub-tile pair (a lane a row and
// 8 bodies, shuffled from the lanes that loaded them), until one pair
// settles the branch. Bounds as box_branch's: the fast mode's are exact by
// monotonicity; the MXU modes' take the margin kMargin (v + Z), Z the exact
// max zi + max zj. Adds the pairs it scanned to *pairs (thread 0's).
template <int DIM, int MODE>
__device__ int exact_branch(const DecideArgs& a, int I, int J, bool not_near, const Box<DIM>& bi,
                            int* s_list, int* s_flags, float* s_red, unsigned long long* pairs) {
  constexpr bool kQuad = MODE != kFast;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nsi = a.tile_i / kSub, nsj = a.tile_j / kSub;
  const float* subs = a.stats + static_cast<size_t>(a.ni + a.nj) * 3 * DIM;
  const float* sub_i = subs + static_cast<size_t>(I) * nsi * 3 * DIM;
  const int first_j = J * a.tile_j;
  const float* sub_j = subs + static_cast<size_t>(first_j / kSub) * 3 * DIM;
  float c[DIM];
  float near_lim = 0.0f, zsum = 0.0f;
  if constexpr (kQuad) {
    const Box<DIM> bj(a.stats + static_cast<size_t>(a.ni + J) * 3 * DIM);
    frame<DIM>(bi, bj, c);
    zsum = add(z_max<DIM>(a, I * a.tile_i, a.tile_i, c, s_red),
               z_max<DIM>(a, first_j, a.tile_j, c, s_red));
    near_lim = mul(a.near_coef, zsum);
  }
  // settled (s_flags[0]: near, or fast: a pair within thresh; s_flags[1]:
  // a pair within thresh, mxu-fast), and the sub-tile pairs scanned
  bool near = false, within = false;
  for (int e0 = 0; e0 < nsi * nsj; e0 += kSubChunk) {
    const int e1 = min(nsi * nsj, e0 + kSubChunk);
    if (tid == 0) s_flags[2] = 0;  // the list's length
    __syncthreads();
    bool sure_near = false, sure_within = false, open = false;
    const int e = e0 + tid;
    if (e < e1) {
      float L, U;
      box_bounds<DIM>(sub_i + static_cast<size_t>(e / nsj) * 3 * DIM,
                      sub_j + static_cast<size_t>(e % nsj) * 3 * DIM, L, U);
      if constexpr (kQuad) {
        const float hi = add(U, mul(kMargin, add(U, zsum)));  // >= every pair's d2
        const float lo = sub(L, mul(kMargin, add(L, zsum)));  // <= every pair's d2
        sure_near |= hi <= near_lim;
        open = !(lo > near_lim);
        if constexpr (MODE == kMxuFast) {
          sure_within |= hi <= a.thresh;
          open = open || !(lo > a.thresh);
        }
      } else {
        sure_near |= U <= a.thresh;
        open = L <= a.thresh;
      }
    }
    // the open sub-tile pairs into the list, one atomic a warp
    const unsigned ballot = __ballot_sync(0xffffffffu, open);
    int at = 0;
    if (lane == 0 && ballot != 0) at = atomicAdd(&s_flags[2], __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (open) s_list[at + __popc(ballot & ((1u << lane) - 1))] = e;
    near = __syncthreads_or(sure_near) != 0;
    if (near) break;
    const bool sure = __syncthreads_or(sure_within) != 0;
    within = within || sure;
    if (not_near && within) break;  // mxu-fast: far, whatever the rest holds
    const int count = s_flags[2];
    if (tid == 0) s_flags[0] = s_flags[1] = 0;
    __syncthreads();
    for (int k = warp; k < count; k += kWarps) {
      if (__shfl_sync(0xffffffffu, *static_cast<volatile int*>(&s_flags[0]), 0)) break;
      const int e = s_list[k];
      float xr[DIM], xb[DIM];
      body<DIM>(a, I * a.tile_i + (e / nsj) * kSub + (lane & (kSub - 1)), xr);
      body<DIM>(a, first_j + (e % nsj) * kSub + (lane & (kSub - 1)), xb);
      bool hit_near = false, hit_within = false;
      if constexpr (kQuad) {
        float yr[DIM], yb[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          yr[d] = sub(xr[d], c[d]);
          yb[d] = sub(xb[d], c[d]);
        }
        const float zr = norm2<DIM>(yr), zb = norm2<DIM>(yb);
#pragma unroll
        for (int d = 0; d < DIM; ++d) yb[d] = mul(-2.0f, yb[d]);
#pragma unroll
        for (int k2 = 0; k2 < kSub / 2; ++k2) {
          const int src = (lane >> 4) * (kSub / 2) + k2;
          float d2 = add(zr, __shfl_sync(0xffffffffu, zb, src));
#pragma unroll
          for (int d = 0; d < DIM; ++d) d2 = add(d2, mul(yr[d], __shfl_sync(0xffffffffu, yb[d], src)));
          hit_near |= d2 <= near_lim;
          hit_within |= d2 <= a.thresh;
        }
      } else {
#pragma unroll
        for (int k2 = 0; k2 < kSub / 2; ++k2) {
          const int src = (lane >> 4) * (kSub / 2) + k2;
          float dx[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d) dx[d] = sub(__shfl_sync(0xffffffffu, xb[d], src), xr[d]);
          hit_near |= norm2<DIM>(dx) <= a.thresh;
        }
      }
      if (lane == 0) atomicAdd(&s_flags[3], 1);
      hit_near = __any_sync(0xffffffffu, hit_near);
      hit_within = __any_sync(0xffffffffu, hit_within);
      if (lane == 0 && hit_within) s_flags[1] = 1;
      if (lane == 0 && (hit_near || (not_near && hit_within))) s_flags[0] = 1;
    }
    __syncthreads();
    near = s_flags[0] != 0 && !(kQuad && not_near);
    within = within || s_flags[1] != 0;
    if (near || (not_near && within)) break;
  }
  if (tid == 0) {
    *pairs += static_cast<unsigned long long>(s_flags[3]) * kSub * kSub;
    s_flags[3] = 0;
  }
  if constexpr (MODE == kFast) {
    return near ? 0 : 1;
  } else {
    if (near) return 0;
    if constexpr (MODE == kMxu) return 1;
    return within ? 1 : 2;
  }
}

template <int DIM, int MODE>
__global__ void __launch_bounds__(kThreads) tile_decide_kernel(DecideArgs a) {
  __shared__ int s_list[kSubChunk];  // open sub-tile pairs
  __shared__ int s_open[kThreads];   // open j-tiles
  __shared__ int s_flags[4];         // settled, within, list length, sub-tile pairs scanned
  __shared__ int s_count;
  __shared__ float s_red[32];
  const int I = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) s_flags[3] = 0;
  const Box<DIM> bi(a.stats + static_cast<size_t>(I) * 3 * DIM);
  int8_t* row = a.table + static_cast<size_t>(I) * a.nj;
  unsigned long long opened = 0, pairs = 0;
  for (int J0 = 0; J0 < a.nj; J0 += kThreads) {
    if (tid == 0) s_count = 0;
    __syncthreads();
    const int J = J0 + tid;
    if (J < a.nj) {
      const Box<DIM> bj(a.stats + static_cast<size_t>(a.ni + J) * 3 * DIM);
      const int v = box_branch<DIM, MODE>(bi, bj, a.near_coef, a.thresh);
      if (v >= 0) {
        row[J] = static_cast<int8_t>(v);
      } else {
        s_open[atomicAdd(&s_count, 1)] = v == -2 ? (J | kOpenNotNear) : J;
      }
    }
    __syncthreads();
    const int count = s_count;
    for (int e = 0; e < count; ++e) {
      const int entry = s_open[e];
      const int Je = entry & (kOpenNotNear - 1);
      const int v = exact_branch<DIM, MODE>(a, I, Je, (entry & kOpenNotNear) != 0, bi, s_list,
                                            s_flags, s_red, &pairs);
      if (tid == 0) row[Je] = static_cast<int8_t>(v);
      __syncthreads();  // s_flags and s_list are written again
    }
    opened += count;
    __syncthreads();  // s_open and s_count are written again
  }
  if (a.work != nullptr && tid == 0) {
    a.work[2 * I] = opened;
    a.work[2 * I + 1] = pairs;
  }
}

template <int DIM>
cudaError_t launch_decide(int mode, const DecideArgs& a, cudaStream_t stream) {
  if (mode == kFast) {
    tile_decide_kernel<DIM, kFast><<<a.ni, kThreads, 0, stream>>>(a);
  } else if (mode == kMxu) {
    tile_decide_kernel<DIM, kMxu><<<a.ni, kThreads, 0, stream>>>(a);
  } else if (mode == kMxuFast) {
    tile_decide_kernel<DIM, kMxuFast><<<a.ni, kThreads, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: n rows of dim float32 values (device). The tiles cover npad bodies:
// ni = npad / tile_i i-tiles, nj = npad / tile_j j-tiles, tiles of at most
// 4096 bodies, tile_i a multiple of 16. stats: (ni + nj + npad / 16) * 3 *
// dim floats, each tile's [lo, hi, mean] (mean 0 unless `means`), then each
// 16-body sub-tile's [lo, hi, 0]; inv_i, inv_j: 1 / tile_i and 1 / tile_j
// rounded to float32. Returns the launch's cudaError_t.
extern "C" int nbody_tile_stats(int device, int dim, const void* x, int n, int npad, int tile_i,
                                int tile_j, double inv_i, double inv_j, int means, void* stats,
                                void* stream) {
  if (n <= 0 || tile_i <= 0 || tile_j <= 0 || tile_i > kMaxTile || tile_j > kMaxTile ||
      tile_i % kSub != 0 || npad < n || npad % tile_i != 0 || npad % tile_j != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int ni = npad / tile_i, nj = npad / tile_j;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* st = static_cast<float*>(stats);
  const float ii = static_cast<float>(inv_i), ij = static_cast<float>(inv_j);
  if (dim == 2) {
    tile_stats_kernel<2><<<ni + nj, kThreads, 0, s>>>(xf, n, ni, nj, tile_i, tile_j, ii, ij,
                                                      means, st);
  } else if (dim == 3) {
    tile_stats_kernel<3><<<ni + nj, kThreads, 0, s>>>(xf, n, ni, nj, tile_i, tile_j, ii, ij,
                                                      means, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// mode: 0 fast (far iff min d2 > thresh), 1 MXU, 2 MXU with far-fast
// (thresh = far_thresh; near_coef = near_factor * eps in float32). stats:
// nbody_tile_stats' (with means for the MXU modes); table: ni * nj int8;
// work: null or ni * 2 uint64. tile_i and tile_j multiples of 16.
// Returns the launch's cudaError_t.
extern "C" int nbody_tile_decide(int device, int dim, int mode, const void* x, int n, int npad,
                                 int tile_i, int tile_j, const void* stats, double near_coef,
                                 double thresh, void* table, void* work, void* stream) {
  if (n <= 0 || tile_i <= 0 || tile_i > kMaxTile || tile_i % kSub != 0 || tile_j <= 0 ||
      tile_j > kMaxTile || tile_j % kSub != 0 || npad < n || npad % tile_i != 0 ||
      npad % tile_j != 0 || npad / tile_j >= kOpenNotNear) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const DecideArgs a{static_cast<const float*>(x), n, tile_i, tile_j, npad / tile_i,
                     npad / tile_j, static_cast<const float*>(stats),
                     static_cast<float>(near_coef), static_cast<float>(thresh),
                     static_cast<int8_t*>(table), static_cast<unsigned long long*>(work)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) return launch_decide<2>(mode, a, s);
  if (dim == 3) return launch_decide<3>(mode, a, s);
  return cudaErrorInvalidValue;
}
