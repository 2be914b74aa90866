// The entry-cost probes' kernels for Hopper (sm_90a), with a plain C
// interface that nbody_torch/ops/cuda_entry_probes.py loads through ctypes.
// They time what one near-field entry costs beyond its pair math: each
// entry adds the pairs of a row tile of tb <= 512 rows with one block of S
// sources, the octree's sqrt3 softening, IEEE division (pair.cuh), as the
// production entries kernel (group_eval.cu) computes them. An entry's block
// is staged in shared memory as S float4 rows (x, y, z | 0, m), whatever
// the layout it is read from, so every kernel here sums the same staged
// values in the same order (add_block), and two of them that differ only
// in how the block arrives agree bit for bit.
//
// entry_ladder_kernel<DIM, PACKED, SEL, WHEN, SWITCH, MATH> replaces the
// rung kernels of scripts/probe_entry_overhead.py: run_ideal (:188,
// kern_ideal :120), run_sepmj (:197, kern_sepmj :126), run_masked (:210,
// kern_sel :138 and kern_when :148) and run_switch (:225, kern_switch
// :162). Each rung adds one feature:
//   ideal   PACKED: the block read as float4 rows of the (N, 4) sources
//           (cuda_group_eval.pack_sources), every entry full width, one
//           fixed tile;
//   sepmj   the block read from the split mj (N,) and xj (N, dim);
//   sel     PACKED + SEL: a full-S pass whose masses carry a 0/1 lane
//           weight for [lo, hi) (lohi = lo | hi << 16);
//   when    sel under a block-uniform hi > lo branch;
//   switch  PACKED + SEL + SWITCH: each entry's tile id (entry >> 16)
//           picks the rows it acts on and the rows it writes, over T tiles;
//   noskip  SEL + SWITCH on split sources: entries_lohi_eval_pallas with
//           skip_empty=False, the script's prod_noskip (its
//           prod_packed_noskip is `switch`).
// The TPU ran its grid of E entry steps in order on one core. Here every
// rung launches the same grid: blocks of per_block consecutive entries
// (the probe gives E / T, 128 blocks, one wave on 132 SMs). The
// fixed-tile rungs write one (tb, dim) partial per block, which the wrapper
// sums; switch and noskip write the tile rows: directly where the tile's
// run of entries lies inside the block, else with atomicAdd on zeroed rows.
// MATH = false is probe_dma_pipeline.py's control (its PROBE_MATH=0): the
// block is only touched, out[:, d] += sum_k block[k].d.
//
// dma_ring_kernel<DIM, NBUF, MATH> replaces probe_dma_pipeline.py's manual
// kernel (run_b :177, kern_b :129): CE consecutive entries per block (64),
// all on one fixed tile, their blocks of the (N, 4) sources copied into a
// ring of NBUF shared-memory slots with NBUF - 1 copies in flight ahead of
// the math. One entry's block is one contiguous 16*S-byte range; it is
// copied with cp.async, 16 bytes a thread, one commit group per entry and
// wait_group(NBUF - 1) before its math. cp.async and not a TMA bulk copy:
// its completion needs no mbarrier phase bookkeeping, and at 256 threads
// a 16 KB block takes four 16-byte copies a thread, a cost the ring hides.
// The script's BlockSpec kernel (run_a :122, kern_a :102), one synchronous
// block copy per entry, is the ideal rung on the same grid of CE entries
// per block (probe_entry_overhead.py:13 says as much).
// NBUF * S * 16 bytes of dynamic shared memory: 64 KB at NBUF 4 and S 1,024,
// above the default 48 KB, so each launch raises the kernel's limit first
// and returns the error if the card refuses it.
//
// What bounds them: with MATH, FP32 and SFU issue of the pair math (19
// FLOPs a pair in 3-D, the IEEE sqrt and division), as for the entries
// kernel; one block per SM and 8 warps hide little latency, which is what
// the probes measure. The MATH = false control moves E * 16 * S bytes and
// is bound by them.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair.cuh"
#include "tiles.cuh"

namespace {

using nbody::add_source;
using nbody::add_to;
using nbody::kGroup;
using nbody::kRows;
using nbody::kRowsPerBlock;
using nbody::kThreads;
using nbody::Rows;
using nbody::zero;

// One entry's staged block s[0, S) acting on the block's rows, added to
// `sum` as one entry partial of kGroup-term groups. SEL weights source k by
// 1 inside [lo, hi), else 0 (the mask multiplies, nothing is skipped).
template <int DIM, bool SEL>
__device__ __forceinline__ void add_block(const Rows<float, DIM>& rows, const float4* s, int S, int lo,
                                          int hi, float eps, float (&sum)[kRows][DIM]) {
  float ent[kRows][DIM];
  zero(ent);
  for (int k0 = 0; k0 < S; k0 += kGroup) {
    float group[kRows][DIM];
    zero(group);
    const int k1 = min(S, k0 + kGroup);
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 v = s[k];
      float m = v.w;
      if constexpr (SEL) m *= (k >= lo && k < hi) ? 1.0f : 0.0f;
      float x[DIM];
      x[0] = v.x;
      x[1] = v.y;
      if constexpr (DIM == 3) x[2] = v.z;
      add_source<float, DIM, true>(rows.p, m, x, eps, group);
    }
    add_to(ent, group);
  }
  add_to(sum, ent);
}

// The MATH = false control: every row adds sum_k s[k].d. Called by every
// thread of the block.
template <int DIM>
__device__ __forceinline__ void touch_block(const float4* s, int S, float* s_red,
                                           float (&sum)[kRows][DIM]) {
  float v[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) v[d] = 0.0f;
  for (int k = threadIdx.x; k < S; k += kThreads) {
    const float4 q = s[k];
    v[0] += q.x;
    v[1] += q.y;
    if constexpr (DIM == 3) v[2] += q.z;
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float total = nbody::block_reduce(v[d], s_red, nbody::Sum());
#pragma unroll
    for (int r = 0; r < kRows; ++r) sum[r][d] += total;
  }
}

// Stage block rows [base, base + S) into s, synchronously; rows past nj
// are zeros (mass 0 adds nothing).
template <int DIM, bool PACKED>
__device__ __forceinline__ void stage(float4* s, const float4* __restrict__ xm,
                                      const float* __restrict__ mj, const float* __restrict__ xj,
                                      int nj, int base, int S) {
  for (int k = threadIdx.x; k < S; k += kThreads) {
    const int j = base + k;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (j < nj) {
      if constexpr (PACKED) {
        v = xm[j];
      } else {
        const size_t o = static_cast<size_t>(j) * DIM;
        v = make_float4(xj[o], xj[o + 1], DIM == 3 ? xj[o + 2] : 0.0f, mj[j]);
      }
    }
    s[k] = v;
  }
}

template <int DIM, bool PACKED, bool SEL, bool WHEN, bool SWITCH, bool MATH>
__global__ void __launch_bounds__(kThreads)
entry_ladder_kernel(const float* __restrict__ xi, int tb, int ntiles, const float4* __restrict__ xm,
                    const float* __restrict__ mj, const float* __restrict__ xj, int nj,
                    const int* __restrict__ entries, const int* __restrict__ lohis, int E,
                    int per_block, int S, float eps, float* __restrict__ out) {
  extern __shared__ float4 s_blk[];  // S rows
  __shared__ float s_red[32];

  const int e0 = blockIdx.x * per_block;
  const int e1 = min(E, e0 + per_block);
  if (e0 >= e1) return;
  int tile = SWITCH ? entries[e0] >> 16 : 0;
  if (tile >= ntiles) return;
  Rows<float, DIM> rows(xi, tb, tile);
  // switch: does the tile's run of entries start before this block?
  bool shared = SWITCH && e0 > 0 && (entries[e0 - 1] >> 16) == tile;
  for (int e = e0; e < e1; ++e) {
    const int ent = entries[e];
    if constexpr (SWITCH) {
      if ((ent >> 16) != tile) {  // the same for every thread: a uniform branch
        if (shared) {
          rows.store_add(out);
        } else {
          rows.store(out);
        }
        tile = ent >> 16;
        if (tile >= ntiles) return;  // sorted: no later entry has a row tile
        shared = false;
        rows.load(xi, tb, tile, 0);
      }
    }
    int lo = 0;
    int hi = S;
    if constexpr (SEL) {
      const int lohi = lohis[e];
      lo = lohi & 0xFFFF;
      hi = lohi >> 16;
    }
    if constexpr (WHEN) {
      if (hi <= lo) continue;  // block-uniform
    }
    stage<DIM, PACKED>(s_blk, xm, mj, xj, nj, (ent & 0xFFFF) * S, S);
    __syncthreads();
    if constexpr (MATH) {
      add_block<DIM, SEL>(rows, s_blk, S, lo, hi, eps, rows.acc);
    } else {
      touch_block<DIM>(s_blk, S, s_red, rows.acc);
    }
    __syncthreads();
  }
  if constexpr (SWITCH) {
    if (shared || (e1 < E && (entries[e1] >> 16) == tile)) {
      rows.store_add(out);
    } else {
      rows.store(out);
    }
  } else {
    rows.store(out + static_cast<size_t>(blockIdx.x) * tb * DIM);  // this block's partial
  }
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DIM, int NBUF, bool MATH>
__global__ void __launch_bounds__(kThreads)
dma_ring_kernel(const float* __restrict__ xi, int tb, const float4* __restrict__ xm, int nj,
                const int* __restrict__ entries, int E, int ce, int S, float eps,
                float* __restrict__ out) {
  extern __shared__ float4 ring[];  // NBUF slots of S rows
  __shared__ float s_red[32];

  const int e0 = blockIdx.x * ce;
  const int n = min(ce, E - e0);
  Rows<float, DIM> rows(xi, tb, 0);
  // entry i of the block into slot i % NBUF; one commit group per entry
  auto issue = [&](int i) {
    float4* dst = ring + (i % NBUF) * S;
    const int base = (entries[e0 + i] & 0xFFFF) * S;
    for (int k = threadIdx.x; k < S; k += kThreads) {
      const bool valid = base + k < nj;
      cp_async16(dst + k, xm + (valid ? base + k : 0), valid);
    }
  };
#pragma unroll
  for (int i = 0; i < NBUF - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    // slot (i - 1) % NBUF was read in step i - 1, before its closing barrier
    if (i + NBUF - 1 < n) issue(i + NBUF - 1);
    cp_async_commit();
    cp_async_wait<NBUF - 1>();  // entry i's group is done, for this thread
    __syncthreads();            // ... and for every thread
    const float4* s = ring + (i % NBUF) * S;
    if constexpr (MATH) {
      add_block<DIM, false>(rows, s, S, 0, S, eps, rows.acc);
    } else {
      touch_block<DIM>(s, S, s_red, rows.acc);
    }
    __syncthreads();
  }
  rows.store(out + static_cast<size_t>(blockIdx.x) * tb * DIM);
}

using LadderFn = void (*)(const float*, int, int, const float4*, const float*, const float*, int,
                          const int*, const int*, int, int, int, float, float*);

// Rungs, in the order of cuda_entry_probes.RUNGS: ideal, sepmj, sel, when,
// switch, noskip; MATH = false only for ideal.
template <int DIM>
LadderFn ladder_for(int rung, int math) {
  if (!math) return rung == 0 ? entry_ladder_kernel<DIM, true, false, false, false, false> : nullptr;
  switch (rung) {
    case 0: return entry_ladder_kernel<DIM, true, false, false, false, true>;
    case 1: return entry_ladder_kernel<DIM, false, false, false, false, true>;
    case 2: return entry_ladder_kernel<DIM, true, true, false, false, true>;
    case 3: return entry_ladder_kernel<DIM, true, true, true, false, true>;
    case 4: return entry_ladder_kernel<DIM, true, true, false, true, true>;
    case 5: return entry_ladder_kernel<DIM, false, true, false, true, true>;
    default: return nullptr;
  }
}

using RingFn = void (*)(const float*, int, const float4*, int, const int*, int, int, int, float, float*);

template <int DIM>
RingFn ring_for(int nbuf, int math) {
  if (nbuf == 2) return math ? dma_ring_kernel<DIM, 2, true> : dma_ring_kernel<DIM, 2, false>;
  if (nbuf == 4) return math ? dma_ring_kernel<DIM, 4, true> : dma_ring_kernel<DIM, 4, false>;
  return nullptr;
}

// Raise the kernel's dynamic shared memory limit to `bytes`; the card
// refuses more than it has.
template <typename Fn>
cudaError_t allow_shared(Fn kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % alignof(float4) == 0; }

}  // namespace

// One rung of the ladder. Pointers are device pointers to contiguous
// arrays: xi (ntiles*tb, dim) rows, tb <= 512; the sources as xm (nj, 4)
// float4 rows (16-byte aligned) for the packed rungs, mj (nj,) and xj (nj,
// dim) for the split ones (the other pointers may be null); entries (E,)
// int32 (tile << 16 | blk), lohis (E,) int32 (lo | hi << 16) for the
// masked rungs. Block b takes entries [b*per_block, (b+1)*per_block). out
// is (blocks, tb, dim) partials for the fixed-tile rungs, the (ntiles*tb,
// dim) rows, zeroed, for switch and noskip. Returns the cudaError_t of the
// launch; the kernel runs on `stream` and nothing here synchronises.
extern "C" int nbody_entry_ladder(int device, int dim, int rung, int math, const void* xi, int tb,
                                  int ntiles, const void* xm, const void* mj, const void* xj,
                                  int nj, const void* entries, const void* lohis, int E,
                                  int per_block, int S, double eps, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const LadderFn kernel = dim == 2 ? ladder_for<2>(rung, math) : dim == 3 ? ladder_for<3>(rung, math)
                                                                          : nullptr;
  if (kernel == nullptr || tb <= 0 || tb > kRowsPerBlock || ntiles <= 0 || S <= 0 || E <= 0 ||
      per_block <= 0 || (xm != nullptr && !aligned16(xm))) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(S) * sizeof(float4);
  err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (E + per_block - 1) / per_block;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, ntiles, static_cast<const float4*>(xm),
      static_cast<const float*>(mj), static_cast<const float*>(xj), nj, static_cast<const int*>(entries),
      static_cast<const int*>(lohis), E, per_block, S, static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}

// The ring: xi (tb, dim) rows of one tile, tb <= 512; xm (nj, 4) float4
// rows, 16-byte aligned; entries (E,) int32, block b takes [b*ce,
// (b+1)*ce); out (ceil(E / ce), tb, dim) partials. nbuf is 2 or 4.
extern "C" int nbody_dma_ring(int device, int dim, int nbuf, int math, const void* xi, int tb,
                              const void* xm, int nj, const void* entries, int E, int ce, int S,
                              double eps, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const RingFn kernel = dim == 2 ? ring_for<2>(nbuf, math) : dim == 3 ? ring_for<3>(nbuf, math) : nullptr;
  if (kernel == nullptr || tb <= 0 || tb > kRowsPerBlock || S <= 0 || E <= 0 || ce <= 0 ||
      !aligned16(xm)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(nbuf) * S * sizeof(float4);
  err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (E + ce - 1) / ce;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float4*>(xm), nj,
      static_cast<const int*>(entries), E, ce, S, static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}
