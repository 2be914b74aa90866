// The entry-cost probes' kernels for Hopper (sm_90a), with a plain C
// interface that nbody_torch/ops/cuda_entry_probes.py loads through ctypes.
// They time what one near-field entry costs beyond its pair math: each
// entry adds the pairs of a row tile of tb <= 512 rows with one block of S
// sources, the octree's sqrt3 softening, on the production entries
// kernel's design (group_eval.cu entries_kernel):
//   - the pair math is the two-MUFU chain (pair.cuh ChainWeight, d2 summed
//     from the least normal number), the reciprocal refined by one Newton
//     step as nbody_tpu's entry kernels take it (pallas_group_eval.py
//     :877-878, _pair_weight :143-144); no IEEE division or root;
//   - an entry's sources are staged kChunk (256) at a time, one 16-byte
//     (x, y, z | 0, m) row a thread, and summed in kGroup-term groups,
//     each stage's sum added to the rows' total (staged.cuh add_staged_run
//     and add_stage), in one fixed order for every rung, so that two
//     kernels that differ only in how the sources arrive agree bit for bit;
//   - 2 rows a thread (kRows), 256 threads, at most 48 registers so that 5
//     blocks share an SM (the ring and the ideal rung it is compared with:
//     64, see below), and each block of entries split into P parts in
//     the kernel, each writing its partial rows to its own slice, which
//     parts_sum_kernel (group_eval.cu) adds in part order: no atomics on
//     the probes' grids, so two launches give the same bits.
//
// entry_ladder_kernel<DIM, PACKED, SEL, WHEN, SWITCH, MATH, MIN_BLOCKS> replaces the
// rung kernels of scripts/probe_entry_overhead.py: run_ideal (:188,
// kern_ideal :120), run_sepmj (:197, kern_sepmj :126), run_masked (:210,
// kern_sel :138 and kern_when :148) and run_switch (:225, kern_switch
// :162). Each rung adds one feature, and prices on the GPU what it names:
//   ideal   PACKED: each source read as one float4 row of the (N, 4)
//           sources (cuda_group_eval.pack_sources), every entry full
//           width, one fixed tile;
//   sepmj   the sources read from the split mj (N,) and xj (N, dim): three
//           or four loads a staged row instead of one;
//   sel     PACKED + SEL: the full-S pass of the TPU rung, each staged mass
//           multiplied once by its 0/1 lane weight for [lo, hi) (lohi = lo
//           | hi << 16), m * [lo <= k < hi], as the dense-mask window folds
//           its weight: one multiply a staged source, none a pair. Its
//           function and bits are the TPU rung's (m * 1 = m, m * 0 = 0);
//   when    sel under a block-uniform hi > lo branch that skips a whole
//           entry, the TPU rung's only skip (no stage is skipped);
//   switch  PACKED + SEL + SWITCH: each entry's tile id (entry >> 16)
//           picks the rows it acts on and the rows it writes, over T
//           tiles: a row load and a row store at every change of tile;
//   noskip  SEL + SWITCH on split sources: entries_lohi_eval_pallas with
//           skip_empty=False, the script's prod_noskip (its
//           prod_packed_noskip is `switch`).
// The TPU ran its grid of E entry steps in order on one core. Here every
// rung takes blocks of per_block consecutive entries (the probe gives E /
// T, 64 at E = 8,192) and splits each into P parts in the kernel (grid
// blocks * P, block b * P + p is part p of block b; ops/cuda_entry_probes
// .ladder_parts mirrors the split in Python):
//   - the fixed-tile rungs: part p of a block of n entries takes the
//     entries [n * p / np, n * (p + 1) / np), np = min(n, P) parts, none
//     empty, and writes its (tb, dim) partial to slice b * P + p (zeros
//     for p >= np); the wrapper's parts_sum_kernel adds each block's P
//     slices in order, then (a second launch) the blocks in order;
//   - switch and noskip: each run of one tile inside a block is split the
//     same way; part p takes the p-th share of every run of its block and
//     writes its partial rows of the run's tile t to slice t * P + p of a
//     zeroed scratch (ntiles * P, tb, dim): a plain store where the tile's
//     run lies inside the block, atomicAdd where it crosses a block (the
//     only atomics; none on the probe's grid, where a block is one tile's
//     run); parts_sum_kernel adds each tile's P slices in order.
// MATH = false is probe_dma_pipeline.py's control (its PROBE_MATH=0): the
// sources are only read, 16 bytes a thread, and summed; every row of a
// part gets sum_e sum_k block_e[k].d (each thread's running sum over its
// rows k = threadIdx.x + 256 i of every entry, then one block sum a part).
//
// dma_ring_kernel<DIM, NBUF, MATH> replaces probe_dma_pipeline.py's manual
// kernel (run_b :177, kern_b :129) on the same grid as the ideal rung of
// CE = 64 entries a block (P parts each, slice b * P + p), the script's
// BlockSpec kernel (run_a :122, kern_a :102; probe_entry_overhead.py:13
// says as much). Its part's entries come through a ring of NBUF slots of
// S rows in dynamic shared memory, NBUF - 1 copies in flight ahead of the
// math, on Hopper's bulk copies and mbarriers:
//   - one thread (thread 0) copies an entry's contiguous 16 * S bytes of
//     the (N, 4) sources with one cp.async.bulk (no tensor map) and arrives
//     on the slot's "full" mbarrier with expect_tx of those bytes; a block
//     that runs past nj is copied as its in-range prefix, and the rows
//     past it are not read (a mass-0 row would add +0 to every sum: the
//     same bits);
//   - every thread waits on the slot's full barrier (try_wait.parity, the
//     parity of the slot's use i / NBUF), sums the slot as the ideal
//     rung sums its stages (add_stage over kChunk rows at a time: the same
//     order, so the ring equals the ideal rung on its grid bit for bit),
//     and each warp arrives on the slot's "empty" mbarrier when it is done;
//   - before thread 0 refills a slot it waits on that slot's empty barrier
//     for the previous use, not on a block-wide barrier: no __syncthreads
//     after the barriers are set up (fence.mbarrier_init,
//     fence.proxy.async), but MATH = false's one block sum a part.
// Register budgets: the ladder's rungs take at most 48 registers
// (__launch_bounds__(256, kLadderBlocks = 5)), the entries kernel's. The
// ring takes at most 64 (kRingBlocks = 4), room for its slot bookkeeping
// beside the chain. So that the ring and the staged loop differ only in how the
// sources arrive, the ideal rung is also built at the ring's bounds
// (MIN_BLOCKS = kRingBlocks), and that instantiation is the dma-pipeline
// probe's blockspec. NBUF * S * 16 bytes of dynamic shared memory (64 KB at
// NBUF 4, S 1,024) limit the ring's blocks an SM further; each launch
// raises the kernel's limit and returns the error if the card refuses it,
// and the wrapper refuses a ring larger than a block's 227 KB before it
// launches. nbody_entry_probe_budget reads each kernel's registers, spill
// and shared bytes and resident blocks an SM from the CUDA runtime.
//
// What bounds them: with MATH, the MUFU pipe (two operations a pair, 16 a
// clock on each SM) beside the chain's FP32 work, as for the entries
// kernel; every rung computes all S lanes of each entry it runs. The MATH
// = false control moves E * 16 * S bytes, most of them from L2 (the
// sources of n = 1,000,000 are 16 MB), and is bound by them.

#include <cuda_runtime.h>

#include <cstdint>

#include "pair.cuh"
#include "staged.cuh"
#include "tiles.cuh"

namespace {

using nbody::add_stage;
using nbody::add_staged_run;
using nbody::kChunk;
using nbody::kRowsPerBlock;
using nbody::kThreads;
using nbody::Rows;
using nbody::SplitSource;

using Weight = nbody::ChainWeight<float, true>;  // sqrt3, the octree's softening

constexpr int kLadderBlocks = 5;  // the rungs' launch bounds: at most 48 registers
constexpr int kRingBlocks = 4;    // the ring's, and blockspec's: at most 64

// Entries [a, c) of part p of the n entries from s0, np = min(n, P) parts;
// c == a for p >= np. n * P < 2^31 (the launch checks per_block * P), so
// 32-bit arithmetic: a 64-bit division would be a called subroutine.
struct Share {
  int a, c;
};
__device__ __forceinline__ Share share_of(int s0, int n, int P, int p) {
  const int np = min(n, P);
  if (p >= np) return Share{s0, s0};
  return Share{s0 + n * p / np, s0 + n * (p + 1) / np};
}

// The MATH = false control: the thread's running sums v of its rows k =
// threadIdx.x + kThreads * i of rows[0, len).
template <int DIM>
__device__ __forceinline__ void touch_rows(const float4* rows, int len, float (&v)[DIM]) {
  for (int k = threadIdx.x; k < len; k += kThreads) {
    const float4 q = rows[k];
    v[0] += q.x;
    v[1] += q.y;
    if constexpr (DIM == 3) v[2] += q.z;
  }
}

// The control's one block sum a part: every row of the part gets the
// block's total of v. Called by every thread of the block.
template <int DIM>
__device__ __forceinline__ void touch_total(Rows<float, DIM>& rows, const float (&v)[DIM],
                                            float* s_red) {
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    const float total = nbody::block_reduce(v[d], s_red, nbody::Sum());
#pragma unroll
    for (int r = 0; r < nbody::kRows; ++r) rows.acc[r][d] += total;
  }
}

// The rows in range of an entry's block from source `base`: min(S, nj - base), >= 0.
__device__ __forceinline__ int rows_in(long long base, int S, int nj) {
  return static_cast<int>(max(0LL, min(static_cast<long long>(S), nj - base)));
}

template <int DIM, bool PACKED, bool SEL, bool WHEN, bool MATH>
__device__ __forceinline__ void add_entry(Rows<float, DIM>& rows, int e,
                                          const float4* __restrict__ xm,
                                          const SplitSource<float, DIM>& split, int nj,
                                          const int* __restrict__ entries,
                                          const int* __restrict__ lohis, int S,
                                          const Weight& weight, float4* s_body,
                                          float (&touched)[DIM]) {
  const long long base = static_cast<long long>(entries[e] & 0xFFFF) * S;
  const int len = rows_in(base, S, nj);
  if constexpr (!MATH) {
    touch_rows<DIM>(xm + base, len, touched);
    return;
  }
  int lo = 0;
  int hi = S;
  if constexpr (SEL) {
    const int lohi = lohis[e];
    lo = lohi & 0xFFFF;
    hi = lohi >> 16;
  }
  if constexpr (WHEN) {
    if (hi <= lo) return;  // block-uniform: the whole entry
  }
  add_staged_run(rows, 0, S, weight, s_body, [&](long long k) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // rows past nj: mass 0
    if (k < len) {
      const int j = static_cast<int>(base + k);
      if constexpr (PACKED) {
        v = xm[j];
      } else {
        v = nbody::staged(split, j);
      }
    }
    if constexpr (SEL) v.w = v.w * ((k >= lo && k < hi) ? 1.0f : 0.0f);  // the lane weight
    return v;
  });
}

// Block b * P + p: part p of block b's entries [b * per_block, (b + 1) *
// per_block) (see the header for the switch rungs' runs), its partial rows
// to its slice of parts.
template <int DIM, bool PACKED, bool SEL, bool WHEN, bool SWITCH, bool MATH, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
entry_ladder_kernel(const float* __restrict__ xi, int tb, int ntiles, const float4* __restrict__ xm,
                    const float* __restrict__ mj, const float* __restrict__ xj, int nj,
                    const int* __restrict__ entries, const int* __restrict__ lohis, int E,
                    int per_block, int P, int S, float eps, float* __restrict__ parts) {
  __shared__ float4 s_body[kChunk];
  __shared__ float s_red[32];

  const int b = blockIdx.x / P, p = blockIdx.x % P;
  const int e0 = static_cast<int>(min(static_cast<long long>(b) * per_block, static_cast<long long>(E)));
  const int e1 = static_cast<int>(min(static_cast<long long>(e0) + per_block, static_cast<long long>(E)));
  const Weight weight{eps};
  const SplitSource<float, DIM> split{mj, xj};
  float touched[DIM] = {};
  Rows<float, DIM> rows(xi, tb, 0);
  if constexpr (!SWITCH) {
    const Share sh = share_of(e0, e1 - e0, P, p);
    for (int e = sh.a; e < sh.c; ++e) {
      add_entry<DIM, PACKED, SEL, WHEN, MATH>(rows, e, xm, split, nj, entries, lohis, S, weight,
                                              s_body, touched);
    }
    if constexpr (!MATH) touch_total(rows, touched, s_red);
    rows.store(parts + static_cast<size_t>(blockIdx.x) * tb * DIM);  // zeros past np
  } else {
    // the runs of one tile in [e0, e1), in order: the same for every thread
    for (int s0 = e0; s0 < e1;) {
      const int tile = entries[s0] >> 16;
      if (tile >= ntiles) break;  // sorted: no later entry has a row tile
      int s1 = s0 + 1;
      while (s1 < e1 && (entries[s1] >> 16) == tile) ++s1;
      const Share sh = share_of(s0, s1 - s0, P, p);
      if (sh.c > sh.a) {
        rows.load(xi, tb, tile, 0);
        for (int e = sh.a; e < sh.c; ++e) {
          add_entry<DIM, PACKED, SEL, WHEN, MATH>(rows, e, xm, split, nj, entries, lohis, S,
                                                  weight, s_body, touched);
        }
        // slice tile * P + p; rows.store adds the tile's own row offset
        float* slice = parts + static_cast<size_t>(tile) * (P - 1) * tb * DIM +
                       static_cast<size_t>(p) * tb * DIM;
        const bool crosses = (s0 == e0 && e0 > 0 && (entries[e0 - 1] >> 16) == tile) ||
                             (s1 == e1 && e1 < E && (entries[e1] >> 16) == tile);
        if (crosses) {
          rows.store_add(slice);
        } else {
          rows.store(slice);
        }
      }
      s0 = s1;
    }
  }
}

// --- Hopper's bulk copies and mbarriers (PTX), shared::cta addresses ------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem(bar))
      : "memory");
}

// Arrive, and expect `bytes` more of asynchronous copies before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(smem(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

constexpr int kMaxRingEntries = 256;  // entries a ring block takes at most (ce)

// Block b * P + p: part p of block b's CE entries through the ring, its
// partial rows to slice b * P + p of parts. The part's entries' first
// sources and rows in range are tabled in shared memory first, so that the
// loop keeps little in registers. At most 64 registers, 4 blocks an SM
// where the slots leave room (see the header).
template <int DIM, int NBUF, bool MATH>
__global__ void __launch_bounds__(kThreads, kRingBlocks)
dma_ring_kernel(const float* __restrict__ xi, int tb, const float4* __restrict__ xm, int nj,
                const int* __restrict__ entries, int E, int ce, int P, int S, float eps,
                float* __restrict__ parts) {
  extern __shared__ __align__(128) float4 ring[];  // NBUF slots of S rows
  __shared__ __align__(8) uint64_t full[NBUF];
  __shared__ __align__(8) uint64_t empty[NBUF];
  __shared__ int s_base[kMaxRingEntries];  // entry i's first source
  __shared__ int s_len[kMaxRingEntries];   // ... and its rows below nj
  __shared__ float s_red[32];

  const int b = blockIdx.x / P, p = blockIdx.x % P;
  const int e0 = static_cast<int>(min(static_cast<long long>(b) * ce, static_cast<long long>(E)));
  const Share sh = share_of(e0, min(ce, E - e0), P, p);
  const int n = sh.c - sh.a;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long base = static_cast<long long>(entries[sh.a + i] & 0xFFFF) * S;
    const int len = rows_in(base, S, nj);
    s_base[i] = len > 0 ? static_cast<int>(base) : 0;
    s_len[i] = len;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrive, plus the bytes
      mbar_init(&empty[s], kThreads / 32);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();  // the barriers are set up, the table written

  // thread 0: entry i of the part into slot i % NBUF
  const auto issue = [&](int i) {
    const int len = s_len[i];
    uint64_t* bar = &full[i % NBUF];
    if (len > 0) {
      const unsigned bytes = static_cast<unsigned>(len) * sizeof(float4);
      mbar_arrive_expect_tx(bar, bytes);
      bulk_copy(ring + (i % NBUF) * S, xm + s_base[i], bytes, bar);
    } else {
      mbar_arrive(bar);  // nothing to copy: the phase completes on the arrive
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < min(NBUF - 1, n); ++i) issue(i);
  }
  Rows<float, DIM> rows(xi, tb, 0);
  const Weight weight{eps};
  float touched[DIM] = {};
  for (int i = 0; i < n; ++i) {
    if (threadIdx.x == 0 && i + NBUF - 1 < n) {
      // slot (i - 1) % NBUF once every warp has released entry i - 1
      if (i > 0) mbar_wait(&empty[(i - 1) % NBUF], ((i - 1) / NBUF) & 1);
      issue(i + NBUF - 1);
    }
    const int s = i % NBUF;
    mbar_wait(&full[s], (i / NBUF) & 1);
    const float4* slot = ring + s * S;
    const int len = s_len[i];
    if constexpr (MATH) {
      for (int k0 = 0; k0 < len; k0 += kChunk) add_stage(rows, slot + k0, min(kChunk, len - k0), weight);
    } else {
      touch_rows<DIM>(slot, len, touched);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
  if constexpr (!MATH) touch_total(rows, touched, s_red);
  rows.store(parts + static_cast<size_t>(blockIdx.x) * tb * DIM);
}

using LadderFn = void (*)(const float*, int, int, const float4*, const float*, const float*, int,
                          const int*, const int*, int, int, int, int, float, float*);

// Rungs, in the order of cuda_entry_probes.RUNGS: ideal, sepmj, sel, when,
// switch, noskip, at kLadderBlocks; MATH = false, and min_blocks =
// kRingBlocks, only for ideal.
template <int DIM>
LadderFn ladder_for(int rung, int math, int min_blocks) {
  if (min_blocks == kRingBlocks) {
    if (rung != 0) return nullptr;
    return math ? entry_ladder_kernel<DIM, true, false, false, false, true, kRingBlocks>
                : entry_ladder_kernel<DIM, true, false, false, false, false, kRingBlocks>;
  }
  if (min_blocks != kLadderBlocks) return nullptr;
  constexpr int B = kLadderBlocks;
  if (!math) return rung == 0 ? entry_ladder_kernel<DIM, true, false, false, false, false, B> : nullptr;
  switch (rung) {
    case 0: return entry_ladder_kernel<DIM, true, false, false, false, true, B>;
    case 1: return entry_ladder_kernel<DIM, false, false, false, false, true, B>;
    case 2: return entry_ladder_kernel<DIM, true, true, false, false, true, B>;
    case 3: return entry_ladder_kernel<DIM, true, true, true, false, true, B>;
    case 4: return entry_ladder_kernel<DIM, true, true, false, true, true, B>;
    case 5: return entry_ladder_kernel<DIM, false, true, false, true, true, B>;
    default: return nullptr;
  }
}

using RingFn = void (*)(const float*, int, const float4*, int, const int*, int, int, int, int, float,
                        float*);

template <int DIM>
RingFn ring_for(int nbuf, int math) {
  if (nbuf == 2) return math ? dma_ring_kernel<DIM, 2, true> : dma_ring_kernel<DIM, 2, false>;
  if (nbuf == 4) return math ? dma_ring_kernel<DIM, 4, true> : dma_ring_kernel<DIM, 4, false>;
  return nullptr;
}

LadderFn ladder_of(int dim, int rung, int math, int min_blocks) {
  return dim == 2 ? ladder_for<2>(rung, math, min_blocks)
                  : dim == 3 ? ladder_for<3>(rung, math, min_blocks) : nullptr;
}

RingFn ring_of(int dim, int nbuf, int math) {
  return dim == 2 ? ring_for<2>(nbuf, math) : dim == 3 ? ring_for<3>(nbuf, math) : nullptr;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % alignof(float4) == 0; }

// The grid of `blocks` blocks of P parts; 0 when it does not fit.
unsigned grid_of(int E, int per_block, int P) {
  const long long blocks = (static_cast<long long>(E) + per_block - 1) / per_block;
  return blocks * P > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks * P);
}

}  // namespace

// One rung of the ladder, its kernel built with launch bounds asking
// min_blocks blocks an SM (kLadderBlocks; kRingBlocks for the ideal rung
// only). Pointers are device pointers to contiguous
// arrays: xi (ntiles*tb, dim) rows, tb <= 512; the sources as xm (nj, 4)
// float4 rows (16-byte aligned) for the packed rungs and the control, mj
// (nj,) and xj (nj, dim) for the split ones (the other pointers may be
// null); entries (E,) int32 (tile << 16 | blk), lohis (E,) int32 (lo | hi
// << 16) for the masked rungs. Block b takes entries [b*per_block,
// (b+1)*per_block) in P parts. parts is (ceil(E / per_block) * P, tb, dim)
// for the fixed-tile rungs, every slice written; (ntiles * P, tb, dim),
// zeroed, for switch and noskip. Returns the cudaError_t of the launch;
// the kernel runs on `stream` and nothing here synchronises.
extern "C" int nbody_entry_ladder(int device, int dim, int rung, int math, int min_blocks,
                                  const void* xi, int tb, int ntiles, const void* xm,
                                  const void* mj, const void* xj, int nj, const void* entries,
                                  const void* lohis, int E, int per_block, int P, int S,
                                  double eps, void* parts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const LadderFn kernel = ladder_of(dim, rung, math, min_blocks);
  if (kernel == nullptr || tb <= 0 || tb > kRowsPerBlock || ntiles <= 0 || S <= 0 || E <= 0 ||
      per_block <= 0 || P <= 0 || (xm != nullptr && !aligned16(xm))) {
    return cudaErrorInvalidValue;
  }
  const unsigned grid = grid_of(E, per_block, P);
  if (grid == 0 || static_cast<long long>(per_block) * P > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, ntiles, static_cast<const float4*>(xm),
      static_cast<const float*>(mj), static_cast<const float*>(xj), nj, static_cast<const int*>(entries),
      static_cast<const int*>(lohis), E, per_block, P, S, static_cast<float>(eps),
      static_cast<float*>(parts));
  return cudaGetLastError();
}

// The ring: xi (tb, dim) rows of one tile, tb <= 512; xm (nj, 4) float4
// rows, 16-byte aligned; entries (E,) int32, block b takes [b*ce,
// (b+1)*ce) in P parts; parts (ceil(E / ce) * P, tb, dim), every slice
// written. nbuf is 2 or 4; ce at most kMaxRingEntries (256).
extern "C" int nbody_dma_ring(int device, int dim, int nbuf, int math, const void* xi, int tb,
                              const void* xm, int nj, const void* entries, int E, int ce, int P,
                              int S, double eps, void* parts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const RingFn kernel = ring_of(dim, nbuf, math);
  if (kernel == nullptr || tb <= 0 || tb > kRowsPerBlock || S <= 0 || E <= 0 || ce <= 0 ||
      ce > kMaxRingEntries || P <= 0 || !aligned16(xm)) {
    return cudaErrorInvalidValue;
  }
  const unsigned grid = grid_of(E, ce, P);
  if (grid == 0) return cudaErrorInvalidValue;
  const size_t smem_bytes = static_cast<size_t>(nbuf) * S * sizeof(float4);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float4*>(xm), nj,
      static_cast<const int*>(entries), E, ce, P, S, static_cast<float>(eps), static_cast<float*>(parts));
  return cudaGetLastError();
}

// The budget of one probe kernel as the CUDA runtime reports it: kernel 0 is the
// ladder (variant = rung, with math and min_blocks as nbody_entry_ladder
// takes them), 1 the ring (variant = nbuf, with math; S sets its slots).
// out[0..4] = registers a thread, local (spill) bytes a thread, static
// shared bytes, dynamic shared bytes, resident blocks of 256 threads an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns the cudaError_t.
extern "C" int nbody_entry_probe_budget(int device, int dim, int kernel, int variant, int math,
                                        int min_blocks, int S, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* fn = nullptr;
  size_t dynamic = 0;
  if (kernel == 0) {
    fn = reinterpret_cast<const void*>(ladder_of(dim, variant, math, min_blocks));
  } else if (kernel == 1 && S > 0) {
    const RingFn ring = ring_of(dim, variant, math);
    fn = reinterpret_cast<const void*>(ring);
    dynamic = static_cast<size_t>(variant) * S * sizeof(float4);
    if (ring != nullptr) {
      err = cudaFuncSetAttribute(ring, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(dynamic));
      if (err != cudaSuccess) return err;
    }
  }
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, dynamic);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(dynamic);
  out[4] = blocks;
  return cudaSuccess;
}
