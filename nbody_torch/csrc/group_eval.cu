// Tree-evaluation kernels of the octree and BVH fast and list paths for
// Hopper (sm_90a), with a plain C interface that nbody_torch/ops/cuda_group_eval.py
// loads through ctypes. Each evaluates T row tiles of `tb` consecutive
// sorted bodies against a set of sources and writes the raw (G-less)
// accelerations
//     out_i = sum_j m_j * (x_j - x_i) / t,
// with pair.cuh's softening: t = (sqrt(d2) + eps)^3 (sqrt3, the octree's)
// or t = d2 * sqrt(d2) + eps (poly, the BVH's). Every evaluation kernel
// is templated on it (SQRT3).
//
// masked_eval_bits_kernel<DIM, SQRT3> replaces masked_eval_bits_pallas
// (nbody_tpu/ops/pallas_group_eval.py:310, body _masked_bits_kernel :270):
// the far field. Every tile sees the same W heap nodes (mass, COM); a packed
// accept bit per (tile, node) gates each node (word l / 32, bit l % 32). A
// tile accepts few of them (81 of the octree's kept nodes a 2^20 3-D tile on
// average, 179 of the BVH's 4,095), so the block compacts its tile's
// accepted nodes before it stages any: each thread reads one word of the
// tile (kThreads words a batch, coalesced), a block scan of the words' bit
// counts gives each word its offset, and the threads write the accepted
// ids, in node order, into a shared list of at most kThreads * 32. The
// staged loop (add_staged_run) then runs over that list, each node gathered
// as one 16-byte body (x, y, z | 0, m). No unaccepted node is staged or
// evaluated; that is exact, since its Pallas weight is 0 * m / t with a
// finite t. A tile with no bit set writes zeros. The walk (add_compacted)
// is shared with the two kernels below that weight their nodes by floats.
//
// window_eval_interval_kernel<DIM, SQRT3> replaces
// window_eval_interval_pallas (:502, body _window_interval_kernel :455):
// the octree's near window (sqrt3; poly for the partitioned BVH that
// nbody_tpu also runs through it). Tile t sees the sorted bodies
// [max(lo, w0*tb), min(hi, (w0 + window_tiles)*tb, nj)), the cell-snapped
// interval inside its window. Only those columns are visited, which is
// nbody_tpu's skip_outside carried to the column. Each of P blocks of the
// tile computes the interval from w0, lo and hi alone and takes the p-th
// of at most P equal shares of it (tile_parts); an empty interval has no
// part. Each part writes its partial rows to its own slice;
// parts_sum_kernel adds them in order. (ops/cuda_group_eval.interval_parts
// mirrors the split in Python.)
//
// window_eval_nodemask_kernel<DIM, SQRT3> replaces
// window_eval_nodemask_pallas (:614, body _window_nodemask_kernel): the
// BVH's near window. Tile t's window is the window_tiles*tb bodies from
// w0*tb, cut into wnodes slots of S bodies; slot v counts when its node is
// open for the tile (in_win[t, v], one byte). Each of P blocks of the tile
// stages the tile's in_win row in shared memory, counts its open bodies
// (those of the open slots below nj) with a block sum, and takes the p-th
// of at most P equal shares of them, in slot order (tile_parts): it walks
// the runs of consecutive open slots with a block-uniform loop and adds
// the part of each run that lies in its share as one range of bodies. A
// closed slot is never visited, which is exact for the reason above and is
// nbody_tpu's skip_outside carried to the slot. The TPU's limit of 64 slots
// per block (unrolled selects) does not apply. Each part writes its partial
// rows to its own slice; parts_sum_kernel adds them in order.
// (ops/cuda_group_eval.window_parts mirrors the split in Python.)
//
// window_eval_dense_kernel<DIM, SQRT3> replaces window_eval_pallas (:383,
// body _masked_eval_kernel :184): the same window with a dense float32 weight
// per (tile, column), mask[t, c], that multiplies m_j as (mask * m) * r, in
// nbody_tpu's order. The BVH takes it where a window block would hold more
// than 64 slots (systems of at most 16 bodies, padded to a few tiles of
// mass-0 bodies), the octree's densemask token on its interval. Tile t's
// columns are [w0*tb, min(w0*tb + wb, nj)); each of P blocks of the tile
// takes the p-th of tile_parts equal shares of them (as the interval window
// does; ops/cuda_group_eval.dense_parts mirrors it) and stages each body
// with its weight folded into the mass. A stage whose folded masses are all
// zero (a closed or padded run of columns) is skipped block-uniformly, which
// changes no bit: its terms are 0 * dx / t with a finite t, and a row sum
// that starts at +0 never becomes -0. Each part writes its partial rows to
// its own slice; parts_sum_kernel adds them in order.
//
// entries_kernel<DIM, SQRT3, Src> ("entries_lohi_kernel") replaces
// entries_lohi_eval_pallas (:963, body _entries_lohi_kernel): the
// near-field exact entries (the octree's near field, the BVH's residual).
// The entry list (tile << 16 | blk, lo | hi << 16) is sorted by tile;
// entry e adds the bodies blk*S + [lo, hi) to its tile's rows. The
// wrapper's plan (cuda_group_eval.entries_plan, on the device) decodes
// each live entry to its first body start[e], numbers the live entries'
// bodies in list order (cum[e] of them before entry e) and cuts each
// tile's run of them into parts of at most part_len bodies, inside an
// entry where it must; block b takes one part, walks it 256 bodies at a
// time across entry boundaries (a part's bodies all act on the same rows;
// body u of entry e is source start[e] + u - cum[e]), and writes its rows'
// partial sums to its own slice of a scratch. entries_sum_kernel
// (parts_sum_kernel on the plan's part_start) then adds each tile's parts
// in part order: no atomics, so two launches give the same bits. A tile
// with no bodies gets one empty part, and so zeros.
//
// The same kernel ("entries_tables_kernel") replaces
// entries_tables_eval_pallas (:1126, body _entries_tables_kernel :777):
// the table-driven entries that scripts/probe_entries_kernel.py times.
// Only the plan's decoder differs: entry (tile << 16 | g) takes its block
// blk_tbl[g] and its range lohi_tbl[g] from two tables, the range cut at
// the block's S lanes (the TPU's lane mask); a pad row (lo == hi) adds no
// bodies. The TPU's chunks, each a grid pass whose outputs are summed, are
// one walk here: the wrapper passes the entries of the chunks that would
// run, which stay tile-sorted. The entries are decoded once, on the
// device, by the plan; the kernel reads only start[e].
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
// padded with mass-0 entries; the kernel visits only each segment's live
// head, [0, n0[t]) and [split, split + n1[t]), which is exact: a padding
// entry adds 0 * dx / t = 0. The callers pass heads of zero for the tiles
// that the exact fallback overwrites, so those tiles cost nothing here. The
// TPU's padding of L to 1,024 lanes is not carried over. Unlike the other
// kernels here it is templated on T in {float, double}, as allpairs.cu is,
// with its rows a thread fixed by T (kListRows: float32 2, float64 1, 4-8%
// faster than 2 at 2^20). Each of P blocks of a tile takes the
// p-th of at most P equal shares of its concatenated heads (tile_parts,
// from n0[t] and n1[t] in the kernel: no plan launches, no host sync); a
// tile whose heads are both empty has no part and its blocks exit at once;
// parts_sum_kernel adds each tile's parts in order.
//
// masked_eval_kernel<DIM, SQRT3> replaces masked_eval_pallas (:216, body
// _masked_eval_kernel :184): the far field with a dense float32 weight per
// (tile, node), mask (T, W), the ablation token densemask of both trees.
// Every tile sees the same W nodes, node l adding (mask[t, l] * m_l) * r *
// dx, in nbody_tpu's order (:206-208). It is the far field's walk with the
// words formed from the floats: each warp reads 32 consecutive weights at
// a time (one coalesced 128-byte load, 16 such loads in flight a thread:
// 8 left the 2^20 octree's rows further from the bytes bound, and at 32 the
// shared lists spill) and turns them into one word by a ballot of w != 0,
// node l in word l / 32, bit l % 32; the block then compacts the nonzero
// weights' ids as masked_eval_bits_kernel does and stages each node as
// (x, y, z | 0, mask[t, l] * m_l), the product rounded once before the
// chain, as window_eval_dense_kernel folds it. A dropped term is (0 * m) *
// r * dx with r finite (t >= eps > 0) and m finite: zero, and a row sum
// that starts at +0 stays +0 without the -0 terms, so dropping it changes
// no bit. A NaN weight is kept (NaN != 0) and carries into the rows, as in
// the Pallas sum; a nonzero weight on a node of mass 0 is kept (the test
// looks at the weight alone) and adds a zero term. A tile with no nonzero weight
// writes zeros. A 2^20 octree row is 37,449 floats (heap levels 0..5), of
// which a tile keeps about 81: the row's bytes, not its pairs, set the
// kernel's floor. One block a tile, no parts: on the descent's lists, whose
// heaviest tiles keep 5x the mean, parts cut some of that tail but cost
// every other call more (the second pass, the rows written P times), and a
// persistent walk that copied each batch's weights into shared memory
// ahead of the chain was slower (PERF.md).
//
// group_shared_masked_kernel<DIM, SQRT3> replaces
// group_shared_masked_eval_pallas (:717, body _group_shared_masked_kernel
// :684): supertiles of G consecutive tiles share one gathered monopole list
// (mj (nsuper, M), xj (nsuper, M, dim)); tile t reads list t / G with its
// own weight row (T, M). The octree's farcompact far field and the
// descent's monopoles (desc1 / desc2) take it. The same walk as
// masked_eval_kernel over list t / G (the weight folded as at :707-709);
// padded monopoles carry m = 0.
//
// entries_kernel<DIM, SQRT3, PackedSource> ("entries_lohi_kernel<packed>")
// replaces _entries_lohi_packed_kernel (:896, entries_lohi_eval_pallas(
// packed_j=True) :1040): the entries kernel reading each source body as
// one 16-byte float4 (x, y, z | 0, m) from an (npad, 4) array the wrapper
// builds, the GPU form of the TPU's one (4, S) block per entry (ablation
// token packedj). The unpacked kernel stages the same float4 from the
// split arrays, so the staged values, the plan and the pair arithmetic
// after them are the same, and the two agree bit for bit.
//
// Four kernels take a mode, a template flag, for the A/B tokens of the
// fast paths (ablate=): masked_eval_bits_kernel<.., TG = 2> (ftg2: a block
// holds two tiles' rows and walks the OR of their words),
// window_eval_interval_kernel<.., FULL> and window_eval_nodemask_kernel<..,
// FULL> (nowinskip: every window column visited), entries_kernel<.., SPAN>
// (subwN, noskip: each entry visits a span around [lo, hi)). Each visits
// what the Pallas kernel visits in that mode and gives a source it masks
// the weight (0 * m) * r, as nbody_tpu does; the default instantiations
// are unchanged.
//
// What bounds them on an H100: FP32 and SFU issue per pair (float64 issue
// in the float64 list kernel), not bytes: the sources are staged once per
// block through shared memory and read as broadcasts (the dense-mask far
// field also streams its mask rows: 307 MB at 2^20 3-D). Each thread holds
// two rows (256 threads, 512 rows per block, one default tile), and every
// staged source is used for both. A tile of more than 512 rows gets
// several blocks. All of them are bound by the pair chain (and, but for the
// three far fields, by the tail of their heaviest tiles), and share one
// design:
//   - the two-MUFU chain of pair.cuh (ChainWeight), d2 summed from the
//     least normal number (the sources include the rows themselves, and a
//     self-pair's dx = 0 then gets a finite weight and a zero term): in
//     float32 the approximate reciprocal and one Newton step that
//     _entries_lohi_kernel (pallas_group_eval.py:877-878), _group_eval_kernel
//     (:73-74) and the windows (_pair_weight :143-144) take; in float64
//     the MUFU seeds refined twice, within a few ulps of the IEEE division
//     that nbody_tpu's float64 jnp evaluation takes;
//   - parts of about equal work (but in the three far fields, whose tiles
//     keep 81-337 sources at 2^20 on average, too few to pay for a second
//     pass; see masked_eval_kernel): one block a tile ends a call on a tail
//     of its heaviest tiles (the entries' work varies 2.5-10x a tile) or in
//     a part-empty last wave (2,048 blocks of 512 rows at 2^20); the
//     entries' parts come from a plan (entries_plan), the list's and the
//     windows' are computed in the kernel from what each tile holds, P a
//     tile from shapes alone; each part writes its own slice of partial
//     rows and parts_sum_kernel adds them in order, so two launches give
//     the same bits (the sum pass is bound by its bytes: 16-byte loads,
//     several parts in flight a thread);
//   - one staged loop (staged.cuh add_staged_run): each body staged once as
//     (x, y, z | 0, m), 16 bytes in float32 and 32 in float64, and read as
//     broadcasts.
//
// Summation: a thread sums groups of kGroup = 32 terms, adds each group to
// its shared stage's sum (kChunk bodies), and each stage to the row total
// (in the entries kernel, the part's; a stage there may span entries). A
// single running sum over a 256-body stage lost up to ~150 ulps of the
// row's sum of |term| where the terms share a sign (measured on an H100:
// 8.7e-6 against float64 at the 2^20 window, ~13x the twin's error). The
// longest running sums left are a row's over its stages, or over a tile's
// parts (parts_sum_kernel).

#include <cuda_runtime.h>

#include <cstdint>

#include "pair.cuh"
#include "staged.cuh"
#include "tiles.cuh"

namespace {

using nbody::add_staged_run;
using nbody::kChunk;
using nbody::kRowsPerBlock;
using nbody::kThreads;
using nbody::PackedSource;
using nbody::Rows;
using nbody::SplitSource;
using nbody::Staged;
using nbody::staged;

constexpr int kFarWords = kThreads;                         // far-field words a batch, one a thread
constexpr int kWeightLoads = 16;                            // weight loads in flight a thread
constexpr int kMaxWindowSlots = 32768;                     // node-mask window slots a tile

// The parts of a tile whose work (bodies, in its order) is `work`, split by
// the list kernel and the three windows: one part per kChunk bodies, at most
// P; part p of np takes the bodies [work * p / np, work * (p + 1) / np).
// No part for a tile without work.
__device__ __forceinline__ int tile_parts(long long work, int P) {
  return static_cast<int>(min(static_cast<long long>(P), (work + kChunk - 1) / kChunk));
}

// The sum of v over the block (kThreads threads), returned to every
// thread; s_red holds kThreads / 32 ints.
__device__ __forceinline__ int block_sum(int v, int* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += s_red[w];
  return total;
}

// The exclusive prefix sum of v over the block (kThreads threads), and the
// block's total in `total`; s_red holds kThreads / 32 ints, which the
// caller may write again only after its next barrier.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_red, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inclusive = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inclusive, o);
    if (lane >= o) inclusive += u;
  }
  if (lane == 31) s_red[warp] = inclusive;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int n = s_red[w];
    if (w < warp) before += n;
    total += n;
  }
  return before + inclusive - v;
}

// The words of a far-field batch: the thread's word b0 + threadIdx.x of
// its tile (node l in word l / 32, bit l % 32), 0 past the tile's words.
// Called by every thread with the same b0. From packed accept bits in
// memory (masked_eval_bits_kernel); bits past node W - 1 in the last word
// are not read ...
struct BitWords {
  const unsigned* __restrict__ words;  // the tile's nw words
  int nw;
  unsigned tail;  // the last word's nodes

  __device__ __forceinline__ unsigned operator()(int b0) const {
    const int k = b0 + static_cast<int>(threadIdx.x);
    unsigned bits = k < nw ? words[k] : 0u;
    if (k == nw - 1) bits &= tail;
    return bits;
  }
};

// ... or by a ballot over the tile's row of W float weights, a bit set where
// the weight is not zero (masked_eval_kernel, group_shared_masked_kernel).
// Warp v forms the batch's words v*32 .. v*32 + 31, one a step: its lanes
// read the word's 32 consecutive weights (one coalesced 128-byte load;
// kWeightLoads words' loads in flight before their ballots) and lane k
// keeps word v*32 + k. The row's start need not be 16-byte aligned, so the
// loads are 4 bytes a lane; weights past W read as zero.
struct WeightWords {
  const float* __restrict__ w;  // the tile's W weights
  int W;

  __device__ __forceinline__ unsigned operator()(int b0) const {
    const int lane = static_cast<int>(threadIdx.x & 31u);
    const int word0 = b0 + static_cast<int>(threadIdx.x & ~31u);  // the warp's first word
    unsigned mine = 0u;
#pragma unroll 1
    for (int k0 = 0; k0 < 32 && (word0 + k0) * 32 < W; k0 += kWeightLoads) {  // warp-uniform
      float v[kWeightLoads];
#pragma unroll
      for (int k = 0; k < kWeightLoads; ++k) {
        const int l = (word0 + k0 + k) * 32 + lane;
        v[k] = l < W ? w[l] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kWeightLoads; ++k) {
        const unsigned word = __ballot_sync(0xffffffffu, v[k] != 0.0f);  // NaN != 0: kept
        if (lane == k0 + k) mine = word;
      }
    }
    return mine;
  }
};

// Node l of `src` staged with its weight folded into its mass, (x, y, z |
// 0, w[l] * m_l): nbody_tpu's (mask * m), rounded once before the chain.
template <int DIM>
__device__ __forceinline__ float4 weighted(const SplitSource<float, DIM>& src,
                                           const float* __restrict__ w, int l) {
  float4 v = staged(src, l);
  v.w = w[l] * v.w;
  return v;
}

// The three far fields' walk over a tile's nw words, kFarWords a batch,
// one a thread (word(b0), BitWords or WeightWords): each batch's nodes with
// a set bit (at most kFarWords * 32, so an id relative to the batch fits
// 16 bits) are compacted into s_ids in node order (a block scan of the
// words' bit counts gives each word its offset) and run through the staged
// loop, node l staged as fetch(l).
template <int DIM, bool SQRT3, typename Words, typename Fetch>
__device__ __forceinline__ void add_compacted(Rows<float, DIM>& rows, int nw, const Words& word,
                                              const Fetch& fetch, float eps) {
  __shared__ unsigned short s_ids[kFarWords * 32];
  __shared__ float4 s_body[kChunk];
  __shared__ int s_red[kThreads / 32];

  const nbody::ChainWeight<float, SQRT3> weight{eps};
  for (int b0 = 0; b0 < nw; b0 += kFarWords) {
    unsigned bits = word(b0);
    int accepted;
    int at = block_exclusive_scan(__popc(bits), s_red, accepted);
    for (; bits; bits &= bits - 1) {
      s_ids[at++] = static_cast<unsigned short>(threadIdx.x * 32 + __ffs(bits) - 1);
    }
    __syncthreads();  // s_ids written (and s_red read)
    const int node0 = b0 * 32;
    add_staged_run(rows, 0, accepted, weight, s_body,
                   [&](long long u) { return fetch(node0 + s_ids[u]); });
  }
}

// One stage of the two-tile far field: the staged nodes s[0, len) and their
// tiles' accept bits sel[k] (bit r set: row r's tile accepts node k), added
// to rows.acc as add_stage adds them, row r weighting node k's mass by its
// own tile's bit, (sel * m) * r: a node its tile did not accept adds 0 * dx.
template <int DIM, bool SQRT3>
__device__ __forceinline__ void add_stage_pair(Rows<float, DIM>& rows, const float4* s,
                                               const unsigned char* sel, int len,
                                               const nbody::ChainWeight<float, SQRT3>& weight) {
  float part[nbody::kRows][DIM];
  nbody::zero(part);
  for (int k0 = 0; k0 < len; k0 += nbody::kGroup) {
    float group[nbody::kRows][DIM];
    nbody::zero(group);
    const int k1 = min(len, k0 + nbody::kGroup);
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 v = s[k];
      const unsigned bits = sel[k];
      const float x[3] = {v.x, v.y, v.z};
#pragma unroll
      for (int r = 0; r < nbody::kRows; ++r) {
        float dx[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) dx[d] = x[d] - rows.p[r][d];
        const float m = static_cast<float>((bits >> r) & 1u) * v.w;
        const float w = weight(m, nbody::sep2_from<float, DIM>(nbody::least_normal(0.0f), dx));
#pragma unroll
        for (int d = 0; d < DIM; ++d) group[r][d] += w * dx[d];
      }
    }
    nbody::add_to(part, group);
  }
  nbody::add_to(rows.acc, part);
}

// Block (t, sub): tile t's far field into rows sub*512.. of the tile, its
// accepted nodes from its packed bits. With TG = 2 (the ftg2 token,
// nbody_tpu's tile_group=2, pallas_group_eval.py:290-301), block (g, sub)
// holds the rows sub*256.. of both tiles 2g and 2g + 1, row r of each thread
// in tile 2g + r: it walks the OR of the two tiles' words, each compacted
// node carrying its two bits, and each row weights a node by its own tile's
// bit; a last odd tile pairs with a pad tile of no bits and no rows
// (:341-346). At most 48 registers, 5 blocks an SM, as the windows take.
template <int DIM, bool SQRT3, int TG>
__global__ void __launch_bounds__(kThreads, 5)
masked_eval_bits_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                        const float* __restrict__ xj, int W, const unsigned* __restrict__ words,
                        int nw, int ntiles, float eps, float* __restrict__ out) {
  const unsigned tail = W % 32 == 0 ? ~0u : (1u << (W % 32)) - 1u;  // the last word's nodes
  const SplitSource<float, DIM> src{mj, xj};
  if constexpr (TG == 1) {
    Rows<float, DIM> rows(xi, tb);
    const BitWords bits{words + static_cast<size_t>(blockIdx.x) * nw, nw, tail};
    add_compacted<DIM, SQRT3>(rows, nw, bits, [&](int l) { return staged(src, l); }, eps);
    rows.store(out);
  } else {
    __shared__ unsigned short s_ids[kFarWords * 32];
    __shared__ unsigned char s_pick[kFarWords * 32];
    __shared__ float4 s_body[kChunk];
    __shared__ unsigned char s_sel[kChunk];
    __shared__ int s_red[kThreads / 32];

    Rows<float, DIM> rows(xi, tb, 0, 0);
    const int local = static_cast<int>(blockIdx.y) * kThreads + static_cast<int>(threadIdx.x);
#pragma unroll
    for (int r = 0; r < nbody::kRows; ++r) {  // row r of the thread: tile 2g + r
      const int t = 2 * static_cast<int>(blockIdx.x) + r;
      rows.row[r] = t < ntiles && local < tb ? t * tb + local : -1;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        rows.p[r][d] = rows.row[r] >= 0 ? xi[static_cast<size_t>(rows.row[r]) * DIM + d] : 0.0f;
      }
    }
    const unsigned* wa = words + static_cast<size_t>(2 * blockIdx.x) * nw;
    const bool has_b = 2 * static_cast<int>(blockIdx.x) + 1 < ntiles;
    const nbody::ChainWeight<float, SQRT3> weight{eps};
    for (int b0 = 0; b0 < nw; b0 += kFarWords) {
      const int k = b0 + static_cast<int>(threadIdx.x);
      unsigned a = k < nw ? wa[k] : 0u;
      unsigned b = has_b && k < nw ? wa[nw + k] : 0u;
      if (k == nw - 1) {
        a &= tail;
        b &= tail;
      }
      unsigned bits = a | b;
      int accepted;
      int at = block_exclusive_scan(__popc(bits), s_red, accepted);
      for (; bits; bits &= bits - 1) {
        const int bit = __ffs(bits) - 1;
        s_ids[at] = static_cast<unsigned short>(threadIdx.x * 32 + bit);
        s_pick[at++] = static_cast<unsigned char>(((a >> bit) & 1u) | (((b >> bit) & 1u) << 1));
      }
      __syncthreads();  // s_ids and s_pick written (and s_red read)
      const int node0 = b0 * 32;
      for (int j0 = 0; j0 < accepted; j0 += kChunk) {
        const int len = min(kChunk, accepted - j0);
        if (static_cast<int>(threadIdx.x) < len) {
          s_body[threadIdx.x] = staged(src, node0 + s_ids[j0 + threadIdx.x]);
          s_sel[threadIdx.x] = s_pick[j0 + threadIdx.x];
        }
        __syncthreads();
        add_stage_pair<DIM, SQRT3>(rows, s_body, s_sel, len, weight);
        __syncthreads();
      }
    }
    rows.store(out);
  }
}

// Block (t, sub): tile t's dense-mask far field into rows sub*512.. of the
// tile: its nonzero weights mask[t, l] compacted, each node staged with
// mask[t, l] * m_l. At most 48 registers, 5 blocks an SM.
template <int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads, 5)
masked_eval_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                   const float* __restrict__ xj, int W, const float* __restrict__ mask, float eps,
                   float* __restrict__ out) {
  Rows<float, DIM> rows(xi, tb);
  const float* weights = mask + static_cast<size_t>(blockIdx.x) * W;
  const SplitSource<float, DIM> src{mj, xj};
  add_compacted<DIM, SQRT3>(rows, (W + 31) / 32, WeightWords{weights, W},
                            [&](int l) { return weighted(src, weights, l); }, eps);
  rows.store(out);
}

// Block (t, sub): the same over supertile t / G's list of M monopoles, with
// tile t's weight row. At most 48 registers, 5 blocks an SM.
template <int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads, 5)
group_shared_masked_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                           const float* __restrict__ xj, int M, int G,
                           const float* __restrict__ mask, float eps, float* __restrict__ out) {
  Rows<float, DIM> rows(xi, tb);
  const int t = blockIdx.x;
  const size_t list = static_cast<size_t>(t / G) * M;  // the supertile's monopoles
  const float* weights = mask + static_cast<size_t>(t) * M;
  const SplitSource<float, DIM> src{mj + list, xj + list * DIM};
  add_compacted<DIM, SQRT3>(rows, (M + 31) / 32, WeightWords{weights, M},
                            [&](int l) { return weighted(src, weights, l); }, eps);
  rows.store(out);
}

// Tile t's interval, [a, b) = [max(lo[t], w0[t]*tb), min(hi[t], (w0[t] +
// window_tiles)*tb, nj)) (empty where b <= a), and its work b - a, >= 0.
struct Interval {
  long long a, work;
};
__device__ __forceinline__ Interval tile_interval(int t, int tb, int nj, const int* __restrict__ w0,
                                                  const int* __restrict__ lo,
                                                  const int* __restrict__ hi, int window_tiles) {
  const long long col0 = static_cast<long long>(w0[t]) * tb;
  const long long a = max(static_cast<long long>(lo[t]), col0);
  const long long b = min(min(static_cast<long long>(hi[t]), col0 + static_cast<long long>(window_tiles) * tb),
                          static_cast<long long>(nj));
  return Interval{a, max(b - a, 0LL)};
}

// Block (t*P + p, sub): part p of tile t's interval, the p-th of tile_parts
// equal shares of its bodies, into rows sub*512.. of the tile, written to
// slice t*P + p of parts (ntiles * P, tb, DIM); block (t*P, 0) writes the
// tile's part count to nparts[t]. An empty interval has no part. With FULL
// (the nowinskip token: nbody_tpu's skip_outside=False,
// pallas_group_eval.py:482-494) the parts share the whole window [w0*tb,
// min((w0 + window_tiles)*tb, nj)) instead, and a column outside [lo, hi)
// gets weight zero, (sel * m) * r (:485-487). At most 48 registers, 5 blocks
// an SM, as the node-mask window takes: left to itself nvcc gave this kernel
// 64 (4 blocks), 2% slower at 2^20 (PERF.md).
template <int DIM, bool SQRT3, bool FULL>
__global__ void __launch_bounds__(kThreads, 5)
window_eval_interval_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                            const float* __restrict__ xj, int nj, const int* __restrict__ w0,
                            const int* __restrict__ lo, const int* __restrict__ hi,
                            int window_tiles, int P, float eps, int* __restrict__ nparts,
                            float* __restrict__ parts) {
  __shared__ float4 s_body[kChunk];

  const int t = blockIdx.x / P, p = blockIdx.x % P;
  Interval iv;
  if constexpr (FULL) {
    const long long col0 = static_cast<long long>(w0[t]) * tb;
    const long long end = min(col0 + static_cast<long long>(window_tiles) * tb, static_cast<long long>(nj));
    iv = Interval{col0, max(end - col0, 0LL)};
  } else {
    iv = tile_interval(t, tb, nj, w0, lo, hi, window_tiles);
  }
  const int np = tile_parts(iv.work, P);
  if (p == 0 && blockIdx.y == 0 && threadIdx.x == 0) nparts[t] = np;
  if (p >= np) return;  // an empty interval, or a part past the tile's count
  Rows<float, DIM> rows(xi, tb, t, blockIdx.y);
  const SplitSource<float, DIM> src{mj, xj};
  const long long keep_lo = FULL ? lo[t] : 0, keep_hi = FULL ? hi[t] : 0;
  add_staged_run(rows, iv.a + iv.work * p / np, iv.a + iv.work * (p + 1) / np,
                 nbody::ChainWeight<float, SQRT3>{eps}, s_body, [&](long long j) {
                   float4 v = staged(src, static_cast<int>(j));
                   if constexpr (FULL) v.w = (j >= keep_lo && j < keep_hi ? 1.0f : 0.0f) * v.w;
                   return v;
                 });
  rows.store(parts + static_cast<size_t>(blockIdx.x - t) * tb * DIM);
}

// The bodies of window slot v that lie below nj: min(S, nj - (col0 + v*S)), >= 0.
__device__ __forceinline__ int slot_bodies(long long col0, int v, int S, int nj) {
  return static_cast<int>(max(0LL, min(static_cast<long long>(S), nj - (col0 + static_cast<long long>(v) * S))));
}

// Block (t*P + p, sub): part p of tile t's open window bodies, in slot
// order, into rows sub*512.. of the tile, written to slice t*P + p of
// parts (ntiles * P, tb, DIM); block (t*P, 0) writes the tile's part count
// to nparts[t]. The tile's in_win row is staged in dynamic shared memory.
// With FULL (the nowinskip token: nbody_tpu's skip_outside=False,
// pallas_group_eval.py:582-606) the parts share every window body below nj,
// open or not, and a body of a closed slot gets weight zero, (sel * m) * r
// (:590-596).
template <int DIM, bool SQRT3, bool FULL>
__global__ void __launch_bounds__(kThreads)
window_eval_nodemask_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                            const float* __restrict__ xj, int nj, const int* __restrict__ w0,
                            const unsigned char* __restrict__ in_win, int wnodes, int S, int P,
                            float eps, int* __restrict__ nparts, float* __restrict__ parts) {
  extern __shared__ unsigned char s_open[];
  __shared__ float4 s_body[kChunk];
  __shared__ int s_red[kThreads / 32];

  const int t = blockIdx.x / P, p = blockIdx.x % P;
  const long long col0 = static_cast<long long>(w0[t]) * tb;
  const unsigned char* slot_open = in_win + static_cast<size_t>(t) * wnodes;
  int open = 0;
  for (int v = threadIdx.x; v < wnodes; v += kThreads) {
    const unsigned char o = slot_open[v];
    s_open[v] = o;
    if (o || FULL) open += slot_bodies(col0, v, S, nj);
  }
  const int work = block_sum(open, s_red);  // its barrier also publishes s_open
  const int np = tile_parts(work, P);
  if (p == 0 && blockIdx.y == 0 && threadIdx.x == 0) nparts[t] = np;
  if (p >= np) return;  // no open body, or a part past the tile's count
  Rows<float, DIM> rows(xi, tb, t, blockIdx.y);
  const long long u0 = static_cast<long long>(work) * p / np;
  const long long u1 = static_cast<long long>(work) * (p + 1) / np;
  const nbody::ChainWeight<float, SQRT3> weight{eps};
  const SplitSource<float, DIM> src{mj, xj};
  if constexpr (FULL) {  // the window's bodies as one run, each weighted by its slot
    add_staged_run(rows, col0 + u0, col0 + u1, weight, s_body, [&](long long j) {
      float4 v = staged(src, static_cast<int>(j));
      v.w = (s_open[(j - col0) / S] ? 1.0f : 0.0f) * v.w;
      return v;
    });
  } else {
    const auto fetch = [&](long long j) { return staged(src, static_cast<int>(j)); };
    // the same slots for every thread: a block-uniform walk over the runs of
    // open slots, each run one contiguous range of bodies; c of the tile's
    // open bodies lie before the run
    long long c = 0;
    for (int v = 0; v < wnodes && c < u1;) {
      if (!s_open[v]) {
        ++v;
        continue;
      }
      int v1 = v + 1;
      while (v1 < wnodes && s_open[v1]) ++v1;
      const long long a = col0 + static_cast<long long>(v) * S;
      const long long len = max(0LL, min(col0 + static_cast<long long>(v1) * S, static_cast<long long>(nj)) - a);
      const long long lo = max(u0 - c, 0LL), hi = min(u1 - c, len);
      if (lo < hi) add_staged_run(rows, a + lo, a + hi, weight, s_body, fetch);
      c += len;
      v = v1;
    }
  }
  rows.store(parts + static_cast<size_t>(blockIdx.x - t) * tb * DIM);
}

// Block (t*P + p, sub): part p of tile t's window columns [a, min(a + wb,
// nj)), a = w0[t]*tb, the p-th of tile_parts equal shares, each body staged
// with mask[t, c] * m_j as its mass, into rows sub*512.. of the tile,
// written to slice t*P + p of parts (ntiles * P, tb, DIM); block (t*P, 0)
// writes the tile's part count to nparts[t]. A stage of zero weights is
// skipped. At most 48 registers, 5 blocks an SM, as the interval window.
template <int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads, 5)
window_eval_dense_kernel(const float* __restrict__ xi, int tb, const float* __restrict__ mj,
                         const float* __restrict__ xj, int nj, const int* __restrict__ w0,
                         const float* __restrict__ mask, int wb, int P, float eps,
                         int* __restrict__ nparts, float* __restrict__ parts) {
  __shared__ float4 s_body[kChunk];

  const int t = blockIdx.x / P, p = blockIdx.x % P;
  const long long a = static_cast<long long>(w0[t]) * tb;
  const long long work = max(min(a + wb, static_cast<long long>(nj)) - a, 0LL);
  const int np = tile_parts(work, P);
  if (p == 0 && blockIdx.y == 0 && threadIdx.x == 0) nparts[t] = np;
  if (p >= np) return;  // no column below nj, or a part past the tile's count
  Rows<float, DIM> rows(xi, tb, t, blockIdx.y);
  const float* tile_mask = mask + static_cast<size_t>(t) * wb;
  const SplitSource<float, DIM> src{mj, xj};
  add_staged_run<true>(rows, a + work * p / np, a + work * (p + 1) / np,
                       nbody::ChainWeight<float, SQRT3>{eps}, s_body, [&](long long j) {
                         float4 v = staged(src, static_cast<int>(j));
                         v.w = tile_mask[j - a] * v.w;  // (mask * m), nbody_tpu's order
                         return v;
                       });
  rows.store(parts + static_cast<size_t>(blockIdx.x - t) * tb * DIM);
}

// An entries launch's plan (cuda_group_eval.entries_plan): block b takes
// the bodies [u0[b], u1[b]) of tile tile[b] in the live entries' body
// order (cum[e] bodies before entry e, the first of them source start[e]),
// which lie in the entries [e0[b], e1[b]); tile[b] < 0 marks a block past
// the plan's parts. In the span mode each entry's visited sources
// [start[e], start[e] + cum[e + 1] - cum[e]) hold its live ones [keep_lo[e],
// keep_hi[e]); null in the default mode, where every visited source is live.
struct EntriesPlan {
  const long long* __restrict__ cum;
  const long long* __restrict__ start;
  const int* __restrict__ tile;
  const int* __restrict__ e0;
  const int* __restrict__ e1;
  const long long* __restrict__ u0;
  const long long* __restrict__ u1;
  const long long* __restrict__ keep_lo;
  const long long* __restrict__ keep_hi;
};

// Block (b, sub) sums its part's bodies into rows sub*512.. of its tile and
// writes them to slice b of parts (blocks, tb, DIM). With SPAN (the tokens
// subwN and noskip: nbody_tpu's sub_width and skip_empty=False,
// pallas_group_eval.py:855-893) each entry visits a span [a, b) around its
// live range [lo, hi), and a source outside [lo, hi) gets weight zero, (sel *
// m) * r (:879): the plan's parts count the visited sources.
template <int DIM, bool SQRT3, typename Src, bool SPAN>
__global__ void __launch_bounds__(kThreads)
entries_kernel(const float* __restrict__ xi, int tb, const Src src, const EntriesPlan plan,
               float eps, float* __restrict__ parts) {
  __shared__ float4 s_body[kChunk];

  const int b = blockIdx.x;
  const int t = plan.tile[b];
  if (t < 0) return;  // past the plan's parts: no rows to write
  Rows<float, DIM> rows(xi, tb, t, blockIdx.y);
  const int e0 = plan.e0[b], e1 = plan.e1[b];
  // body u of the order lies in the last entry e of [e0, e1) with cum[e] <= u
  const auto fetch = [&](long long u) {
    int lo = e0, hi = e1 - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (plan.cum[mid] <= u) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const long long j = plan.start[lo] + (u - plan.cum[lo]);
    float4 v = staged(src, static_cast<int>(j));
    if constexpr (SPAN) v.w = (j >= plan.keep_lo[lo] && j < plan.keep_hi[lo] ? 1.0f : 0.0f) * v.w;
    return v;
  };
  add_staged_run(rows, plan.u0[b], plan.u1[b], nbody::ChainWeight<float, SQRT3>{eps}, s_body, fetch);
  // b >= t (every tile has a part), so slice b starts (b - t) * tb rows in
  rows.store(parts + static_cast<size_t>(b - t) * tb * DIM);
}

// Where tile t's parts lie in a scratch of partial rows, in part order:
// [first, stop). An entries plan's, from its part_start ...
struct PartStart {
  const int* __restrict__ part_start;
  __device__ __forceinline__ int2 operator()(int t) const {
    return make_int2(part_start[t], part_start[t + 1]);
  }
};
// ... or P slices a tile, of which the first nparts[t] were written (the
// list kernel and the three windows).
struct PartCount {
  const int* __restrict__ nparts;
  int P;
  __device__ __forceinline__ int2 operator()(int t) const {
    return make_int2(t * P, t * P + nparts[t]);
  }
};

// 16 consecutive bytes of a slice, moved as one load and one store: four
// float32 (float4) or two float64 (double2); consecutive threads take
// consecutive 16 bytes, so a warp's loads of one part are contiguous.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ void store(float* p) const { *reinterpret_cast<float4*>(p) = v; }
  __device__ __forceinline__ void add(const Vec16& o) {
    v.x += o.v.x;
    v.y += o.v.y;
    v.z += o.v.z;
    v.w += o.v.w;
  }
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Vec16<double> {
  double2 v;
  __device__ __forceinline__ void load(const double* p) { v = __ldg(reinterpret_cast<const double2*>(p)); }
  __device__ __forceinline__ void store(double* p) const { *reinterpret_cast<double2*>(p) = v; }
  __device__ __forceinline__ void add(const Vec16& o) {
    v.x += o.v.x;
    v.y += o.v.y;
  }
  __device__ __forceinline__ void zero() { v = make_double2(0.0, 0.0); }
};
// ... or one element, for slices whose length is not a multiple of
// Vec16's elements (or whose arrays are not 16-byte aligned).
template <typename T>
struct Single {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = __ldg(p); }
  __device__ __forceinline__ void store(T* p) const { *p = v; }
  __device__ __forceinline__ void add(const Single& o) { v += o.v; }
  __device__ __forceinline__ void zero() { v = T(0); }
};

constexpr int kSumLoads = 8;        // parts a thread loads before adding (PARTS_PER_TILE)
constexpr int kSumBlocksPerSm = 8;  // the sum pass's grid: at most this many blocks an SM

// out (ntiles * tb, dim): each row the sum of its tile's parts of parts
// (slices, tb, dim), added in part order; zero for a tile without parts.
// On an entries plan (PartStart, float) it is "entries_sum_kernel". Pure
// bandwidth: the written slices read once, the rows written once. Item k
// is tile t's elements [q*W, (q+1)*W) of its slice of `slice` (= tb*dim)
// elements (W = 16 bytes' worth with Vec16, 1 with Single; consecutive
// threads on consecutive items), walked by a grid-stride loop over a grid
// of a few blocks an SM. A thread issues the loads of up to Loads parts
// before it adds any, then adds them in part order from the first (not
// from 0, which would turn a -0 into +0): the plain version's chain, bit
// for bit. Loads is kSumLoads, or 4 where no tile has more parts (fewer
// registers, more threads an SM).
template <typename T, typename Parts, typename Item, int Loads>
__global__ void __launch_bounds__(kThreads)
parts_sum_kernel(const T* __restrict__ parts, const Parts ranges, int slice, int items,
                 T* __restrict__ out) {
  constexpr int W = sizeof(Item) / sizeof(T);
  const int per_tile = slice / W;
  for (long long k = blockIdx.x * kThreads + threadIdx.x; k < items; k += gridDim.x * kThreads) {
    const int t = static_cast<int>(k) / per_tile;
    const size_t within = static_cast<size_t>(static_cast<int>(k) - t * per_tile) * W;
    const int2 range = ranges(t);
    Item acc;
    acc.zero();
    for (int p0 = range.x; p0 < range.y; p0 += Loads) {
      const int n = min(Loads, range.y - p0);
      Item v[Loads];
#pragma unroll
      for (int i = 0; i < Loads; ++i) {
        if (i < n) v[i].load(parts + static_cast<size_t>(p0 + i) * slice + within);
      }
#pragma unroll
      for (int i = 0; i < Loads; ++i) {
        if (i >= n) continue;
        if (i == 0 && p0 == range.x) {
          acc = v[i];
        } else {
          acc.add(v[i]);
        }
      }
    }
    acc.store(out + static_cast<size_t>(t) * slice + within);
  }
}

// The list kernel's rows a thread: float32 2, float64 1 (measured on an
// H100 at 2^20: 4-8% faster than 2, PERF.md).
template <typename T>
constexpr int kListRows = sizeof(T) == 4 ? 2 : 1;

// Block (t*P + p, sub): part p of tile t's live heads, nodes [0, n0[t])
// then leaf bodies [split, split + n1[t]), into rows sub*kThreads*R.. of
// the tile, written to slice t*P + p of parts (ntiles * P, tb, DIM);
// block (t*P, 0) writes the tile's part count to nparts[t]. A tile whose
// heads are both empty has no part: its blocks exit at once.
template <typename T, int DIM, bool SQRT3>
__global__ void __launch_bounds__(kThreads)
group_eval_kernel(const T* __restrict__ xi, int tb, const T* __restrict__ mj,
                  const T* __restrict__ xj, int L, int split, const int* __restrict__ n0,
                  const int* __restrict__ n1, int P, T eps, int* __restrict__ nparts,
                  T* __restrict__ parts) {
  __shared__ Staged<T> s_body[kChunk];

  const int t = blockIdx.x / P, p = blockIdx.x % P;
  const long long a = min(max(n0[t], 0), split);
  const long long work = a + min(max(n1[t], 0), L - split);
  const int np = tile_parts(work, P);
  if (p == 0 && blockIdx.y == 0 && threadIdx.x == 0) nparts[t] = np;
  if (p >= np) return;
  Rows<T, DIM, kListRows<T>> rows(xi, tb, t, blockIdx.y);
  const long long u0 = work * p / np, u1 = work * (p + 1) / np;
  const T* tile_m = mj + static_cast<size_t>(t) * L;
  const T* tile_x = xj + static_cast<size_t>(t) * L * DIM;
  const nbody::ChainWeight<T, SQRT3> weight{eps};
  const SplitSource<T, DIM> src{tile_m, tile_x};
  const auto fetch = [&](long long i) { return staged(src, static_cast<int>(i)); };
  // the share's nodes, then its leaf bodies: order u < a is entry u, else split + u - a
  add_staged_run(rows, min(u0, a), min(u1, a), weight, s_body, fetch);
  add_staged_run(rows, split + max(u0, a) - a, split + max(u1, a) - a, weight, s_body, fetch);
  rows.store(parts + static_cast<size_t>(blockIdx.x - t) * tb * DIM);
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

// The split kernels' grid: P blocks a tile, each with tb / (kThreads * R)
// row blocks; {0, 0, 0} when ntiles * P does not fit a grid.
inline dim3 split_grid(int ntiles, int P, int tb, int rows_per_block) {
  if (P <= 0 || static_cast<long long>(ntiles) * P > 0x7fffffffLL) return dim3(0, 0, 0);
  return dim3(static_cast<unsigned>(ntiles * P),
              static_cast<unsigned>((tb + rows_per_block - 1) / rows_per_block));
}

template <typename T>
cudaError_t launch_group_eval(int dim, int sqrt3, const void* xi, int ntiles, int tb, const void* mj,
                              const void* xj, int L, int split, const void* n0, const void* n1,
                              int P, double eps, void* nparts, void* parts, cudaStream_t stream) {
  const auto kernel = pick(dim, sqrt3, group_eval_kernel<T, 2, false>, group_eval_kernel<T, 2, true>,
                           group_eval_kernel<T, 3, false>, group_eval_kernel<T, 3, true>);
  const dim3 grid = split_grid(ntiles, P, tb, kThreads * kListRows<T>);
  if (kernel == nullptr || grid.x == 0 || L < 0 || split < 0 || split > L) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xi), tb, static_cast<const T*>(mj), static_cast<const T*>(xj), L, split,
      static_cast<const int*>(n0), static_cast<const int*>(n1), P, static_cast<T>(eps),
      static_cast<int*>(nparts), static_cast<T*>(parts));
  return cudaGetLastError();
}

// The sum pass on `device`: Vec16 items where every slice starts 16 bytes
// aligned (slice a multiple of Vec16's elements, both arrays aligned), else
// Single; at most max_parts parts a tile.
template <typename T, typename Parts, typename Item>
auto parts_sum_for(int max_parts) {
  return max_parts <= 4 ? parts_sum_kernel<T, Parts, Item, 4> : parts_sum_kernel<T, Parts, Item, kSumLoads>;
}

template <typename T, typename Parts>
cudaError_t launch_parts_sum(int device, int dim, const void* parts, const Parts& ranges, int ntiles,
                             int tb, int max_parts, void* out, void* stream) {
  if (dim != 2 && dim != 3) return cudaErrorInvalidValue;
  const long long count = static_cast<long long>(ntiles) * tb * dim;
  if (count > 0x7fffffffLL) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int slice = tb * dim;
  constexpr int kVec = sizeof(Vec16<T>) / sizeof(T);
  const bool vec = slice % kVec == 0 && reinterpret_cast<uintptr_t>(parts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int items = static_cast<int>(vec ? count / kVec : count);
  const unsigned blocks = static_cast<unsigned>(
      max(1LL, min((static_cast<long long>(items) + kThreads - 1) / kThreads,
                   static_cast<long long>(sms) * kSumBlocksPerSm)));
  const auto kernel = vec ? parts_sum_for<T, Parts, Vec16<T>>(max_parts)
                          : parts_sum_for<T, Parts, Single<T>>(max_parts);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(parts), ranges, slice, items, static_cast<T*>(out));
  return cudaGetLastError();
}

template <int DIM, typename Src>
cudaError_t launch_entries(int sqrt3, const void* xi, int tb, const Src& src,
                           const EntriesPlan& plan, int blocks, double eps, void* parts,
                           void* stream) {
  if ((sqrt3 != 0 && sqrt3 != 1) || blocks <= 0) return cudaErrorInvalidValue;
  if ((plan.keep_lo == nullptr) != (plan.keep_hi == nullptr)) return cudaErrorInvalidValue;
  const bool span = plan.keep_lo != nullptr;
  const auto kernel = sqrt3 ? (span ? entries_kernel<DIM, true, Src, true> : entries_kernel<DIM, true, Src, false>)
                            : (span ? entries_kernel<DIM, false, Src, true> : entries_kernel<DIM, false, Src, false>);
  kernel<<<grid_for(blocks, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, src, plan, static_cast<float>(eps),
      static_cast<float*>(parts));
  return cudaGetLastError();
}

}  // namespace

// Each tile's own list: mj (ntiles, L) and xj (ntiles, L, dim) of `dtype`
// (0 float32, 1 float64), the same type as the rows xi (ntiles*tb, dim);
// n0 and n1 are int32 (ntiles,) live lengths of the list's two segments
// [0, split) and [split, L). Each tile's heads are split into at most P
// parts (kListRows rows a thread: float32 2, float64 1): the kernel
// writes each part's partial rows to parts (ntiles * P, tb, dim) and each
// tile's part count to nparts (ntiles,) int32, which nbody_parts_sum adds.
// Returns the cudaError_t of the launch.
extern "C" int nbody_group_eval(int device, int dtype, int dim, const void* xi, int ntiles, int tb,
                                const void* mj, const void* xj, int L, int split, const void* n0,
                                const void* n1, int sqrt3, double eps, int P, void* nparts,
                                void* parts, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_group_eval<float>(dim, sqrt3, xi, ntiles, tb, mj, xj, L, split, n0, n1, P, eps, nparts, parts, s);
  }
  if (dtype == 1) {
    return launch_group_eval<double>(dim, sqrt3, xi, ntiles, tb, mj, xj, L, split, n0, n1, P, eps, nparts, parts, s);
  }
  return cudaErrorInvalidValue;
}

// out (ntiles * tb, dim) of `dtype` (0 float32, 1 float64): each row the
// sum of its tile's first nparts[t] slices [t * P, t * P + nparts[t]) of
// parts (ntiles * P, tb, dim), added in part order; zero where nparts[t] is
// 0. The second pass of the list kernel and the three windows.
extern "C" int nbody_parts_sum(int device, int dtype, int dim, const void* parts, const void* nparts,
                               int P, int ntiles, int tb, void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  if (P <= 0) return cudaErrorInvalidValue;
  const PartCount ranges{static_cast<const int*>(nparts), P};
  if (dtype == 0) return launch_parts_sum<float>(device, dim, parts, ranges, ntiles, tb, P, out, stream);
  if (dtype == 1) return launch_parts_sum<double>(device, dim, parts, ranges, ntiles, tb, P, out, stream);
  return cudaErrorInvalidValue;
}

// Float32 only. Pointers are device pointers to contiguous arrays: xi
// (ntiles*tb, dim) rows, mj (nj,) and xj (nj, dim) sources, int32 index
// arrays. `sqrt3` picks the softening: 1 sqrt3, 0 poly. Each returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream`
// and nothing here synchronises.
extern "C" int nbody_masked_eval_bits(int device, int dim, const void* xi, int ntiles,
                                      int tb, const void* mj, const void* xj, int W,
                                      const void* words, int nw, int tile_group, int sqrt3,
                                      double eps, void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = tile_group == 2
                          ? pick(dim, sqrt3, masked_eval_bits_kernel<2, false, 2>, masked_eval_bits_kernel<2, true, 2>,
                                 masked_eval_bits_kernel<3, false, 2>, masked_eval_bits_kernel<3, true, 2>)
                          : pick(dim, sqrt3, masked_eval_bits_kernel<2, false, 1>, masked_eval_bits_kernel<2, true, 1>,
                                 masked_eval_bits_kernel<3, false, 1>, masked_eval_bits_kernel<3, true, 1>);
  if (kernel == nullptr || W < 0 || nw != (W + 31) / 32 || (tile_group != 1 && tile_group != 2)) {
    return cudaErrorInvalidValue;
  }
  // two tiles a block: each block's threads hold kThreads rows of each tile
  const dim3 grid = tile_group == 1 ? grid_for(ntiles, tb)
                                    : dim3(static_cast<unsigned>((ntiles + 1) / 2),
                                           static_cast<unsigned>((tb + kThreads - 1) / kThreads));
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), W,
      static_cast<const unsigned*>(words), nw, ntiles, static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}

// The octree's interval window in at most P parts a tile: each part's
// partial rows to parts (ntiles * P, tb, dim), each tile's part count to
// nparts (ntiles,) int32, for nbody_parts_sum; w0, lo, hi (ntiles,) int32.
// full = 1 visits the whole window, the columns outside [lo, hi) weighted 0.
extern "C" int nbody_window_eval_interval(int device, int dim, const void* xi, int ntiles,
                                          int tb, const void* mj, const void* xj, int nj,
                                          const void* w0, const void* lo, const void* hi,
                                          int window_tiles, int full, int sqrt3, double eps,
                                          int P, void* nparts, void* parts, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  if (full != 0 && full != 1) return cudaErrorInvalidValue;
  const auto kernel = full ? pick(dim, sqrt3, window_eval_interval_kernel<2, false, true>,
                                  window_eval_interval_kernel<2, true, true>,
                                  window_eval_interval_kernel<3, false, true>,
                                  window_eval_interval_kernel<3, true, true>)
                           : pick(dim, sqrt3, window_eval_interval_kernel<2, false, false>,
                                  window_eval_interval_kernel<2, true, false>,
                                  window_eval_interval_kernel<3, false, false>,
                                  window_eval_interval_kernel<3, true, false>);
  const dim3 grid = split_grid(ntiles, P, tb, kRowsPerBlock);
  if (kernel == nullptr || grid.x == 0 || window_tiles < 0) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), nj,
      static_cast<const int*>(w0), static_cast<const int*>(lo), static_cast<const int*>(hi), window_tiles, P,
      static_cast<float>(eps), static_cast<int*>(nparts), static_cast<float*>(parts));
  return cudaGetLastError();
}

// The node-mask window in at most P parts a tile: each part's partial
// rows to parts (ntiles * P, tb, dim), each tile's part count to nparts
// (ntiles,) int32, for nbody_parts_sum; in_win (ntiles, wnodes) bytes, at
// most kMaxWindowSlots a tile. full = 1 visits every slot, a closed one's
// bodies weighted 0.
extern "C" int nbody_window_eval_nodemask(int device, int dim, const void* xi, int ntiles,
                                          int tb, const void* mj, const void* xj, int nj,
                                          const void* w0, const void* in_win, int wnodes, int S,
                                          int full, int sqrt3, double eps, int P, void* nparts,
                                          void* parts, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = full ? pick(dim, sqrt3, window_eval_nodemask_kernel<2, false, true>,
                                  window_eval_nodemask_kernel<2, true, true>,
                                  window_eval_nodemask_kernel<3, false, true>,
                                  window_eval_nodemask_kernel<3, true, true>)
                           : pick(dim, sqrt3, window_eval_nodemask_kernel<2, false, false>,
                                  window_eval_nodemask_kernel<2, true, false>,
                                  window_eval_nodemask_kernel<3, false, false>,
                                  window_eval_nodemask_kernel<3, true, false>);
  const dim3 grid = split_grid(ntiles, P, tb, kRowsPerBlock);
  if (kernel == nullptr || grid.x == 0 || wnodes <= 0 || wnodes > kMaxWindowSlots || S <= 0 ||
      (full != 0 && full != 1)) {
    return cudaErrorInvalidValue;
  }
  kernel<<<grid, kThreads, static_cast<size_t>(wnodes), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), nj,
      static_cast<const int*>(w0), static_cast<const unsigned char*>(in_win), wnodes, S, P,
      static_cast<float>(eps), static_cast<int*>(nparts), static_cast<float*>(parts));
  return cudaGetLastError();
}

// The dense-mask window in at most P parts a tile: mask (ntiles, wb)
// float32 weights on the masses of the window columns w0[t]*tb + [0, wb)
// below nj; each part's partial rows to parts (ntiles * P, tb, dim), each
// tile's part count to nparts (ntiles,) int32, for nbody_parts_sum.
extern "C" int nbody_window_eval_dense(int device, int dim, const void* xi, int ntiles, int tb,
                                       const void* mj, const void* xj, int nj, const void* w0,
                                       const void* mask, int wb, int sqrt3, double eps, int P,
                                       void* nparts, void* parts, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, sqrt3, window_eval_dense_kernel<2, false>, window_eval_dense_kernel<2, true>,
                           window_eval_dense_kernel<3, false>, window_eval_dense_kernel<3, true>);
  const dim3 grid = split_grid(ntiles, P, tb, kRowsPerBlock);
  if (kernel == nullptr || grid.x == 0 || wb <= 0) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), nj,
      static_cast<const int*>(w0), static_cast<const float*>(mask), wb, P, static_cast<float>(eps),
      static_cast<int*>(nparts), static_cast<float*>(parts));
  return cudaGetLastError();
}

// The entries kernels write their parts' partial rows to parts (blocks,
// tb, dim) by the plan (cum (E + 1,) and start (E,) int64, tile / e0 / e1
// (blocks,) int32, u0 / u1 (blocks,) int64, and in the span mode keep_lo /
// keep_hi (E,) int64, else both null: EntriesPlan); nbody_entries_sum adds
// them into the rows. The sources are (mj, xj), or with xm != null packed
// as one float4 (x, y, z | 0, m) each in xm (nj, 4), 16-byte aligned; nj is
// not read: the plan addresses only sources below it.
extern "C" int nbody_entries_eval(int device, int dim, const void* xi, int ntiles, int tb,
                                  const void* mj, const void* xj, const void* xm, int sqrt3,
                                  double eps, const void* cum, const void* start,
                                  const void* tile, const void* e0, const void* e1,
                                  const void* u0, const void* u1, const void* keep_lo,
                                  const void* keep_hi, int blocks, void* parts, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  if (xm != nullptr && reinterpret_cast<uintptr_t>(xm) % alignof(float4) != 0) {
    return cudaErrorInvalidValue;
  }
  const EntriesPlan plan{static_cast<const long long*>(cum), static_cast<const long long*>(start),
                         static_cast<const int*>(tile), static_cast<const int*>(e0),
                         static_cast<const int*>(e1), static_cast<const long long*>(u0),
                         static_cast<const long long*>(u1), static_cast<const long long*>(keep_lo),
                         static_cast<const long long*>(keep_hi)};
  const auto* m = static_cast<const float*>(mj);
  const auto* x = static_cast<const float*>(xj);
  const auto* packed = static_cast<const float4*>(xm);
  if (dim == 2) {
    return xm != nullptr
               ? launch_entries<2>(sqrt3, xi, tb, PackedSource<2>{packed}, plan, blocks, eps, parts, stream)
               : launch_entries<2>(sqrt3, xi, tb, SplitSource<float, 2>{m, x}, plan, blocks, eps, parts, stream);
  }
  if (dim == 3) {
    return xm != nullptr
               ? launch_entries<3>(sqrt3, xi, tb, PackedSource<3>{packed}, plan, blocks, eps, parts, stream)
               : launch_entries<3>(sqrt3, xi, tb, SplitSource<float, 3>{m, x}, plan, blocks, eps, parts, stream);
  }
  return cudaErrorInvalidValue;
}

// out (ntiles * tb, dim): each tile's parts of parts (blocks, tb, dim),
// [part_start[t], part_start[t + 1]) by the int32 (ntiles + 1,)
// part_start, added in part order.
extern "C" int nbody_entries_sum(int device, int dim, const void* parts, const void* part_start,
                                 int ntiles, int tb, void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  return launch_parts_sum<float>(device, dim, parts, PartStart{static_cast<const int*>(part_start)},
                                 ntiles, tb, kSumLoads, out, stream);
}

// The dense-mask far field: mask (ntiles, W) float32 weights on the W
// shared nodes mj (W,), xj (W, dim).
extern "C" int nbody_masked_eval(int device, int dim, const void* xi, int ntiles, int tb,
                                 const void* mj, const void* xj, int W, const void* mask,
                                 int sqrt3, double eps, void* out, void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, sqrt3, masked_eval_kernel<2, false>, masked_eval_kernel<2, true>,
                           masked_eval_kernel<3, false>, masked_eval_kernel<3, true>);
  if (kernel == nullptr || W < 0) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), W,
      static_cast<const float*>(mask), static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}

// Supertile-shared monopoles: mj (ceil(ntiles / G), M), xj (ceil(ntiles /
// G), M, dim); tile t reads list t / G with its mask row (ntiles, M).
extern "C" int nbody_group_shared_masked_eval(int device, int dim, const void* xi, int ntiles,
                                              int tb, const void* mj, const void* xj, int M, int G,
                                              const void* mask, int sqrt3, double eps, void* out,
                                              void* stream) {
  cudaError_t err = prepare(device, ntiles, tb);
  if (err != cudaSuccess) return err;
  const auto kernel = pick(dim, sqrt3, group_shared_masked_kernel<2, false>,
                           group_shared_masked_kernel<2, true>, group_shared_masked_kernel<3, false>,
                           group_shared_masked_kernel<3, true>);
  if (kernel == nullptr || M < 0 || G <= 0) return cudaErrorInvalidValue;
  kernel<<<grid_for(ntiles, tb), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xi), tb, static_cast<const float*>(mj), static_cast<const float*>(xj), M,
      G, static_cast<const float*>(mask), static_cast<float>(eps), static_cast<float*>(out));
  return cudaGetLastError();
}
