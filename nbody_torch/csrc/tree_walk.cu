// The trees' faithful per-body walks for Hopper (sm_90a), with a plain C
// interface that nbody_torch/ops/cuda_tree_walk.py loads through ctypes.
// One thread walks one body, 256 threads a block, over the sorted bodies:
// Hilbert order for the BVH, Morton order for the octree, so that the
// threads of a warp take similar paths. Each writes G * acc of its row.
//
// Neither walk replaces a Pallas kernel: nbody_tpu runs each as a vmapped
// lax.while_loop (nbody_tpu/ops/bvh.py:129 compute_force, and
// nbody_tpu/ops/octree.py:198 compute_force), which a plain torch port
// would turn into a loop of thousands of small launches a step. One
// thread a body is the reference's own GPU design (src/bvh.h:251-324,
// src/octree.h:227-255).
//
// bvh_walk_kernel<T, DIM> is the state machine of nbody_tpu/ops/
// bvh.py:144-207, state (t, level, acc, covered), over the heap of
// ops/bvh.py:
//   * at the leaf level (level == nlevels) it sums the node's two bodies
//     t - nnodes and t - nnodes + 1 directly, skipping itself and bodies
//     past n, adds 2 to covered and goes up right (to parent + 1);
//   * at an internal node it accepts when bw^2 < theta^2 * d2, adds
//     m / (d2 * sqrt(d2) + eps) * d and 2^(nlevels - level) to covered
//     and goes right (up when the node is a right child), or else
//     descends to 2t + 1. A dead node (mass 0, centre at the origin,
//     width 0) is accepted like any other and adds nothing but covered;
//   * it ends when covered >= n. n == 1 gives zeros (bvh.py:209-210).
// octree_walk_kernel<T, DIM> is the state machine of
// nbody_tpu/ops/octree.py:237-334 over the level tree of ops/octree.py
// (build_octree): VISIT a node (a one-body node with its body's exact m
// and x; accept when it holds one body or side_l / (sqrt(d2) + eps) <
// theta, side_l = root_side / 2^l; queue a deepest multi-body cell's
// bodies; else descend to its first child), drain the queued bodies (the
// self-pair included: its d is 0) before anything else, then go on to the
// node that ADVANCE reaches: the next sibling, or the first next sibling
// of an ancestor; none from the root ends the walk. Each term is den > 0
// ? m / den : 0 times d, den = (sqrt(d2) + eps)^3 (octree.py:260-263,
// :283).
//
// The layout. An iteration of either walk used to gather its node from
// three to eight arrays (centre, width, mass; count, start, child, parent,
// the bodies' x and m), each load its own sector a lane, the int64 levels
// read as they are. The walks now read packed records, built once a call,
// each a whole number of 16-byte vectors:
//   * BVH node {c_0..c_dim-1, bw, mm} (2-D: 16 bytes in float32, 32 in
//     float64; 3-D float64 48), in 3-D float32 {c, bw} (16 bytes) beside
//     the masses mm, read only for an accepted node, built by
//     ops/cuda_tree_walk.bvh_records;
//   * body {x_0..x_dim-1, m} (16 bytes in float32, 32 in float64);
//   * octree node int4 {first child's flat index, count, start, rope} and
//     a float record {com, mass}, in which a node of count <= 1 carries
//     the body at its clamped start instead (the x and m VISIT used).
// The rope is the flat index that octree.py's ADVANCE loop reaches from
// the node (-1: done), so that the walk jumps there and spends no
// iteration on ADVANCE, which adds no term. octree_pack_kernel<T, DIM>
// builds the octree's records and ropes, a thread a node (it climbs at
// most depth parents) and a body; the walk finds the rope's level by
// stepping down the level offsets (kept in shared memory with the side
// table), as many steps as the rope climbs.
//
// The step. Each iteration is one path for every lane: a record (a node,
// or a body), a separation, maybe a term, a move. The BVH takes a leaf's
// two bodies as two iterations, each a body slot taken like an accepted
// node that covers 1; the octree takes each queued body as an iteration
// taken like an accepted node. So a lane at a leaf or draining a cell
// does not hold its warp-mates on a path of their own, and each lane
// still accepts, opens and queues exactly the nodes that nbody_tpu's
// machine does and adds its terms in that order.
//
// Both walks move strictly forward in depth-first pre-order (the key
// (first leaf slot, level) of a BVH node, (first body, level) of an octree
// node, only grows along a walk; tests/test_torch_walk_layout.py), so a
// warp could step only its lanes at its least key and load their node
// once for all of them. That order was built and timed at groups of 2 to
// 32 lanes and lost to the lanes' own order at every width once the steps
// above were one path (PERF.md §6, rows 15-16); it is not kept.
//
// Arithmetic: IEEE square root and division, as nbody_tpu's plain jnp
// walks take them (nvcc's defaults keep both; the build never passes
// --use_fast_math), accumulated in T in the walk's order: no float32 term
// is promoted to float64. Where they differ from their twins
// (ops/cuda_tree_walk.py) is nvcc's contraction of a * b + c into one
// fused multiply-add, a few ulps of each row's sum of |term|.
//
// What bounds them: the instructions a warp issues an iteration (~80 in
// SASS, the IEEE root's and division's range checks and the state
// machine's moves among them) times the iterations of its longest lane,
// and the scattered 16-byte gathers of the records; the operations bound
// (the interactions' FLOPs) is 6-25x below the walks' times.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kWalkThreads = 256;
constexpr int kMaxOctreeLevels = 17;  // depth <= 16 (ops/octree.max_depth)

// The flat offset of each octree level, passed by value; at[depth + 1] is
// the total.
struct LevelOffsets {
  int at[kMaxOctreeLevels + 1];
};

// A record of FIELDS values of T, padded to whole 16-byte vectors.
template <typename T>
constexpr int kVecLanes = 16 / static_cast<int>(sizeof(T));
template <typename T, int FIELDS>
constexpr int kRecordWidth = (FIELDS + kVecLanes<T> - 1) / kVecLanes<T> * kVecLanes<T>;

template <typename T>
struct VecOf;
template <>
struct VecOf<float> {
  using type = float4;
};
template <>
struct VecOf<double> {
  using type = double2;
};
template <typename T>
using Vec = typename VecOf<T>::type;

__device__ __forceinline__ void unpack(const float4& v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* o) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* o) { return make_float4(o[0], o[1], o[2], o[3]); }
__device__ __forceinline__ double2 pack(const double* o) { return make_double2(o[0], o[1]); }

// Values [LO, HI) of the record at rec (16-byte aligned) into out[LO, HI),
// 16 bytes a load.
template <typename T, int LO, int HI, int W>
__device__ __forceinline__ void load_values(const T* __restrict__ rec, T (&out)[W]) {
  static_assert(LO % kVecLanes<T> == 0 && HI % kVecLanes<T> == 0 && HI <= W,
                "whole 16-byte vectors");
  const Vec<T>* v = reinterpret_cast<const Vec<T>*>(rec);
#pragma unroll
  for (int k = LO / kVecLanes<T>; k < HI / kVecLanes<T>; ++k) {
    unpack(v[k], &out[k * kVecLanes<T>]);
  }
}

template <typename T, int W>
__device__ __forceinline__ void load_record(const T* __restrict__ rec, T (&out)[W]) {
  load_values<T, 0, W>(rec, out);
}

template <typename T, int W>
__device__ __forceinline__ void store_record(T* __restrict__ rec, const T (&in)[W]) {
  Vec<T>* v = reinterpret_cast<Vec<T>*>(rec);
#pragma unroll
  for (int k = 0; k < W / kVecLanes<T>; ++k) v[k] = pack(&in[k * kVecLanes<T>]);
}

// d = xj - xi and its squared length, summed in component order; xj the
// first DIM values of a record.
template <typename T, int DIM, int W>
__device__ __forceinline__ T separation(const T (&xj)[W], const T (&xi)[DIM], T (&d)[DIM]) {
  T d2 = T(0);
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    d[k] = xj[k] - xi[k];
    d2 += d[k] * d[k];
  }
  return d2;
}

template <typename T, int DIM>
__device__ __forceinline__ void add_term(T (&acc)[DIM], T w, const T (&d)[DIM]) {
#pragma unroll
  for (int k = 0; k < DIM; ++k) acc[k] += w * d[k];
}

template <typename T, int DIM>
__device__ __forceinline__ void store_row(T* __restrict__ out, int r, T G, const T (&acc)[DIM]) {
#pragma unroll
  for (int k = 0; k < DIM; ++k) out[static_cast<long long>(r) * DIM + k] = G * acc[k];
}

// The body of row r: its index and position, from the body records.
template <typename T, int DIM>
__device__ __forceinline__ int load_body(const T* __restrict__ bodies, const long long* rows,
                                         int r, T (&xi)[DIM]) {
  constexpr int W = kRecordWidth<T, DIM + 1>;
  const int i = rows ? static_cast<int>(rows[r]) : r;
  T rec[W];
  load_record<T, W>(bodies + static_cast<long long>(i) * W, rec);
#pragma unroll
  for (int k = 0; k < DIM; ++k) xi[k] = rec[k];
  return i;
}

// -------------------------------------------------------------------- BVH

// kApart (3-D float32): the node record is {c, bw}, one 16-byte vector,
// and the masses mm an array of their own, read only for an accepted node;
// else {c, bw, mm}. Each is the faster layout of its dtype on an H100
// (PERF.md §6, row 15): 48-byte float64 records beat 32 bytes and a mass
// apart.
template <typename T, int DIM>
struct BvhTree {
  static constexpr bool kApart = DIM == 3 && sizeof(T) == sizeof(float);
  static constexpr int kNode = kRecordWidth<T, kApart ? DIM + 1 : DIM + 2>;
  static constexpr int kBody = kRecordWidth<T, DIM + 1>;  // {x, m}
  const T* __restrict__ nodes;
  const T* __restrict__ mm;
  const T* __restrict__ bodies;
  int nlevels, nnodes, n;
  T theta2, eps;
};

template <typename T, int DIM>
struct BvhLane {
  const BvhTree<T, DIM>& tr;
  int i, t, level, covered;
  T xi[DIM], acc[DIM];

  __device__ __forceinline__ bool walking() const { return covered < tr.n; }

  // One iteration. A body slot b = t - nnodes of the leaf level is taken
  // like an accepted node that covers 1 (its term if b != i), so a leaf's
  // two bodies are two iterations in bvh.py's order and every iteration is
  // one path: a record, a separation, maybe a term. The walk covers the
  // slots left to right, so covered is the node's first slot: while it
  // walks (covered < n) t lies in the heap and b below n, and bvh.py's
  // clamps and its test b < n never act.
  __device__ __forceinline__ void step() {
    constexpr int kNode = BvhTree<T, DIM>::kNode;
    constexpr int kBody = BvhTree<T, DIM>::kBody;
    constexpr int kFirst = kNode < kBody ? kNode : kBody;
    const bool leaf = level == tr.nlevels;
    const int b = t - tr.nnodes;
    T rec[kNode > kBody ? kNode : kBody];
    const T* src = leaf ? tr.bodies + static_cast<long long>(b) * kBody
                        : tr.nodes + static_cast<long long>(t) * kNode;
    load_values<T, 0, kFirst>(src, rec);
    if (kNode > kFirst && !leaf) load_values<T, kFirst, kNode>(src, rec);
    T d[DIM];
    const T d2 = separation<T, DIM>(rec, xi, d);
    const bool take = leaf ? b != i : rec[DIM] * rec[DIM] < tr.theta2 * d2;
    if (take) {
      T mass = rec[DIM];
      if (!leaf) {
        if constexpr (BvhTree<T, DIM>::kApart) {
          mass = tr.mm[t];
        } else {
          mass = rec[DIM + 1];
        }
      }
      add_term<T, DIM>(acc, mass / (d2 * sqrt(d2) + tr.eps), d);
    }
    // taken (or a slot): on to the right sibling, or up to the parent's
    // right from a right child; else down to the left child
    const bool next = leaf || take;
    const bool up = next && ((t - 1) & 1) == 1;
    covered += next ? 1 << (tr.nlevels - level) : 0;
    t = up ? ((t - 1) >> 1) + 1 : next ? t + 1 : 2 * t + 1;
    level += up ? -1 : next ? 0 : 1;
  }
};

template <typename T, int DIM>
__global__ void __launch_bounds__(kWalkThreads)
bvh_walk_kernel(const BvhTree<T, DIM> tr, const long long* __restrict__ rows, int nrows, T G,
                T* __restrict__ out) {
  const int r = blockIdx.x * kWalkThreads + threadIdx.x;
  if (r >= nrows) return;
  BvhLane<T, DIM> lane{tr, 0, 0, 0, tr.n > 1 ? 0 : tr.n};
  lane.i = load_body<T, DIM>(tr.bodies, rows, r, lane.xi);
#pragma unroll
  for (int k = 0; k < DIM; ++k) lane.acc[k] = T(0);
  while (lane.walking()) lane.step();
  store_row<T, DIM>(out, r, tr.n == 1 ? T(0) : G, lane.acc);
}

// ----------------------------------------------------------------- octree

template <typename T>
__device__ __forceinline__ T cube_weight(T m, T dx) {
  const T den = dx * dx * dx;
  return den > T(0) ? m / den : T(0);
}

template <typename T, int DIM>
struct OctreeTree {
  static constexpr int kRec = kRecordWidth<T, DIM + 1>;  // {com, mass} and {x, m}
  const int4* __restrict__ nodes;  // {first child's flat index, count, start, rope}
  const T* __restrict__ fnodes;
  const T* __restrict__ bodies;
  int n, depth;
  T theta, eps;
};

template <typename T, int DIM>
struct OctreeLane {
  const OctreeTree<T, DIM>& tr;
  const int* off;   // the levels' flat offsets (shared memory)
  const T* side;    // root_side / 2^l (shared memory)
  int node, lvl;    // the next node to visit (-1: none) and its level
  int ds_pos, ds_rem;  // the queued bodies, drained before the node
  T xi[DIM], acc[DIM];

  __device__ __forceinline__ bool walking() const { return node >= 0 || ds_rem > 0; }

  // One iteration: drain one queued body, else VISIT the node (its two
  // records); a drained body is taken like an accepted node, so every
  // iteration is one path: a record, a separation, maybe a term.
  __device__ __forceinline__ void step() {
    constexpr int W = OctreeTree<T, DIM>::kRec;
    const bool drain = ds_rem > 0;
    const int4 rec = drain ? make_int4(0, 0, 0, 0) : tr.nodes[node];
    const T* src = drain ? tr.bodies + static_cast<long long>(min(max(ds_pos, 0), tr.n - 1)) * W
                         : tr.fnodes + static_cast<long long>(node) * W;
    T f[W];
    load_record<T, W>(src, f);
    T d[DIM];
    const T d2 = separation<T, DIM>(f, xi, d);
    const T dx = sqrt(d2) + tr.eps;
    const bool take = drain || rec.y <= 1 || side[lvl] / dx < tr.theta;
    if (take) add_term<T, DIM>(acc, cube_weight(f[DIM], dx), d);
    if (drain) {
      ds_pos += 1;
      ds_rem -= 1;
      return;
    }
    if (!take) {
      if (lvl < tr.depth) {  // descend to the first child, which starts at the same body
        node = rec.x;
        lvl += 1;
        return;
      }
      ds_pos = rec.z;  // a deepest multi-body cell: queue its bodies
      ds_rem = rec.y;
    }
    node = rec.w;  // the rope
    if (node >= 0) {
      while (node < off[lvl]) --lvl;
    }
  }
};

template <typename T, int DIM>
__global__ void __launch_bounds__(kWalkThreads)
octree_walk_kernel(const OctreeTree<T, DIM> tr, const LevelOffsets off,
                   const T* __restrict__ root_side, const long long* __restrict__ rows, int nrows,
                   T G, T* __restrict__ out) {
  __shared__ int s_off[kMaxOctreeLevels + 1];
  __shared__ T s_side[kMaxOctreeLevels];
  if (static_cast<int>(threadIdx.x) <= tr.depth) {
    s_off[threadIdx.x] = off.at[threadIdx.x];
    s_side[threadIdx.x] = *root_side / static_cast<T>(1LL << threadIdx.x);
  }
  __syncthreads();
  const int r = blockIdx.x * kWalkThreads + threadIdx.x;
  if (r >= nrows) return;
  OctreeLane<T, DIM> lane{tr, s_off, s_side, 0, 0, 0, 0};
  load_body<T, DIM>(tr.bodies, rows, r, lane.xi);
#pragma unroll
  for (int k = 0; k < DIM; ++k) lane.acc[k] = T(0);
  while (lane.walking()) lane.step();
  store_row<T, DIM>(out, r, G, lane.acc);
}

// The octree's records, a thread a node f (and a body f): the int4 node
// record (the rope found by octree.py's ADVANCE rule, climbing at most
// depth parents), the float record ({com, mass}, or for a count <= 1 the
// body at the clamped start), the body record {x, m}. Padding nodes get
// records by the same rules; no walk reaches them.
template <typename T, int DIM>
__global__ void __launch_bounds__(kWalkThreads)
octree_pack_kernel(const T* __restrict__ mass, const T* __restrict__ com,
                   const long long* __restrict__ start, const long long* __restrict__ count,
                   const long long* __restrict__ child_start,
                   const long long* __restrict__ child_count,
                   const long long* __restrict__ parent, const LevelOffsets off, int depth,
                   const T* __restrict__ ms, const T* __restrict__ xs, int n,
                   int4* __restrict__ nodes, T* __restrict__ fnodes, T* __restrict__ bodies) {
  constexpr int W = kRecordWidth<T, DIM + 1>;
  const long long f = static_cast<long long>(blockIdx.x) * kWalkThreads + threadIdx.x;
  T rec[W];
#pragma unroll
  for (int k = 0; k < W; ++k) rec[k] = T(0);
  if (f < n) {
#pragma unroll
    for (int k = 0; k < DIM; ++k) rec[k] = xs[f * DIM + k];
    rec[DIM] = ms[f];
    store_record<T, W>(bodies + f * W, rec);
  }
  if (f >= off.at[depth + 1]) return;
  int l = 0;
  while (l < depth && f >= off.at[l + 1]) ++l;
  const long long cnt = count[f], st = start[f];
  int rope = -1;
  long long g = f;
  for (int lg = l; lg > 0; --lg) {
    const long long pf = off.at[lg - 1] + parent[g];
    if (g - off.at[lg] + 1 < child_start[pf] + child_count[pf]) {
      rope = static_cast<int>(g + 1);
      break;
    }
    g = pf;
  }
  const int child = l < depth ? static_cast<int>(off.at[l + 1] + child_start[f]) : -1;
  nodes[f] = make_int4(child, static_cast<int>(cnt), static_cast<int>(st), rope);
  const long long b = min(max(st, 0LL), static_cast<long long>(n - 1));
#pragma unroll
  for (int k = 0; k < DIM; ++k) rec[k] = cnt <= 1 ? xs[b * DIM + k] : com[f * DIM + k];
  rec[DIM] = cnt <= 1 ? ms[b] : mass[f];
  store_record<T, W>(fnodes + f * W, rec);
}

int blocks_for(long long threads) {
  return static_cast<int>((threads + kWalkThreads - 1) / kWalkThreads);
}

template <typename T, int DIM>
cudaError_t launch_bvh(const void* nodes, const void* mm, int nlevels, const void* bodies, int n,
                       const void* rows, int nrows, double theta2, double eps, double G,
                       void* out, cudaStream_t s) {
  const BvhTree<T, DIM> tr{static_cast<const T*>(nodes), static_cast<const T*>(mm),
                           static_cast<const T*>(bodies), nlevels, (1 << nlevels) - 1, n,
                           static_cast<T>(theta2), static_cast<T>(eps)};
  bvh_walk_kernel<T, DIM><<<blocks_for(nrows), kWalkThreads, 0, s>>>(
      tr, static_cast<const long long*>(rows), nrows, static_cast<T>(G), static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int DIM>
cudaError_t launch_octree(const void* nodes, const void* fnodes, const LevelOffsets& off,
                          int depth, const void* bodies, int n, const void* root_side,
                          const void* rows, int nrows, double theta, double eps, double G,
                          void* out, cudaStream_t s) {
  const OctreeTree<T, DIM> tr{static_cast<const int4*>(nodes), static_cast<const T*>(fnodes),
                              static_cast<const T*>(bodies), n, depth, static_cast<T>(theta),
                              static_cast<T>(eps)};
  octree_walk_kernel<T, DIM><<<blocks_for(nrows), kWalkThreads, 0, s>>>(
      tr, off, static_cast<const T*>(root_side), static_cast<const long long*>(rows), nrows,
      static_cast<T>(G), static_cast<T*>(out));
  return cudaGetLastError();
}

struct PackArgs {
  const void *mass, *com, *start, *count, *child_start, *child_count, *parent;
  LevelOffsets off;
  int depth;
  const void *ms, *xs;
  int n;
  void *nodes, *fnodes, *bodies;
};

template <typename T, int DIM>
cudaError_t launch_pack(const PackArgs& a, cudaStream_t s) {
  using I = const long long*;
  const long long threads = a.off.at[a.depth + 1] > a.n ? a.off.at[a.depth + 1] : a.n;
  octree_pack_kernel<T, DIM><<<blocks_for(threads), kWalkThreads, 0, s>>>(
      static_cast<const T*>(a.mass), static_cast<const T*>(a.com), static_cast<I>(a.start),
      static_cast<I>(a.count), static_cast<I>(a.child_start), static_cast<I>(a.child_count),
      static_cast<I>(a.parent), a.off, a.depth, static_cast<const T*>(a.ms),
      static_cast<const T*>(a.xs), a.n, static_cast<int4*>(a.nodes), static_cast<T*>(a.fnodes),
      static_cast<T*>(a.bodies));
  return cudaGetLastError();
}

// The host's offsets (int64, depth + 1 of them) and the total, as int32.
bool read_offsets(const void* offsets, int depth, long long total, LevelOffsets* off) {
  if (depth < 0 || depth >= kMaxOctreeLevels || total <= 0 || total > INT_MAX) return false;
  for (int l = 0; l <= depth; ++l) {
    const long long o = static_cast<const long long*>(offsets)[l];
    if (o < 0 || o >= total || (l > 0 && o <= off->at[l - 1])) return false;
    off->at[l] = static_cast<int>(o);
  }
  off->at[depth + 1] = static_cast<int>(total);
  return true;
}

}  // namespace

// The BVH walk of nrows bodies: row r walks sorted body rows[r] (int64
// (nrows,)), or body r where rows is null. nodes (2^nlevels - 1, W) are
// the heap of ops/bvh.build_tree packed as {c, bw, mm, 0...}, in 3-D
// float32 as {c, bw} beside its masses mm (2^nlevels - 1,), which only
// that case reads; bodies (n, W') its Hilbert-sorted bodies as {x, m,
// 0...}; each record W
// (W') values of `dtype` (0 float32, 1 float64) padded to whole 16-byte
// vectors (ops/cuda_tree_walk.bvh_records, body_records). out (nrows,
// dim) of dtype gets G * acc. Pointers are device pointers to contiguous
// arrays, the records 16-byte aligned. Returns the launch's cudaError_t (0
// on success); the kernel runs on `stream` and nothing here
// synchronises.
extern "C" int nbody_bvh_walk(int device, int dtype, int dim, const void* nodes, const void* mm,
                              int nlevels, const void* bodies, int n, const void* rows, int nrows,
                              double theta2, double eps, double G, void* out, void* stream) {
  if (nrows <= 0 || n <= 0 || nlevels < 1 || nlevels > 30 || (dim != 2 && dim != 3)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dim == 3 ? launch_bvh<float, 3>(nodes, mm, nlevels, bodies, n, rows, nrows, theta2, eps, G, out, s)
                    : launch_bvh<float, 2>(nodes, mm, nlevels, bodies, n, rows, nrows, theta2, eps, G, out, s);
  }
  if (dtype == 1) {
    return dim == 3 ? launch_bvh<double, 3>(nodes, mm, nlevels, bodies, n, rows, nrows, theta2, eps, G, out, s)
                    : launch_bvh<double, 2>(nodes, mm, nlevels, bodies, n, rows, nrows, theta2, eps, G, out, s);
  }
  return cudaErrorInvalidValue;
}

// The octree's records from ops/octree.build_octree's levels: mass (total,)
// and com (total, dim) of `dtype`, start, count, child_start, child_count
// and parent (total,) int64, offsets a HOST pointer to the depth + 1
// levels' flat offsets (int64), ms (n,) and xs (n, dim) the Morton-sorted
// bodies. Writes nodes (total,) int4 {first child's flat index (-1 at the
// deepest level), count, start, rope (-1: done)}, fnodes (total, W) and
// bodies (n, W) of dtype, W = 4 (ops/cuda_tree_walk.octree_records_torch
// is its plain version). Returns as nbody_bvh_walk.
extern "C" int nbody_octree_pack(int device, int dtype, int dim, const void* mass,
                                 const void* com, const void* start, const void* count,
                                 const void* child_start, const void* child_count,
                                 const void* parent, const void* offsets, int depth, int total,
                                 const void* ms, const void* xs, int n, void* nodes,
                                 void* fnodes, void* bodies, void* stream) {
  PackArgs a{mass, com, start, count, child_start, child_count, parent, {}, depth, ms, xs, n,
             nodes, fnodes, bodies};
  if (n <= 0 || (dim != 2 && dim != 3) || !read_offsets(offsets, depth, total, &a.off)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dim == 3 ? launch_pack<float, 3>(a, s) : launch_pack<float, 2>(a, s);
  if (dtype == 1) return dim == 3 ? launch_pack<double, 3>(a, s) : launch_pack<double, 2>(a, s);
  return cudaErrorInvalidValue;
}

// The octree walk of nrows bodies over nbody_octree_pack's records: nodes
// (total,) int4, fnodes (total, W) and bodies (n, W) of `dtype`, offsets
// and depth as there, root_side a device scalar of dtype (the root box's
// side), rows and out as in nbody_bvh_walk. Returns as nbody_bvh_walk.
extern "C" int nbody_octree_walk(int device, int dtype, int dim, const void* nodes,
                                 const void* fnodes, const void* offsets, int depth, int total,
                                 const void* bodies, int n, const void* root_side,
                                 const void* rows, int nrows, double theta, double eps, double G,
                                 void* out, void* stream) {
  LevelOffsets off{};
  if (nrows <= 0 || n <= 0 || (dim != 2 && dim != 3) ||
      !read_offsets(offsets, depth, total, &off)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dim == 3 ? launch_octree<float, 3>(nodes, fnodes, off, depth, bodies, n, root_side, rows, nrows, theta, eps, G, out, s)
                    : launch_octree<float, 2>(nodes, fnodes, off, depth, bodies, n, root_side, rows, nrows, theta, eps, G, out, s);
  }
  if (dtype == 1) {
    return dim == 3 ? launch_octree<double, 3>(nodes, fnodes, off, depth, bodies, n, root_side, rows, nrows, theta, eps, G, out, s)
                    : launch_octree<double, 2>(nodes, fnodes, off, depth, bodies, n, root_side, rows, nrows, theta, eps, G, out, s);
  }
  return cudaErrorInvalidValue;
}
