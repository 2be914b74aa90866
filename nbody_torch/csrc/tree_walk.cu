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
// bvh_walk_kernel<T, DIM> is the state machine of nbody_tpu/ops/bvh.py:
// 144-207, state (t, level, acc, covered), over the heap of ops/bvh.py:
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
// bodies; else descend to its first child), drain the queued bodies one an
// iteration (the self-pair included: its d is 0) before anything else,
// ADVANCE to the next sibling or up to the parent; advancing from the root
// ends the walk. Each term is den > 0 ? m / den : 0 times d, den =
// (sqrt(d2) + eps)^3 (octree.py:260-263, :283).
//
// Arithmetic: IEEE square root and division, as nbody_tpu's plain jnp
// walks take them (nvcc's defaults keep both; the build never passes
// --use_fast_math), accumulated in T in the walk's order: no float32 term
// is promoted to float64. Where they differ from their twins
// (ops/cuda_tree_walk.py) is nvcc's contraction of a * b + c into one
// fused multiply-add, a few ulps of each row's sum of |term|.
//
// What bounds them: the operations of the interactions a body takes (the
// accepted nodes and the direct pairs) and of the opened nodes' MAC tests,
// at the FP32 or FP64 rate, and the latency of their dependent gathers:
// each iteration loads one node or body that the previous iteration
// chose. The design does nothing about either yet: a simple kernel first
// (node layout, warp divergence and the fast form are later work).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWalkThreads = 256;
constexpr int kMaxOctreeLevels = 17;  // depth <= 16 (ops/octree.max_depth)

// The flat offset of each octree level, passed by value.
struct LevelOffsets {
  long long at[kMaxOctreeLevels];
};

template <typename T, int DIM>
__device__ __forceinline__ void load_row(const T* __restrict__ x, long long i, T (&out)[DIM]) {
#pragma unroll
  for (int k = 0; k < DIM; ++k) out[k] = x[i * DIM + k];
}

// d = xj - xi and its squared length, summed in component order.
template <typename T, int DIM>
__device__ __forceinline__ T separation(const T* __restrict__ xj, long long j, const T (&xi)[DIM],
                                        T (&d)[DIM]) {
  T d2 = T(0);
#pragma unroll
  for (int k = 0; k < DIM; ++k) {
    d[k] = xj[j * DIM + k] - xi[k];
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

template <typename T, int DIM>
__global__ void __launch_bounds__(kWalkThreads)
bvh_walk_kernel(const T* __restrict__ mm, const T* __restrict__ mx, const T* __restrict__ bw,
                int nlevels, const T* __restrict__ m, const T* __restrict__ x, int n,
                const long long* __restrict__ rows, int nrows, T theta2, T eps, T G,
                T* __restrict__ out) {
  const int r = blockIdx.x * kWalkThreads + threadIdx.x;
  if (r >= nrows) return;
  const int i = rows ? static_cast<int>(rows[r]) : r;
  T acc[DIM];
#pragma unroll
  for (int k = 0; k < DIM; ++k) acc[k] = T(0);
  if (n == 1) {
    store_row<T, DIM>(out, r, T(0), acc);
    return;
  }
  T xi[DIM], d[DIM];
  load_row<T, DIM>(x, i, xi);
  const int nnodes = (1 << nlevels) - 1;
  int t = 0, level = 0, covered = 0;
  while (covered < n) {
    const int parent = (t - 1) >> 1;  // floor division, as bvh.py's (t - 1) // 2
    if (level == nlevels) {
      const int b0 = t - nnodes;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int b = b0 + k;
        if (b >= 0 && b < n && b != i) {
          const T d2 = separation<T, DIM>(x, b, xi, d);
          add_term<T, DIM>(acc, m[b] / (d2 * sqrt(d2) + eps), d);
        }
      }
      covered += 2;
      t = parent + 1;
      level -= 1;
    } else {
      const int tc = min(max(t, 0), nnodes - 1);
      const T d2 = separation<T, DIM>(mx, tc, xi, d);
      const T w = bw[tc];
      if (w * w < theta2 * d2) {
        add_term<T, DIM>(acc, mm[tc] / (d2 * sqrt(d2) + eps), d);
        covered += 1 << (nlevels - level);
        if (((t - 1) & 1) == 1) {  // a right child: up to the parent's right
          t = parent + 1;
          level -= 1;
        } else {
          t += 1;
        }
      } else {
        t = 2 * t + 1;
        level += 1;
      }
    }
  }
  store_row<T, DIM>(out, r, G, acc);
}

template <typename T>
__device__ __forceinline__ T cube_weight(T m, T dx) {
  const T den = dx * dx * dx;
  return den > T(0) ? m / den : T(0);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(kWalkThreads)
octree_walk_kernel(const T* __restrict__ mass, const T* __restrict__ com,
                   const long long* __restrict__ start, const long long* __restrict__ count,
                   const long long* __restrict__ child_start,
                   const long long* __restrict__ child_count,
                   const long long* __restrict__ parent, LevelOffsets off, int depth,
                   const T* __restrict__ ms, const T* __restrict__ xs, int n,
                   const T* __restrict__ root_side, const long long* __restrict__ rows,
                   int nrows, T theta, T eps, T G, T* __restrict__ out) {
  enum { kVisit, kAdvance, kDone };
  const int r = blockIdx.x * kWalkThreads + threadIdx.x;
  if (r >= nrows) return;
  const long long i = rows ? rows[r] : r;
  T xi[DIM], d[DIM], acc[DIM];
  load_row<T, DIM>(xs, i, xi);
#pragma unroll
  for (int k = 0; k < DIM; ++k) acc[k] = T(0);
  const T side0 = *root_side;
  int lvl = 0, mode = kVisit;
  long long idx = 0, ds_pos = 0, ds_rem = 0;
  while (mode != kDone || ds_rem > 0) {
    const long long flat = off.at[min(max(lvl, 0), depth)] + idx;
    if (ds_rem > 0) {  // drain one queued body first
      const long long b = min(max(ds_pos, 0LL), static_cast<long long>(n - 1));
      const T d2 = separation<T, DIM>(xs, b, xi, d);
      add_term<T, DIM>(acc, cube_weight(ms[b], sqrt(d2) + eps), d);
      ds_pos += 1;
      ds_rem -= 1;
    } else if (mode == kVisit) {
      const long long cnt = count[flat];
      const bool single = cnt <= 1;
      const long long bfirst = min(max(start[flat], 0LL), static_cast<long long>(n - 1));
      const T d2 = single ? separation<T, DIM>(xs, bfirst, xi, d)
                          : separation<T, DIM>(com, flat, xi, d);
      const T dx = sqrt(d2) + eps;
      const T side = side0 / static_cast<T>(1LL << min(max(lvl, 0), depth));
      if (single || side / dx < theta) {
        add_term<T, DIM>(acc, cube_weight(single ? ms[bfirst] : mass[flat], dx), d);
        mode = kAdvance;
      } else if (lvl >= depth) {  // a deepest multi-body cell: queue its bodies
        ds_pos = start[flat];
        ds_rem = cnt;
        mode = kAdvance;
      } else {
        lvl += 1;
        idx = child_start[flat];
      }
    } else if (lvl <= 0) {
      mode = kDone;
    } else {
      const long long par = parent[flat];
      const long long pf = off.at[min(max(lvl - 1, 0), depth)] + par;
      if (idx + 1 < child_start[pf] + child_count[pf]) {
        idx += 1;
        mode = kVisit;
      } else {
        lvl -= 1;
        idx = par;
      }
    }
  }
  store_row<T, DIM>(out, r, G, acc);
}

int blocks_for(int nrows) { return (nrows + kWalkThreads - 1) / kWalkThreads; }

template <typename T, int DIM>
cudaError_t launch_bvh(const void* mm, const void* mx, const void* bw, int nlevels, const void* m,
                       const void* x, int n, const void* rows, int nrows, double theta2,
                       double eps, double G, void* out, cudaStream_t s) {
  bvh_walk_kernel<T, DIM><<<blocks_for(nrows), kWalkThreads, 0, s>>>(
      static_cast<const T*>(mm), static_cast<const T*>(mx), static_cast<const T*>(bw), nlevels,
      static_cast<const T*>(m), static_cast<const T*>(x), n,
      static_cast<const long long*>(rows), nrows, static_cast<T>(theta2), static_cast<T>(eps),
      static_cast<T>(G), static_cast<T*>(out));
  return cudaGetLastError();
}

struct OctreeArgs {
  const void *mass, *com, *start, *count, *child_start, *child_count, *parent;
  LevelOffsets off;
  int depth;
  const void *ms, *xs;
  int n;
  const void *root_side, *rows;
  int nrows;
  double theta, eps, G;
  void* out;
};

template <typename T, int DIM>
cudaError_t launch_octree(const OctreeArgs& a, cudaStream_t s) {
  using I = const long long*;
  octree_walk_kernel<T, DIM><<<blocks_for(a.nrows), kWalkThreads, 0, s>>>(
      static_cast<const T*>(a.mass), static_cast<const T*>(a.com), static_cast<I>(a.start),
      static_cast<I>(a.count), static_cast<I>(a.child_start), static_cast<I>(a.child_count),
      static_cast<I>(a.parent), a.off, a.depth, static_cast<const T*>(a.ms),
      static_cast<const T*>(a.xs), a.n, static_cast<const T*>(a.root_side),
      static_cast<I>(a.rows), a.nrows, static_cast<T>(a.theta), static_cast<T>(a.eps),
      static_cast<T>(a.G), static_cast<T*>(a.out));
  return cudaGetLastError();
}

}  // namespace

// The BVH walk of nrows bodies: row r walks sorted body rows[r] (int64
// (nrows,)), or body r where rows is null. mm (2^nlevels - 1,), mx
// (2^nlevels - 1, dim) and bw (2^nlevels - 1,) are the heap of
// ops/bvh.build_tree over m (n,) and x (n, dim), all of `dtype` (0 float32,
// 1 float64). out (nrows, dim) of dtype gets G * acc. Pointers are device
// pointers to contiguous arrays. Returns the launch's cudaError_t (0 on
// success); the kernel runs on `stream` and nothing here synchronises.
extern "C" int nbody_bvh_walk(int device, int dtype, int dim, const void* mm, const void* mx,
                              const void* bw, int nlevels, const void* m, const void* x, int n,
                              const void* rows, int nrows, double theta2, double eps, double G,
                              void* out, void* stream) {
  if (nrows <= 0 || n <= 0 || nlevels < 1 || nlevels > 30 || (dim != 2 && dim != 3)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dim == 3 ? launch_bvh<float, 3>(mm, mx, bw, nlevels, m, x, n, rows, nrows, theta2, eps, G, out, s)
                    : launch_bvh<float, 2>(mm, mx, bw, nlevels, m, x, n, rows, nrows, theta2, eps, G, out, s);
  }
  if (dtype == 1) {
    return dim == 3 ? launch_bvh<double, 3>(mm, mx, bw, nlevels, m, x, n, rows, nrows, theta2, eps, G, out, s)
                    : launch_bvh<double, 2>(mm, mx, bw, nlevels, m, x, n, rows, nrows, theta2, eps, G, out, s);
  }
  return cudaErrorInvalidValue;
}

// The octree walk of nrows bodies over ops/octree.build_octree's levels:
// mass (total,) and com (total, dim) of `dtype`, start, count, child_start,
// child_count and parent (total,) int64, offsets a HOST pointer to the
// depth + 1 levels' flat offsets (int64), ms (n,) and xs (n, dim) the
// Morton-sorted bodies, root_side a device scalar of dtype (the root box's
// side), rows as in nbody_bvh_walk. Returns as nbody_bvh_walk.
extern "C" int nbody_octree_walk(int device, int dtype, int dim, const void* mass, const void* com,
                                 const void* start, const void* count, const void* child_start,
                                 const void* child_count, const void* parent, const void* offsets,
                                 int depth, const void* ms, const void* xs, int n,
                                 const void* root_side, const void* rows, int nrows, double theta,
                                 double eps, double G, void* out, void* stream) {
  if (nrows <= 0 || n <= 0 || depth < 0 || depth >= kMaxOctreeLevels || (dim != 2 && dim != 3)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  OctreeArgs a{mass, com, start, count, child_start, child_count, parent, {}, depth, ms, xs, n,
               root_side, rows, nrows, theta, eps, G, out};
  for (int l = 0; l <= depth; ++l) a.off.at[l] = static_cast<const long long*>(offsets)[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dim == 3 ? launch_octree<float, 3>(a, s) : launch_octree<float, 2>(a, s);
  if (dtype == 1) return dim == 3 ? launch_octree<double, 3>(a, s) : launch_octree<double, 2>(a, s);
  return cudaErrorInvalidValue;
}
