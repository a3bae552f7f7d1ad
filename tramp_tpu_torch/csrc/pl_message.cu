// EP messages of a piecewise-linear channel, hand-written for Hopper
// (sm_90a): the posterior of pl_posterior.cu fused with what its caller
// does next.
//
// Replaces, together with pl_posterior.cu, the Pallas TPU kernel
// tramp_tpu/ops/pl_fused.py (`_kernel`, launched by `_fused_call` through
// pl.pallas_call), and takes in the two steps that the channel applies to
// the kernel's output in tramp_tpu/channels/base_channel.py: the isotropic
// mean of the merged variance and the moment-matching update
// `compute_ab_new`. One call computes, for one side (x for the forward
// message, z for the backward one), the per-region moments and their
// softmax merge (r_i, v_i) per element, v = mean_i v_i, and
//     a_new = clamp(1 / max(v, vmin) - a, amin, amax),
//     b_new = r (a + a_new) - b,
// with (a, b) = (ax, bx) forward and (az, bz) backward. No logZ and no
// merge of the other side are computed.
//
// What bounds it on an H100. The function reads two streams and writes one:
// 12 B/element in float32, 24 in float64, at 3.35 TB/s. The arithmetic per
// element is that of pl_posterior.cu less one merge and one logarithm, so
// at large n the instruction count decides; at the EP engine's sizes
// (2048 elements) the time is one launch, where the plain composition
// launches the kernel and then about eight small PyTorch kernels on its
// output. Measured times are in PERF.md.
//
// What the design does about it. The mean couples all elements, and blocks
// run in no order, so:
// - n <= 16384, one lane: ONE launch of one thread-block cluster (1, 2, 4
//   or 8 blocks of 512 threads, up to 4 elements a thread). Each thread
//   keeps its elements' r and b in shared memory; the variances are summed in
//   double, per thread in element order, then by a shuffle tree per warp,
//   then over the warps in order; after a cluster barrier warp 0 of every
//   block fetches the blocks' sums through distributed shared memory, one
//   per lane, and adds them in rank order. Every block so holds the same v
//   and finishes its own elements from what it kept: no load waits behind
//   the barrier, and neither r nor v_i reaches device memory. A second
//   cluster barrier keeps every block's shared memory alive until all have
//   read it. (Tried and slower, PERF.md: arriving at that barrier early
//   and waiting late; thread 0 fetching the sums one after another.)
// - n > 16384: two launches. The first is the same kernel on a grid-stride
//   loop, sized to the blocks the card holds at once; it stores r in the
//   b_new buffer and one double per block in a scratch array. The second
//   adds the scratch array in a fixed order in every block and rewrites
//   b_new in place. It moves 24 B/element in float32 (48 in float64): two
//   loads and a store in each pass.
// Lanes. The inputs may be `lanes` instances of n elements each, laid out
// one after another, with a precision per lane (what jax.vmap gives the TPU
// kernel); the mean, the update and the clamps are then per lane. A lane
// is summed term by term as the single launch on its data sums it (one
// launch, or the first of two, without lanes; LANED = false below), and
// every element goes through the same device functions, whose rounding is
// written out (explicit fused multiply-adds; this file is built with
// -fmad=false, so nvcc fuses nothing else): lane i of a batched launch
// gives the bits of the single launch on lane i's data by construction,
// whatever each kernel's unrolling and scheduling. A precision is read as
// a[lane * lane_stride + e *
// element_stride]: strides (0, 0) for one number, (0, 1) for one per lane,
// (1, n) for one per element; a_new is written per lane or, for a
// precision per element, per element. Three layouts:
// - lanes > 1, n <= 4096 (the EP engine's batched sweeps: 2048 lanes of
//   2048 on the relu net): pl_message_lanes_kernel, the laned form of the
//   Pallas kernel under jax.vmap. What bounds it is the bytes, as above
//   (12 B/element in float32, 24 in float64, at 3.35 TB/s;
//   chip_smoke.py's bound_ms takes the larger of that and the operations
//   at the card's peak rate). The layout of the single launch run once per
//   lane (a cluster of up to 8 blocks of 512 threads, one element a
//   thread, two cluster barriers and a DSMEM exchange) left each wave of
//   clusters one element's dependent chain of erfcx, log, rsqrt and
//   division plus the barriers, with nothing to hide them: 156.06 us in
//   float32 and 379.66 in float64 at 2048 x 2048 on an NVIDIA H100 80GB
//   HBM3 at 700 W, 9.63% and 7.92% of the bound (PERF.md). So here a lane
//   is one block, or a part of one where n is small, with no cluster and
//   no DSMEM and one block barrier; a thread takes up to 16 elements one
//   after another and keeps their r, b and v in shared memory, and as
//   many warps as the registers allow share an SM to hide the chain's
//   latency (the launch bounds); the grid is one block per group of
//   lanes, which the card hands to its SMs as they free up. Measured on
//   the same card (chip_kernel_times.py against the parent in one call,
//   relu, 2048 x 2048): 69.34 / 68.95 us forward / backward in float32,
//   21.7% / 21.8% of the bound, and 154.19 / 152.89 us in float64, 19.5% /
//   19.7% (pl_posterior: 78.55 / 238.58 us); what is left is the
//   element's own latency-bound arithmetic (PERF.md).
// - lanes > 1, 4096 < n <= 16384: pl_message_kernel<.., true>, one
//   cluster per lane on the grid's y axis (clusterDim = (blocks, 1, 1)), a
//   cluster taking several lanes in turn beyond gridDim.y's limit of 65535.
// - n > 16384: the two launches, one row of `blocks` block sums per lane.
// The kernel without lanes, LANED = false, keeps a single instance at its
// time: the lane loop and the lane offsets fold away at compile time (one
// instantiation for both cost a single instance 5-8% of its time in
// float32, PERF.md).
// Every sum has a fixed order for a given n: there are no floating-point
// atomics, so two runs give the same bits. The clamps and the softmax
// maximum are comparisons that let a NaN through (pl_common.cuh), as
// torch.clamp and torch.maximum do, so a bad sweep still reaches the
// engine's finite guard. vmin, amin and amax come from the caller.
//
// C interface (loaded with ctypes): pl_message_f32 / pl_message_f64 (n is
// the number of elements of one lane, partials_len the length of one lane's
// row of partials). They
// launch on the given stream, allocate nothing, do not synchronise, and
// return cudaGetLastError() (0 on success). Compile with -DPL_F32_ONLY or
// -DPL_F64_ONLY to build one type's entry point alone.

#include <cooperative_groups.h>

#include "pl_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace pl;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int64_t kClusterMax = 16384;  // CLUSTER_MAX of the wrapper
// elements a thread holds in the cluster
constexpr int kHeld = kClusterMax / (kMaxCluster * kThreads);
// The laned launch up to kLaneMax elements a lane (LANE_MAX of the
// wrapper): blocks of kLaneThreads threads, a lane on up to all of a
// block's warps, up to kLaneHeld elements a thread.
constexpr int64_t kLaneMax = 4096;
constexpr int kLaneThreads = 256;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kLaneHeld = kLaneMax / kLaneThreads;
// most lanes it takes: its lane index is 32 bits wide, and its blocks fit
// gridDim.x (2^31 - 1)
constexpr int64_t kLaneLanesMax = (int64_t)1 << 30;
// up to kLaneMax a single launch gives every virtual thread (below) one
// element at most
static_assert(kLaneMax <= kMaxCluster * kThreads, "one element a thread");
// blocks of kLaneThreads threads an SM holds, which bounds the registers:
// the most for which ptxas spills nothing at up to three regions (with one
// element at a time the time is set by how many warps an SM holds)
template <typename T, int K>
constexpr int kLaneMinBlocks =
    sizeof(T) == 4 ? (K <= 3 ? 5 : 4) : (K <= 2 ? 3 : 2);

template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;

constexpr int kForward = 0;   // x side
constexpr int kBackward = 1;  // z side

// Merged mean and variance of one element on one side
template <typename T, int K, int SIDE>
__device__ __forceinline__ void message_element(const Regions<T>& rg, T az,
                                                T bz, T ax, T bx, T& r_o,
                                                T& v_o) {
  T r[K], v[K], A[K], p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    region_moments(rg, k, az, bz, ax, bx, r[k], v[k], A[k]);
    if (SIDE == kForward) {
      r[k] = rg.slope[k] * r[k] + rg.x0[k];
      v[k] = rg.slope2[k] * v[k];
    }
  }
  T A_max, Z;
  softmax_weights<T, K>(A, p, A_max, Z);
  merge<T, K>(p, r, v, r_o, v_o);
}

// Sum over the block in a fixed order: shuffle tree per warp, then the
// warps in order. Valid in thread 0.
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
  }
  return s;
}

// The moment-matching update of one element (tramp_tpu/base.py
// compute_ab_new) from the mean variance v
template <typename T>
__device__ __forceinline__ T a_update(T v, T a, T vmin, T amin, T amax) {
  const T v_safe = v < vmin ? vmin : v;  // NaN stays NaN
  return clamp_range(T(1) / v_safe - a, amin, amax);
}

// b_new = r (a + a_new) - b of one element, rounded once after the sum
template <typename T>
__device__ __forceinline__ T b_update(T r, T a, T an, T b) {
  return m_fma(r, a + an, -b);
}

// clustered != 0: the grid's x is one cluster and every thread has at most
// kHeld elements of its lane; the whole message in this launch.
// clustered == 0: the first pass of two; r goes to b_new and the block's sum
// to its lane's row of partials.
// (launch bounds: the block count tells ptxas how many registers a thread
// may take. Two blocks of 512 threads per SM, 64 registers, hold every
// float32 instantiation of up to three regions without a spill; float64
// needs the 128 registers of one block. With no block count given, ptxas
// cuts float64 to 64 registers and spills; with one block for both,
// float32 takes 80 registers, loses the second block and the two-launch
// path slows down.)
template <typename T, int K, int SIDE, bool LANED>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
pl_message_kernel(const T* __restrict__ az, int64_t az_stride,
                  int64_t az_lane, const T* __restrict__ bz,
                  const T* __restrict__ ax, int64_t ax_stride,
                  int64_t ax_lane, const T* __restrict__ bx,
                  T* __restrict__ a_new, int a_new_per_element,
                  T* __restrict__ b_new, double* __restrict__ partials,
                  int64_t n, int64_t lanes, int clustered, T vmin, T amin,
                  T amax, const Regions<T> rg) {
  __shared__ T r_held[kHeld * kThreads];
  __shared__ T b_held[kHeld * kThreads];
  __shared__ double warp_sums[kWarps];
  __shared__ double block_total;
  __shared__ double total;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;

  // LANED == false: one lane, and the lane arithmetic folds away
  const int64_t lane_end = LANED ? lanes : 1;
  for (int64_t lane = LANED ? blockIdx.y : 0; lane < lane_end;
       lane += LANED ? gridDim.y : 1) {
    const T* az_l = LANED ? az + lane * az_lane : az;
    const T* ax_l = LANED ? ax + lane * ax_lane : ax;
    const T* bz_l = LANED ? bz + lane * n : bz;
    const T* bx_l = LANED ? bx + lane * n : bx;
    T* b_new_l = LANED ? b_new + lane * n : b_new;
    // the message's own side: (ax, bx) forward, (az, bz) backward
    const T* a_own = SIDE == kForward ? ax_l : az_l;
    const int64_t a_stride = SIDE == kForward ? ax_stride : az_stride;
    const T a_first = a_own[0];

    double acc = 0.0;
    int e = 0;
    for (int64_t i = first; i < n; i += step, ++e) {
      const T bz_i = bz_l[i], bx_i = bx_l[i];
      T r, v;
      message_element<T, K, SIDE>(rg, az_l[i * az_stride], bz_i,
                                  ax_l[i * ax_stride], bx_i, r, v);
      acc += (double)v;
      if (clustered) {
        r_held[e * kThreads + threadIdx.x] = r;
        b_held[e * kThreads + threadIdx.x] = SIDE == kForward ? bx_i : bz_i;
      } else {
        b_new_l[i] = r;
      }
    }
    const double s = block_sum(acc, warp_sums);
    if (!clustered) {
      if (threadIdx.x == 0) {
        partials[(LANED ? lane * gridDim.x : 0) + blockIdx.x] = s;
      }
      if (!LANED) return;
      // warp_sums is written again in the next lane's block_sum
      __syncthreads();
      continue;
    }

    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) block_total = s;
    cluster.sync();
    if (threadIdx.x < 32) {
      // lane r fetches block r's sum, all at once; then added in rank order
      const unsigned blocks = cluster.num_blocks();
      const double fetched =
          threadIdx.x < blocks
              ? *cluster.map_shared_rank(&block_total, threadIdx.x)
              : 0.0;
      double t = 0.0;
      for (unsigned rank = 0; rank < blocks; ++rank) {
        t += __shfl_sync(0xffffffffu, fetched, rank);
      }
      if (threadIdx.x == 0) total = t;
    }
    __syncthreads();
    const T v_mean = (T)(total / (double)n);

    // r, b and a scalar a were kept on the chip: no load waits behind the
    // barrier (per-element precisions are read again)
    T* a_new_l =
        LANED ? a_new + (a_new_per_element ? lane * n : lane) : a_new;
    e = 0;
    for (int64_t i = first; i < n; i += step, ++e) {
      const T a = a_stride ? a_own[i] : a_first;
      const T b = b_held[e * kThreads + threadIdx.x];
      const T an = a_update(v_mean, a, vmin, amin, amax);
      b_new_l[i] = b_update(r_held[e * kThreads + threadIdx.x], a, an, b);
      if (a_new_per_element) a_new_l[i] = an;
    }
    if (!a_new_per_element && first == 0) {
      a_new_l[0] = a_update(v_mean, a_first, vmin, amin, amax);
    }
    // no block may leave, or go on to its next lane, while another still
    // reads its block_total
    cluster.sync();
  }
}

// The shuffle trees of eight virtual warps at once. Thread j holds element
// j of each, x[k] for virtual warp k. The tree of one virtual warp adds
// element p + d to element p for d = 16, 8, 4, 2, 1 (p < d), as a
// __shfl_down_sync tree does for lane 0. Here the first three levels also
// halve the values a thread holds: at d = 16 the threads with j & 16 keep
// the odd virtual warps' pairs and the others the even ones', each pair
// one exchange (__shfl_xor_sync by d); d = 8 and d = 4 do the same on what
// is left; d = 2 and 1 are plain shuffles. Every addition is one of
// the single tree's, on the same two terms. Thread 4 a ends with the sum
// of virtual warp bit-reverse(a) (three bits): 9 exchanges for 8 trees,
// not 40.
__device__ __forceinline__ double tree8(const double (&x)[8]) {
  const unsigned all = 0xffffffffu;
  const int j = threadIdx.x & 31;
  double y[4], z[2];
  const bool b16 = j & 16, b8 = j & 8, b4 = j & 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double other = __shfl_xor_sync(all, b16 ? x[2 * q] : x[2 * q + 1],
                                         16);
    y[q] = b16 ? other + x[2 * q + 1] : x[2 * q] + other;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const double other = __shfl_xor_sync(all, b8 ? y[2 * q] : y[2 * q + 1],
                                         8);
    z[q] = b8 ? other + y[2 * q + 1] : y[2 * q] + other;
  }
  const double other = __shfl_xor_sync(all, b4 ? z[0] : z[1], 4);
  double u = b4 ? other + z[1] : z[0] + other;
  u += __shfl_down_sync(all, u, 2);
  u += __shfl_down_sync(all, u, 1);
  return u;
}

// The laned launch with n <= kLaneMax: one lane on `lane_warps` warps of a
// block (a block holds kLaneWarps / lane_warps lanes), a thread with up to
// 8 elements, or up to kLaneHeld where a lane has all the block's warps;
// one block for each group of lanes, handed to the SMs as they free up.
//
// The sums are those of the single launch (pl_message_kernel<.., false>),
// term by term. There, for n <= kLaneMax, element i is the one element of
// thread i % 512 of block i / 512 (the grid stride, blocks x 512, is at
// least n); a block adds its threads by a shuffle tree per warp of 32
// consecutive elements, then its 16 warps in order; the cluster adds its
// `blocks` block sums in rank order. Here the lane's elements form
// ceil(n / 32) virtual warps, virtual warp w being elements 32 w to 32 w +
// 31. Real warp g of the lane's warps takes virtual warps g, g +
// lane_warps, ..., its thread j element 32 w + j of each, and runs the
// same shuffle tree on each (eight at once, tree8); the tree's sum goes to
// shared memory. After one block barrier every warp adds, in lane b <
// blocks, the 16 sums of virtual block b in warp order (0 for a warp past
// the last element, as a warp without elements gives), and then the
// `blocks` block sums in rank order by shuffles. An element and its update
// go through the single launch's own functions (message_element, a_update,
// b_update), whose rounding is written out (pl_common.cuh): lane i has the
// bits of its single launch by construction.
//
// A thread computes its elements one after another and keeps their r, b
// and v in shared memory. Held in registers instead (8 elements unrolled,
// so that independent elements could hide each other's latency), the
// kernel took 107 us, not 81, on the same grid at 2048 lanes of 2048 in
// float32, and 241, not 183, in float64, which spilled (an NVIDIA H100
// 80GB HBM3 at 700 W, PERF.md): the registers cost more warps an SM than
// the unrolled elements gained.
template <typename T, int K, int SIDE>
__global__ void __launch_bounds__(kLaneThreads, kLaneMinBlocks<T, K>)
pl_message_lanes_kernel(const T* __restrict__ az, int64_t az_stride,
                        int64_t az_lane, const T* __restrict__ bz,
                        const T* __restrict__ ax, int64_t ax_stride,
                        int64_t ax_lane, const T* __restrict__ bx,
                        T* __restrict__ a_new, int a_new_per_element,
                        T* __restrict__ b_new, int64_t n, int64_t lanes,
                        int lane_warps, int held, T vmin, T amin, T amax,
                        const Regions<T> rg) {
  // per lane of the block: the virtual warps' sums, virtual warp 16 b + w
  // at w * blocks + b, so that lane b of a warp reads consecutive words
  __shared__ double sums[kWarps * kMaxCluster];
  // rows of kLaneThreads: a thread's e-th element has r, b and v in rows
  // 3 e, 3 e + 1 and 3 e + 2, at its threadIdx.x (constant offsets: fewer
  // registers a thread)
  extern __shared__ __align__(16) unsigned char held_bytes[];
  T* const r_held = reinterpret_cast<T*>(held_bytes) + threadIdx.x;
  constexpr int b_row = kLaneThreads, v_row = 2 * kLaneThreads;
  constexpr int e_rows = 3 * kLaneThreads;
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int g = warp % lane_warps, group = warp / lane_warps;
  const int groups = kLaneWarps / lane_warps;
  // 32-bit element and lane indices (n <= kLaneMax, lanes <=
  // kLaneLanesMax): fewer registers a thread
  const int m = (int)n, first = 32 * g + j, step = 32 * lane_warps;
  const int az_s = (int)az_stride, ax_s = (int)ax_stride;

  const int lane = blockIdx.x * groups + group;
  // a group past the last lane computes nothing and meets the barrier
  const int lane_m = lane < (int)lanes ? m : 0;
  // offsets from the arguments' own pointers, not pointers of the lane:
  // fewer registers a thread
  const int64_t b_off = (int64_t)lane * m;
  const int64_t az_off = lane * az_lane, ax_off = lane * ax_lane;

  T* slot = r_held;
  for (int i = first; i < lane_m; i += step, slot += e_rows) {
    const T bz_i = bz[b_off + i], bx_i = bx[b_off + i];
    T r, v;
    message_element<T, K, SIDE>(rg, az[az_off + i * az_s], bz_i,
                                ax[ax_off + i * ax_s], bx_i, r, v);
    slot[0] = r;
    slot[b_row] = SIDE == kForward ? bx_i : bz_i;
    slot[v_row] = v;
  }
  // the single launch's blocks: the least power of two that covers n
  int blocks = 1;
  while (blocks * kThreads < m) blocks *= 2;
  const int virtual_warps = (m + 31) >> 5;
  double* lane_sums = sums + group * kWarps * blocks;
  if (lane_m) {
    // eight virtual warps at a time: their trees in one (see tree8)
    for (int k0 = 0; k0 < held && g + k0 * lane_warps < virtual_warps;
         k0 += 8) {
      double x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        x[k] = 0.0;
        if (first + (k0 + k) * step < m) {
          x[k] += (double)r_held[(k0 + k) * e_rows + v_row];
        }
      }
      const double sum = tree8(x);
      // lane 4 a holds the sum of virtual warp k0 + bit-reverse(a)
      const int a = j >> 2;
      const int k = k0 + ((a & 1) << 2 | (a & 2) | a >> 2);
      const int w = g + k * lane_warps;
      if ((j & 3) == 0 && w < virtual_warps) {
        lane_sums[(w % kWarps) * blocks + w / kWarps] = sum;
      }
    }
  }
  __syncthreads();
  if (!lane_m) return;

  double s = 0.0;
  if (j < blocks) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += j * kWarps + w < virtual_warps ? lane_sums[w * blocks + j] : 0.0;
    }
  }
  double t = 0.0;
  for (int rank = 0; rank < blocks; ++rank) {
    t += __shfl_sync(0xffffffffu, s, rank);
  }
  const T v_mean = (T)(t / (double)n);

  const T* a_own = SIDE == kForward ? ax + ax_off : az + az_off;
  const int a_stride = SIDE == kForward ? ax_s : az_s;
  const T a_first = a_own[0];
  // one precision for the lane: one update for all its elements
  const T an_first = a_update(v_mean, a_first, vmin, amin, amax);
  T* b_new_l = b_new + b_off;
  T* a_new_l = a_new + (a_new_per_element ? b_off : lane);
  slot = r_held;
  for (int i = first; i < m; i += step, slot += e_rows) {
    const T a = a_stride ? a_own[i] : a_first;
    const T an = a_stride ? a_update(v_mean, a, vmin, amin, amax)
                          : an_first;
    b_new_l[i] = b_update(slot[0], a, an, slot[b_row]);
    if (a_new_per_element) a_new_l[i] = an;
  }
  if (!a_new_per_element && first == 0) a_new_l[0] = an_first;
}

// Second pass for n > kClusterMax: b_new holds r; every block of a lane adds
// the lane's row of the first pass's sums in the same order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pl_message_finish_kernel(const T* __restrict__ a_own, int64_t a_stride,
                         int64_t a_lane, const T* __restrict__ b_own,
                         T* __restrict__ a_new, int a_new_per_element,
                         T* __restrict__ b_new,
                         const double* __restrict__ partials, int n_partials,
                         int64_t n, int64_t lanes, T vmin, T amin, T amax) {
  __shared__ double warp_sums[kWarps];
  __shared__ double total;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t lane = blockIdx.y; lane < lanes; lane += gridDim.y) {
    const double* row = partials + lane * n_partials;
    double acc = 0.0;
    for (int j = threadIdx.x; j < n_partials; j += kThreads) acc += row[j];
    const double s = block_sum(acc, warp_sums);
    if (threadIdx.x == 0) total = s;
    __syncthreads();
    const T v_mean = (T)(total / (double)n);

    const T* a_l = a_own + lane * a_lane;
    const T* b_l = b_own + lane * n;
    T* b_new_l = b_new + lane * n;
    T* a_new_l = a_new + (a_new_per_element ? lane * n : lane);
    for (int64_t i = first; i < n; i += step) {
      const T a = a_l[i * a_stride];
      const T an = a_update(v_mean, a, vmin, amin, amax);
      b_new_l[i] = b_update(b_new_l[i], a, an, b_l[i]);
      if (a_new_per_element) a_new_l[i] = an;
    }
    if (!a_new_per_element && first == 0) {
      a_new_l[0] = a_update(v_mean, a_l[0], vmin, amin, amax);
    }
    // total and warp_sums are written again for the next lane
    __syncthreads();
  }
}

template <typename T, int K, int SIDE>
int launch_ks(const T* az, int64_t az_stride, int64_t az_lane, const T* bz,
              const T* ax, int64_t ax_stride, int64_t ax_lane, const T* bx,
              T* a_new, int a_new_per_element, T* b_new, double* partials,
              int64_t partials_len, int64_t n, int64_t lanes, T vmin, T amin,
              T amax, const Regions<T>& rg, cudaStream_t s) {
  if (lanes > 1 && lanes <= kLaneLanesMax && n <= kLaneMax) {
    // a lane's warps: a power of two, so that a block's lanes tile it, and
    // enough for 8 elements a thread; then up to kLaneHeld on all warps
    int lane_warps = 1;
    while (lane_warps < kLaneWarps && lane_warps * 32 * 8 < n) {
      lane_warps *= 2;
    }
    const int held = (int)((n + 32 * lane_warps - 1) / (32 * lane_warps));
    const int rows = held <= kLaneHeld / 2 ? kLaneHeld / 2 : kLaneHeld;
    auto lanes_kernel = pl_message_lanes_kernel<T, K, SIDE>;
    // r, b, v of kLaneHeld elements a thread
    const size_t most = 3 * kLaneHeld * kLaneThreads * sizeof(T);
    // more than 48 KB of shared memory is a block's only when asked for
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)most);
    if (opt_in != cudaSuccess) return (int)opt_in;
    // one block per group of lanes: a grid of the blocks the card holds at
    // once, each taking groups in turn, left the last round of 2048 lanes
    // (68 of 660 blocks in float32) to a few SMs
    const int64_t groups = kLaneWarps / lane_warps;
    lanes_kernel<<<(unsigned)((lanes + groups - 1) / groups), kLaneThreads,
                   most / kLaneHeld * rows, s>>>(
        az, az_stride, az_lane, bz, ax, ax_stride, ax_lane, bx, a_new,
        a_new_per_element, b_new, n, lanes, lane_warps, rows, vmin, amin,
        amax, rg);
    return (int)cudaGetLastError();
  }
  auto kernel = lanes == 1 ? pl_message_kernel<T, K, SIDE, false>
                           : pl_message_kernel<T, K, SIDE, true>;
  const unsigned rows = (unsigned)(lanes < kMaxGridY ? lanes : kMaxGridY);
  if (n <= kClusterMax) {
    const int64_t need = (n + kThreads - 1) / kThreads;
    unsigned blocks = 1;
    while (blocks < need && blocks < kMaxCluster) blocks *= 2;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks, rows);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = 0;
    config.stream = s;
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = blocks;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    config.attrs = attribute;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &config, kernel, az, az_stride, az_lane, bz, ax, ax_stride, ax_lane,
        bx, a_new, a_new_per_element, b_new, partials, n, lanes, 1, vmin,
        amin, amax, rg);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  }

  // blocks per lane: by n, the card and the row of partials alone, so that
  // a lane is summed as it is without lanes
  static const int64_t resident_one =
      resident_blocks(pl_message_kernel<T, K, SIDE, false>, kThreads);
  static const int64_t resident_many =
      resident_blocks(pl_message_kernel<T, K, SIDE, true>, kThreads);
  // the smaller of the two, so that a lane is split as a single launch is
  const int64_t resident =
      resident_one < resident_many ? resident_one : resident_many;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks > partials_len) blocks = partials_len;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, rows), kThreads, 0, s>>>(
      az, az_stride, az_lane, bz, ax, ax_stride, ax_lane, bx, a_new,
      a_new_per_element, b_new, partials, n, lanes, 0, vmin, amin, amax, rg);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  pl_message_finish_kernel<T>
      <<<dim3((unsigned)blocks, rows), kThreads, 0, s>>>(
          SIDE == kForward ? ax : az,
          SIDE == kForward ? ax_stride : az_stride,
          SIDE == kForward ? ax_lane : az_lane, SIDE == kForward ? bx : bz,
          a_new, a_new_per_element, b_new, partials, (int)blocks, n, lanes,
          vmin, amin, amax);
  return (int)cudaGetLastError();
}

template <typename T, int SIDE>
int launch_s(const T* az, int64_t az_stride, int64_t az_lane, const T* bz,
             const T* ax, int64_t ax_stride, int64_t ax_lane, const T* bx,
             T* a_new, int a_new_per_element, T* b_new, double* partials,
             int64_t partials_len, int64_t n, int64_t lanes, T vmin, T amin,
             T amax, const Regions<T>& rg, int k, cudaStream_t s) {
#define PL_LAUNCH(KK)                                                        \
  case KK:                                                                   \
    return launch_ks<T, KK, SIDE>(az, az_stride, az_lane, bz, ax, ax_stride, \
                                  ax_lane, bx, a_new, a_new_per_element,     \
                                  b_new, partials, partials_len, n, lanes,   \
                                  vmin, amin, amax, rg, s);
  switch (k) {
    PL_LAUNCH(1)
    PL_LAUNCH(2)
    PL_LAUNCH(3)
    PL_LAUNCH(4)
    PL_LAUNCH(5)
    PL_LAUNCH(6)
    PL_LAUNCH(7)
    PL_LAUNCH(8)
  }
#undef PL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(int side, const T* az, int64_t az_stride, int64_t az_lane,
           const T* bz, const T* ax, int64_t ax_stride, int64_t ax_lane,
           const T* bx, T* a_new, int a_new_per_element, T* b_new,
           double* partials, int64_t partials_len, int64_t n, int64_t lanes,
           const T* specs, int k, double vmin, double amin, double amax,
           void* stream) {
  if (k < 1 || k > kMaxRegions || n < 1 || lanes < 1 ||
      (side != kForward && side != kBackward)) {
    return (int)cudaErrorInvalidValue;
  }
  const Regions<T> rg = regions_from(specs, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (side == kForward) {
    return launch_s<T, kForward>(az, az_stride, az_lane, bz, ax, ax_stride,
                                 ax_lane, bx, a_new, a_new_per_element, b_new,
                                 partials, partials_len, n, lanes, (T)vmin,
                                 (T)amin, (T)amax, rg, k, s);
  }
  return launch_s<T, kBackward>(az, az_stride, az_lane, bz, ax, ax_stride,
                                ax_lane, bx, a_new, a_new_per_element, b_new,
                                partials, partials_len, n, lanes, (T)vmin,
                                (T)amin, (T)amax, rg, k, s);
}

}  // namespace

#ifndef PL_F64_ONLY
extern "C" int pl_message_f32(int side, const float* az, int64_t az_stride,
                              int64_t az_lane, const float* bz,
                              const float* ax, int64_t ax_stride,
                              int64_t ax_lane, const float* bx, float* a_new,
                              int a_new_per_element, float* b_new,
                              double* partials, int64_t partials_len,
                              int64_t n, int64_t lanes, const float* specs,
                              int k, double vmin, double amin, double amax,
                              void* stream) {
  return launch<float>(side, az, az_stride, az_lane, bz, ax, ax_stride,
                       ax_lane, bx, a_new, a_new_per_element, b_new, partials,
                       partials_len, n, lanes, specs, k, vmin, amin, amax,
                       stream);
}
#endif

#ifndef PL_F32_ONLY
extern "C" int pl_message_f64(int side, const double* az, int64_t az_stride,
                              int64_t az_lane, const double* bz,
                              const double* ax, int64_t ax_stride,
                              int64_t ax_lane, const double* bx,
                              double* a_new, int a_new_per_element,
                              double* b_new, double* partials,
                              int64_t partials_len, int64_t n, int64_t lanes,
                              const double* specs, int k, double vmin,
                              double amin, double amax, void* stream) {
  return launch<double>(side, az, az_stride, az_lane, bz, ax, ax_stride,
                        ax_lane, bx, a_new, a_new_per_element, b_new,
                        partials, partials_len, n, lanes, specs, k, vmin,
                        amin, amax, stream);
}
#endif
