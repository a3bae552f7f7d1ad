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
// - n <= 16384: ONE launch of one thread-block cluster (1, 2, 4 or 8 blocks
//   of 512 threads, up to 4 elements a thread). Each thread keeps its
//   elements' r and b in shared memory; the variances are summed in
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
// kernel); the mean, the update and the clamps are then per lane. Lanes lie
// on the grid's y axis: one cluster per lane in the one-launch path
// (clusterDim = (blocks, 1, 1), so the grid's x is one cluster wide), and
// one row of `blocks` block sums per lane in the two-launch path. A lane's
// blocks, threads and sums are laid out by n alone, exactly as in a launch
// without lanes, so lane i of a batched launch gives the bits of the single
// launch on lane i's data. Beyond gridDim.y's limit of 65535 a cluster
// takes several lanes in turn. A precision is read as
// a[lane * lane_stride + e * element_stride]: strides (0, 0) for one number,
// (0, 1) for one per lane, (1, n) for one per element; a_new is written per
// lane or, for a precision per element, per element. The kernel is
// instantiated twice: with LANED = true as described, and with LANED = false
// for a single instance (lanes == 1), where the lane loop and the lane
// offsets fold away at compile time (one instantiation for both cost a
// single instance 5-8% of its time in float32, PERF.md). Both split a lane
// into the same blocks and run the same arithmetic per element.
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
      b_new_l[i] = r_held[e * kThreads + threadIdx.x] * (a + an) - b;
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
      b_new_l[i] = b_new_l[i] * (a + an) - b_l[i];
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
