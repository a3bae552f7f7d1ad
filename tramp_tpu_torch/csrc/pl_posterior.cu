// Fused piecewise-linear posterior, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tramp_tpu/ops/pl_fused.py (`_kernel`,
// launched by `_fused_call` through pl.pallas_call). For each element i and
// each region k = (zmin, zmax, x0, slope) of a piecewise-linear channel it
// tilts the Gaussian, takes the truncated-normal mean, variance and
// log-partition on the region's interval and the region weight A_k
// (pl_common.cuh); then it softmax-merges the regions on the z side and on
// the x side. Outputs: rz, vz, rx, vx and logZ = logsumexp_k A_k, the five
// streams of the TPU kernel. The EP sweep itself runs the message kernels
// of pl_message.cu, built from the same device functions; this kernel
// serves the posterior readouts, which need all five streams.
//
// What bounds it on an H100. One call moves 7 streams (2 loads, 5 stores),
// 28 B/element in float32 and 56 in float64; at 3.35 TB/s that is the
// card's least time for it. Every region costs an erfcx, a logarithm, an
// exponential, a reciprocal square root and a division per element, so at
// large n the instruction count decides the time and the bytes do not; at
// the EP engine's sizes (2048 elements) one call is 8 blocks and its time
// is the launch itself. Measured times are in PERF.md.
//
// What the design does about it. All five outputs in one launch, with the
// per-region moments and the merge in registers (the region count K is a
// template parameter): no (K, n) intermediate reaches device memory. The
// instruction count is cut where the arithmetic allows (pl_common.cuh): one
// erfcx per half-infinite region serves G0, G1 and G2, one logarithm per
// region, every division taken once and shared, and region parameters that
// arrive converted to the kernel's type with slope^2, x0^2 and the
// interval's kind precomputed. One thread per element, neighbouring
// threads on neighbouring addresses, in a grid-stride loop over a grid of
// at most the blocks the card holds at once (SMs x resident blocks, asked
// of the runtime per instantiation); the ragged tail is the loop bound, and
// no alignment is assumed. Several elements per thread with 16-byte loads
// and stores were tried and were slower (PERF.md): the arithmetic, not the
// loads, fills the time, and more elements in flight per thread only cost
// registers. The precisions az and ax are read on the device, so the caller
// never synchronises to pass them.
//
// Lanes. The inputs may be `lanes` instances of n elements each, laid out
// one after another, with a precision per lane (what jax.vmap gives the TPU
// kernel). Lanes lie on the grid's y axis, so a thread knows its lane
// without a division, and a precision is read as
// a[lane * lane_stride + e * element_stride]: strides (0, 0) for one number,
// (0, 1) for one per lane, (1, n) for one per element. No (lanes, n) copy of
// a precision is made. The kernel is instantiated twice: with LANED = true
// as described, and with LANED = false for a single instance (lanes == 1),
// where the lane loop and the lane offsets fold away at compile time. One
// instantiation for both cost a single instance 7 to 8 registers and 5-8% of
// its time in float32 (PERF.md); the arithmetic per element is the same
// code in both, so a lane has the bits of its single launch.
//
// C interface (loaded with ctypes): pl_posterior_f32 / pl_posterior_f64
// (n is the number of elements of one lane),
// and pl_launch_floor, an empty kernel whose time is the floor under every
// launch. They launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() (0 on success). Compile with
// -DPL_F32_ONLY or -DPL_F64_ONLY to build one type's entry points alone.

#include "pl_common.cuh"

namespace {

using namespace pl;

constexpr int kThreads = 256;
// Blocks per SM that ptxas fits the registers to: 2 leaves 128 registers a
// thread, which every instantiation with up to three regions takes without
// a spill (chip_smoke.py prints ptxas's report).
constexpr int kMinBlocks = 2;

// All five outputs of one element
template <typename T, int K>
__device__ __forceinline__ void posterior_element(const Regions<T>& rg, T az,
                                                  T bz, T ax, T bx, T& rz_o,
                                                  T& vz_o, T& rx_o, T& vx_o,
                                                  T& logz_o) {
  T rz[K], vz[K], rx[K], vx[K], A[K], p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    region_moments(rg, k, az, bz, ax, bx, rz[k], vz[k], A[k]);
    rx[k] = rg.slope[k] * rz[k] + rg.x0[k];
    vx[k] = rg.slope2[k] * vz[k];
  }
  T A_max, Z;
  softmax_weights<T, K>(A, p, A_max, Z);
  merge<T, K>(p, rz, vz, rz_o, vz_o);
  merge<T, K>(p, rx, vx, rx_o, vx_o);
  logz_o = A_max + m_log(Z);
}

template <typename T, int K, bool LANED>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pl_posterior_kernel(const T* __restrict__ az, int64_t az_stride,
                    int64_t az_lane, const T* __restrict__ bz,
                    const T* __restrict__ ax, int64_t ax_stride,
                    int64_t ax_lane, const T* __restrict__ bx,
                    T* __restrict__ rz_out, T* __restrict__ vz_out,
                    T* __restrict__ rx_out, T* __restrict__ vx_out,
                    T* __restrict__ logz_out, int64_t n, int64_t lanes,
                    const Regions<T> rg) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  // LANED == false: one lane, and the lane arithmetic folds away
  const int64_t lane_end = LANED ? lanes : 1;
  for (int64_t lane = LANED ? blockIdx.y : 0; lane < lane_end;
       lane += LANED ? gridDim.y : 1) {
    const T* az_l = LANED ? az + lane * az_lane : az;
    const T* ax_l = LANED ? ax + lane * ax_lane : ax;
    const int64_t base = LANED ? lane * n : 0;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
         e += step) {
      const int64_t i = base + e;
      T rz, vz, rx, vx, logz;
      posterior_element<T, K>(rg, az_l[e * az_stride], bz[i],
                              ax_l[e * ax_stride], bx[i], rz, vz, rx, vx,
                              logz);
      rz_out[i] = rz;
      vz_out[i] = vz;
      rx_out[i] = rx;
      vx_out[i] = vx;
      logz_out[i] = logz;
    }
  }
}

__global__ void pl_empty_kernel() {}

// The grid: x over a lane's elements, y over the lanes, and together at
// most about the blocks the card holds at once (the loops take the rest).
template <typename T, int K>
int launch_k(const T* az, int64_t az_stride, int64_t az_lane, const T* bz,
             const T* ax, int64_t ax_stride, int64_t ax_lane, const T* bx,
             T* rz, T* vz, T* rx, T* vx, T* logz, int64_t n, int64_t lanes,
             const Regions<T>& rg, cudaStream_t s) {
  // one instance takes the instantiation without the lane arithmetic
  static const int64_t resident_one =
      resident_blocks(pl_posterior_kernel<T, K, false>, kThreads);
  static const int64_t resident_many =
      resident_blocks(pl_posterior_kernel<T, K, true>, kThreads);
  const int64_t resident = lanes == 1 ? resident_one : resident_many;
  auto kernel = lanes == 1 ? pl_posterior_kernel<T, K, false>
                           : pl_posterior_kernel<T, K, true>;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  int64_t rows = (resident + blocks - 1) / blocks;
  if (rows > lanes) rows = lanes;
  if (rows > kMaxGridY) rows = kMaxGridY;
  kernel<<<dim3((unsigned)blocks, (unsigned)rows), kThreads, 0, s>>>(
      az, az_stride, az_lane, bz, ax, ax_stride, ax_lane, bx, rz, vz, rx, vx,
      logz, n, lanes, rg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* az, int64_t az_stride, int64_t az_lane, const T* bz,
           const T* ax, int64_t ax_stride, int64_t ax_lane, const T* bx,
           T* rz, T* vz, T* rx, T* vx, T* logz, int64_t n, int64_t lanes,
           const T* specs, int k, void* stream) {
  if (k < 1 || k > kMaxRegions || n < 0 || lanes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  const Regions<T> rg = regions_from(specs, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PL_LAUNCH(KK)                                                      \
  case KK:                                                                 \
    return launch_k<T, KK>(az, az_stride, az_lane, bz, ax, ax_stride,      \
                           ax_lane, bx, rz, vz, rx, vx, logz, n, lanes, rg, \
                           s);
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

}  // namespace

#ifndef PL_F64_ONLY
extern "C" int pl_posterior_f32(const float* az, int64_t az_stride,
                                int64_t az_lane, const float* bz,
                                const float* ax, int64_t ax_stride,
                                int64_t ax_lane, const float* bx, float* rz,
                                float* vz, float* rx, float* vx, float* logz,
                                int64_t n, int64_t lanes, const float* specs,
                                int k, void* stream) {
  return launch<float>(az, az_stride, az_lane, bz, ax, ax_stride, ax_lane, bx,
                       rz, vz, rx, vx, logz, n, lanes, specs, k, stream);
}
#endif

#ifndef PL_F32_ONLY
extern "C" int pl_posterior_f64(const double* az, int64_t az_stride,
                                int64_t az_lane, const double* bz,
                                const double* ax, int64_t ax_stride,
                                int64_t ax_lane, const double* bx,
                                double* rz, double* vz, double* rx,
                                double* vx, double* logz, int64_t n,
                                int64_t lanes, const double* specs, int k,
                                void* stream) {
  return launch<double>(az, az_stride, az_lane, bz, ax, ax_stride, ax_lane,
                        bx, rz, vz, rx, vx, logz, n, lanes, specs, k, stream);
}
#endif

extern "C" int pl_launch_floor(void* stream) {
  pl_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
