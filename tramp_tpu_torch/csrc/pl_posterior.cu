// Fused piecewise-linear posterior, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tramp_tpu/ops/pl_fused.py (`_kernel`,
// launched by `_fused_call` through pl.pallas_call). For each element i and
// each region k = (zmin, zmax, x0, slope) of a piecewise-linear channel it
// tilts the Gaussian,
//     a = az + slope^2 ax,   b = bz + slope (bx - ax x0),
// takes the truncated-normal mean, variance and log-partition of
// N(b/a, 1/a) on [zmin, zmax], the x-side moments slope rz + x0 and
// slope^2 vz, and the region weight A_k = logZ_k - ax x0^2 / 2 + bx x0; then
// it softmax-merges the regions (mean, and variance plus the between-region
// spread) on the z side and on the x side. Outputs: rz, vz, rx, vx and
// logZ = logsumexp_k A_k. The arithmetic is that of the plain PyTorch twin
// `pl_posterior_plain` (tramp_tpu_torch/ops/pl_fused.py), which follows
// tramp_tpu/utils/truncated_normal.py regime by regime.
//
// What bounds it on an H100. At the EP engine's sizes (M = 2048 elements
// for the relu net) one call is 8 blocks of 256 threads: the time is launch
// latency, not the card. At large N a call moves 7 streams (2 loads, 5
// stores), 28 B/element in float32, about 9 us per 2^20 elements at
// 3.35 TB/s, while each region costs several transcendental calls (erfcx,
// exp, log, log1p) per element; those are expected to cost more than the
// bytes. Measured times are in PERF.md.
//
// What the design does about it. One launch computes all five outputs and
// keeps the per-region moments and the softmax merge in registers (the
// region count K is a template parameter, so the per-region arrays are
// unrolled into registers): no (K, N) intermediate reaches device memory,
// where the plain version writes dozens of elementwise temporaries. The
// precisions az and ax are read on the device (a pointer with stride 0 for
// a scalar, 1 for per-element values), so the caller never synchronises to
// pass them. One thread per element in a grid-stride loop, no padding: the
// ragged tail is masked by the loop bound. The +-inf bounds of a region are
// a warp-uniform branch (every thread sees the same region); the four
// finite-interval regimes (close / neg / pos / other) are a per-element
// branch. CUDA's own erfcx, erfc, erf and log1p take the place of the
// TPU kernel's Chebyshev forms.
//
// C interface (loaded with ctypes): pl_posterior_f32 / pl_posterior_f64.
// They launch on the given stream, allocate nothing, do not synchronise,
// and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRegions = 8;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrtPi = 1.7724538509055159;
constexpr double kSqrt2OverPi = 0.7978845608028654;  // sqrt(2 / pi)
constexpr double kTwoOverSqrtPi = 1.1283791670955126;  // 2 / sqrt(pi)
constexpr double kLogHalf = -0.6931471805599453;
constexpr double kTwoPi = 6.283185307179586;
constexpr double kCloseThresh = 1e-7;

struct Region {
  double zmin, zmax, x0, slope;
};

struct Regions {
  Region r[kMaxRegions];
};

// float / double overloads of the CUDA math library
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_erf(double x) { return erf(x); }
__device__ __forceinline__ float m_erfcx(float x) { return erfcxf(x); }
__device__ __forceinline__ double m_erfcx(double x) { return erfcx(x); }

// maximum that propagates NaN, as torch.maximum / jnp.maximum do
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T clamp_abs(T x, T bound) {
  return x < -bound ? -bound : (x > bound ? bound : x);
}

// log Phi(t) through erfcx, clamped at |t / sqrt2| = 1e15
// (tramp_tpu/utils/special.py:205-228)
template <typename T>
__device__ __forceinline__ T log_phi_erfcx(T t) {
  const T u = clamp_abs(t / T(kSqrt2), T(1e15));
  if (t <= T(0)) return m_log(T(0.5) * m_erfcx(-u)) - u * u;
  return m_log1p(T(-0.5) * m_erfcx(u) * m_exp(-u * u));
}

// G0, G1, G2 at a half-infinite interval [x, inf) (sign = +1) or
// (-inf, x] (sign = -1), x standardized
// (tramp_tpu/utils/truncated_normal.py:137-179)
template <typename T>
__device__ __forceinline__ void g_half_inf(T x, T sign, T& g0, T& g1, T& g2) {
  const T xs = x / T(kSqrt2);
  const T e = m_erfcx(sign * xs);
  g1 = T(kSqrt2OverPi) * (sign / e);
  g2 = T(kTwoOverSqrtPi) * (sign * xs / e);
  g0 = log_phi_erfcx(-sign * x);
}

// G0, G1, G2 on a finite interval [x, y], x and y standardized: F0/F1/F2 at
// x/sqrt2, y/sqrt2 in one of four regimes
// (tramp_tpu/utils/truncated_normal.py:22-134)
template <typename T>
__device__ __forceinline__ void g_finite(T x, T y, T& g0, T& g1, T& g2) {
  T X = x / T(kSqrt2);
  T Y = y / T(kSqrt2);
  if (m_abs(X) > m_abs(Y)) {  // order so that |X| <= |Y|
    const T t = X;
    X = Y;
    Y = t;
  }
  const bool close = m_abs(X - Y) <= T(kCloseThresh);
  const bool neg = X < T(0) && Y < T(0) && !close;
  const bool pos = X > T(0) && Y > T(0) && !close;
  T f0, f1, f2;
  if (pos) {
    const T D = m_exp(X * X - Y * Y);
    const T den = m_erfcx(X) - D * m_erfcx(Y);
    f0 = m_log(m_abs(den)) - X * X;
    f1 = (T(1) - D) / den;
    f2 = (X - D * Y) / den;
  } else if (neg) {
    const T D = m_exp(X * X - Y * Y);
    const T den = D * m_erfcx(-Y) - m_erfcx(-X);
    f0 = m_log(m_abs(den)) - X * X;
    f1 = (T(1) - D) / den;
    f2 = (X - D * Y) / den;
  } else if (close) {
    const T e = Y - X;
    const T x2 = X * X;
    const T x4 = x2 * x2;
    const T e2 = e * e;
    const T e3 = e2 * e;
    const T e4 = e2 * e2;
    const T e_abs = m_abs(e) > T(1e-300) ? m_abs(e) : T(1e-300);
    // the e^4 factor of the third Taylor term is missing in the reference
    // too; kept so that fixed points match it in this regime
    f0 = (-X * e + T(1.0 / 6.0) * (x2 - T(2)) * e2 -
          T(1.0 / 180.0) * (x4 + T(2) * x2 - T(8)) +
          m_log(T(2) * e_abs / T(kSqrtPi))) -
         x2;
    f1 = T(kSqrtPi) * (X + T(0.5) * e - T(1.0 / 6.0) * e2 -
                       T(1.0 / 12.0) * e3 +
                       T(1.0 / 90.0) * X * (x2 + T(1)) * e4);
    f2 = T(kSqrtPi) * (x2 - T(0.5) + X * e -
                       T(1.0 / 3.0) * (x2 - T(1)) * e2 -
                       T(1.0 / 3.0) * X * e3 +
                       T(1.0 / 90.0) * (T(2) * x4 + T(3) * x2 - T(8)) * e4);
  } else {
    const T D = m_exp(X * X - Y * Y);
    const T d = m_erf(Y) - m_erf(X);
    const T ex = m_exp(-(X * X));
    f0 = m_log(m_abs(d));
    f1 = ex * (T(1) - D) / d;
    f2 = ex * (X - D * Y) / d;
  }
  g0 = T(kLogHalf) + f0;
  g1 = T(kSqrt2OverPi) * f1;
  g2 = T(kTwoOverSqrtPi) * f2;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
pl_posterior_kernel(const T* __restrict__ az, int64_t az_stride,
                    const T* __restrict__ bz, const T* __restrict__ ax,
                    int64_t ax_stride, const T* __restrict__ bx,
                    T* __restrict__ rz_out, T* __restrict__ vz_out,
                    T* __restrict__ rx_out, T* __restrict__ vx_out,
                    T* __restrict__ logz_out, int64_t n, Regions regions) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const T az_i = az[i * az_stride];
    const T ax_i = ax[i * ax_stride];
    const T bz_i = bz[i];
    const T bx_i = bx[i];
    T rz[K], vz[K], rx[K], vx[K], A[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Region rg = regions.r[k];
      const T slope = T(rg.slope);
      const T x0 = T(rg.x0);
      const T a = az_i + T(rg.slope * rg.slope) * ax_i;
      const T b = bz_i + slope * (bx_i - ax_i * x0);
      const T r0 = b / a;
      const T v0 = T(1) / a;
      const T s0 = m_sqrt(v0);
      const bool lo_inf = isinf(rg.zmin) && rg.zmin < 0.0;
      const bool hi_inf = isinf(rg.zmax) && rg.zmax > 0.0;
      T g0, g1, g2;
      if (lo_inf && hi_inf) {
        g0 = g1 = g2 = T(0);
      } else if (hi_inf) {
        g_half_inf((T(rg.zmin) - r0) / s0, T(1), g0, g1, g2);
      } else if (lo_inf) {
        g_half_inf((T(rg.zmax) - r0) / s0, T(-1), g0, g1, g2);
      } else {
        g_finite((T(rg.zmin) - r0) / s0, (T(rg.zmax) - r0) / s0, g0, g1, g2);
      }
      const T mean = r0 + s0 * g1;
      const T var = v0 * (T(1) + g2 - g1 * g1);
      const T logz = T(0.5) * m_log(T(kTwoPi) * v0) +
                     T(0.5) * (r0 * r0) / v0 + g0;
      rz[k] = mean;
      vz[k] = var;
      rx[k] = slope * mean + x0;
      vx[k] = T(rg.slope * rg.slope) * var;
      A[k] = logz - T(0.5) * ax_i * T(rg.x0 * rg.x0) + bx_i * x0;
    }
    // softmax merge over regions (tramp_tpu/ops/pl_fused.py:63-78)
    T A_max = A[0];
#pragma unroll
    for (int k = 1; k < K; ++k) A_max = nan_max(A_max, A[k]);
    T w[K];
    T Z = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k] = m_exp(A[k] - A_max);
      Z += w[k];
    }
    T r_z = T(0), r2_z = T(0), v_z = T(0);
    T r_x = T(0), r2_x = T(0), v_x = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T p = w[k] / Z;
      r_z += p * rz[k];
      r2_z += p * (rz[k] * rz[k]);
      v_z += p * vz[k];
      r_x += p * rx[k];
      r2_x += p * (rx[k] * rx[k]);
      v_x += p * vx[k];
    }
    rz_out[i] = r_z;
    vz_out[i] = v_z + (r2_z - r_z * r_z);
    rx_out[i] = r_x;
    vx_out[i] = v_x + (r2_x - r_x * r_x);
    logz_out[i] = A_max + m_log(Z);
  }
}

template <typename T>
int launch(const T* az, int64_t az_stride, const T* bz, const T* ax,
           int64_t ax_stride, const T* bx, T* rz, T* vz, T* rx, T* vx,
           T* logz, int64_t n, const double* specs, int k, void* stream) {
  if (k < 1 || k > kMaxRegions || n < 0) return (int)cudaErrorInvalidValue;
  Regions regions = {};
  for (int j = 0; j < k; ++j) {
    regions.r[j] = Region{specs[4 * j], specs[4 * j + 1], specs[4 * j + 2],
                          specs[4 * j + 3]};
  }
  if (n == 0) return (int)cudaGetLastError();
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PL_LAUNCH(KK)                                                     \
  case KK:                                                                \
    pl_posterior_kernel<T, KK><<<(unsigned)blocks, kThreads, 0, s>>>(     \
        az, az_stride, bz, ax, ax_stride, bx, rz, vz, rx, vx, logz, n,    \
        regions);                                                         \
    break;
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
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pl_posterior_f32(const float* az, int64_t az_stride,
                                const float* bz, const float* ax,
                                int64_t ax_stride, const float* bx, float* rz,
                                float* vz, float* rx, float* vx, float* logz,
                                int64_t n, const double* specs, int k,
                                void* stream) {
  return launch<float>(az, az_stride, bz, ax, ax_stride, bx, rz, vz, rx, vx,
                       logz, n, specs, k, stream);
}

extern "C" int pl_posterior_f64(const double* az, int64_t az_stride,
                                const double* bz, const double* ax,
                                int64_t ax_stride, const double* bx,
                                double* rz, double* vz, double* rx,
                                double* vx, double* logz, int64_t n,
                                const double* specs, int k, void* stream) {
  return launch<double>(az, az_stride, bz, ax, ax_stride, bx, rz, vz, rx, vx,
                        logz, n, specs, k, stream);
}
