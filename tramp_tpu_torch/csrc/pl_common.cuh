// Device functions shared by the piecewise-linear kernels of
// tramp_tpu_torch (pl_posterior.cu, pl_message.cu): the per-region tilted
// truncated-normal moments and the softmax merge over regions. The
// arithmetic follows the plain PyTorch twin `pl_posterior_plain`
// (tramp_tpu_torch/ops/pl_fused.py), which follows
// tramp_tpu/utils/truncated_normal.py regime by regime.
//
// Region parameters reach the kernels already in the kernels' own type T:
// the wrapper converts each channel's (zmin, zmax, x0, slope) once, with
// slope^2, x0^2 and the kind of the interval (which bounds are infinite)
// beside them, so the inner loop holds no double arithmetic and no isinf
// test in float32. The struct is a kernel parameter: with the region count
// K a template parameter, every field is read from the constant bank at a
// fixed offset, and the branch on the kind is the same for every thread.
//
// Divisions are the costliest plain operations here (an IEEE division is a
// reciprocal, Newton steps and a fix-up), so each is taken once and reused
// as a product: one rsqrt(a) gives the tilted variance, its root and the
// root's inverse; 1 / erfcx, 1 / den and 1 / Z are shared by the terms they
// divide; r0^2 / v0 is r0 b. Logarithms come next: the G functions hand
// back log-probability G0 as log(L) + add, so that the region's
// log-partition takes ONE logarithm, log(sqrt(2 pi v0) L). Each such step
// differs from the plain version's by an ulp or two, far inside the stated
// tolerances.
//
// Rounding is written out. Every product that feeds a sum in the hot path
// is an explicit fused multiply-add (m_fma), and pl_message.cu is compiled
// with -fmad=false, so that nvcc contracts nothing on its own there: each
// operation rounds as the source says, and two kernels that compute an
// element through these functions give it the same bits however they are
// unrolled, inlined or scheduled.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace pl {

constexpr int kMaxRegions = 8;
constexpr int kSpecFields = 7;  // zmin, zmax, x0, slope, slope^2, x0^2, kind
constexpr int64_t kMaxGridY = 65535;  // CUDA's limit on gridDim.y

constexpr double kInvSqrt2 = 0.7071067811865476;
constexpr double kSqrtPi = 1.7724538509055159;
constexpr double kSqrt2OverPi = 0.7978845608028654;  // sqrt(2 / pi)
constexpr double kTwoOverSqrtPi = 1.1283791670955126;  // 2 / sqrt(pi)
constexpr double kSqrtTwoPi = 2.5066282746310002;
constexpr double kInvSqrtPi = 0.5641895835477563;
constexpr double kCloseThresh = 1e-7;

// kinds of interval, set by the wrapper from the bounds
constexpr int kBothInf = 0;   // (-inf, inf)
constexpr int kUpperInf = 1;  // [zmin, inf)
constexpr int kLowerInf = 2;  // (-inf, zmax]
constexpr int kFinite = 3;    // [zmin, zmax]

template <typename T>
struct Regions {
  T zmin[kMaxRegions], zmax[kMaxRegions], x0[kMaxRegions];
  T slope[kMaxRegions], slope2[kMaxRegions], x02[kMaxRegions];
  int kind[kMaxRegions];
};

// The wrapper's flat array (k rows of kSpecFields values of type T) as the
// kernel parameter. Host side, a copy: the conversion was done once.
template <typename T>
inline Regions<T> regions_from(const T* specs, int k) {
  Regions<T> rg = {};
  for (int j = 0; j < k; ++j) {
    const T* s = specs + kSpecFields * j;
    rg.zmin[j] = s[0];
    rg.zmax[j] = s[1];
    rg.x0[j] = s[2];
    rg.slope[j] = s[3];
    rg.slope2[j] = s[4];
    rg.x02[j] = s[5];
    rg.kind[j] = (int)s[6];
  }
  return rg;
}

// Blocks of `kernel` that the card holds at once: SMs x resident blocks of
// `threads` threads (host side).
template <typename Kernel>
inline int64_t resident_blocks(Kernel kernel, int threads) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return (int64_t)sms * (per_sm > 0 ? per_sm : 1);
}

// float / double overloads of the CUDA math library
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double m_rsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_erf(double x) { return erf(x); }
__device__ __forceinline__ float m_erfcx(float x) { return erfcxf(x); }
__device__ __forceinline__ double m_erfcx(double x) { return erfcx(x); }
// a * b + c rounded once
__device__ __forceinline__ float m_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double m_fma(double a, double b, double c) {
  return fma(a, b, c);
}

// |u| beyond which erfc(u) / 2 is below half an ulp of 1: there
// log Phi(u sqrt2) rounds to 0. erfc(6) = 2.2e-17, erfc(4) = 1.5e-8.
// Up to it, 2 exp(u^2) stays finite: 1.8e7 in float32, 8.6e15 in float64.
__device__ __forceinline__ float tail_cut(float) { return 4.0f; }
__device__ __forceinline__ double tail_cut(double) { return 6.0; }

// Floor under |Y - X| in the close regime of g_finite: the plain version's
// 1e-300 in float64; in float32, where 1e-300 rounds to 0, the smallest
// positive normal number (torch.finfo(torch.float32).tiny).
__device__ __forceinline__ float gap_floor(float) { return FLT_MIN; }
__device__ __forceinline__ double gap_floor(double) { return 1e-300; }

// Maximum that propagates NaN, as torch.maximum / jnp.maximum do. CUDA's
// fmax returns the other operand and would hide a NaN from the engine's
// finite guard.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// Clamps written with comparisons, not fmin / fmax: a NaN fails every
// comparison and comes out as it went in, as torch.clamp propagates it.
template <typename T>
__device__ __forceinline__ T clamp_abs(T x, T bound) {
  return x < -bound ? -bound : (x > bound ? bound : x);
}

template <typename T>
__device__ __forceinline__ T clamp_range(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// G0 = log(L) + add, G1, G2 at a half-infinite interval [x, inf)
// (sign = +1) or (-inf, x] (sign = -1), x standardized
// (tramp_tpu/utils/truncated_normal.py:137-179). With w = sign x / sqrt2
// all three come from ONE e = erfcx(w):
//   G1 = sqrt(2/pi) sign / e,   G2 = (2/sqrt pi) w / e,
//   G0 = log Phi(-sign x) = log(e / 2) - w^2.
// That form of G0 is the plain version's own for w >= 0. For w < 0 the
// plain version calls erfcx(-w) a second time, with an exponential and a
// log1p; here the same form serves down to w = -tail_cut, where e is
// about 2 exp(w^2) and the difference loses at most tail_cut^2 ulps of 1
// (G0 enters the log-partition as one term of a sum of order 1). Below
// -tail_cut, where e goes on to overflow, erfc(-w) / 2 is under half an
// ulp and G0 is 0. w is clamped at 1e15 for G0 as the plain version clamps
// it (tramp_tpu/utils/special.py:205-228).
template <typename T>
__device__ __forceinline__ void g_half_inf(T x, T sign, T& L, T& add, T& g1,
                                           T& g2) {
  const T w = sign * (x * T(kInvSqrt2));
  const T e = m_erfcx(w);
  const T inv_e = T(1) / e;
  g1 = T(kSqrt2OverPi) * (sign * inv_e);
  g2 = T(kTwoOverSqrtPi) * (w * inv_e);
  const T u = clamp_abs(w, T(1e15));
  const bool tail = u < -tail_cut(u);  // false for a NaN, which goes on in L
  L = tail ? T(1) : T(0.5) * e;
  add = tail ? T(0) : -(u * u);
}

// G0 = log(L) + add, G1, G2 on a finite interval [x, y], x and y
// standardized: F0/F1/F2 at x/sqrt2, y/sqrt2 in one of four regimes
// (tramp_tpu/utils/truncated_normal.py:22-134)
template <typename T>
__device__ __forceinline__ void g_finite(T x, T y, T& L, T& add, T& g1,
                                         T& g2) {
  T X = x * T(kInvSqrt2);
  T Y = y * T(kInvSqrt2);
  if (m_abs(X) > m_abs(Y)) {  // order so that |X| <= |Y|
    const T t = X;
    X = Y;
    Y = t;
  }
  const bool close = m_abs(X - Y) <= T(kCloseThresh);
  const bool neg = X < T(0) && Y < T(0) && !close;
  const bool pos = X > T(0) && Y > T(0) && !close;
  T f1, f2;
  if (pos || neg) {
    // the two one-sided regimes are mirror images: with s = +-1,
    // den = s (erfcx(s X) - D erfcx(s Y))
    const T s = pos ? T(1) : T(-1);
    const T D = m_exp(m_fma(X, X, -(Y * Y)));
    const T den = s * m_fma(-D, m_erfcx(s * Y), m_erfcx(s * X));
    const T inv_den = T(1) / den;
    L = T(0.5) * m_abs(den);
    add = -(X * X);
    f1 = (T(1) - D) * inv_den;
    f2 = m_fma(-D, Y, X) * inv_den;
  } else if (close) {
    const T e = Y - X;
    const T x2 = X * X;
    const T x4 = x2 * x2;
    const T e2 = e * e;
    const T e3 = e2 * e;
    const T e4 = e2 * e2;
    // floored so that log(L) stays finite where zmin == zmax
    const T e_abs = m_abs(e) > gap_floor(e) ? m_abs(e) : gap_floor(e);
    // the e^4 factor of the third Taylor term is missing in the reference
    // too; kept so that fixed points match it in this regime
    L = e_abs * T(kInvSqrtPi);
    add = (-X * e + T(1.0 / 6.0) * (x2 - T(2)) * e2 -
           T(1.0 / 180.0) * (x4 + T(2) * x2 - T(8))) -
          x2;
    f1 = T(kSqrtPi) * (X + T(0.5) * e - T(1.0 / 6.0) * e2 -
                       T(1.0 / 12.0) * e3 +
                       T(1.0 / 90.0) * X * (x2 + T(1)) * e4);
    f2 = T(kSqrtPi) * (x2 - T(0.5) + X * e -
                       T(1.0 / 3.0) * (x2 - T(1)) * e2 -
                       T(1.0 / 3.0) * X * e3 +
                       T(1.0 / 90.0) * (T(2) * x4 + T(3) * x2 - T(8)) * e4);
  } else {
    const T D = m_exp(m_fma(X, X, -(Y * Y)));
    const T d = m_erf(Y) - m_erf(X);
    const T ex_d = m_exp(-(X * X)) / d;
    L = T(0.5) * m_abs(d);
    add = T(0);
    f1 = ex_d * (T(1) - D);
    f2 = ex_d * m_fma(-D, Y, X);
  }
  g1 = T(kSqrt2OverPi) * f1;
  g2 = T(kTwoOverSqrtPi) * f2;
}

// Region k of one element: the tilted Gaussian
//   a = az + slope^2 ax,   b = bz + slope (bx - ax x0),
// the mean and variance of N(b/a, 1/a) truncated to the region's interval
// (the z side), and the region's weight A = logZ - ax x0^2 / 2 + bx x0.
template <typename T>
__device__ __forceinline__ void region_moments(const Regions<T>& rg, int k,
                                               T az, T bz, T ax, T bx,
                                               T& mean, T& var, T& A) {
  const T x0 = rg.x0[k];
  const T a = m_fma(rg.slope2[k], ax, az);
  const T b = m_fma(rg.slope[k], m_fma(-ax, x0, bx), bz);
  const T s0 = m_rsqrt(a);      // sqrt(v0)
  const T v0 = s0 * s0;         // 1 / a
  const T inv_s0 = a * s0;      // 1 / sqrt(v0)
  const T r0 = b * v0;
  const int kind = rg.kind[k];
  T L, add, g1, g2;
  if (kind == kBothInf) {
    L = T(1);
    add = g1 = g2 = T(0);
  } else if (kind == kUpperInf) {
    g_half_inf((rg.zmin[k] - r0) * inv_s0, T(1), L, add, g1, g2);
  } else if (kind == kLowerInf) {
    g_half_inf((rg.zmax[k] - r0) * inv_s0, T(-1), L, add, g1, g2);
  } else {
    g_finite((rg.zmin[k] - r0) * inv_s0, (rg.zmax[k] - r0) * inv_s0, L, add,
             g1, g2);
  }
  mean = m_fma(s0, g1, r0);
  var = v0 * m_fma(-g1, g1, T(1) + g2);
  // log sqrt(2 pi v0) + r0^2 / (2 v0) + G0
  const T logz = m_fma(T(0.5), r0 * b, m_log(T(kSqrtTwoPi) * s0 * L)) + add;
  A = m_fma(bx, x0, m_fma(T(-0.5) * ax, rg.x02[k], logz));
}

// Softmax weights over the K region weights A (tramp_tpu/ops/
// pl_fused.py:63-68): p_k = exp(A_k - A_max) / Z, Z = sum_k exp(A_k -
// A_max). The total log-partition is A_max + log Z.
template <typename T, int K>
__device__ __forceinline__ void softmax_weights(const T (&A)[K], T (&p)[K],
                                                T& A_max, T& Z) {
  A_max = A[0];
#pragma unroll
  for (int k = 1; k < K; ++k) A_max = nan_max(A_max, A[k]);
  Z = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    p[k] = m_exp(A[k] - A_max);
    Z += p[k];
  }
  const T inv_Z = T(1) / Z;
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = p[k] * inv_Z;
}

// Mixture mean and variance (within-region plus between-region spread)
// of one side (tramp_tpu/ops/pl_fused.py:70-73)
template <typename T, int K>
__device__ __forceinline__ void merge(const T (&p)[K], const T (&r)[K],
                                      const T (&v)[K], T& r_out, T& v_out) {
  T m = T(0), m2 = T(0), w = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    m = m_fma(p[k], r[k], m);
    m2 = m_fma(p[k], r[k] * r[k], m2);
    w = m_fma(p[k], v[k], w);
  }
  r_out = m;
  v_out = w + m_fma(-m, m, m2);
}

}  // namespace pl
