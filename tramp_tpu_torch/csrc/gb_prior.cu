// The isotropic Gauss-Bernoulli prior's posterior and EP message, written
// by hand for Hopper (sm_90a), for every lane of a batch in one launch.
//
// It replaces no TPU kernel: the JAX package leaves this prior to XLA,
// which fuses its elementwise chain. The port ran the same chain eagerly
// (tramp_tpu_torch/priors/gauss_bernoulli_prior.py, beliefs/sparse.py,
// beliefs/normal.py): 30 kernels for the posterior
// (`compute_forward_posterior` with the isotropic lane mean) and 38 for
// the message (`Prior.compute_forward_message`, with `compute_ab_new`),
// about 23 and 25 of them reading and writing the whole (lanes, n)
// interface, the others one value per lane. For lane l with
// precision ax, the prior's a0 = 1 / var, b0 = mean / var and eta, and
// every element i:
//     a = ax + a0,  b = bx_i + b0,
//     A = 0.5 (b^2 / a + log(2 pi / a)),  s = sigmoid(A - eta),
//     r_i = s (b / a),  v_i = s / a + s (1 - s) (b / a)^2,
//     v = mean_i v_i,
// and for the message
//     a_new = clamp(1 / max(v, vmin) - ax, amin, amax),
//     b_new_i = r_i (ax + a_new) - bx_i.
// The posterior writes r and v (one value per lane), the message a_new (one
// value per lane) and b_new.
//
// What bounds it on an H100. One full-width read (bx) and one full-width
// write (r or b_new): 16 B/element in float64, 8 in float32, at 3.35 TB/s.
// The element's arithmetic (four IEEE divisions and an exponential, the
// logarithm once per lane) is about as long in float64: at the cells'
// sizes the card's float64 units need 60-90% of the bytes' time, so the
// design has to keep the loads in flight while other warps compute.
//
// What the design does about it. A lane is one block, and the grid is one
// block per lane: the lane mean couples a lane's elements and nothing else,
// so no sum crosses blocks and every lane is one launch. A block of
// kThreads threads streams its lane in 16-byte chunks, neighbouring threads
// on neighbouring chunks, kGroup chunks a thread in flight at a time, and
// holds little in registers, so four blocks share an SM and one block's
// loads overlap the others' arithmetic. (Measured against 512 threads, two
// blocks an SM, on an NVIDIA H100 80GB HBM3 at 700 W, float64, 2048 lanes:
// the posterior at n = 10^4 136.3 against 143.9 us; with two chunks in
// flight a thread, 2-7% slower than four. PERF.md.)
// - Posterior (gb_prior_posterior_kernel): r does not wait for the mean, so
//   each chunk's r is stored at once; v is added to the thread's sum.
// - Message (gb_prior_message_kernel): b_new waits for the lane's mean, so
//   the block sweeps its lane twice. The first sweep sums v and keeps the
//   first kCacheBytes of r in shared memory (4096 elements in float64, all
//   of the relu batch's lane); the second, after the block's sum, reads bx
//   again, takes r from shared memory where it was kept and computes it
//   again, as the first sweep did, past it, and writes b_new. The second
//   read finds the lane in L2, which the block read a sweep earlier: device
//   memory sees bx read once and b_new written once. A lane may have any
//   length, and the block's 32 KB keep four blocks an SM. (Measured in
//   turns on an NVIDIA H100 80GB HBM3 at 700 W, 2048 lanes in float64,
//   n = 4096 / 10^4: this design 65.1 / 209.9 us; r all in dynamic shared
//   memory, which caps a lane at 16,384 elements and fewer blocks an SM,
//   64.4 / 206.9 us; r all computed again, 94.4 / 230.5 us. Holding the
//   lane's bx in registers, 16 elements a thread in blocks of up to 1024
//   threads, spilled 12-56 bytes a thread and took 74.0 us at n = 4096.
//   PERF.md.)
// Rounding follows the eager chain operation by operation: this file is
// built with -fmad=false, so nvcc contracts no product into a fused
// multiply-add, and every step is the same IEEE operation on the same
// operands as the PyTorch kernel it replaces (x / y a true division,
// 2 pi / a the product of 1 / a and 2 pi as Tensor.__rtruediv__ computes
// it, sigmoid as 1 / (1 + exp(-x))). Elements so differ from the eager
// chain only where the device library's exp or log does; the lane mean
// is summed in double in a fixed order (per thread in element order, a
// shuffle tree per warp, the warps in order), which depends on n and the
// block size alone, never on the number of lanes: lane i of a batch gets
// the bits of lane i launched alone. The clamps let a NaN through, as
// torch.clamp does, so a bad step still reaches the solvers' finite test.
//
// Lanes. bx is `lanes` rows of n elements, one after another. ax is read as
// ax[lane * ax_lane] (0 for one number, the tensor's stride for one value
// per lane); a hyperparameter is a number, or a per-lane array read the
// same way. A lane has any number of elements.
//
// C interface (loaded with ctypes): gb_prior_f32 / gb_prior_f64. They
// launch on the given stream, allocate nothing, do not synchronise, and
// return a CUDA error code (0 on success; cudaErrorInvalidValue for sizes
// they do not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a block's threads, and the 16-byte chunks a thread has in flight
constexpr int kThreads = 256;
constexpr int kGroup = 4;
// the message's shared memory for the first elements of a lane's r
constexpr int kCacheBytes = 32768;
// Python's 2.0 * math.pi
constexpr double kTwoPi = 6.283185307179586;

template <typename T>
struct Hyper {
  T value;       // the number, where ptr is null
  const T* ptr;  // one value per lane, or null
  int64_t lane;  // the lane stride of ptr
};

template <typename T>
__device__ __forceinline__ T at(const Hyper<T>& h, int64_t lane) {
  return h.ptr ? h.ptr[lane * h.lane] : h.value;
}

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }

// 16-byte chunks of W elements, and single elements (W = 1) where a row
// does not start on 16 bytes
template <typename T, int W>
struct VecOf;
template <>
struct VecOf<float, 1> { using type = float; };
template <>
struct VecOf<double, 1> { using type = double; };
template <>
struct VecOf<float, 4> { using type = float4; };
template <>
struct VecOf<double, 2> { using type = double2; };

template <typename T, int W>
union Pack {
  typename VecOf<T, W>::type vec;
  T e[W];
};

// What a lane's elements share
template <typename T>
struct Lane {
  T ax;   // the message's precision
  T a;    // ax + a0
  T log;  // log(2 pi / a)
  T b0;
  T eta;
};

template <typename T>
__device__ __forceinline__ Lane<T> lane_of(const T* ax, int64_t ax_lane,
                                           const Hyper<T>& a0,
                                           const Hyper<T>& b0,
                                           const Hyper<T>& eta,
                                           int64_t lane) {
  Lane<T> p;
  p.ax = ax[lane * ax_lane];
  p.a = p.ax + at(a0, lane);
  p.log = m_log((T(1) / p.a) * T(kTwoPi));
  p.b0 = at(b0, lane);
  p.eta = at(eta, lane);
  return p;
}

// r and v of one element (beliefs/sparse.py r and v, beliefs/normal.py A)
template <typename T>
__device__ __forceinline__ void element(const Lane<T>& p, T bx, T& r, T& v) {
  const T b = bx + p.b0;
  const T A = T(0.5) * ((b * b) / p.a + p.log);
  const T s = T(1) / (T(1) + m_exp(-(A - p.eta)));
  const T q = b / p.a;
  r = s * q;
  v = s / p.a + (s * (T(1) - s)) * (q * q);
}

// Sum over the block in a fixed order: a shuffle tree per warp, then the
// warps in order. Valid in thread 0. blockDim.x is a multiple of 32.
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    const int warps = blockDim.x >> 5;
    for (int w = 0; w < warps; ++w) s += warp_sums[w];
  }
  return s;
}

// torch.clamp(x, lo, hi): a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_range(T x, T lo, T hi) {
  return x != x ? x : (x < lo ? lo : (x > hi ? hi : x));
}

// One pass over a lane: every chunk's bx and r handed to store(chunk, bx,
// r) and the sum of its v returned (per thread, in element order). A thread
// streams its chunks, kGroup of them in flight at a time.
template <typename T, int W, typename Store>
__device__ __forceinline__ double sweep(const Lane<T>& p,
                                        const typename VecOf<T, W>::type* x,
                                        int64_t chunks, Store store) {
  double acc = 0.0;
  for (int64_t c0 = threadIdx.x; c0 < chunks;
       c0 += (int64_t)kThreads * kGroup) {
    Pack<T, W> in[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int64_t c = c0 + (int64_t)g * kThreads;
      if (c < chunks) in[g].vec = x[c];
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int64_t c = c0 + (int64_t)g * kThreads;
      if (c < chunks) {
        Pack<T, W> o;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          T v;
          element(p, in[g].e[w], o.e[w], v);
          acc += (double)v;
        }
        store(c, in[g], o);
      }
    }
  }
  return acc;
}

// The posterior: r of every element and v, the mean of the v_i, per lane.
// (launch bounds: four blocks an SM, 64 registers, hold every
// instantiation without a spill)
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 4)
gb_prior_posterior_kernel(const T* __restrict__ ax, int64_t ax_lane,
                          const T* __restrict__ bx, const Hyper<T> a0,
                          const Hyper<T> b0, const Hyper<T> eta,
                          T* __restrict__ r, T* __restrict__ v_mean,
                          int64_t n) {
  using V = typename VecOf<T, W>::type;
  __shared__ double warp_sums[kThreads / 32];
  const int64_t lane = blockIdx.x;
  const Lane<T> p = lane_of(ax, ax_lane, a0, b0, eta, lane);
  const V* x = reinterpret_cast<const V*>(bx + lane * n);
  V* out = reinterpret_cast<V*>(r + lane * n);
  const double acc = sweep<T, W>(
      p, x, n / W,
      [out](int64_t c, const Pack<T, W>&, const Pack<T, W>& o) {
        out[c] = o.vec;
      });
  const double total = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) v_mean[lane] = (T)(total / (double)n);
}

// The message: a_new per lane and b_new of every element. b_new waits for
// the lane's mean, so the block sweeps its lane twice: the first sums v and
// keeps r of the first kCached chunks in shared memory, the second takes r
// from there and, past it, computes r again as the first did, and writes
// b_new. The second reads bx from L2: the lane was read by this block a
// sweep earlier (the blocks on the card at once hold 34 MB of it at the
// relu batch's size, of a 50-MB L2).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 4)
gb_prior_message_kernel(const T* __restrict__ ax, int64_t ax_lane,
                        const T* __restrict__ bx, const Hyper<T> a0,
                        const Hyper<T> b0, const Hyper<T> eta,
                        T* __restrict__ a_new, T* __restrict__ b_new,
                        int64_t n, T vmin, T amin, T amax) {
  using V = typename VecOf<T, W>::type;
  __shared__ double warp_sums[kThreads / 32];
  __shared__ T a_new_lane;
  const int64_t lane = blockIdx.x;
  const Lane<T> p = lane_of(ax, ax_lane, a0, b0, eta, lane);
  const int64_t chunks = n / W;
  const V* x = reinterpret_cast<const V*>(bx + lane * n);
  V* out = reinterpret_cast<V*>(b_new + lane * n);
  constexpr int64_t kCached = kCacheBytes / (int64_t)sizeof(V);
  __shared__ V cache[kCached];
  const double acc = sweep<T, W>(
      p, x, chunks, [](int64_t c, const Pack<T, W>&, const Pack<T, W>& r) {
        if (c < kCached) cache[c] = r.vec;
      });
  const double total = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    const T v = (T)(total / (double)n);
    const T v_safe = v < vmin ? vmin : v;  // NaN stays NaN
    a_new_lane = clamp_range(T(1) / v_safe - p.ax, amin, amax);
    a_new[lane] = a_new_lane;
  }
  __syncthreads();
  const T scale = p.ax + a_new_lane;
  const int64_t held = chunks < kCached ? chunks : kCached;
  for (int64_t c = threadIdx.x; c < held; c += kThreads) {
    Pack<T, W> in, r, o;
    in.vec = x[c];
    r.vec = cache[c];
#pragma unroll
    for (int w = 0; w < W; ++w) o.e[w] = r.e[w] * scale - in.e[w];
    out[c] = o.vec;
  }
  sweep<T, W>(p, x + held, chunks - held,
              [out, scale, held](int64_t c, const Pack<T, W>& in,
                                 const Pack<T, W>& r) {
                Pack<T, W> o;
#pragma unroll
                for (int w = 0; w < W; ++w) o.e[w] = r.e[w] * scale - in.e[w];
                out[held + c] = o.vec;
              });
}

template <typename T, int W>
int launch_posterior(const T* ax, int64_t ax_lane, const T* bx,
                     const Hyper<T>& a0, const Hyper<T>& b0,
                     const Hyper<T>& eta, T* v_mean, T* r, int64_t n,
                     int64_t lanes, cudaStream_t stream) {
  gb_prior_posterior_kernel<T, W><<<(unsigned)lanes, kThreads, 0, stream>>>(
      ax, ax_lane, bx, a0, b0, eta, r, v_mean, n);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_message(const T* ax, int64_t ax_lane, const T* bx,
                   const Hyper<T>& a0, const Hyper<T>& b0,
                   const Hyper<T>& eta, T* a_new, T* b_new, int64_t n,
                   int64_t lanes, T vmin, T amin, T amax,
                   cudaStream_t stream) {
  gb_prior_message_kernel<T, W><<<(unsigned)lanes, kThreads, 0, stream>>>(
      ax, ax_lane, bx, a0, b0, eta, a_new, b_new, n, vmin, amin, amax);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int message, const T* ax, int64_t ax_lane, const T* bx,
           double a0, const T* a0_ptr, int64_t a0_lane, double b0,
           const T* b0_ptr, int64_t b0_lane, double eta, const T* eta_ptr,
           int64_t eta_lane, T* out_lane, T* out, int64_t n, int64_t lanes,
           int vec, double vmin, double amin, double amax, void* stream) {
  constexpr int W = 16 / sizeof(T);
  if (n < 1 || lanes < 1 || lanes > 0x7fffffff ||
      (vec && n % W != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Hyper<T> h_a0{(T)a0, a0_ptr, a0_lane};
  const Hyper<T> h_b0{(T)b0, b0_ptr, b0_lane};
  const Hyper<T> h_eta{(T)eta, eta_ptr, eta_lane};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (message) {
    return vec ? launch_message<T, W>(ax, ax_lane, bx, h_a0, h_b0, h_eta,
                                      out_lane, out, n, lanes, (T)vmin,
                                      (T)amin, (T)amax, s)
               : launch_message<T, 1>(ax, ax_lane, bx, h_a0, h_b0, h_eta,
                                      out_lane, out, n, lanes, (T)vmin,
                                      (T)amin, (T)amax, s);
  }
  return vec ? launch_posterior<T, W>(ax, ax_lane, bx, h_a0, h_b0, h_eta,
                                      out_lane, out, n, lanes, s)
             : launch_posterior<T, 1>(ax, ax_lane, bx, h_a0, h_b0, h_eta,
                                      out_lane, out, n, lanes, s);
}

}  // namespace

// message 0: the posterior, out_lane = v (one per lane), out = r;
// message 1: the message, out_lane = a_new (one per lane), out = b_new.
// A hyperparameter is its value where its pointer is null.
extern "C" int gb_prior_f32(int message, const float* ax, int64_t ax_lane,
                            const float* bx, double a0, const float* a0_ptr,
                            int64_t a0_lane, double b0, const float* b0_ptr,
                            int64_t b0_lane, double eta,
                            const float* eta_ptr, int64_t eta_lane,
                            float* out_lane, float* out, int64_t n,
                            int64_t lanes, int vec, double vmin, double amin,
                            double amax, void* stream) {
  return launch<float>(message, ax, ax_lane, bx, a0, a0_ptr, a0_lane, b0,
                       b0_ptr, b0_lane, eta, eta_ptr, eta_lane, out_lane, out,
                       n, lanes, vec, vmin, amin, amax, stream);
}

extern "C" int gb_prior_f64(int message, const double* ax, int64_t ax_lane,
                            const double* bx, double a0,
                            const double* a0_ptr, int64_t a0_lane, double b0,
                            const double* b0_ptr, int64_t b0_lane, double eta,
                            const double* eta_ptr, int64_t eta_lane,
                            double* out_lane, double* out, int64_t n,
                            int64_t lanes, int vec, double vmin, double amin,
                            double amax, void* stream) {
  return launch<double>(message, ax, ax_lane, bx, a0, a0_ptr, a0_lane, b0,
                        b0_ptr, b0_lane, eta, eta_ptr, eta_lane, out_lane,
                        out, n, lanes, vec, vmin, amin, amax, stream);
}
