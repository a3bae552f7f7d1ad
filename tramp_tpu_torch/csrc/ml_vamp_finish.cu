// ML-VAMP's loop finish, written by hand for Hopper (sm_90a): what
// MLVAMPSolver._iterate (tramp_tpu_torch/parallel/ml_vamp.py) does after its
// step, for every lane of a batch in one launch.
//
// It replaces no TPU kernel: the JAX package runs this chain inside its
// `while_loop`, where XLA fuses it. The port ran it eagerly
// (ops/ml_vamp_finish.py, ml_vamp_finish_plain): for the relu net, 124
// kernels an iteration, most of them reading or writing a whole interface.
// For lane l, over the leaves of the step's output (`next`) and of the loop's
// carry (`carry`), and the interfaces the stop metric reads:
//     ok = every element of every leaf of next is finite,
//     keep = ok and not done (ok alone without lanes),
//     carry = next where keep (a leaf the step passed through is skipped),
//     at each interface, from the carry so selected,
//         r_j = (fb_j + bb_j) / max(fa_j + ba_j, tiny),
//         d = sqrt(mean (r_j - r_old_j)^2) / max(sqrt(mean r_j^2), tiny),
//     delta = max over the interfaces (NaN if one is NaN),
//     converged = delta < tol and count > 0,
// r_old is overwritten with r, and the lane's flags advance as
// lanes.advance has them: where not done, n_iter = count + 1 and conv |=
// converged; done |= converged or not ok (count, the loop's, is raised by
// the caller after the launch). A pinned interface reads its pinned message
// where the carry has none: such a tensor is a leaf only read.
//
// What bounds it on an H100. Bytes: each leaf of next read once, each carry
// leaf and the metric written once, the old metric and the pinned message
// read once. For the relu net (N = 4096, M = 2048) in float64, a lane reads
// 16,389 + 8,192 + 2,049 elements and writes 16,389 + 8,192: 409,688 B, so
// 2048 lanes take 0.250 ms at 3.35 TB/s. The arithmetic (a division a metric
// element) is far below its own bound.
//
// What the design does about it. A lane is one block, and the grid is one
// block per lane: the finite test, the stop metric's sums and delta couple a
// lane's elements and nothing else, so no sum crosses blocks. A block makes
// three passes over its lane, as the eager chain's order has them. The
// first reads every leaf of next and ANDs the finite test over the block
// (__syncthreads_and). The second copies next into the carry where the lane
// is kept. The third, interface by interface, reads the carry, computes r
// against r_old, sums both squares and reduces the two sums over the block.
// The second pass finds next in L2 (the step wrote it just before, and the
// block read it a pass earlier), and the third the carry (the block wrote
// it a pass earlier): device memory sees next read once and the carry
// written once. (Writing the carry inside the third pass, from next, spilled
// the float64 instantiation's registers at two blocks an SM.) Loads are
// grouped, kGroup a thread in flight, neighbouring threads on neighbouring
// elements; two blocks share an SM, so one block's barriers overlap the
// other's loads. The leaves' table is a __grid_constant__
// parameter: a graph captures the launch with its pointers, and nothing is
// copied to the device. It holds up to 512 leaves and 128 interfaces, a
// chain of up to 56 relu layers: 26.7 KB, under the 32,764 B that CUDA 12.1
// and later give a kernel's parameters on sm_70 and later. (A 2.1-KB table
// for chains of up to three relu layers timed the same on the relu net,
// device and host, so the one size serves every chain.)
//
// Rounding. Every element of the carry, r and the flags is the eager chain's
// bits: copies are copies, and r is the same IEEE additions, clamp and
// division as the PyTorch kernels it replaces (this file is built with
// -fmad=false). A lane that is not kept is read from its unchanged carry,
// so its r is the one it had, and its change 0, as the eager chain computes
// it. Only delta's sums are taken in another order: in double, per thread in
// element order, a shuffle tree per warp, the warps in order. That order
// depends on the interface's length and the block size alone, never on the
// number of lanes: lane i of a batch gets the bits of lane i launched alone.
//
// Lanes. A leaf of next is read as next[lane * next_lane + j], j < n (n = 1
// for one value a lane, read for every element of its interface); a carry
// leaf and the metric are contiguous, n elements a lane. Without lanes the
// grid is one block and every stride 0.
//
// C interface (loaded with ctypes): ml_vamp_finish_f32 / ml_vamp_finish_f64
// take the table (struct Finish) by pointer and pass it by value to the
// kernel. They launch on the given stream, allocate nothing, do not
// synchronise, and return a CUDA error code (0 on success;
// cudaErrorInvalidValue for a table they do not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// a block's threads, and the elements a thread has in flight
constexpr int kThreads = 512;
constexpr int kGroup = 2;
constexpr int kWarps = kThreads / 32;
// the table's capacity (ops/ml_vamp_finish.py MAX_LEAVES, MAX_SIDES)
constexpr int kMaxLeaves = 512;
constexpr int kMaxSides = 128;
// Leaf::flags: part of the finite test
constexpr int64_t kChecked = 1;

struct Leaf {
  const void* next;   // the step's output, or a tensor only read (a pin)
  void* carry;        // takes next where the lane is kept; or null
  int64_t n;          // elements a lane
  int64_t next_lane;  // next's lane stride, in elements
  int64_t flags;
};

struct Side {
  int64_t fa, ba, fb, bb;  // indices into the leaves
  void* r;                 // the metric: r_old in, r out; n a lane
  int64_t n;
};

struct Head {
  int64_t n_leaves, n_sides;
  int64_t laned;  // 1: one block per lane, the flags and outputs (lanes,)
  const int64_t* count;
  int64_t* n_iter;
  uint8_t* conv;
  uint8_t* done;
  uint8_t* ok;
  uint8_t* converged;
  void* delta;
  double tol;
};

struct Finish {
  Head head;
  Leaf leaf[kMaxLeaves];
  Side side[kMaxSides];
};

template <typename T>
__device__ __forceinline__ T smallest_normal();
template <>
__device__ __forceinline__ float smallest_normal<float>() {
  return 1.17549435e-38f;
}
template <>
__device__ __forceinline__ double smallest_normal<double>() {
  return 2.2250738585072014e-308;
}

// torch.clamp(x, min=tiny): a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_tiny(T x) {
  const T tiny = smallest_normal<T>();
  return x != x ? x : (x < tiny ? tiny : x);
}

template <typename T>
__device__ __forceinline__ const T* next_of(const Leaf& f, int64_t lane) {
  return static_cast<const T*>(f.next) + lane * f.next_lane;
}

template <typename T>
__device__ __forceinline__ T* carry_of(const Leaf& f, int64_t lane) {
  return f.carry ? static_cast<T*>(f.carry) + lane * f.n : nullptr;
}

// Sums of x and y over the block in a fixed order: a shuffle tree per warp,
// then the warps in order. Valid in thread 0.
__device__ __forceinline__ void block_sum2(double& x, double& y,
                                           double (*warp_sums)[kWarps]) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, d);
    y += __shfl_down_sync(0xffffffffu, y, d);
  }
  if ((threadIdx.x & 31) == 0) {
    warp_sums[0][threadIdx.x >> 5] = x;
    warp_sums[1][threadIdx.x >> 5] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    x = 0.0;
    y = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      x += warp_sums[0][w];
      y += warp_sums[1][w];
    }
  }
  // the next interface writes warp_sums again
  __syncthreads();
}

// (launch bounds: two blocks an SM, up to 64 registers)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ml_vamp_finish_kernel(const __grid_constant__ Finish p) {
  const Head& h = p.head;
  __shared__ double warp_sums[2][kWarps];
  const int64_t lane = blockIdx.x;
  // 1. the finite test over every leaf of next
  int finite = 1;
  for (int i = 0; i < h.n_leaves; ++i) {
    const Leaf& f = p.leaf[i];
    if (!(f.flags & kChecked)) continue;
    const T* x = next_of<T>(f, lane);
    for (int64_t j0 = threadIdx.x; j0 < f.n; j0 += kThreads * kGroup) {
      T v[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int64_t j = j0 + (int64_t)g * kThreads;
        v[g] = j < f.n ? x[j] : T(0);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) finite &= (int)isfinite(v[g]);
    }
  }
  const bool ok = __syncthreads_and(finite) != 0;
  const bool done = h.done[h.laned ? lane : 0] != 0;
  const bool keep = ok && !(h.laned && done);
  // 2. a kept lane's carry takes next
  if (keep) {
    for (int i = 0; i < h.n_leaves; ++i) {
      const Leaf& f = p.leaf[i];
      if (!f.carry) continue;
      const T* x = next_of<T>(f, lane);
      T* y = carry_of<T>(f, lane);
      for (int64_t j0 = threadIdx.x; j0 < f.n; j0 += kThreads * kGroup) {
        T v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int64_t j = j0 + (int64_t)g * kThreads;
          if (j < f.n) v[g] = x[j];
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int64_t j = j0 + (int64_t)g * kThreads;
          if (j < f.n) y[j] = v[g];
        }
      }
    }
  }
  // the block's writes to the carry before its reads of them
  __syncthreads();
  // 3. the interfaces, from the carry (next where there is none): r and
  // the sums of its change and of its square
  T delta = T(0);
  bool delta_nan = false;
  for (int s = 0; s < h.n_sides; ++s) {
    const Side& d = p.side[s];
    const int64_t slot[4] = {d.fa, d.ba, d.fb, d.bb};
    const T* src[4];
    bool whole[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Leaf& f = p.leaf[slot[k]];
      src[k] = f.carry ? carry_of<T>(f, lane) : next_of<T>(f, lane);
      whole[k] = f.n != 1;
    }
    T* r = static_cast<T*>(d.r) + lane * d.n;
    double change = 0.0, size = 0.0;
    for (int64_t j0 = threadIdx.x; j0 < d.n; j0 += kThreads * kGroup) {
      T v[kGroup][4], old[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int64_t j = j0 + (int64_t)g * kThreads;
        if (j < d.n) {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[g][k] = src[k][whole[k] ? j : 0];
          old[g] = r[j];
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int64_t j = j0 + (int64_t)g * kThreads;
        if (j < d.n) {
          const T a = clamp_tiny(v[g][0] + v[g][1]);
          const T rj = (v[g][2] + v[g][3]) / a;
          const T diff = rj - old[g];
          change += (double)(diff * diff);
          size += (double)(rj * rj);
          r[j] = rj;
        }
      }
    }
    block_sum2(change, size, warp_sums);
    if (threadIdx.x == 0) {
      const T num = sqrt((T)(change / (double)d.n));
      const T den = clamp_tiny(sqrt((T)(size / (double)d.n)));
      const T ds = num / den;
      if (ds != ds) {
        delta_nan = true;
      } else if (s == 0 || ds > delta) {
        delta = ds;
      }
    }
  }
  // every thread read done before the barriers above
  if (threadIdx.x == 0) {
    const int64_t out = h.laned ? lane : 0;
    if (delta_nan) delta = T(NAN);
    const int64_t count = *h.count;
    const bool converged = (delta < (T)h.tol) && count > 0;
    static_cast<T*>(h.delta)[out] = delta;
    h.ok[out] = ok;
    h.converged[out] = converged;
    if (!done) h.n_iter[out] = count + 1;
    h.conv[out] = h.conv[out] || (!done && converged);
    h.done[out] = done || converged || !ok;
  }
}

template <typename T>
int launch(const void* table, int64_t lanes, void* stream) {
  const Finish* p = static_cast<const Finish*>(table);
  const Head& h = p->head;
  if (lanes < 1 || lanes > 0x7fffffff || h.n_leaves < 1 ||
      h.n_leaves > kMaxLeaves || h.n_sides < 1 || h.n_sides > kMaxSides ||
      (!h.laned && lanes != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int64_t s = 0; s < h.n_sides; ++s) {
    const Side& d = p->side[s];
    const int64_t slot[4] = {d.fa, d.ba, d.fb, d.bb};
    if (d.n < 1) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < 4; ++k) {
      if (slot[k] < 0 || slot[k] >= h.n_leaves ||
          (p->leaf[slot[k]].n != 1 && p->leaf[slot[k]].n != d.n)) {
        return (int)cudaErrorInvalidValue;
      }
    }
  }
  ml_vamp_finish_kernel<T><<<(unsigned)lanes, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

}  // namespace

// table: a struct Finish (ops/ml_vamp_finish.py _Finish)
extern "C" int ml_vamp_finish_f32(const void* table, int64_t lanes,
                                  void* stream) {
  return launch<float>(table, lanes, stream);
}

extern "C" int ml_vamp_finish_f64(const void* table, int64_t lanes,
                                  void* stream) {
  return launch<double>(table, lanes, stream);
}
