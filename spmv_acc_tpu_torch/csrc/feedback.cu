// F-1, the chained loop's feedback: the bench's power-iteration step after
// each SpMV or SpMM, in one cooperative launch and no atomics.
//
// Replaces XLA's fusion of the JAX package's loop bodies, which has no Pallas
// kernel of its own: spmv_acc_tpu/ops/swell.py::_swell_power_run (its body,
// s = f32(alpha * A@x + beta * y), x *= 1 + mean(s * s) * 1e-30) and
// _swell_amx_power_run (s = A@X, X *= 1 + mean(s * s) * 1e-30; the port casts
// s to float32 there too).  Eagerly the same body is about nine launches and
// writes s, s * s and the scaled x to device memory; here it is one.
//
// One launch, every block resident at once (so a barrier across the blocks
// cannot deadlock, whatever else holds the SMs):
//   phase 1: s = alpha * ax + beta * y in the plan's dtype (or s = ax), cast
//     to float32; each block sums s * s in float32 over a fixed share of the
//     elements, in a fixed order (a grid-stride walk, kUnroll vectors loaded
//     at once, then a warp-shuffle tree and a tree over the warps).  Before
//     that walk each thread loads the first kHold vectors of its share of x
//     into registers, so that their reads overlap phase 1's (without them an
//     iteration of the bench's chain took 0.1-0.2 us more on each of five
//     small-set matrices on the H100, PERF.md);
//   a barrier across the blocks;
//   phase 2: every block folds the same block sums in the same order into the
//     same float32 mean, forms scale = 1 + T(mean) * 1e-30 and multiplies its
//     share of x in place: the held vectors from registers, the rest read
//     again.  x is read and written at every step, as XLA's fusion does, even
//     where the scale rounds to exactly 1.
// The barrier is cooperative_groups' grid.sync(); the block sums go through
// `partials` in device memory.  Blocks of kSmallThreads threads where one
// vector a thread needs at most a block an SM (the bench's small set: more,
// smaller blocks reach the data sooner; 512-thread blocks there cost another
// 0.2-0.4 us an iteration), else kThreads; as many blocks as the
// data needs, at most as many as are resident (occupancy x SMs) and
// kMaxBlocks.  A barrier in device memory costs about as much as the second
// launch of the two-pass form this replaced, and a grid of one thread-block
// cluster (the cluster's hardware barrier, the sums in distributed shared
// memory) cost more on the small set (PERF.md).
//
// The sum is taken in another order than torch's mean, so the float32 mean may
// differ in its last bits; with the bench's data 1 + mean * 1e-30 rounds to
// exactly 1 in float64 unless the mean passes ~1e14, so x comes out the same
// bits either way.  The order depends only on the grid, which depends only on
// the sizes and the card, so two calls give the same bits.  The IEEE
// operations are written as __dmul_rn / __dadd_rn (and the float32 ones) so
// that nothing is contracted into an FMA: s and s * s round as the eager
// expression rounds them.
//
// What bounds it on an H100: device-memory bytes.  SpMV reads ax and y (8 B
// each per row in float64) and reads and writes x (16 B per column): 16 m +
// 16 n; SpMM reads AX and reads and writes X: 8 m k + 16 n k.  Every thread
// loads 16 B at a time (double2 / float4), consecutive threads on consecutive
// vectors, kUnroll loads in flight.  The few elements past the last whole
// vector are taken by thread 0 of block 0.  grid.sync() needs no relocatable
// device code with this toolkit (CUDA 12).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kSmallThreads = 128;
constexpr int kMaxBlocks = 1024;  // the wrapper's partials buffer
constexpr int kHold = 4;          // vectors of x a thread keeps in registers across the barrier
constexpr int kUnroll = 4;        // vectors a thread loads at once in each walk
constexpr int kMaxDevices = 64;

template <typename T> struct Vec;
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// The float32 square of s = alpha * a + beta * b (has_y) or s = a.
template <typename T>
__device__ __forceinline__ float square(T a, T b, T alpha, T beta, bool has_y) {
  const T s = has_y ? add_rn(mul_rn(alpha, a), mul_rn(beta, b)) : a;
  const float f = float(s);
  return __fmul_rn(f, f);
}

// acc plus the float32 squares of one vector's elements, in element order.
__device__ __forceinline__ float add_squares(float acc, double2 a, double2 b, double alpha,
                                             double beta, bool has_y) {
  acc = __fadd_rn(acc, square(a.x, b.x, alpha, beta, has_y));
  return __fadd_rn(acc, square(a.y, b.y, alpha, beta, has_y));
}
__device__ __forceinline__ float add_squares(float acc, float4 a, float4 b, float alpha,
                                             float beta, bool has_y) {
  acc = __fadd_rn(acc, square(a.x, b.x, alpha, beta, has_y));
  acc = __fadd_rn(acc, square(a.y, b.y, alpha, beta, has_y));
  acc = __fadd_rn(acc, square(a.z, b.z, alpha, beta, has_y));
  return __fadd_rn(acc, square(a.w, b.w, alpha, beta, has_y));
}

__device__ __forceinline__ double2 scaled(double2 v, double s) {
  return make_double2(mul_rn(v.x, s), mul_rn(v.y, s));
}
__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(mul_rn(v.x, s), mul_rn(v.y, s), mul_rn(v.z, s), mul_rn(v.w, s));
}

// The sum of v over a block of NT threads in a fixed order; every thread gets it.
template <int NT>
__device__ __forceinline__ float block_sum(float v) {
  constexpr int kWarps = NT / 32;
  __shared__ float warp_sums[kWarps];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float t = lane < kWarps ? warp_sums[lane] : 0.0f;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1) t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, off));
  if (threadIdx.x == 0) total = t;
  __syncthreads();
  return total;
}

// One thread's share of the work (vectors first, first + stride, ...): the
// first kHold vectors of x, loaded at once, phase 1's float32 sum and phase
// 2's scaling.
template <typename T, int NT>
struct Share {
  using V = typename Vec<T>::type;
  static constexpr int kVec = Vec<T>::n;
  int64_t first, stride;
  V held[kHold];

  __device__ __forceinline__ Share(const T* x, int64_t xlen)
      : first(int64_t(blockIdx.x) * NT + threadIdx.x), stride(int64_t(gridDim.x) * NT) {
    const V* xv = reinterpret_cast<const V*>(x);
#pragma unroll
    for (int h = 0; h < kHold; ++h) {
      const int64_t i = first + h * stride;
      held[h] = i < xlen / kVec ? xv[i] : V{};
    }
  }

  __device__ __forceinline__ float sum_squares(const T* ax, const T* y, T alpha, T beta,
                                               bool has_y, int64_t len) const {
    const int64_t nvec = len / kVec;
    const V* av = reinterpret_cast<const V*>(ax);
    const V* yv = reinterpret_cast<const V*>(y);
    float acc = 0.0f;
    for (int64_t base = first; base < nvec; base += kUnroll * stride) {
      V a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * stride;
        a[u] = i < nvec ? av[i] : V{};
        b[u] = has_y && i < nvec ? yv[i] : V{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * stride < nvec) acc = add_squares(acc, a[u], b[u], alpha, beta, has_y);
    }
    if (first == 0)
      for (int64_t i = nvec * kVec; i < len; ++i)
        acc = __fadd_rn(acc, square(ax[i], has_y ? y[i] : T(0), alpha, beta, has_y));
    return acc;
  }

  // x *= s over this thread's share: the held vectors, then the rest.
  __device__ __forceinline__ void scale(T* x, int64_t xlen, T s) const {
    const int64_t xnvec = xlen / kVec;
    V* xv = reinterpret_cast<V*>(x);
#pragma unroll
    for (int h = 0; h < kHold; ++h) {
      const int64_t i = first + h * stride;
      if (i < xnvec) xv[i] = scaled(held[h], s);
    }
    for (int64_t base = first + kHold * stride; base < xnvec; base += kUnroll * stride) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * stride;
        v[u] = i < xnvec ? xv[i] : V{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * stride;
        if (i < xnvec) xv[i] = scaled(v[u], s);
      }
    }
    if (first == 0)
      for (int64_t i = xnvec * kVec; i < xlen; ++i) x[i] = mul_rn(x[i], s);
  }
};

// 1 + T(sum / len) * 1e-30, the mean in float32.
template <typename T>
__device__ __forceinline__ T scale_of(float sum, int64_t len) {
  const float mean = __fdiv_rn(sum, float(len));
  return add_rn(T(1), mul_rn(T(mean), T(1e-30)));
}

// Both phases, with grid.sync() between them.
template <typename T, int NT>
__global__ void __launch_bounds__(NT)
feedback_kernel(const T* __restrict__ ax, const T* __restrict__ y, T alpha, T beta, int has_y,
                int64_t len, T* __restrict__ x, int64_t xlen, float* __restrict__ partials) {
  const Share<T, NT> share(x, xlen);
  const float part = block_sum<NT>(share.sum_squares(ax, y, alpha, beta, has_y, len));
  if (threadIdx.x == 0) partials[blockIdx.x] = part;
  cg::this_grid().sync();
  float tot = 0.0f;
  for (int p = threadIdx.x; p < int(gridDim.x); p += NT) tot = __fadd_rn(tot, __ldcg(partials + p));
  share.scale(x, xlen, scale_of<T>(block_sum<NT>(tot), len));
}

// The card's SMs and the most blocks of feedback_kernel<T, NT> resident on
// each; 0 SMs when the device cannot launch cooperatively.  Found at a
// device's first call and kept, so that later calls (inside a stream capture
// too) make no query.
struct Residency {
  int sms, per_sm;
};

template <typename T, int NT>
cudaError_t residency(Residency* out) {
  static Residency cache[kMaxDevices];  // sms 0: not yet known; -1: no cooperative launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, feedback_kernel<T, NT>, NT,
                                                             0)) != cudaSuccess)
      return err;
    cache[dev] = (!coop || sms < 1 || per_sm < 1) ? Residency{-1, 0} : Residency{sms, per_sm};
  }
  *out = cache[dev];
  return out->sms < 0 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

template <typename T, int NT>
int launch_nt(const Residency& res, int64_t vecs, int has_y, const T* ax, const T* y, T alpha,
              T beta, int64_t len, T* x, int64_t xlen, float* partials, cudaStream_t st) {
  int64_t most = int64_t(res.sms) * res.per_sm;
  if (most > kMaxBlocks) most = kMaxBlocks;
  const int64_t need = (vecs + NT - 1) / NT;  // blocks for one vector a thread
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(need < 1 ? 1 : (need < most ? need : most)));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, feedback_kernel<T, NT>, ax, y, alpha, beta,
                                             has_y, len, x, xlen, partials);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T>
int launch(int has_y, const void* ax, const void* y, double alpha, double beta, int64_t len,
           void* x, int64_t xlen, void* partials, cudaStream_t st) {
  const int64_t vecs = (len > xlen ? len : xlen) / Vec<T>::n;
  Residency small, big;
  cudaError_t err = residency<T, kSmallThreads>(&small);
  if (err == cudaSuccess) err = residency<T, kThreads>(&big);
  if (err != cudaSuccess) return int(err);
  const T* a = static_cast<const T*>(ax);
  const T* b = static_cast<const T*>(y);
  float* p = static_cast<float*>(partials);
  return vecs <= int64_t(small.sms) * kSmallThreads
             ? launch_nt<T, kSmallThreads>(small, vecs, has_y, a, b, T(alpha), T(beta), len,
                                           static_cast<T*>(x), xlen, p, st)
             : launch_nt<T, kThreads>(big, vecs, has_y, a, b, T(alpha), T(beta), len,
                                      static_cast<T*>(x), xlen, p, st);
}

}  // namespace

// One cooperative launch on `stream`: the float32 mean of s * s over the
// `len` elements of ax (s = alpha * ax + beta * y when has_y, else s = ax),
// then x (xlen elements) *= 1 + mean * 1e-30 in place; float64 (is_f64 != 0)
// or float32 throughout.  ax, y and x are 16-byte aligned and contiguous, x
// overlaps neither; `partials` holds at least 1024 floats.  Does not
// synchronise.  Returns the launch's error, else cudaGetLastError() after it
// (0 on success), or cudaErrorInvalidValue for a bad size.
extern "C" int feedback(int is_f64, int has_y, const void* ax, const void* y, double alpha,
                        double beta, int64_t len, void* x, int64_t xlen, void* partials,
                        void* stream) {
  if (len <= 0 || xlen < 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(has_y, ax, y, alpha, beta, len, x, xlen, partials, st)
                : launch<float>(has_y, ax, y, alpha, beta, len, x, xlen, partials, st);
}
