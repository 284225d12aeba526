// F-1, the chained loop's feedback: the bench's power-iteration step after
// each SpMV or SpMM, in two passes and no atomics.
//
// Replaces XLA's fusion of the JAX package's loop bodies, which has no Pallas
// kernel of its own: spmv_acc_tpu/ops/swell.py::_swell_power_run (its body,
// s = f32(alpha * A@x + beta * y), x *= 1 + mean(s * s) * 1e-30) and
// _swell_amx_power_run (s = A@X, X *= 1 + mean(s * s) * 1e-30; the port casts
// s to float32 there too).  Eagerly the same body is about nine launches and
// writes s, s * s and the scaled x to device memory; here it is two.
//
//   pass 1 (feedback_partials): s = alpha * ax + beta * y in the plan's dtype
//     (or s = ax), cast to float32; each block writes the float32 sum of s * s
//     over a fixed share of the elements, in a fixed order (a grid-stride walk,
//     then a warp-shuffle tree and a tree over the warps).
//   pass 2 (feedback_scale): every block folds the same partials in the same
//     order into the same float32 mean, forms scale = 1 + T(mean) * 1e-30 and
//     multiplies its share of x in place.
//
// The sum is taken in another order than torch's mean, so the float32 mean may
// differ in its last bits; with the bench's data 1 + mean * 1e-30 rounds to
// exactly 1 in float64 unless the mean passes ~1e14, so x comes out the same
// bits either way.  The IEEE operations are written as __dmul_rn / __dadd_rn
// (and the float32 ones) so that nothing is contracted into an FMA: s and
// s * s round as the eager expression rounds them.
//
// What bounds it on an H100: device-memory bytes.  SpMV reads ax and y (8 B
// each per row in float64) and reads and writes x (16 B per column): 16 m +
// 16 n; SpMM reads AX and reads and writes X: 8 m k + 16 n k.  Every thread
// loads 16 B at a time (double2 / float4), consecutive threads on consecutive
// vectors; at most kMaxBlocks blocks walk the vectors, so pass 2 re-reads at
// most 4 KB of partials per block from L2.  The few elements past the last
// whole vector are taken by thread 0 of block 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;

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

// The sum of v over the block in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float t = lane < kWarps ? warp_sums[lane] : 0.0f;
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1) t = __fadd_rn(t, __shfl_down_sync(0xffffffffu, t, off));
  __shared__ float total;
  if (threadIdx.x == 0) total = t;
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
feedback_partials(const T* __restrict__ ax, const T* __restrict__ y, T alpha, T beta,
                  int has_y, int64_t len, float* __restrict__ partials) {
  using V = typename Vec<T>::type;
  constexpr int kVec = Vec<T>::n;
  const int64_t nvec = len / kVec;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const V* av = reinterpret_cast<const V*>(ax);
  const V* yv = reinterpret_cast<const V*>(y);
  float acc = 0.0f;
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < nvec; i += stride) {
    const V a = av[i];
    const V b = has_y ? yv[i] : V{};
    const T* ap = reinterpret_cast<const T*>(&a);
    const T* bp = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc = __fadd_rn(acc, square(ap[j], bp[j], alpha, beta, has_y));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int64_t i = nvec * kVec; i < len; ++i)
      acc = __fadd_rn(acc, square(ax[i], has_y ? y[i] : T(0), alpha, beta, has_y));
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
feedback_scale(T* __restrict__ x, int64_t xlen, const float* __restrict__ partials, int nparts,
               int64_t len) {
  using V = typename Vec<T>::type;
  constexpr int kVec = Vec<T>::n;
  float acc = 0.0f;
  for (int p = threadIdx.x; p < nparts; p += kThreads) acc = __fadd_rn(acc, partials[p]);
  const float mean = __fdiv_rn(block_sum(acc), float(len));
  const T scale = add_rn(T(1), mul_rn(T(mean), T(1e-30)));
  const int64_t nvec = xlen / kVec;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  V* xv = reinterpret_cast<V*>(x);
  for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < nvec; i += stride) {
    V v = xv[i];
    T* vp = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) vp[j] = mul_rn(vp[j], scale);
    xv[i] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int64_t i = nvec * kVec; i < xlen; ++i) x[i] = mul_rn(x[i], scale);
}

int blocks_for(int64_t elems, int vec) {
  const int64_t b = (elems / vec + kThreads - 1) / kThreads;
  return int(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename T>
int launch(int has_y, const void* ax, const void* y, double alpha, double beta, int64_t len,
           void* x, int64_t xlen, void* partials, cudaStream_t st) {
  const int nb1 = blocks_for(len, Vec<T>::n), nb2 = blocks_for(xlen, Vec<T>::n);
  float* part = static_cast<float*>(partials);
  feedback_partials<T><<<nb1, kThreads, 0, st>>>(
      static_cast<const T*>(ax), static_cast<const T*>(y), T(alpha), T(beta), has_y, len, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  feedback_scale<T><<<nb2, kThreads, 0, st>>>(static_cast<T*>(x), xlen, part, nb1, len);
  return int(cudaGetLastError());
}

}  // namespace

// Launches both passes on `stream`: the float32 mean of s * s over the `len`
// elements of ax (s = alpha * ax + beta * y when has_y, else s = ax), then
// x (xlen elements) *= 1 + mean * 1e-30 in place; float64 (is_f64 != 0) or
// float32 throughout.  ax, y and x are 16-byte aligned and contiguous;
// `partials` holds at least 1024 floats.  Does not synchronise.  Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a bad size.
extern "C" int feedback(int is_f64, int has_y, const void* ax, const void* y, double alpha,
                        double beta, int64_t len, void* x, int64_t xlen, void* partials,
                        void* stream) {
  if (len <= 0 || xlen < 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(has_y, ax, y, alpha, beta, len, x, xlen, partials, st)
                : launch<float>(has_y, ax, y, alpha, beta, len, x, xlen, partials, st);
}
