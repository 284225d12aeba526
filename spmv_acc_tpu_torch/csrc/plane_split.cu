// The Hopper plane-split kernel: x (float64 or float32) into the bf16 chunk
// planes the JAX package's on-chip swell kernels read.
//
// Replaces K-d of the JAX package, spmv_acc_tpu/ops/swell.py::_plane_split_kernel
// (its pallas_call in _plane_split_call), together with the padding and the
// hi/lo split that _prep_x_pure does around it in XLA ops.  For every entry q
// of the padded vector (q < nchunks * 16384, x[q - delta] inside [0, n), else
// 0) it forms the f32 sets (float32: v; float64: hi = f32(v), lo = f32(v - hi))
// and splits each set into three bf16 planes whose sum is exact:
//   c1 = rne(v), c2 = rne(v - c1), c3 = v - c1 - c2,
// rne being the reference's integer round-to-nearest-even to bf16,
// (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000, not a cast the compiler could
// fold.  Each plane is bf16-representable, so its bf16 is its top 16 bits.
// Output (nchunks, 128, 3 * sets * 128) bf16: set s, plane p of entry q at
// [q >> 14][(q >> 7) & 127][(3s + p) * 128 + (q & 127)], bit for bit the JAX
// function's.
//
// What bounds it on an H100: device-memory bytes (8 or 4 B read and 6 * sets B
// written per padded entry, a few integer and float32 operations between).
// One thread per padded entry, consecutive threads on consecutive entries, so
// the reads and each plane's stores are coalesced; the IEEE operations are
// written as __fsub_rn / __dsub_rn so nothing is contracted or reassociated.
// A single launch at the main path's sizes (under 1 M entries) is short enough
// that launch latency is a large part of it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float rne_bf16(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__device__ __forceinline__ uint16_t top_bits(float v) {
  return uint16_t(__float_as_uint(v) >> 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
plane_split_kernel(const T* __restrict__ x, uint16_t* __restrict__ out, int64_t n,
                   int64_t delta, int64_t n_pad) {
  constexpr int kSets = sizeof(T) == 8 ? 2 : 1;
  const int64_t q = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n_pad) return;
  const int64_t i = q - delta;
  const T v = (i >= 0 && i < n) ? x[i] : T(0);
  float set[kSets];
  if constexpr (kSets == 2) {
    set[0] = __double2float_rn(v);
    set[1] = __double2float_rn(__dsub_rn(v, double(set[0])));
  } else {
    set[0] = v;
  }
  uint16_t* o = out + (q >> 7) * (3 * kSets * kLanes) + (q & (kLanes - 1));
#pragma unroll
  for (int s = 0; s < kSets; ++s) {
    const float c1 = rne_bf16(set[s]);
    const float r1 = __fsub_rn(set[s], c1);
    const float c2 = rne_bf16(r1);
    const float c3 = __fsub_rn(r1, c2);
    o[(3 * s) * kLanes] = top_bits(c1);
    o[(3 * s + 1) * kLanes] = top_bits(c2);
    o[(3 * s + 2) * kLanes] = top_bits(c3);
  }
}

}  // namespace

// Launches the plane split on `stream`: x (n,) float64 (is_f64 != 0) or
// float32 into out (n_pad / 16384, 128, 3 * sets * 128) bf16, entry q reading
// x[q - delta].  Does not synchronise.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a bad size.
extern "C" int plane_split(int is_f64, const void* x, void* out, int64_t n, int64_t delta,
                           int64_t n_pad, void* stream) {
  if (n < 0 || delta < 0 || n_pad <= 0 || n_pad % (kLanes * kLanes) != 0 || n + delta > n_pad)
    return int(cudaErrorInvalidValue);
  const int64_t blocks = (n_pad + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint16_t* o = static_cast<uint16_t*>(out);
  if (is_f64)
    plane_split_kernel<double><<<unsigned(blocks), kThreads, 0, st>>>(
        static_cast<const double*>(x), o, n, delta, n_pad);
  else
    plane_split_kernel<float><<<unsigned(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(x), o, n, delta, n_pad);
  return int(cudaGetLastError());
}
