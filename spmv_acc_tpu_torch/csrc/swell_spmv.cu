// H1: the Hopper swell SpMV kernel, ax = A @ x over the swell slab layout, FP64.
//
// Replaces the TPU swell kernel family of the JAX package, spmv_acc_tpu/ops/swell.py:
//   K-a _make_f64_kernel    (one grid step of a depth-D bucket, two-f32 Dekker/2Sum)
//   K-b _make_fused_kernel  (K-a with G steps per grid iteration)
//   K-c _make_fused3_kernel (K-b as a 3-stage software pipeline)
//   K-d _plane_split_kernel (x split into bf16 planes for the one-hot table matmuls)
//   K-e _make_native_steps_kernel (the CPU executor of K-a's per-step products)
// All five compute the same function: for every 128-row block, the sum over its
// slabs of value * x[window column].  On the TPU that needed x tables, one-hot
// matmuls and f64 emulated as two f32; here each thread reads x directly in
// native FP64.
//
// What bounds it on an H100: device-memory bytes.  Every padded slot is read
// once (8 B value + 1 B in-window index, about 9 B a slot), plus x gathers
// (mostly L2 hits: a slab's columns lie inside one 256-column window) and 8 B
// per row of output; there are 2 flops per slot.  What the design does about
// it: values stay FP64 (no hi/lo planes), column indices are uint8 offsets into
// the slab's window (1 B instead of 4 B), and slabs are stored slot-major,
// [off + slot*128 + lane], so the 32 lanes of a warp read 256 contiguous bytes
// of values and 32 contiguous bytes of indices per slot.
//
// Simple form: one 128-thread block per row-block, one thread per row.  Each
// thread walks its row-block's slabs and slots in layout order and accumulates
// in FP64 registers, so the result is the same from run to run: no atomics, no
// cross-block pass.  Padded slots hold value 0 and their column is masked to
// [0, n), so they never read x out of range.  All index arithmetic is int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

__global__ void __launch_bounds__(kLanes)
swell_spmv_f64_kernel(const double* __restrict__ vals,
                      const uint8_t* __restrict__ lidx,
                      const int64_t* __restrict__ slab_off,
                      const int8_t* __restrict__ slab_log2d,
                      const int32_t* __restrict__ slab_col_base,
                      const int64_t* __restrict__ rb_slab_ptr,
                      const double* __restrict__ x,
                      double* __restrict__ ax,
                      int64_t m, int64_t n) {
  const int64_t rb = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t s0 = rb_slab_ptr[rb];
  const int64_t s1 = rb_slab_ptr[rb + 1];
  double acc = 0.0;
  for (int64_t s = s0; s < s1; ++s) {
    const int64_t base = slab_off[s] + lane;
    const int64_t depth = int64_t(1) << slab_log2d[s];
    const int64_t col_base = slab_col_base[s];
#pragma unroll 4
    for (int64_t t = 0; t < depth; ++t) {
      const int64_t p = base + t * kLanes;
      const int64_t c = col_base + lidx[p];
      if (c >= 0 && c < n) acc += vals[p] * __ldg(x + c);
    }
  }
  const int64_t row = rb * kLanes + lane;
  if (row < m) ax[row] = acc;
}

}  // namespace

// Launches H1 on `stream` over `mrb` row-blocks (mrb = ceil(m / 128), at least 1).
// Does not synchronise.  Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int swell_spmv_f64(const void* vals, const void* lidx, const void* slab_off,
                              const void* slab_log2d, const void* slab_col_base,
                              const void* rb_slab_ptr, const void* x, void* ax,
                              int64_t m, int64_t n, int64_t mrb, void* stream) {
  if (mrb <= 0 || mrb > 0x7fffffff) return int(cudaErrorInvalidValue);
  swell_spmv_f64_kernel<<<dim3(unsigned(mrb)), dim3(kLanes), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(vals), static_cast<const uint8_t*>(lidx),
      static_cast<const int64_t*>(slab_off), static_cast<const int8_t*>(slab_log2d),
      static_cast<const int32_t*>(slab_col_base), static_cast<const int64_t*>(rb_slab_ptr),
      static_cast<const double*>(x), static_cast<double*>(ax), m, n);
  return int(cudaGetLastError());
}
