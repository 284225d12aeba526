// The Hopper tile kernel of the adaptive_plus strategy: y = A @ x over the tile
// plan (ops/tile_plan.py), for float64 and float32 values.
//
// Replaces the TPU tile lane-gather kernels of the JAX package,
// spmv_acc_tpu/ops/adaptive_plus.py:
//   K-g _make_df64_kernel (one grid step: P blocks of depth W, two-f32 products
//       and compensated folds, x resident in VMEM as (nct8, 8, 128) tables)
//   K-h _make_f32_kernel  (K-g in float32)
// Both compute, for every 128-row block, the sum over its (128 x 128)-window
// blocks of the block's W x 128 slots times the 128-wide x window.  On the TPU
// the x gather had to be a lane permutation of a resident window, f64 had to be
// two f32 words, and x had to fit in VMEM (X_VMEM_LIMIT); here x stays in HBM,
// each block stages its window in shared memory and sums in native FP64.
//
// What bounds it on an H100: device-memory bytes where the row blocks fill the
// card (every padded slot is read once: 8 or 4 B of value plus a 1 B in-window
// index, plus 128 x values per block, mostly L2 hits), and load latency where
// they do not (TSOPF_RS_b2383: 298 row blocks, some 40 blocks deep, for 132
// SMs).  What the design does about it: values stay in the source dtype, the
// index is one byte, a block's slots are stored slot-row major, [slot * 128 +
// lane], so a warp reads 32 contiguous values and 32 contiguous bytes per slot,
// and the gather is a shared-memory read.
//
// Simple form: one 128-thread block per 128-row block, one thread per row.  The
// row block's blocks are contiguous in the layout, sorted by (row block,
// bucket, column tile); each is staged (x[ct * 128 + lane], 0 past n) and its W
// slots are summed in layout order into one FP64 register per thread, also for
// float32 input: the product of two floats is exact in FP64, so the only
// rounding of the f32 path is the final store.  Every row of y is written once,
// with no atomics, so the result is the same from run to run; a row block
// without blocks writes zeros.  Padded slots hold value 0 and index 0.  All
// offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

template <typename T>
__global__ void __launch_bounds__(kLanes)
tile_kernel(const T* __restrict__ vals,
            const uint8_t* __restrict__ lidx,
            const int64_t* __restrict__ blk_off,    // first slot row of each block
            const int32_t* __restrict__ blk_depth,  // W of each block
            const int32_t* __restrict__ blk_ct,     // column tile of each block
            const int64_t* __restrict__ rb_ptr,     // (mrb + 1) block pointer
            const T* __restrict__ x,
            T* __restrict__ y,
            int64_t m, int64_t n) {
  __shared__ T xs[kLanes];
  const int64_t rb = blockIdx.x;
  const int lane = threadIdx.x;
  double acc = 0.0;
  const int64_t b1 = rb_ptr[rb + 1];
  for (int64_t b = rb_ptr[rb]; b < b1; ++b) {
    const int64_t col = int64_t(blk_ct[b]) * kLanes + lane;
    const int depth = blk_depth[b];
    const T* v = vals + blk_off[b] * kLanes + lane;
    const uint8_t* ix = lidx + blk_off[b] * kLanes + lane;
    __syncthreads();  // every thread is done with the previous window
    xs[lane] = col < n ? x[col] : T(0);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < depth; ++t)
      acc += double(v[int64_t(t) * kLanes]) * double(xs[ix[int64_t(t) * kLanes]]);
  }
  const int64_t row = rb * kLanes + lane;
  if (row < m) y[row] = T(acc);
}

template <typename T>
int launch(const void* vals, const void* lidx, const void* blk_off, const void* blk_depth,
           const void* blk_ct, const void* rb_ptr, const void* x, void* y, int64_t m,
           int64_t n, int64_t mrb, cudaStream_t stream) {
  tile_kernel<T><<<dim3(unsigned(mrb)), dim3(kLanes), 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const uint8_t*>(lidx),
      static_cast<const int64_t*>(blk_off), static_cast<const int32_t*>(blk_depth),
      static_cast<const int32_t*>(blk_ct), static_cast<const int64_t*>(rb_ptr),
      static_cast<const T*>(x), static_cast<T*>(y), m, n);
  return int(cudaGetLastError());
}

}  // namespace

// Launches the tile kernel on `stream`: y (m) = A @ x (n) over `mrb` row blocks
// of 128 rows, values in float64 (is_f64 != 0) or float32.  Does not
// synchronise.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a grid that does not fit.
extern "C" int tile_spmv(int is_f64, const void* vals, const void* lidx, const void* blk_off,
                         const void* blk_depth, const void* blk_ct, const void* rb_ptr,
                         const void* x, void* y, int64_t m, int64_t n, int64_t mrb,
                         void* stream) {
  if (mrb <= 0 || mrb > 0x7fffffff) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(vals, lidx, blk_off, blk_depth, blk_ct, rb_ptr, x, y, m, n, mrb, s)
                : launch<float>(vals, lidx, blk_off, blk_depth, blk_ct, rb_ptr, x, y, m, n, mrb, s);
}
