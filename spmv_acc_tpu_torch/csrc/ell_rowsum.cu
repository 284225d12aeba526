// The Hopper ELL row-sum kernel of the vector_row strategy: y[r] = sum_w
// vals[r, w] * x[col[r, w]] over a row-major padded ELL slab, for float64 and
// float32 values.
//
// Replaces the TPU row-sum kernels of the JAX package,
// spmv_acc_tpu/ops/vector_row.py:
//   K-i _rowsum_kernel64 (256 x 512 tiles of vals * xg, two-f32 Dekker products
//       and 2Sum folds, a hi/err accumulator carried across width tiles)
//   K-j _rowsum_kernel   (K-i in the input dtype)
// On the TPU the gather x[col] ran in XLA before the kernel, because Mosaic has
// no general gather, and f64 ran as two f32 words; here the kernel reads
// col[r, w] and x[col] itself and sums in native FP64.
//
// What bounds it on an H100: device-memory bytes (every ELL cell is read once:
// 8 or 4 B of value and 4 B of column, padding included, plus an x gather that
// is mostly an L2 hit and the output row).  What the design does about it: a
// vector of VS lanes owns one row (the reference's vector-row kernel,
// hip-vector-row/vector_row_native.hpp:13-58), so a vector's loads are
// contiguous; VS is a power of two <= 32 chosen from the width so that each
// lane strides over at least 4 cells (ops/vector_row.py::vector_size): fewer
// idle lanes and shuffle steps per row than a full warp on short rows.
//
// Each lane sums its strided cells w = j, j + VS, ... in FP64, also for float32
// input (the product of two floats is exact in FP64), then the vector reduces
// with warp shuffles in a fixed tree and lane 0 stores the row, rounded once.
// No atomics: the result is the same from run to run.  Padding cells hold
// value 0 and column 0.  All offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int VS>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const T* __restrict__ vals,
           const int32_t* __restrict__ col,
           const T* __restrict__ x,
           T* __restrict__ y,
           int64_t rows, int64_t width) {
  const int64_t row = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / VS;
  const int j = threadIdx.x % VS;
  double acc = 0.0;
  if (row < rows) {
    const T* v = vals + row * width;
    const int32_t* c = col + row * width;
    for (int64_t w = j; w < width; w += VS) acc += double(v[w]) * double(__ldg(x + c[w]));
  }
  // every lane of the warp takes part, rows past the end with 0
#pragma unroll
  for (int off = VS / 2; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, VS);
  if (j == 0 && row < rows) y[row] = T(acc);
}

template <typename T, int VS>
int launch(const void* vals, const void* col, const void* x, void* y, int64_t rows,
           int64_t width, cudaStream_t stream) {
  const int64_t blocks = (rows * VS + kThreads - 1) / kThreads;
  if (blocks <= 0 || blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  ell_kernel<T, VS><<<dim3(unsigned(blocks)), dim3(kThreads), 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(col), static_cast<const T*>(x),
      static_cast<T*>(y), rows, width);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int vs, const void* vals, const void* col, const void* x, void* y, int64_t rows,
             int64_t width, cudaStream_t s) {
  switch (vs) {
    case 2: return launch<T, 2>(vals, col, x, y, rows, width, s);
    case 4: return launch<T, 4>(vals, col, x, y, rows, width, s);
    case 8: return launch<T, 8>(vals, col, x, y, rows, width, s);
    case 16: return launch<T, 16>(vals, col, x, y, rows, width, s);
    case 32: return launch<T, 32>(vals, col, x, y, rows, width, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the ELL row-sum kernel on `stream`: y (rows) = row sums of vals * x[col]
// over a row-major (rows, width) slab, values in float64 (is_f64 != 0) or
// float32, `vs` lanes per row (2, 4, 8, 16 or 32).  Does not synchronise.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for another vs or a grid that does not fit.
extern "C" int ell_rowsum(int is_f64, int vs, const void* vals, const void* col, const void* x,
                          void* y, int64_t rows, int64_t width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? dispatch<double>(vs, vals, col, x, y, rows, width, s)
                : dispatch<float>(vs, vals, col, x, y, rows, width, s);
}
