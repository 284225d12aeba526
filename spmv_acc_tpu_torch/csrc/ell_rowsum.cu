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
// What bounds it on an H100: device-memory bytes and the latency of each
// row's dependent loads.  It reads each row's stored cells only (row_len[r] of
// them: 8 or 4 B of value and 4 B of column), row_len (4 B a row), an x gather
// that is mostly a cache hit, and writes the output row: in 32-B sectors
// 1.06x the bytes A @ x needs in CSR on boneS10 in float64 and 1.09x in
// float32, where the walk over the whole slab read 1.27x (the longest row
// over the mean, and the width rounded up to 8 for the TPU).  Measured, that
// gains only 1-3.5 %: a row's padding (72 B of values on boneS10) shares its
// memory lines with the next row's cells, which are read anyway, and the
// row_len load comes before every other load of the row.  On Ga41As41H72, with
// 1.14x padding, the walk to the width is 10 % faster (PERF.md).
//
// What the design does about it: a vector of VS lanes owns one row (the
// reference's vector-row kernel, hip-vector-row/vector_row_native.hpp:13-58),
// so a vector's loads are contiguous.  Lane j takes the row's 16-B vectors
// j, j + VS, ... (double2 of values and int2 of columns in float64, float4 and
// int4 in float32), kUnroll of them a step: it issues all the value and
// column loads of a step, then their x gathers, then the FMAs.  The last
// partial vector is read cell by cell.  Where a row's start is not 16-B
// aligned (a width that is not a multiple of the vector, or an offset
// tensor), the same walk runs on single cells.  VS is a power of two <= 32
// chosen from the width in vectors (ops/vector_row.py::vector_size).
//
// A padding cell holds value 0 and column 0, so the whole-slab sum adds
// 0 * x[0] for each; lane 0 of a row with row_len < width adds that term once,
// so the result is the whole slab's, NaN when x[0] is inf or NaN included.
// Each lane sums in FP64, also for float32 input (the product of two floats
// is exact in FP64), then the vector reduces with warp shuffles in a fixed
// tree and lane 0 stores the row, rounded once.  No atomics: the result is the
// same from run to run.  All offsets are int64.  Without row_len every row is
// read to the width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 16-B vectors a lane loads in one step, before it gathers: one in float64 and
// two in float32, the faster of 1 and 2 on the A/B (scripts/torch_ab_ell.py);
// 4 was slower: more vectors a step cost registers, so fewer warps hide latency
template <typename T> constexpr int kUnroll = sizeof(T) == 4 ? 2 : 1;

// a vector of E values and its E columns, loaded as one 16-B (values) and one
// 4E-B (columns) access; E = 1 is the single-cell walk
template <typename T, int E> struct Vec;
template <> struct Vec<double, 2> { using V = double2; using C = int2; };
template <> struct Vec<float, 4> { using V = float4; using C = int4; };
template <typename T> struct Vec<T, 1> { using V = T; using C = int32_t; };

__device__ __forceinline__ double cell(double a, int) { return a; }
__device__ __forceinline__ float cell(float a, int) { return a; }
__device__ __forceinline__ int32_t cell(int32_t a, int) { return a; }
__device__ __forceinline__ double cell(const double2& a, int e) { return e == 0 ? a.x : a.y; }
__device__ __forceinline__ int32_t cell(const int2& a, int e) { return e == 0 ? a.x : a.y; }
__device__ __forceinline__ float cell(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}
__device__ __forceinline__ int32_t cell(const int4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

template <typename T, int VS, int E>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const T* __restrict__ vals,
           const int32_t* __restrict__ col,
           const int32_t* __restrict__ row_len,
           const T* __restrict__ x,
           T* __restrict__ y,
           int64_t rows, int64_t width) {
  using V = typename Vec<T, E>::V;
  using C = typename Vec<T, E>::C;
  const int64_t row = (int64_t(blockIdx.x) * kThreads + threadIdx.x) / VS;
  const int j = threadIdx.x % VS;
  double acc = 0.0;
  if (row < rows) {
    const int64_t len = row_len ? int64_t(row_len[row]) : width;
    const T* v = vals + row * width;
    const int32_t* c = col + row * width;
    const V* vv = reinterpret_cast<const V*>(v);
    const C* cv = reinterpret_cast<const C*>(c);
    const int64_t nvec = len / E;  // whole vectors of the row
    for (int64_t q0 = j; q0 < nvec; q0 += int64_t(kUnroll<T>) * VS) {
      V a[kUnroll<T>];
      C k[kUnroll<T>];
#pragma unroll
      for (int u = 0; u < kUnroll<T>; ++u)
        if (q0 + u * VS < nvec) {
          a[u] = vv[q0 + u * VS];
          k[u] = cv[q0 + u * VS];
        }
      T g[kUnroll<T>][E];
#pragma unroll
      for (int u = 0; u < kUnroll<T>; ++u)
        if (q0 + u * VS < nvec) {
#pragma unroll
          for (int e = 0; e < E; ++e) g[u][e] = __ldg(x + cell(k[u], e));
        }
#pragma unroll
      for (int u = 0; u < kUnroll<T>; ++u)
        if (q0 + u * VS < nvec) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc += double(cell(a[u], e)) * double(g[u][e]);
        }
    }
    // the last partial vector, cell by cell
    for (int64_t w = nvec * E + j; w < len; w += VS) acc += double(v[w]) * double(__ldg(x + c[w]));
    // the padding's 0 * x[0], once
    if (j == 0 && len < width) acc += 0.0 * double(__ldg(x));
  }
  // every lane of the warp takes part, rows past the end with 0
#pragma unroll
  for (int off = VS / 2; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off, VS);
  if (j == 0 && row < rows) y[row] = T(acc);
}

template <typename T, int VS, int E>
int launch(const void* vals, const void* col, const void* row_len, const void* x, void* y,
           int64_t rows, int64_t width, cudaStream_t stream) {
  const int64_t blocks = (rows * VS + kThreads - 1) / kThreads;
  if (blocks <= 0 || blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  ell_kernel<T, VS, E><<<dim3(unsigned(blocks)), dim3(kThreads), 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(col),
      static_cast<const int32_t*>(row_len), static_cast<const T*>(x), static_cast<T*>(y), rows,
      width);
  return int(cudaGetLastError());
}

template <typename T, int E>
int dispatch(int vs, const void* vals, const void* col, const void* row_len, const void* x,
             void* y, int64_t rows, int64_t width, cudaStream_t s) {
  switch (vs) {
    case 2: return launch<T, 2, E>(vals, col, row_len, x, y, rows, width, s);
    case 4: return launch<T, 4, E>(vals, col, row_len, x, y, rows, width, s);
    case 8: return launch<T, 8, E>(vals, col, row_len, x, y, rows, width, s);
    case 16: return launch<T, 16, E>(vals, col, row_len, x, y, rows, width, s);
    case 32: return launch<T, 32, E>(vals, col, row_len, x, y, rows, width, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// 16-B vectors where every row starts on one: E values a vector
template <typename T>
int dispatch_aligned(int vs, const void* vals, const void* col, const void* row_len,
                     const void* x, void* y, int64_t rows, int64_t width, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(col) % (4 * E) == 0 && width % E == 0;
  return aligned ? dispatch<T, E>(vs, vals, col, row_len, x, y, rows, width, s)
                 : dispatch<T, 1>(vs, vals, col, row_len, x, y, rows, width, s);
}

}  // namespace

// Launches the ELL row-sum kernel on `stream`: y (rows) = row sums of vals * x[col]
// over a row-major (rows, width) slab, values in float64 (is_f64 != 0) or
// float32, `vs` lanes per row (2, 4, 8, 16 or 32).  `row_len` (int32, rows) holds
// each row's stored cells, which lead the row and are the only ones read (the
// padding adds 0 * x[0] once); NULL reads every row to the width.  Does not
// synchronise.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for another vs or a grid that does not fit.
extern "C" int ell_rowsum(int is_f64, int vs, const void* vals, const void* col,
                          const void* row_len, const void* x, void* y, int64_t rows,
                          int64_t width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? dispatch_aligned<double>(vs, vals, col, row_len, x, y, rows, width, s)
                : dispatch_aligned<float>(vs, vals, col, row_len, x, y, rows, width, s);
}
