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
// What bounds it on an H100: device-memory bytes once the work fills the card
// (every padded slot is read once: 8 or 4 B of value plus a 1 B in-window
// index, plus 128 x values per block, mostly L2 hits).  What the design does
// about it: values stay in the source dtype, the index is one byte, a block's
// slots are stored slot-row major, [slot * 128 + lane], so a warp reads 32
// contiguous values and 32 contiguous bytes per slot, and the gather is a
// shared-memory read.
//
// Work split: a row block's blocks are a dependent walk, and TSOPF_RS_b2383 has
// 298 row blocks of ~974 slot rows for 132 SMs, so one thread block per row
// block would leave the card latency-bound.  A host-built schedule
// (ops/tile_plan.py, build_tile_schedule) cuts each row block into runs of
// whole blocks of at most TILE_CHUNK_ROWS slot rows (at least one block);
// blockIdx.x is such a chunk, one thread per row.  The row block's blocks are
// contiguous in the layout, sorted by (row block, bucket, column tile); each is
// staged (x[ct * 128 + lane], 0 past n) and its W slots are summed in layout
// order into one FP64 register per thread, also for float32 input: the product
// of two floats is exact in FP64.  A row block's only chunk stores T(sum) to y;
// the chunks of a split row block store FP64 partials, and a second pass adds
// them in chunk order and stores T(sum).  So the only rounding of the f32 path
// is the final store, no float atomics are used and the result is the same
// from run to run; a row block without blocks writes zeros.  Padded slots hold
// value 0 and index 0.  All offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

// The chunk schedule as ChunkSchedule.packed() (ops/swell_plan.py) lays it out
// in one int64 array: ptr (nchunks + 1) | rb | part | split_ptr (nsplit + 1) |
// split_rb.  Chunk c walks blocks [ptr[c], ptr[c+1]) of row block rb[c];
// part[c] is -1 for a row block's only chunk, else its partial slot.
struct Sched {
  const int64_t *ptr, *rb, *part, *split_ptr, *split_rb;
};

Sched unpack(const void* packed, int64_t nchunks, int64_t nsplit) {
  Sched s;
  s.ptr = static_cast<const int64_t*>(packed);
  s.rb = s.ptr + nchunks + 1;
  s.part = s.rb + nchunks;
  s.split_ptr = s.part + nchunks;
  s.split_rb = s.split_ptr + nsplit + 1;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
tile_kernel(const T* __restrict__ vals,
            const uint8_t* __restrict__ lidx,
            const int64_t* __restrict__ blk_off,    // first slot row of each block
            const int32_t* __restrict__ blk_depth,  // W of each block
            const int32_t* __restrict__ blk_ct,     // column tile of each block
            Sched sc,
            const T* __restrict__ x,
            T* __restrict__ y,
            double* __restrict__ part,
            int64_t m, int64_t n) {
  __shared__ T xs[kLanes];
  const int64_t c = blockIdx.x;
  const int lane = threadIdx.x;
  double acc = 0.0;
  const int64_t b1 = sc.ptr[c + 1];
  for (int64_t b = sc.ptr[c]; b < b1; ++b) {
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
  const int64_t p = sc.part[c];
  if (p < 0) {
    const int64_t row = sc.rb[c] * kLanes + lane;
    if (row < m) y[row] = T(acc);
  } else {
    part[p * kLanes + lane] = acc;
  }
}

// The fix-up pass: blockIdx.x is a split row block; each thread adds its row's
// partials in chunk order, in FP64, and stores
template <typename T>
__global__ void __launch_bounds__(kLanes)
fixup_kernel(const double* __restrict__ part, Sched sc, T* __restrict__ y, int64_t m) {
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  double acc = 0.0;
  const int64_t p1 = sc.split_ptr[b + 1];
  // unrolled so that the loads of several partials are in flight at once; the
  // adds stay in chunk order
#pragma unroll 8
  for (int64_t p = sc.split_ptr[b]; p < p1; ++p) acc += part[p * kLanes + lane];
  const int64_t row = sc.split_rb[b] * kLanes + lane;
  if (row < m) y[row] = T(acc);
}

template <typename T>
int launch(const void* vals, const void* lidx, const void* blk_off, const void* blk_depth,
           const void* blk_ct, const void* sched, int64_t nchunks, int64_t nsplit, void* part,
           const void* x, void* y, int64_t m, int64_t n, cudaStream_t stream) {
  const Sched sc = unpack(sched, nchunks, nsplit);
  tile_kernel<T><<<dim3(unsigned(nchunks)), dim3(kLanes), 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const uint8_t*>(lidx),
      static_cast<const int64_t*>(blk_off), static_cast<const int32_t*>(blk_depth),
      static_cast<const int32_t*>(blk_ct), sc, static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<double*>(part), m, n);
  const int rc = int(cudaGetLastError());
  if (rc != 0 || nsplit == 0) return rc;
  fixup_kernel<T><<<dim3(unsigned(nsplit)), dim3(kLanes), 0, stream>>>(
      static_cast<const double*>(part), sc, static_cast<T*>(y), m);
  return int(cudaGetLastError());
}

}  // namespace

// Launches the tile kernel and, when the schedule splits a row block, its
// fix-up pass on `stream`: y (m) = A @ x (n), values in float64 (is_f64 != 0)
// or float32, over the `nchunks` chunks of the packed schedule `sched`
// (`nsplit` split row blocks; `part` holds their partials, nparts * 128
// doubles, and may be null when nsplit is 0).  Does not synchronise.  Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a grid that does not fit.
extern "C" int tile_spmv(int is_f64, const void* vals, const void* lidx, const void* blk_off,
                         const void* blk_depth, const void* blk_ct, const void* sched,
                         int64_t nchunks, int64_t nsplit, void* part, const void* x, void* y,
                         int64_t m, int64_t n, void* stream) {
  if (nchunks <= 0 || nchunks > 0x7fffffff || nsplit < 0 || nsplit > 0x7fffffff ||
      (nsplit > 0 && part == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(vals, lidx, blk_off, blk_depth, blk_ct, sched, nchunks, nsplit,
                                 part, x, y, m, n, s)
                : launch<float>(vals, lidx, blk_off, blk_depth, blk_ct, sched, nchunks, nsplit,
                                part, x, y, m, n, s);
}
