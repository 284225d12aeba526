// F-3, the ILU(0) preconditioner's sparse triangular solves, one launch per
// factor solve, no atomics: two launches on the same data give the same bits.
//
// Replaces XLA's loops of the JAX package's triangular solves, which have no
// Pallas kernel of their own: spmv_acc_tpu/ops/trisolve.py::trisolve (the
// chunk-scheduled fori_loop, :224-260, body :239-254) and ::trisolve_sweeps
// (the Jacobi sweeps' fori_loop, :263-283).  XLA compiles each loop into one
// device program; launched from the host the same exact solve is about eight
// small PyTorch launches per schedule step (2 x 1023 steps an ILU apply at
// 512^2 anisotropic diffusion).  Two entries (spmv_acc_tpu_torch/ops/trisolve.py):
//
// tri_levels, the exact solve over the level schedule: for each level L in
// order, every row of L (rows[level_ptr[L] .. level_ptr[L + 1])) computes
//   y[row] = (b[row] - s) / diag[row],  s = sum of vals[k] * y[cols[k]]
// over its dependencies k = dep_start[row] .. + dep_len[row], in plan order
// from 0.  A row reads only rows of earlier levels, so the levels are the
// only order; between two levels every row of the first must be stored and
// visible.  Two forms, chosen by the host from the plan's widest level:
//   one block (widest <= kBlockMax rows): one thread a row of the level,
//     levels separated by __syncthreads(); y is read with plain loads (rows
//     of the same launch wrote it, and the block's barrier orders them);
//   a cooperative grid (wider): as many resident blocks as cover the widest
//     level, rows walked grid-stride, levels separated by grid.sync(); y is
//     read through L2 (__ldcg), since another SM wrote it and this SM's L1
//     may hold a line of y from an earlier level.
// The static part of a row (its index, dependency range, b, diag and the
// first kPre columns and values) does not depend on y, so a thread loads the
// next level's row before the barrier and after it only the y it sums waits
// on the previous level's stores.
//
// tri_sweeps, `sweeps` Jacobi sweeps in one cooperative launch: y0 = b / diag,
// then each sweep y_new[row] = (b[row] - s) / diag[row], s summed as above
// over y_old; two buffers, swapped after each grid.sync() (the output and a
// scratch vector, chosen so that the last sweep writes the output).  A
// thread keeps its first row's static part in registers over all sweeps.
//
// Arithmetic: __dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn (the float32
// ones for float32), so nothing is contracted into an FMA and the division is
// IEEE: the operations and their order are those of the plain version
// (index_add_ of the products into zeros, then (b - sums) / diag), which on
// the CPU adds a row's products in plan order.  Float32 multiplies and adds
// in float32, as the plain version does after casting the values.
//
// What bounds it on an H100: neither bytes nor operations.  The exact solve
// must read the factor once (a few MB: ~3 us at 3.35 TB/s for 512^2 aniso),
// but its levels form a chain: each level waits for the previous one's
// stores, so the time is at least levels x (one dependent load and store
// through the memory system + a barrier).  The design keeps that chain to
// the y load after each barrier; the sweeps pay one grid barrier a sweep.
// A synchronisation-free design (per-row ready flags, no barrier) is left
// for later.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kBlockMax = 1024;  // the one-block form's threads: the widest level it takes
constexpr int kThreads = 256;    // the cooperative kernels' block
constexpr int kPre = 4;          // dependencies of a row loaded ahead with its row
constexpr int kMaxDevices = 64;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// The factor: per-row dependency ranges into the level-sorted triplets.
template <typename T>
struct Factor {
  const int64_t* __restrict__ dep_start;
  const int64_t* __restrict__ dep_len;
  const int64_t* __restrict__ cols;
  const T* __restrict__ vals;
  const T* __restrict__ diag;
  const T* __restrict__ b;
};

// The static part of one row: what does not depend on y.
template <typename T>
struct Row {
  int64_t row, start, len;
  T b, d;
  int64_t col[kPre];
  T val[kPre];
};

template <typename T>
__device__ __forceinline__ void load_row(Row<T>& r, int64_t row, const Factor<T>& f) {
  r.row = row;
  r.start = f.dep_start[row];
  r.len = f.dep_len[row];
  r.b = f.b[row];
  r.d = f.diag[row];
#pragma unroll
  for (int q = 0; q < kPre; ++q)
    if (q < r.len) {
      r.col[q] = f.cols[r.start + q];
      r.val[q] = f.vals[r.start + q];
    }
}

// y of the current iterate: a plain load (the one-block form) or through L2.
template <bool kL2, typename T>
__device__ __forceinline__ T ld_y(const T* y, int64_t i) {
  if (kL2) return __ldcg(y + i);
  return y[i];
}

// (b - s) / diag for one row, s its products in plan order from 0, over yin.
template <bool kL2, typename T>
__device__ __forceinline__ T solve_row(const Row<T>& r, const Factor<T>& f, const T* yin) {
  T s = T(0);
#pragma unroll
  for (int q = 0; q < kPre; ++q)
    if (q < r.len) s = add_rn(s, mul_rn(r.val[q], ld_y<kL2>(yin, r.col[q])));
  // unrolled so that the loads of several products issue before their adds
  // (the adds keep plan order: only the loads move)
#pragma unroll 8
  for (int64_t k = r.start + kPre; k < r.start + r.len; ++k)
    s = add_rn(s, mul_rn(f.vals[k], ld_y<kL2>(yin, f.cols[k])));
  return div_rn(sub_rn(r.b, s), r.d);
}

// The level walk of tri_levels for thread t of `stride` (the block's or the
// grid's); Sync is the barrier between two levels.
template <bool kL2, typename T, typename Sync>
__device__ __forceinline__ void walk_levels(int64_t t, int64_t stride, int64_t num_levels,
                                            const int64_t* __restrict__ level_ptr,
                                            const int64_t* __restrict__ rows, const Factor<T>& f,
                                            T* y, Sync sync) {
  int64_t beg = level_ptr[0], end = level_ptr[1];
  Row<T> r;
  bool have = beg + t < end;
  if (have) load_row(r, rows[beg + t], f);
  for (int64_t lvl = 0; lvl < num_levels; ++lvl) {
    if (have) y[r.row] = solve_row<kL2>(r, f, y);
    for (int64_t i = beg + t + stride; i < end; i += stride) {
      Row<T> w;
      load_row(w, rows[i], f);
      y[w.row] = solve_row<kL2>(w, f, y);
    }
    if (lvl + 1 == num_levels) break;
    beg = end;
    end = level_ptr[lvl + 2];
    have = beg + t < end;
    if (have) load_row(r, rows[beg + t], f);  // ahead of the barrier: static
    sync();
  }
}

// The barriers between two levels.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct GridSync {
  __device__ __forceinline__ void operator()() const { cg::this_grid().sync(); }
};

template <typename T>
__global__ void __launch_bounds__(kBlockMax)
levels_block_kernel(int64_t num_levels, const int64_t* __restrict__ level_ptr,
                    const int64_t* __restrict__ rows, Factor<T> f, T* y) {
  walk_levels<false>(threadIdx.x, blockDim.x, num_levels, level_ptr, rows, f, y, BlockSync{});
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
levels_grid_kernel(int64_t num_levels, const int64_t* __restrict__ level_ptr,
                   const int64_t* __restrict__ rows, Factor<T> f, T* y) {
  walk_levels<true>(int64_t(blockIdx.x) * kThreads + threadIdx.x, int64_t(gridDim.x) * kThreads,
                    num_levels, level_ptr, rows, f, y, GridSync{});
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweeps_kernel(int64_t m, int64_t sweeps, Factor<T> f, T* out, T* scratch) {
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  // the iterate after s sweeps lives in out where sweeps - s is even
  T* cur = (sweeps & 1) ? scratch : out;
  Row<T> r;
  const bool have = t < m;
  if (have) load_row(r, t, f);
  for (int64_t i = t; i < m; i += stride) cur[i] = div_rn(f.b[i], f.diag[i]);
  for (int64_t s = 0; s < sweeps; ++s) {
    cg::this_grid().sync();
    T* nxt = cur == out ? scratch : out;
    if (have) nxt[t] = solve_row<true>(r, f, cur);
    for (int64_t i = t + stride; i < m; i += stride) {
      Row<T> w;
      load_row(w, i, f);
      nxt[i] = solve_row<true>(w, f, cur);
    }
    cur = nxt;
  }
}

// The card's SMs and the most blocks of one kernel resident on each; sms -1
// where the device cannot launch cooperatively.
struct Residency {
  int sms, per_sm;
};

// One cooperative launch (every block resident at once) of `kernel` with
// `need` blocks, at most the resident ones.  `cache` is the kernel's own:
// filled at a device's first call, so that later calls (inside a stream
// capture too) make no query.
template <typename... Params, typename... Args>
int launch_coop(void (*kernel)(Params...), Residency* cache, int64_t need, cudaStream_t st,
                Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (cache[dev].sms == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
            cudaSuccess)
      return int(err);
    cache[dev] = (!coop || sms < 1 || per_sm < 1) ? Residency{-1, 0} : Residency{sms, per_sm};
  }
  if (cache[dev].sms < 0) return int(cudaErrorCooperativeLaunchTooLarge);
  const int64_t most = int64_t(cache[dev].sms) * cache[dev].per_sm;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(need < 1 ? 1 : (need < most ? need : most)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T>
Factor<T> factor_of(const void* dep_start, const void* dep_len, const void* cols,
                    const void* vals, const void* diag, const void* b) {
  return Factor<T>{static_cast<const int64_t*>(dep_start), static_cast<const int64_t*>(dep_len),
                   static_cast<const int64_t*>(cols), static_cast<const T*>(vals),
                   static_cast<const T*>(diag), static_cast<const T*>(b)};
}

template <typename T>
int launch_levels(int grid, int64_t widest, int64_t num_levels, const void* level_ptr,
                  const void* rows, Factor<T> f, void* y, cudaStream_t st) {
  const int64_t* lp = static_cast<const int64_t*>(level_ptr);
  const int64_t* rw = static_cast<const int64_t*>(rows);
  T* out = static_cast<T*>(y);
  if (!grid) {
    const int threads = int((widest + 31) / 32 * 32);
    levels_block_kernel<T><<<1, threads, 0, st>>>(num_levels, lp, rw, f, out);
    return int(cudaGetLastError());
  }
  static Residency cache[kMaxDevices];
  return launch_coop(levels_grid_kernel<T>, cache, (widest + kThreads - 1) / kThreads, st,
                     num_levels, lp, rw, f, out);
}

template <typename T>
int launch_sweeps(int64_t m, int64_t sweeps, Factor<T> f, void* y, void* scratch,
                  cudaStream_t st) {
  static Residency cache[kMaxDevices];
  return launch_coop(sweeps_kernel<T>, cache, (m + kThreads - 1) / kThreads, st, m, sweeps, f,
                     static_cast<T*>(y), static_cast<T*>(scratch));
}

}  // namespace

// Both entries launch one kernel on `stream` and do not synchronise; float64
// (is_f64 != 0) or float32 values, diag, b and y, int64 indices.  Returns the
// launch's error, else cudaGetLastError() after it (0 on success), or
// cudaErrorInvalidValue for a bad size or form (and the cooperative launches
// cudaErrorCooperativeLaunchTooLarge where the device cannot launch
// cooperatively).

// y = T^{-1} b exactly over the level schedule: num_levels levels,
// level_ptr[num_levels + 1] into rows (the rows by level), `widest` the most
// rows of a level.  form 0: one block (widest <= 1024), 1: a cooperative grid.
extern "C" int tri_levels(int is_f64, int form, int64_t widest, int64_t num_levels,
                          const void* level_ptr, const void* rows, const void* dep_start,
                          const void* dep_len, const void* cols, const void* vals,
                          const void* diag, const void* b, void* y, void* stream) {
  if (num_levels <= 0 || widest <= 0 || (form != 0 && form != 1) ||
      (form == 0 && widest > kBlockMax))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_levels<double>(form, widest, num_levels, level_ptr, rows,
                                        factor_of<double>(dep_start, dep_len, cols, vals, diag, b),
                                        y, st)
                : launch_levels<float>(form, widest, num_levels, level_ptr, rows,
                                       factor_of<float>(dep_start, dep_len, cols, vals, diag, b),
                                       y, st);
}

// `sweeps` Jacobi sweeps y <- (b - N y) / diag from y = b / diag over m rows,
// the iterates alternating between y and scratch (m elements; the result in y).
extern "C" int tri_sweeps(int is_f64, int64_t m, int64_t sweeps, const void* dep_start,
                          const void* dep_len, const void* cols, const void* vals,
                          const void* diag, const void* b, void* y, void* scratch,
                          void* stream) {
  if (m <= 0 || sweeps < 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_sweeps<double>(m, sweeps,
                                        factor_of<double>(dep_start, dep_len, cols, vals, diag, b),
                                        y, scratch, st)
                : launch_sweeps<float>(m, sweeps,
                                       factor_of<float>(dep_start, dep_len, cols, vals, diag, b),
                                       y, scratch, st);
}
