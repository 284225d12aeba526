// F-3, the ILU(0) preconditioner's sparse triangular solves, one launch per
// factor solve, and F-4, the ILU(0) factor's numeric phase on the card, one
// launch a factor; no atomics: two launches on the same data give the same
// bits.
//
// Replaces XLA's loops of the JAX package's triangular solves, which have no
// Pallas kernel of their own: spmv_acc_tpu/ops/trisolve.py::trisolve (the
// chunk-scheduled fori_loop, :224-260, body :239-254) and ::trisolve_sweeps
// (the Jacobi sweeps' fori_loop, :263-283).  XLA compiles each loop into one
// device program; launched from the host the same exact solve is about eight
// small PyTorch launches per schedule step (2 x 1023 steps an ILU apply at
// 512^2 anisotropic diffusion).  Two entries of F-3 (spmv_acc_tpu_torch/ops/trisolve.py):
//
// tri_levels, the exact solve over the level schedule: every row computes
//   y[row] = (b[row] - s) / diag[row],  s = sum of vals[k] * y[cols[k]]
// over its dependencies k = dep_start[row] .. + dep_len[row], in plan order
// from 0.  A row waits only on its own dependencies, each through that row's
// ready flag, and never on the rest of their level: no barrier between
// levels.
//   the walk: threads take the positions of `rows` (the rows by level, as
//     the plan sorts them) grid-stride.  A thread first loads what does not
//     depend on y (the row, its range, b, diag, and its columns and values,
//     kChunk at a time), then polls all those columns' slots at once, again
//     until each has come, and sums their values in plan order.  It stores
//     y[row] and publishes the row's value in its slot.  No atomics.
//   the slots: a row's slot holds its value's bits beside the epoch of the
//     launch that wrote them, in 64-bit words (the epoch in the high half;
//     float64 takes two words), each stored and loaded whole by one relaxed
//     access.  The epoch is the row's ready flag: a word that carries this
//     launch's epoch holds this launch's bits, so the value comes with the
//     poll that finds it ready, and neither side needs a fence.
//   the lanes of a warp poll in step (__any_sync over the warp): a lane
//     whose inputs have all come finishes its row while the others poll
//     again.  A lane spinning on its own would hold the warp from the lane
//     it waits on for as long as the scheduler lets it.
//   why it cannot deadlock: every dependency of the row at position p has a
//     lower level, so it lies at a position < p.  The unfinished row at the
//     lowest position has every input published; its warp holds no earlier
//     unfinished row, so it is polling for that row and finishes it.  Every
//     thread of the launch is resident (one block, or a cooperative launch).
//   the epoch: the plan keeps the slots and one epoch word, zeroed once when
//     its first solve needs them.  Every thread reads the epoch e at its
//     start and publishes with e + 1; after one last barrier one thread
//     writes e + 1.  So a solve needs no reset pass and no host read, and a
//     captured graph's replays, which pass the same arguments, each take the
//     next epoch.  Two launches on one plan must not overlap: both would
//     publish with the same epoch (the host orders a plan's solves, see
//     ops/trisolve.py).
// Two scopes, chosen by the host from the rows in flight that the plan's
// shape asks for (ops/trisolve.py _walk_shape, from the crossover measured on
// an H100):
//   one block of up to kThreads threads, at CTA scope: the plan's slots
//     through the SM's L1; the last barrier __syncthreads();
//   a cooperative grid of kThreads-thread blocks, at most the resident ones,
//     at GPU scope: the plan's slots, through L2; the last barrier
//     grid.sync().
// Either is sized by the rows the host wants in flight: a thread takes its
// next row when its warp has finished the last, and threads past that only
// poll.
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
// F-4, ilu0_refactor, the numeric ILU(0) factor of new values on the pattern
// the handle was made from (ops/trisolve.py ILU0.refactor).  The JAX package
// factors on the host only (spmv_acc_tpu/ops/trisolve.py::ilu0_host), so F-4
// has no TPU counterpart; it computes ilu0_host's IKJ factor
// (native/spmv_native.cpp ilu0_factor) bit for bit: row i copies its values,
// then for each strict-lower entry q (column k) in ascending column order
//   l = lu[q] / lu[diag k],  lu[q] = l,
//   lu[t] -= l * lu[s] for each later entry t of row i whose column row k
//   holds after its diagonal, at s,
// with __ddiv_rn / __dmul_rn / __dsub_rn, nothing contracted.  The pairs
// (t, s) of each q are the symbolic factor, listed once at a handle's first
// refactor (ops/trisolve.py _ikj_updates, torch ops on the card).
//   the walk: a warp a row, the rows in the L-solve's level order taken
//     warp-stride; the row's entries in global memory, its updates of one q
//     spread over the lanes (each t at most once a q, so no two lanes write
//     one entry; __syncwarp() between the q's).  A row waits on row k only
//     where its entry q needs it: the lanes poll the flags of 32 of the
//     row's lower entries at once (a ballot), so a row's early columns are
//     done while its latest dependencies (the previous levels' rows) come,
//     and the steps whose rows came together run with no poll between
//     them.  A flag is one 32-bit word; a row's lanes fence their stores,
//     meet at __syncwarp(), and one stores the flag with release; a poll is
//     relaxed, and the poll that finds q's row ready is followed by an
//     acquire fence and __syncwarp(), after which row k's values are read
//     through L2 (__ldcg).  Every strict-lower column of a row lies at an
//     earlier position, so the unfinished row at the lowest position has its
//     inputs and its warp (which holds no other row) finishes it: no
//     deadlock.  The epoch works as tri_levels'.
//
// What bounds it on an H100: neither bytes nor operations.  The exact solve
// must read the factor once (a few MB: ~3 us at 3.35 TB/s for 512^2 aniso;
// ~283 MB, ~84 us, for HPCG's 104^3 D + L), but its levels form a chain: a
// row's value waits for its latest dependency's, so the time is at least
// levels x (the producer's slot store reaching L2 or L1, the poll that finds
// it, and the row's arithmetic).  The walk keeps every load that does not
// depend on y off that chain, and no barrier or fence on it.  The sweeps pay
// one grid barrier a sweep.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;    // a block of every kernel: the one-block walk's most threads
constexpr int kPre = 4;          // dependencies of a row the sweeps load with its row
constexpr int kChunk = 16;       // dependencies the walk loads, waits on and sums at once
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

// The static part of one row of a sweep: what does not depend on y.
template <typename T>
struct Row {
  int64_t start, len;
  T b, d;
  int64_t col[kPre];
  T val[kPre];
};

template <typename T>
__device__ __forceinline__ void load_row(Row<T>& r, int64_t row, const Factor<T>& f) {
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

// (b - s) / diag for one row of a sweep, s its products in plan order from 0,
// over the previous iterate yin, read through L2 (another SM wrote it, and
// this SM's L1 may hold an older line).
template <typename T>
__device__ __forceinline__ T solve_row(const Row<T>& r, const Factor<T>& f, const T* yin) {
  T s = T(0);
#pragma unroll
  for (int q = 0; q < kPre; ++q)
    if (q < r.len) s = add_rn(s, mul_rn(r.val[q], __ldcg(yin + r.col[q])));
  // unrolled so that the loads of several products issue before their adds
  // (the adds keep plan order: only the loads move)
#pragma unroll 8
  for (int64_t k = r.start + kPre; k < r.start + r.len; ++k)
    s = add_rn(s, mul_rn(f.vals[k], __ldcg(yin + f.cols[k])));
  return div_rn(sub_rn(r.b, s), r.d);
}

// The flag walk's loads and stores of the slots (below) at CTA scope: one
// block, whose threads meet in the SM's L1.
struct CtaScope {
  __device__ static __forceinline__ void load(const uint64_t* p, uint64_t& w) {
    asm volatile("ld.relaxed.cta.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  }
  __device__ static __forceinline__ void load(const uint64_t* p, uint64_t& w0, uint64_t& w1) {
    asm volatile("ld.relaxed.cta.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(w0), "=l"(w1) : "l"(p) : "memory");
  }
  __device__ static __forceinline__ void store(uint64_t* p, uint64_t w) {
    asm volatile("st.relaxed.cta.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
  }
  __device__ static __forceinline__ void store(uint64_t* p, uint64_t w0, uint64_t w1) {
    asm volatile("st.relaxed.cta.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(w0), "l"(w1)
                 : "memory");
  }
  __device__ static __forceinline__ void sync() { __syncthreads(); }
};

// ... and at GPU scope: a cooperative grid, whose blocks meet in L2.
struct GpuScope {
  __device__ static __forceinline__ void load(const uint64_t* p, uint64_t& w) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  }
  __device__ static __forceinline__ void load(const uint64_t* p, uint64_t& w0, uint64_t& w1) {
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(w0), "=l"(w1) : "l"(p) : "memory");
  }
  __device__ static __forceinline__ void store(uint64_t* p, uint64_t w) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
  }
  __device__ static __forceinline__ void store(uint64_t* p, uint64_t w0, uint64_t w1) {
    asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(w0), "l"(w1)
                 : "memory");
  }
  __device__ static __forceinline__ void sync() { cg::this_grid().sync(); }
};

// A row's slot: its value's bits beside the epoch that wrote them, in 64-bit
// words that one relaxed load reads whole, the epoch in the high 32 bits:
// one word a float32 row (slots[row]), two a float64 row (slots[2 row], the
// low and the high half).  A word that carries this launch's epoch holds
// this launch's bits, so neither side needs a fence.
__device__ __forceinline__ uint64_t tagged(unsigned bits, unsigned epoch) {
  return uint64_t(epoch) << 32 | bits;
}
__device__ __forceinline__ unsigned tag_of(uint64_t w) { return unsigned(w >> 32); }

template <typename Scope>
__device__ __forceinline__ void publish(uint64_t* slots, int64_t row, float v, unsigned e) {
  Scope::store(slots + row, tagged(__float_as_uint(v), e));
}
template <typename Scope>
__device__ __forceinline__ void publish(uint64_t* slots, int64_t row, double v, unsigned e) {
  const uint64_t bits = uint64_t(__double_as_longlong(v));
  Scope::store(slots + 2 * row, tagged(unsigned(bits), e), tagged(unsigned(bits >> 32), e));
}

// The raw words of one slot as a poll reads them.
template <typename T>
struct Words;
template <>
struct Words<float> {
  uint64_t w;
  template <typename Scope>
  __device__ __forceinline__ void load(const uint64_t* slots, int64_t row) {
    Scope::load(slots + row, w);
  }
  __device__ __forceinline__ bool ready(unsigned e) const { return tag_of(w) == e; }
  __device__ __forceinline__ float value() const { return __uint_as_float(unsigned(w)); }
};
template <>
struct Words<double> {
  uint64_t lo, hi;
  template <typename Scope>
  __device__ __forceinline__ void load(const uint64_t* slots, int64_t row) {
    Scope::load(slots + 2 * row, lo, hi);
  }
  __device__ __forceinline__ bool ready(unsigned e) const {
    return tag_of(lo) == e && tag_of(hi) == e;
  }
  __device__ __forceinline__ double value() const {
    return __hiloint2double(int(unsigned(hi)), int(unsigned(lo)));
  }
};

// The flag walk of tri_levels (header) for thread t of `stride` (a multiple
// of 32): the rows at positions t, t + stride, ... of `rows`, each published
// in its slot with epoch `want`.  The lanes of a warp poll in step: a lane
// whose inputs have all come finishes its row while the others poll again,
// so no lane spins on its own while a lane it waits on holds the warp.
template <typename Scope, typename T>
__device__ __forceinline__ void walk_flags(int64_t t, int64_t stride, int64_t m,
                                           const int64_t* __restrict__ rows, const Factor<T>& f,
                                           T* y, uint64_t* slots, unsigned want) {
  const int64_t lane = threadIdx.x & 31;
  for (int64_t p = t; p - lane < m; p += stride) {  // while the warp has a row
    bool done = p >= m;
    int64_t row = 0, k0 = 0, end = 0;
    T b = T(0), d = T(1), s = T(0);
    if (!done) {
      row = rows[p];
      k0 = f.dep_start[row];
      end = k0 + f.dep_len[row];
      b = f.b[row];
      d = f.diag[row];
    }
    // the chunk at k0: its columns and values, the inputs still to come
    int64_t col[kChunk];
    T val[kChunk];
    Words<T> in[kChunk];
    int n = 0;
    unsigned pending = 0;
    bool loaded = false;
    while (__any_sync(0xffffffffu, !done)) {
      if (done) continue;
      if (!loaded && k0 < end) {
        n = end - k0 < kChunk ? int(end - k0) : kChunk;
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          if (q < n) {
            col[q] = f.cols[k0 + q];
            val[q] = f.vals[k0 + q];
          }
        pending = (1u << n) - 1u;
        loaded = true;
      }
      // every input still to come polled at once
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        if (pending >> q & 1u) in[q].template load<Scope>(slots, col[q]);
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        if ((pending >> q & 1u) && in[q].ready(want)) pending &= ~(1u << q);
      if (pending) continue;
#pragma unroll
      for (int q = 0; q < kChunk; ++q)
        if (q < n) s = add_rn(s, mul_rn(val[q], in[q].value()));
      k0 += kChunk;
      n = 0;
      loaded = false;
      if (k0 < end) continue;
      const T v = div_rn(sub_rn(b, s), d);
      y[row] = v;
      publish<Scope>(slots, row, v, want);
      done = true;
    }
  }
}

// tri_levels' flag walk in either scope: one block (CtaScope) or a
// cooperative grid (GpuScope).
template <typename T, typename Scope>
__global__ void __launch_bounds__(kThreads)
levels_flags_kernel(int64_t m, const int64_t* __restrict__ rows, Factor<T> f, T* y,
                    uint64_t* slots, unsigned* epoch) {
  const unsigned want = *epoch + 1u;
  walk_flags<Scope>(int64_t(blockIdx.x) * blockDim.x + threadIdx.x,
                    int64_t(gridDim.x) * blockDim.x, m, rows, f, y, slots, want);
  Scope::sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *epoch = want;
}

__device__ __forceinline__ unsigned load_flag(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void publish_flag(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// F-4 (header): a warp a row, the rows at the positions of `rows` taken
// warp-stride on a cooperative grid; lu (the pattern's nnz) gets the factor
// of a.  Row i's strict-lower entry q makes the updates up[q] .. up[q + 1]
// of the lists (ut, us): lu[ut] -= l * lu[us], ut in row i, us in row k.
__global__ void __launch_bounds__(kThreads)
ilu0_factor_kernel(int64_t m, const int64_t* __restrict__ rows, const int* __restrict__ rp,
                   const int* __restrict__ ci, const int* __restrict__ dpos,
                   const int64_t* __restrict__ up, const int* __restrict__ ut,
                   const int* __restrict__ us, const double* __restrict__ a, double* lu,
                   unsigned* flags, unsigned* epoch) {
  const unsigned want = *epoch + 1u;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t p = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5; p < m; p += warps) {
    const int64_t row = rows[p];
    const int r0 = rp[row], dg = dpos[row], r1 = rp[row + 1];
    for (int t = r0 + lane; t < r1; t += 32) lu[t] = a[t];
    unsigned ready = 0;  // of the 32 strict-lower entries from `base`, those whose row is flagged
    int base = r0 - 32;
    for (int q = r0; q < dg; ++q) {
      const int k = ci[q], kd = dpos[k];
      const int64_t u0 = up[q], u1 = up[q + 1];
      int t0 = -1, s0 = 0;  // this lane's first update, loaded before the wait
      if (u0 + lane < u1) {
        t0 = ut[u0 + lane];
        s0 = us[u0 + lane];
      }
      if (q >= base + 32) {
        base = q;
        ready = 0;
      }
      if (!(ready >> (q - base) & 1u)) {  // poll the chunk's rows, each lane one, until q's
        const int e = base + lane;
        const int fk = e < dg ? ci[e] : -1;
        do {
          ready = __ballot_sync(0xffffffffu, fk < 0 || load_flag(flags + fk) == want);
        } while (!(ready >> (q - base) & 1u));
        fence_acq_rel();  // acquire what each lane saw; the barrier passes it to the warp
      }
      __syncwarp();
      const double l = div_rn(lu[q], __ldcg(lu + kd));
      if (t0 >= 0) lu[t0] = sub_rn(lu[t0], mul_rn(l, __ldcg(lu + s0)));
      for (int64_t u = u0 + 32 + lane; u < u1; u += 32)
        lu[ut[u]] = sub_rn(lu[ut[u]], mul_rn(l, __ldcg(lu + us[u])));
      __syncwarp();
      if (lane == 0) lu[q] = l;
    }
    fence_acq_rel();  // release the row's values, each lane its own stores
    __syncwarp();
    if (lane == 0) publish_flag(flags + row, want);
  }
  cg::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *epoch = want;
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
    if (have) nxt[t] = solve_row(r, f, cur);
    for (int64_t i = t + stride; i < m; i += stride) {
      Row<T> w;
      load_row(w, i, f);
      nxt[i] = solve_row(w, f, cur);
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
int launch_levels(int form, int64_t in_flight, int64_t m, const void* rows, Factor<T> f, void* y,
                  void* slots, void* epoch, cudaStream_t st) {
  const int64_t* rw = static_cast<const int64_t*>(rows);
  T* out = static_cast<T*>(y);
  uint64_t* sl = static_cast<uint64_t*>(slots);
  unsigned* ep = static_cast<unsigned*>(epoch);
  if (form == 0) {
    const int threads = int((in_flight + 31) / 32 * 32);
    levels_flags_kernel<T, CtaScope><<<1, threads, 0, st>>>(m, rw, f, out, sl, ep);
    return int(cudaGetLastError());
  }
  static Residency cache[kMaxDevices];
  return launch_coop(levels_flags_kernel<T, GpuScope>, cache,
                     (in_flight + kThreads - 1) / kThreads, st, m, rw, f, out, sl, ep);
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

// y = T^{-1} b exactly over m rows: `rows` the rows by level, `slots` (2 m
// 64-bit words, 16-B aligned) and `epoch` (one 32-bit word) the plan's,
// zeroed once and owned by this entry after.  form 0: one block of
// `in_flight` threads (at most 256); 1: a cooperative grid of blocks enough
// for `in_flight` threads, at most the resident ones.
extern "C" int tri_levels(int is_f64, int form, int64_t in_flight, int64_t m, const void* rows,
                          const void* dep_start, const void* dep_len, const void* cols,
                          const void* vals, const void* diag, const void* b, void* y,
                          void* slots, void* epoch, void* stream) {
  if (m <= 0 || in_flight <= 0 || form < 0 || form > 1 || (form == 0 && in_flight > kThreads))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_levels<double>(form, in_flight, m, rows,
                                        factor_of<double>(dep_start, dep_len, cols, vals, diag, b),
                                        y, slots, epoch, st)
                : launch_levels<float>(form, in_flight, m, rows,
                                       factor_of<float>(dep_start, dep_len, cols, vals, diag, b),
                                       y, slots, epoch, st);
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

// F-4: lu = the ILU(0) factor of a (float64, the pattern's nnz) over m rows
// of the CSR pattern row_ptr / col_idx (int32, sorted columns, a diagonal a
// row at diag_pos), the rows taken in the order of `rows` (int64: any order
// in which each row's strict-lower columns come earlier).  upd_ptr (nnz + 1,
// int64) and upd_t / upd_s (int32) are the IKJ updates of each entry (none
// but a strict-lower one's), upd_t ascending within one.  `flags` (m 32-bit
// words) and `epoch` (one) zeroed once and owned by this entry after.  A
// cooperative grid of blocks enough for `in_flight` warps, at most the
// resident ones.
extern "C" int ilu0_refactor(int64_t in_flight, int64_t m, const void* rows, const void* row_ptr,
                             const void* col_idx, const void* diag_pos, const void* upd_ptr,
                             const void* upd_t, const void* upd_s, const void* a, void* lu,
                             void* flags, void* epoch, void* stream) {
  if (m <= 0 || in_flight <= 0) return int(cudaErrorInvalidValue);
  static Residency cache[kMaxDevices];
  return launch_coop(ilu0_factor_kernel, cache, (32 * in_flight + kThreads - 1) / kThreads,
                     static_cast<cudaStream_t>(stream), m, static_cast<const int64_t*>(rows),
                     static_cast<const int*>(row_ptr), static_cast<const int*>(col_idx),
                     static_cast<const int*>(diag_pos), static_cast<const int64_t*>(upd_ptr),
                     static_cast<const int*>(upd_t), static_cast<const int*>(upd_s),
                     static_cast<const double*>(a), static_cast<double*>(lu),
                     static_cast<unsigned*>(flags), static_cast<unsigned*>(epoch));
}
