// The Hopper swell kernel: Y = A @ X over the swell slab layout, for float64 and
// float32 values, aligned r x r micro-blocks (BSR, r = 1..4) and k right-hand
// sides (X is row-major (n, k); k = 1 is SpMV).
//
// Replaces the TPU swell kernel family of the JAX package, spmv_acc_tpu/ops/swell.py,
// at every (dtype, r, k) it runs:
//   K-a _make_f64_kernel    (one grid step of a depth-D bucket, two-f32 Dekker/2Sum)
//   K-b _make_fused_kernel  (K-a with G steps per grid iteration)
//   K-c _make_fused3_kernel (K-b as a 3-stage software pipeline)
//   K-e _make_native_steps_kernel (the CPU executor of K-a's per-step products;
//       on the card, this kernel computes them)
//   K-f _make_f32_kernel    (K-a in float32)
// The default form reads X in its own dtype.  The plane form (P = true, r = k =
// 1, entry swell_spmv_planes) reads x~ from the bf16 chunk planes of K-d's
// counterpart (csrc/plane_split.cu), the JAX package's on-chip numerics: for a
// node column c it reads entry q = c + delta of every plane and forms
// x~ = (p0 + p1 + p2)_hi + (p0 + p1 + p2)_lo in FP64 (each three-plane sum is
// exact in float32); everything else is the same, so in float32, where
// x~ == x, it returns the default form's result bit for bit.
// All five compute the same function: for every 128-node-row block, the sum over
// its slabs of (r x r cell block) @ (r rows of X).  On the TPU that needed x
// tables, one-hot matmuls and f64 emulated as two f32; here each thread reads X
// directly and accumulates in native FP64.
//
// What bounds it on an H100: device-memory bytes once the work fills the card.
// Every padded slot is read once (r*r values of 8 or 4 B plus a 1 B in-window
// index), plus X gathers (mostly L2 hits: a slab's columns lie inside one
// 256-column window) and the output rows; there are 2*r*r*k flops per slot.
// What the design does about it: values stay in the source dtype (no hi/lo
// planes), column indices are uint8 offsets into the slab's window, and a
// 128-slot row of a slab stores its r*r cells as r*r lane-contiguous planes,
// [(row0 * r*r + cell) * 128 + lane], so the 32 lanes of a warp read 32
// contiguous values for every cell.  One index byte and one X row gather serve
// r*r values and G columns.  Each thread issues the index loads of U slot rows
// before their gathers, so U gathers are in flight at once.
//
// Work split: a row-block's slot rows are a dependent walk, so one long
// row-block (Ga41As41H72-SPD: 9,742 slot rows against a mean of 55) or a few
// deep ones (TSOPF_RS_b2383: 298 of ~541 for 132 SMs) would set the time.  A
// host-built schedule (ops/swell_plan.py, build_swell_schedule) cuts each
// row-block into chunks of at most SWELL_CHUNK_ROWS slot rows, possibly inside
// a slab; blockIdx.x is a chunk, one thread per node row, blockIdx.y a group
// of G columns.  Each thread walks its chunk's slot rows in layout order and
// accumulates r*G sums in FP64 registers, also for float32 input: the product
// of two floats is exact in FP64.  A row-block's only chunk walks its slabs
// whole, with no per-row bookkeeping (boneS10's row-blocks hold ~18 slabs of
// ~2.5 slot rows; tracking rows across them made its float32 launch 21 %
// slower on an H100), and stores T(sum) to y, as an unsplit walk would.  A
// chunk of a split row-block walks from one slot row to another, possibly
// inside slabs, moving to the next slab where one ends, and stores its FP64
// sums as partials, lane-contiguous; a second pass, one block per split
// row-block and column group, adds them in chunk order and stores T(sum).  So
// the only rounding of the f32 path is the final store, no float atomics are
// used, and the result is the same from run to run.  Padded slots hold value 0
// and their X rows are masked to [0, n), so they never read out of range.  All
// index arithmetic is int64.
//
// The sweep store (entry swell_sweep; one column, any r, the default form):
// a Jacobi sweep of the ILU(0) preconditioner (ops/trisolve.py,
// sweep_apply_swell) is y = c - N v (the unit-lower factor) or
// y = (c - N v) * d (the upper one, d = 1 / diag), where N v is this kernel's
// product.  Stored as separate ops, each sweep was a swell launch, then a
// subtract and often a multiply, each a full pass over the vectors.  The
// sweep kernels walk exactly as swell_kernel and fixup_kernel do (walk_chunk,
// fixup_rows, each with a store policy) and store c[row] - T(sum), times
// d[row], where those store T(sum); c and d are loaded before the walk.  The
// subtract and multiply are __dsub_rn / __dmul_rn (__fsub_rn / __fmul_rn):
// each rounds once, as PyTorch's elementwise ops do, and the compiler may not
// contract them into an FMA, which would round once for both; so a sweep's y
// is, bit for bit, what the product and the two separate ops give.  The
// sweep is its own kernel pair and C entry, not a template flag of
// swell_kernel: the instantiations that swell_spmm and swell_spmv_planes
// launch keep their template arguments and names, and their store policy
// (RowsStore) compiles to the store they had.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

// The chunk schedule as ChunkSchedule.packed() (ops/swell_plan.py) lays it out
// in one int64 array: ptr (nchunks + 1) | rb | part | split_ptr (nsplit + 1) |
// split_rb | slab (nchunks + 1).  Chunk c walks slot rows [ptr[c], ptr[c+1])
// of row-block rb[c] from slab slab[c]; part[c] is -1 for a row-block's only
// chunk, else its partial slot; a row-block's only chunk walks exactly the
// slabs slab[c] .. slab[c+1] - 1 (slab[nchunks] is the slab count).
struct Sched {
  const int64_t *ptr, *rb, *part, *split_ptr, *split_rb, *slab;
};

Sched unpack(const void* packed, int64_t nchunks, int64_t nsplit) {
  Sched s;
  s.ptr = static_cast<const int64_t*>(packed);
  s.rb = s.ptr + nchunks + 1;
  s.part = s.rb + nchunks;
  s.split_ptr = s.part + nchunks;
  s.split_rb = s.split_ptr + nsplit + 1;
  s.slab = s.split_rb + nsplit;
  return s;
}

__device__ __forceinline__ float bf16_value(uint16_t b) {
  return __uint_as_float(uint32_t(b) << 16);
}

// x~ at padded entry q of the bf16 planes: one f32 set (float32) or hi and lo
// (float64), three planes each, at [(q >> 7) * 3 * sets * 128 + plane * 128 + (q & 127)]
template <typename T>
__device__ __forceinline__ double plane_x(const uint16_t* __restrict__ planes, int64_t q) {
  constexpr int kSets = sizeof(T) == 8 ? 2 : 1;
  const uint16_t* p = planes + (q >> 7) * (3 * kSets * kLanes) + (q & (kLanes - 1));
  const float hi = __fadd_rn(__fadd_rn(bf16_value(__ldg(p)), bf16_value(__ldg(p + kLanes))),
                             bf16_value(__ldg(p + 2 * kLanes)));
  if constexpr (kSets == 1) {
    return double(hi);
  } else {
    const float lo = __fadd_rn(__fadd_rn(bf16_value(__ldg(p + 3 * kLanes)),
                                         bf16_value(__ldg(p + 4 * kLanes))),
                               bf16_value(__ldg(p + 5 * kLanes)));
    return double(hi) + double(lo);
  }
}

// T(acc) into rows node*R + i (< m), columns c0 + j of the gn live ones
template <typename T, int R, int G>
__device__ __forceinline__ void store_rows(T* __restrict__ y, const double (&acc)[R][G],
                                           int64_t node, int64_t m, int64_t ks, int64_t c0,
                                           int gn) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = node * R + i;
    if (row < m) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j == 0 || j < gn) y[row * ks + c0 + j] = T(acc[i][j]);
    }
  }
}

// Adds slot rows t0 <= t < te of the slab at `off` (relative to its first
// slot row; in-window columns from col_base) into acc, in layout order
template <typename T, int R, int G, bool P>
__device__ __forceinline__ void walk_slab(double (&acc)[R][G], const T* __restrict__ vals,
                                          const uint8_t* __restrict__ lidx, int64_t off,
                                          int64_t col_base, int64_t t0, int64_t te, int lane,
                                          const T* __restrict__ x,
                                          const uint16_t* __restrict__ planes, int64_t delta,
                                          int64_t n, int64_t ks, int64_t c0, int gn) {
  // U slot rows per step, their U index loads issued before any x gather:
  // U = 4 while the body is small, 2 for R*G > 4 (faster for R*G = 8 on an
  // H100, boneS10 k = 8 and TSOPF_RS_b2383 r = 4 k = 8)
  constexpr int U = R * G <= 4 ? 4 : 2;
  for (int64_t t = t0; t < te; t += U) {
    int64_t node_col[U];  // -1 past the last slot row to walk
#pragma unroll
    for (int u = 0; u < U; ++u)
      node_col[u] = t + u < te ? col_base + lidx[off + (t + u) * kLanes + lane] : -1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // cell q of this slot at v[q * kLanes]
      const T* v = vals + (off + (t + u) * kLanes) * (R * R) + lane;
#pragma unroll
      for (int l = 0; l < R; ++l) {
        const int64_t xr = node_col[u] * R + l;
        if (node_col[u] >= 0 && xr < n) {
          double xv[G];
          if constexpr (P) {
            xv[0] = plane_x<T>(planes, node_col[u] + delta);
          } else {
            const T* xp = x + xr * ks + c0;
#pragma unroll
            for (int j = 0; j < G; ++j)  // gn >= 1: column 0 is always live
              xv[j] = (j == 0 || j < gn) ? double(__ldg(xp + j)) : 0.0;
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const double a = double(v[(i * R + l) * kLanes]);
#pragma unroll
            for (int j = 0; j < G; ++j) acc[i][j] += a * xv[j];
          }
        }
      }
    }
  }
}

// The store of the plain product: y[row] = T(sum) (store_rows)
template <typename T, int R, int G>
struct RowsStore {
  __device__ __forceinline__ void put(T* __restrict__ y, const double (&acc)[R][G], int64_t node,
                                      int64_t m, int64_t ks, int64_t c0, int gn) const {
    store_rows<T, R, G>(y, acc, node, m, ks, c0, gn);
  }
};

// The sweep store (one column): y[row] = c[row] - T(sum), times d[row] where
// d is given, each step rounded once as PyTorch's separate subtract and
// multiply round it; no contraction into an FMA.  The kernels load c and d
// (1 without d) at the thread's rows before the walk, so that their latency
// hides behind it.
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

template <typename T, int R>
struct SweepStore {
  const T* cv;
  const T* d;  // null: no scale
  T cr[R], dr[R];

  __device__ __forceinline__ void load(int64_t node, int64_t m) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = node * R + i;
      cr[i] = row < m ? cv[row] : T(0);
      dr[i] = row < m && d != nullptr ? d[row] : T(1);
    }
  }
  __device__ __forceinline__ void put(T* __restrict__ y, const double (&acc)[R][1], int64_t node,
                                      int64_t m, int64_t, int64_t, int) const {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = node * R + i;
      if (row < m) {
        const T v = sub_rn(cr[i], T(acc[i][0]));
        y[row] = d != nullptr ? mul_rn(v, dr[i]) : v;
      }
    }
  }
};

// One chunk's walk, blockIdx.x, over column group blockIdx.y: a row-block's
// only chunk stores its rows through `store`, a chunk of a split row-block
// its partials
template <typename T, int R, int G, bool P, class Store>
__device__ __forceinline__ void walk_chunk(Store& store,
                                           const T* __restrict__ vals,
                                           const uint8_t* __restrict__ lidx,
                                           const int64_t* __restrict__ slab_off,
                                           const int8_t* __restrict__ slab_log2d,
                                           const int32_t* __restrict__ slab_col_base,
                                           const Sched& sc,
                                           const T* __restrict__ x,
                                           const uint16_t* __restrict__ planes,
                                           int64_t delta,
                                           T* __restrict__ y,
                                           double* __restrict__ part,
                                           int64_t m, int64_t n, int64_t k) {
  // G == 1 only for k == 1 (the launcher enforces it), so the SpMV
  // instantiations index x and y with compile-time stride 1
  const int64_t ks = G == 1 ? 1 : k;
  const int64_t c = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t c0 = int64_t(blockIdx.y) * G;
  const int gn = ks - c0 < G ? int(ks - c0) : G;  // live columns of this group
  double acc[R][G];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[i][j] = 0.0;

  const int64_t p = sc.part[c];
  if (p < 0) {
    // a row-block's only chunk: every slot row of its slabs slab[c] ..
    // slab[c+1] - 1, with no per-row bookkeeping (most row-blocks hold many
    // shallow slabs: boneS10 ~18 of ~2.5 slot rows)
    const int64_t s1 = sc.slab[c + 1];
    for (int64_t s = sc.slab[c]; s < s1; ++s)
      walk_slab<T, R, G, P>(acc, vals, lidx, slab_off[s], slab_col_base[s], 0,
                            int64_t(1) << slab_log2d[s], lane, x, planes, delta, n, ks, c0, gn);
    store.put(y, acc, sc.rb[c] * kLanes + lane, m, ks, c0, gn);
    return;
  }
  // one chunk of a split row-block: slot rows ptr[c] .. ptr[c+1] - 1 from
  // slab slab[c] on, moving to the next slab where one ends
  const int64_t row_end = sc.ptr[c + 1];
  int64_t row = sc.ptr[c];  // the next slot row to walk
  for (int64_t s = sc.slab[c]; row < row_end; ++s) {
    const int64_t off = slab_off[s];
    const int64_t srow = off / kLanes;  // the slab's first slot row
    const int64_t slab_end = srow + (int64_t(1) << slab_log2d[s]);
    const int64_t te = (slab_end < row_end ? slab_end : row_end) - srow;
    walk_slab<T, R, G, P>(acc, vals, lidx, off, slab_col_base[s], row - srow, te, lane, x,
                          planes, delta, n, ks, c0, gn);
    row = srow + te;
  }
  // partial slot p holds R * ks * 128 doubles, [(i * ks + column) * 128 + lane]
  double* dst = part + p * (R * ks * kLanes) + lane;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j == 0 || j < gn) dst[(i * ks + c0 + j) * kLanes] = acc[i][j];
}

template <typename T, int R, int G, bool P>
__global__ void __launch_bounds__(kLanes)
swell_kernel(const T* __restrict__ vals,
             const uint8_t* __restrict__ lidx,
             const int64_t* __restrict__ slab_off,
             const int8_t* __restrict__ slab_log2d,
             const int32_t* __restrict__ slab_col_base,
             Sched sc,
             const T* __restrict__ x,
             const uint16_t* __restrict__ planes,
             int64_t delta,
             T* __restrict__ y,
             double* __restrict__ part,
             int64_t m, int64_t n, int64_t k) {
  static_assert(!P || (R == 1 && G == 1), "the plane form runs r = k = 1");
  RowsStore<T, R, G> store;
  walk_chunk<T, R, G, P>(store, vals, lidx, slab_off, slab_log2d, slab_col_base, sc, x, planes,
                         delta, y, part, m, n, k);
}

// The fix-up of split row-block blockIdx.x, column group blockIdx.y: each
// thread adds its node row's partials in chunk order, in FP64, and stores
// them through `store`
template <typename T, int R, int G, class Store>
__device__ __forceinline__ void fixup_rows(Store& store, const double* __restrict__ part,
                                           const Sched& sc, T* __restrict__ y, int64_t m,
                                           int64_t k) {
  const int64_t ks = G == 1 ? 1 : k;
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t c0 = int64_t(blockIdx.y) * G;
  const int gn = ks - c0 < G ? int(ks - c0) : G;
  double acc[R][G];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[i][j] = 0.0;
  const int64_t p1 = sc.split_ptr[b + 1];
  // unrolled so that the loads of several partials are in flight at once; the
  // adds stay in chunk order
#pragma unroll 8
  for (int64_t p = sc.split_ptr[b]; p < p1; ++p) {
    const double* src = part + p * (R * ks * kLanes) + lane;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j == 0 || j < gn) acc[i][j] += src[(i * ks + c0 + j) * kLanes];
  }
  store.put(y, acc, sc.split_rb[b] * kLanes + lane, m, ks, c0, gn);
}

// The fix-up pass of the plain product
template <typename T, int R, int G>
__global__ void __launch_bounds__(kLanes)
fixup_kernel(const double* __restrict__ part, Sched sc, T* __restrict__ y, int64_t m,
             int64_t k) {
  RowsStore<T, R, G> store;
  fixup_rows<T, R, G>(store, part, sc, y, m, k);
}

// swell_kernel's walk for one column (G = 1, the default form) with the sweep
// store; c and d are loaded by a row-block's only chunk (a split row-block's
// rows are stored by the fix-up)
template <typename T, int R>
__global__ void __launch_bounds__(kLanes)
sweep_kernel(const T* __restrict__ vals,
             const uint8_t* __restrict__ lidx,
             const int64_t* __restrict__ slab_off,
             const int8_t* __restrict__ slab_log2d,
             const int32_t* __restrict__ slab_col_base,
             Sched sc,
             const T* __restrict__ x,
             const T* __restrict__ cv,
             const T* __restrict__ d,
             T* __restrict__ y,
             double* __restrict__ part,
             int64_t m, int64_t n) {
  SweepStore<T, R> store{cv, d};
  if (sc.part[blockIdx.x] < 0) store.load(sc.rb[blockIdx.x] * kLanes + threadIdx.x, m);
  walk_chunk<T, R, 1, false>(store, vals, lidx, slab_off, slab_log2d, slab_col_base, sc, x,
                             nullptr, 0, y, part, m, n, 1);
}

// fixup_kernel with the sweep store
template <typename T, int R>
__global__ void __launch_bounds__(kLanes)
sweep_fixup_kernel(const double* __restrict__ part, Sched sc, const T* __restrict__ cv,
                   const T* __restrict__ d, T* __restrict__ y, int64_t m) {
  SweepStore<T, R> store{cv, d};
  store.load(sc.split_rb[blockIdx.x] * kLanes + threadIdx.x, m);
  fixup_rows<T, R, 1>(store, part, sc, y, m, 1);
}

struct Args {
  const void *vals, *lidx, *slab_off, *slab_log2d, *slab_col_base, *sched, *x, *planes;
  int64_t nchunks, nsplit, delta;
  void *y, *part;
  int64_t m, n, k;
  cudaStream_t stream;
};

// Both passes on the stream: the chunks, then (when a row-block is split) the fix-up.
template <typename T, int R, int G, bool P = false>
int launch(const Args& a) {
  const int64_t groups = (a.k + G - 1) / G;
  if (groups > 65535 || (G == 1 && a.k != 1)) return int(cudaErrorInvalidValue);
  const Sched sc = unpack(a.sched, a.nchunks, a.nsplit);
  swell_kernel<T, R, G, P><<<dim3(unsigned(a.nchunks), unsigned(groups)), dim3(kLanes), 0,
                             a.stream>>>(
      static_cast<const T*>(a.vals), static_cast<const uint8_t*>(a.lidx),
      static_cast<const int64_t*>(a.slab_off), static_cast<const int8_t*>(a.slab_log2d),
      static_cast<const int32_t*>(a.slab_col_base), sc, static_cast<const T*>(a.x),
      static_cast<const uint16_t*>(a.planes), a.delta, static_cast<T*>(a.y),
      static_cast<double*>(a.part), a.m, a.n, a.k);
  const int rc = int(cudaGetLastError());
  if (rc != 0 || a.nsplit == 0) return rc;
  fixup_kernel<T, R, G><<<dim3(unsigned(a.nsplit), unsigned(groups)), dim3(kLanes), 0,
                          a.stream>>>(static_cast<const double*>(a.part), sc,
                                      static_cast<T*>(a.y), a.m, a.k);
  return int(cudaGetLastError());
}

// The (R, G) pairs the column grouping can reach: G is a power of two no larger
// than max(1, 8 / R), the JAX package's group size (ops/spmm.py:52).
template <typename T>
int dispatch(int r, int g, const Args& a) {
  switch (r * 16 + g) {
    case 16 + 1: return launch<T, 1, 1>(a);
    case 16 + 2: return launch<T, 1, 2>(a);
    case 16 + 4: return launch<T, 1, 4>(a);
    case 16 + 8: return launch<T, 1, 8>(a);
    case 32 + 1: return launch<T, 2, 1>(a);
    case 32 + 2: return launch<T, 2, 2>(a);
    case 32 + 4: return launch<T, 2, 4>(a);
    case 48 + 1: return launch<T, 3, 1>(a);
    case 48 + 2: return launch<T, 3, 2>(a);
    case 64 + 1: return launch<T, 4, 1>(a);
    case 64 + 2: return launch<T, 4, 2>(a);
    default: return int(cudaErrorInvalidValue);
  }
}

// Both passes of the sweep on the stream: the chunks, then (when a row-block
// is split) the fix-up, each with the sweep store.
template <typename T, int R>
int launch_sweep(const Args& a, const void* c, const void* d) {
  const Sched sc = unpack(a.sched, a.nchunks, a.nsplit);
  const T* cv = static_cast<const T*>(c);
  const T* dv = static_cast<const T*>(d);
  T* y = static_cast<T*>(a.y);
  sweep_kernel<T, R><<<dim3(unsigned(a.nchunks)), dim3(kLanes), 0, a.stream>>>(
      static_cast<const T*>(a.vals), static_cast<const uint8_t*>(a.lidx),
      static_cast<const int64_t*>(a.slab_off), static_cast<const int8_t*>(a.slab_log2d),
      static_cast<const int32_t*>(a.slab_col_base), sc, static_cast<const T*>(a.x), cv, dv, y,
      static_cast<double*>(a.part), a.m, a.n);
  const int rc = int(cudaGetLastError());
  if (rc != 0 || a.nsplit == 0) return rc;
  sweep_fixup_kernel<T, R><<<dim3(unsigned(a.nsplit)), dim3(kLanes), 0, a.stream>>>(
      static_cast<const double*>(a.part), sc, cv, dv, y, a.m);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_sweep(int r, const Args& a, const void* c, const void* d) {
  switch (r) {
    case 1: return launch_sweep<T, 1>(a, c, d);
    case 2: return launch_sweep<T, 2>(a, c, d);
    case 3: return launch_sweep<T, 3>(a, c, d);
    case 4: return launch_sweep<T, 4>(a, c, d);
    default: return int(cudaErrorInvalidValue);
  }
}

bool bad_grid(int64_t nchunks, int64_t nsplit, const void* part) {
  return nchunks <= 0 || nchunks > 0x7fffffff || nsplit < 0 || nsplit > 0x7fffffff ||
         (nsplit > 0 && part == nullptr);
}

}  // namespace

// Launches the swell kernel and, when the schedule splits a row-block, its
// fix-up pass on `stream`: y (m, k) = A @ x (n, k), both row-major, values in
// float64 (is_f64 != 0) or float32, micro-block size r, column group g, over
// the `nchunks` chunks of the packed schedule `sched` (`nsplit` split
// row-blocks; `part` holds their partials, nparts * r * k * 128 doubles, and
// may be null when nsplit is 0).  Does not synchronise.  Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a (r, g) pair that is not instantiated or a grid
// that does not fit.
extern "C" int swell_spmm(int is_f64, int r, int g, const void* vals, const void* lidx,
                          const void* slab_off, const void* slab_log2d,
                          const void* slab_col_base, const void* sched, int64_t nchunks,
                          int64_t nsplit, void* part, const void* x, void* y, int64_t m,
                          int64_t n, int64_t k, void* stream) {
  if (bad_grid(nchunks, nsplit, part) || k <= 0) return int(cudaErrorInvalidValue);
  const Args a{vals, lidx, slab_off, slab_log2d, slab_col_base, sched, x, nullptr,
               nchunks, nsplit, 0, y, part, m, n, k, static_cast<cudaStream_t>(stream)};
  return is_f64 ? dispatch<double>(r, g, a) : dispatch<float>(r, g, a);
}

// Launches the plane form on `stream` (scalar plans, one column): y (m,) = A @ x~,
// x~ read from the bf16 chunk planes of csrc/plane_split.cu for an x of n
// entries front-padded by the plan's column shift delta; the schedule and
// partials as for swell_spmm.  Does not synchronise.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue.
extern "C" int swell_spmv_planes(int is_f64, const void* vals, const void* lidx,
                                 const void* slab_off, const void* slab_log2d,
                                 const void* slab_col_base, const void* sched,
                                 int64_t nchunks, int64_t nsplit, void* part,
                                 const void* planes, void* y, int64_t m, int64_t n,
                                 int64_t delta, void* stream) {
  if (bad_grid(nchunks, nsplit, part) || delta < 0) return int(cudaErrorInvalidValue);
  const Args a{vals, lidx, slab_off, slab_log2d, slab_col_base, sched, nullptr, planes,
               nchunks, nsplit, delta, y, part, m, n, 1, static_cast<cudaStream_t>(stream)};
  return is_f64 ? launch<double, 1, 1, true>(a) : launch<float, 1, 1, true>(a);
}

// Launches one Jacobi sweep's product on `stream` (one column, micro-block
// size r = 1..4): y (m,) = c - A @ x, or (c - A @ x) * d where d is not null,
// with c, d and y (m,) and x (n,) in the layout's dtype; the schedule and
// partials as for swell_spmm.  Each row's FP64 sum is rounded to the dtype,
// then subtracted from c and multiplied by d, each step rounded once: the
// bits of swell_spmm followed by the two separate elementwise ops.  A layout
// with a COO tail is not taken (its cells are added after the kernel).  Does
// not synchronise.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue.
extern "C" int swell_sweep(int is_f64, int r, const void* vals, const void* lidx,
                           const void* slab_off, const void* slab_log2d,
                           const void* slab_col_base, const void* sched, int64_t nchunks,
                           int64_t nsplit, void* part, const void* x, const void* c,
                           const void* d, void* y, int64_t m, int64_t n, void* stream) {
  if (bad_grid(nchunks, nsplit, part) || c == nullptr) return int(cudaErrorInvalidValue);
  const Args a{vals, lidx, slab_off, slab_log2d, slab_col_base, sched, x, nullptr,
               nchunks, nsplit, 0, y, part, m, n, 1, static_cast<cudaStream_t>(stream)};
  return is_f64 ? dispatch_sweep<double>(r, a, c, d) : dispatch_sweep<float>(r, a, c, d);
}
