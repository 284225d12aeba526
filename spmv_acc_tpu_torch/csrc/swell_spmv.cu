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
// What bounds it on an H100: device-memory bytes where the row-blocks fill the
// card, and load latency where they do not.  Every padded slot is read once
// (r*r values of 8 or 4 B plus a 1 B in-window index), plus X gathers (mostly
// L2 hits: a slab's columns lie inside one 256-column window) and the output
// rows; there are 2*r*r*k flops per slot.  What the design does about it:
// values stay in the source dtype (no hi/lo planes), column indices are uint8
// offsets into the slab's window, and a 128-slot row of a slab stores its r*r
// cells as r*r lane-contiguous planes, [(row0 * r*r + cell) * 128 + lane], so
// the 32 lanes of a warp read 32 contiguous values for every cell.  One index
// byte and one X row gather serve r*r values and G columns.  Each thread issues
// the index loads of U slot rows before their gathers, so U gathers are in
// flight at once.  A matrix with few, long row-blocks (TSOPF_RS_b2383: 298 at
// r = 1, 75 at r = 4, for 132 SMs) stays latency-bound all the same.
//
// Simple form: one 128-thread block per row-block of node rows, one thread per
// node row, blockIdx.y picks a group of G columns.  Each thread walks its
// row-block's slabs and slots in layout order and accumulates r*G sums in FP64
// registers, also for float32 input: the product of two floats is exact in FP64,
// so the only rounding of the f32 path is the final store.  No atomics and no
// cross-block pass, so the result is the same from run to run.  Padded slots
// hold value 0 and their X rows are masked to [0, n), so they never read out of
// range.  All index arithmetic is int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

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

template <typename T, int R, int G, bool P>
__global__ void __launch_bounds__(kLanes)
swell_kernel(const T* __restrict__ vals,
             const uint8_t* __restrict__ lidx,
             const int64_t* __restrict__ slab_off,
             const int8_t* __restrict__ slab_log2d,
             const int32_t* __restrict__ slab_col_base,
             const int64_t* __restrict__ rb_slab_ptr,
             const T* __restrict__ x,
             const uint16_t* __restrict__ planes,
             int64_t delta,
             T* __restrict__ y,
             int64_t m, int64_t n, int64_t k) {
  static_assert(!P || (R == 1 && G == 1), "the plane form runs r = k = 1");
  // G == 1 only for k == 1 (the launcher enforces it), so the SpMV
  // instantiations index x and y with compile-time stride 1
  const int64_t ks = G == 1 ? 1 : k;
  const int64_t rb = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t c0 = int64_t(blockIdx.y) * G;
  const int gn = ks - c0 < G ? int(ks - c0) : G;  // live columns of this group
  double acc[R][G];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[i][j] = 0.0;

  const int64_t s0 = rb_slab_ptr[rb];
  const int64_t s1 = rb_slab_ptr[rb + 1];
  for (int64_t s = s0; s < s1; ++s) {
    const int64_t off = slab_off[s];
    const int64_t depth = int64_t(1) << slab_log2d[s];
    const int64_t col_base = slab_col_base[s];
    // U slot rows per step, their U index loads issued before any x gather:
    // U = 4 while the body is small, 2 for R*G > 4 (faster for R*G = 8 on an
    // H100, boneS10 k = 8 and TSOPF_RS_b2383 r = 4 k = 8)
    constexpr int U = R * G <= 4 ? 4 : 2;
    for (int64_t t = 0; t < depth; t += U) {
      int64_t node_col[U];  // -1 past the slab's depth (depth may be < U)
#pragma unroll
      for (int u = 0; u < U; ++u)
        node_col[u] = t + u < depth ? col_base + lidx[off + (t + u) * kLanes + lane] : -1;
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
  const int64_t node = rb * kLanes + lane;
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

struct Args {
  const void *vals, *lidx, *slab_off, *slab_log2d, *slab_col_base, *rb_slab_ptr, *x, *planes;
  int64_t delta;
  void* y;
  int64_t m, n, k, mrb;
  cudaStream_t stream;
};

template <typename T, int R, int G, bool P = false>
int launch(const Args& a) {
  const int64_t groups = (a.k + G - 1) / G;
  if (groups > 65535 || (G == 1 && a.k != 1)) return int(cudaErrorInvalidValue);
  swell_kernel<T, R, G, P><<<dim3(unsigned(a.mrb), unsigned(groups)), dim3(kLanes), 0,
                             a.stream>>>(
      static_cast<const T*>(a.vals), static_cast<const uint8_t*>(a.lidx),
      static_cast<const int64_t*>(a.slab_off), static_cast<const int8_t*>(a.slab_log2d),
      static_cast<const int32_t*>(a.slab_col_base), static_cast<const int64_t*>(a.rb_slab_ptr),
      static_cast<const T*>(a.x), static_cast<const uint16_t*>(a.planes), a.delta,
      static_cast<T*>(a.y), a.m, a.n, a.k);
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

}  // namespace

// Launches the swell kernel on `stream`: y (m, k) = A @ x (n, k), both row-major,
// values in float64 (is_f64 != 0) or float32, micro-block size r, column group g,
// over `mrb` row-blocks of 128 node rows.  Does not synchronise.  Returns
// cudaGetLastError() after the launch (0 on success), or cudaErrorInvalidValue
// for a (r, g) pair that is not instantiated or a grid that does not fit.
extern "C" int swell_spmm(int is_f64, int r, int g, const void* vals, const void* lidx,
                          const void* slab_off, const void* slab_log2d,
                          const void* slab_col_base, const void* rb_slab_ptr,
                          const void* x, void* y, int64_t m, int64_t n, int64_t k,
                          int64_t mrb, void* stream) {
  if (mrb <= 0 || mrb > 0x7fffffff || k <= 0) return int(cudaErrorInvalidValue);
  const Args a{vals, lidx, slab_off, slab_log2d, slab_col_base, rb_slab_ptr, x, nullptr, 0,
               y, m, n, k, mrb, static_cast<cudaStream_t>(stream)};
  return is_f64 ? dispatch<double>(r, g, a) : dispatch<float>(r, g, a);
}

// Launches the plane form on `stream` (scalar plans, one column): y (m,) = A @ x~,
// x~ read from the bf16 chunk planes of csrc/plane_split.cu for an x of n
// entries front-padded by the plan's column shift delta.  Does not synchronise.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int swell_spmv_planes(int is_f64, const void* vals, const void* lidx,
                                 const void* slab_off, const void* slab_log2d,
                                 const void* slab_col_base, const void* rb_slab_ptr,
                                 const void* planes, void* y, int64_t m, int64_t n,
                                 int64_t delta, int64_t mrb, void* stream) {
  if (mrb <= 0 || mrb > 0x7fffffff || delta < 0) return int(cudaErrorInvalidValue);
  const Args a{vals, lidx, slab_off, slab_log2d, slab_col_base, rb_slab_ptr, nullptr, planes,
               delta, y, m, n, 1, mrb, static_cast<cudaStream_t>(stream)};
  return is_f64 ? launch<double, 1, 1, true>(a) : launch<float, 1, 1, true>(a);
}
