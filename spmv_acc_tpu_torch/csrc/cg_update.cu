// F-2, the CG iteration's vector work around the matvec, no float atomics,
// two launches on the same data give the same bits.
//
// Replaces XLA's fusions of the JAX package's CG loop, which has no Pallas
// kernel of its own: spmv_acc_tpu/models/cg.py::_cg_loop, body :74-84 (the
// p·Ap reduction, the x/r/z update with its dot products, the p update) and
// cond :70-72 (dot(r, r) > tol2 and it < max_iters).  Eagerly the same
// iteration is about twenty launches (dots, axpys, the Jacobi multiply, the
// masks, the count).  Two designs (spmv_acc_tpu_torch/ops/cg_update.py):
//
// The fused single-device form, one cooperative launch an iteration for M = I
// or Jacobi (cg_step), two around M's apply for any other M (cg_dot_xr, then
// z = M(r), then cg_dot_p).  Only two scalars order an iteration: alpha needs
// the global p·Ap and beta the global r·z; no input vector depends on either.
// So every thread first issues the loads of all it owns (p, Ap, x, r and inv:
// kHold 16-B vectors of each, consecutive threads on consecutive vectors) and
// holds them in registers, and the scalars are the only thing that crosses
// the grid:
//   phase A: each block sums p·Ap, writes its partial, grid.sync(), and every
//     block folds all partials in block order (the same order on every block,
//     so the same alpha everywhere);
//   phase B: x += alpha p and r -= alpha Ap from registers, stored; z = inv * r
//     (or z = r) formed in registers with the partials of r·z and r·r, then
//     grid.sync() and the same fold;
//   phase C: beta = r·z / rz, with the rz read at the start; p = z + beta p
//     from registers, stored; block 0 writes sums[0..2] and the state rz, rr,
//     it += 1.  Every block read the state before the first barrier, and no
//     block reads it after one, so block 0's write races with nothing.
// Elements past what the grid holds are walked grid-stride and read again in
// the later phases; a ragged tail (n not a multiple of the vector width) is
// walked by thread 0 of block 0, and vectors that are not all 16-B aligned
// (a view t[1:]) take the instantiation that loads one element at a time.
// The grid: as many blocks as hold the data at kHold vectors a thread, at
// most as many as are resident (occupancy x SMs, queried at a device's first
// call and kept, so that a launch inside a stream capture makes no query) and
// kMaxBlocks; it depends only on n, the alignment and the card.
//
// The three-phase form, one launch a phase, for the distributed solve, whose
// all-reduces sit between the phases:
//   cg_dot: out = a·c (p·Ap; r·z in the general form);
//   cg_xr:  alpha = rz / p·Ap; x += alpha p; r -= alpha Ap; the sums r·z and
//           r·r of the new r, z = inv * r (Jacobi) or z = r formed in
//           registers, or r·r alone where z = M(r) is applied after;
//   cg_p:   beta = r·z / rz; p = z + beta p (z formed again, or read); then
//           rz = r·z, rr = r·r, it += 1.
// Each thread walks a fixed share of the elements (a grid-stride walk,
// kUnroll elements loaded at once), the block sums it in a fixed tree, thread
// 0 writes the block's partial and takes an integer ticket (atomicAdd on an
// unsigned: the only atomic); the block that takes the last ticket folds
// every block's partial in block order, writes the result and sets the
// ticket back to 0.  cg_p's last block writes the state the same way, once
// every block has read it.  (16-B loads and a grid sized by occupancy, as
// the fused form has them, made the phases no faster at the distributed
// solve's 1 M-row shard on the H100; PERF.md.)
//
// Masked (tol2 and max_iters given): every block reads active = rr > tol2
// and it < max_iters from the state the previous launch left, and where it
// is false the launch writes nothing at all (a cooperative launch: every
// block returns before its first barrier).  So a captured graph of any number
// of iterations does only what the plain loop does, and the stop test reads
// the r·r that the update summed, no extra dot.
//
// Sums: FMAs in element order within a thread, then warp shuffles and a tree
// over the warps, then the block partials in block order; the order depends
// only on the grid, so the bits repeat.  The elementwise IEEE operations are
// written as __dmul_rn / __dadd_rn / __ddiv_rn (and the float32 ones), so
// nothing is contracted into an FMA: x, r and p round as the eager
// expressions round them, given the same sums.
//
// What bounds it on an H100: memory bytes.  An iteration with Jacobi must
// read p, Ap, x, r and inv once and write x, r and p: 8 vectors, 64 B a row
// in float64.  The fused form moves exactly those (and where the grid cannot
// hold the data, reads the rest again); the three phases read 13 (p and Ap
// twice, r and inv again for z, p again in cg_p) and pay three launches,
// three serial folds in one block, and the loads of each phase only after
// the previous phase has ended.

#include <cooperative_groups.h>
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 2048;  // the wrapper's partials hold kMaxBlocks of each of three sums
constexpr int kHold = 2;          // fused: vectors of each input a thread loads first and holds
constexpr int kWalkUnroll = 2;    // fused: vectors of each input loaded at once when read again
constexpr int kBlocksPerSM = 4;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

// z: r itself (M = I), inv * r (Jacobi), or read from memory (z = M(r))
enum Form { kIdentity = 0, kJacobi = 1, kRead = 2 };

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// Whether this iteration runs: unmasked (no tol2), or rr > tol2 and it < max_iters.
template <typename T>
__device__ __forceinline__ bool is_active(const T* rr, const int64_t* it, const T* tol2,
                                          const int64_t* max_iters) {
  return tol2 == nullptr || (*rr > *tol2 && *it < *max_iters);
}

// The K sums of v over the block in a fixed order; thread 0 gets them.
template <typename T, int K>
__device__ __forceinline__ void block_sums(T (&v)[K]) {
  __shared__ T warp_sums[K][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] = add_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) warp_sums[k][warp] = v[k];
  __syncthreads();
  if (warp == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T t = lane < kWarps ? warp_sums[k][lane] : T(0);
      for (int off = 16; off > 0; off >>= 1) t = add_rn(t, __shfl_down_sync(0xffffffffu, t, off));
      v[k] = t;
    }
}

// After block_sums: thread 0 writes the block's K partials and takes a
// ticket; the block with the last ticket folds every block's partials in
// block order and resets the ticket.  True in thread 0 of that block, which
// then holds the K totals in v.
template <typename T, int K>
__device__ __forceinline__ bool fold_last(T (&v)[K], T* partials, unsigned* ticket) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[k * kMaxBlocks + blockIdx.x] = v[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  T f[K];
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = T(0);
  for (int b = threadIdx.x; b < int(gridDim.x); b += kThreads)
#pragma unroll
    for (int k = 0; k < K; ++k) f[k] = add_rn(f[k], __ldcg(partials + k * kMaxBlocks + b));
  block_sums<T, K>(f);
  if (threadIdx.x != 0) return false;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = f[k];
  *ticket = 0u;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ a, const T* __restrict__ c, int64_t n, T* __restrict__ out,
           T* __restrict__ partials, unsigned* __restrict__ ticket) {
  const int64_t first = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  T acc[1] = {T(0)};
  for (int64_t base = first; base < n; base += kUnroll * stride) {
    T va[kUnroll], vc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      va[u] = i < n ? a[i] : T(0);
      vc[u] = i < n ? c[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * stride < n) acc[0] = fma_rn(va[u], vc[u], acc[0]);
  }
  block_sums<T, 1>(acc);
  if (fold_last<T, 1>(acc, partials, ticket)) *out = acc[0];
}

// sums = [p·Ap, r·z, r·r]: reads sums[0]; writes sums[1] and sums[2]
// (kRead: sums[2] only).
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
xr_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
          const T* __restrict__ ap, const T* __restrict__ inv, int64_t n, const T* rz,
          const T* rr, const int64_t* it, const T* tol2, const int64_t* max_iters, T* sums,
          T* __restrict__ partials, unsigned* __restrict__ ticket) {
  if (!is_active(rr, it, tol2, max_iters)) return;
  const T alpha = div_rn(*rz, sums[0]);
  constexpr int K = kForm == kJacobi ? 2 : 1;  // {r·z, r·r} or {r·r}
  const int64_t first = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
  for (int64_t base = first; base < n; base += kUnroll * stride) {
    T vx[kUnroll], vr[kUnroll], vp[kUnroll], va[kUnroll], vi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      const bool in = i < n;
      vx[u] = in ? x[i] : T(0);
      vr[u] = in ? r[i] : T(0);
      vp[u] = in ? p[i] : T(0);
      va[u] = in ? ap[i] : T(0);
      vi[u] = kForm == kJacobi && in ? inv[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i >= n) continue;
      const T xn = add_rn(vx[u], mul_rn(alpha, vp[u]));
      const T rn = sub_rn(vr[u], mul_rn(alpha, va[u]));
      x[i] = xn;
      r[i] = rn;
      if (kForm == kJacobi) {
        acc[0] = fma_rn(rn, mul_rn(vi[u], rn), acc[0]);
        acc[K - 1] = fma_rn(rn, rn, acc[K - 1]);
      } else {
        acc[0] = fma_rn(rn, rn, acc[0]);
      }
    }
  }
  block_sums<T, K>(acc);
  if (!fold_last<T, K>(acc, partials, ticket)) return;
  if (kForm != kRead) sums[1] = acc[0];  // identity: r·z = r·r
  sums[2] = acc[K - 1];
}

// zin: inv (kJacobi) or z (kRead); reads sums[1] and sums[2].
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
p_kernel(T* __restrict__ p, const T* __restrict__ r, const T* __restrict__ zin, int64_t n,
         T* rz, T* rr, int64_t* it, const T* tol2, const int64_t* max_iters, const T* sums,
         unsigned* __restrict__ ticket) {
  if (!is_active(rr, it, tol2, max_iters)) return;
  const T rz_new = sums[1];
  const T beta = div_rn(rz_new, *rz);
  const int64_t first = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t base = first; base < n; base += kUnroll * stride) {
    T vp[kUnroll], vz[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      const bool in = i < n;
      vp[u] = in ? p[i] : T(0);
      if (kForm == kIdentity) vz[u] = in ? r[i] : T(0);
      if (kForm == kJacobi) vz[u] = in ? mul_rn(zin[i], r[i]) : T(0);
      if (kForm == kRead) vz[u] = in ? zin[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      if (i < n) p[i] = add_rn(vz[u], mul_rn(beta, vp[u]));
    }
  }
  // the state goes last: every block has read rz, rr and it once it has its ticket
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  *rz = rz_new;
  *rr = sums[2];
  *it += 1;
  *ticket = 0u;
}

// Blocks for n elements: one element a thread, at most kBlocksPerSM a
// multiprocessor and kMaxBlocks; the SM count is read at a device's first
// call and kept, so that a launch inside a stream capture makes no query.
cudaError_t grid_for(int64_t n, unsigned* blocks) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = count < 1 ? 1 : count;
  }
  int64_t most = int64_t(sms[dev]) * kBlocksPerSM;
  if (most > kMaxBlocks) most = kMaxBlocks;
  const int64_t need = (n + kThreads - 1) / kThreads;
  *blocks = unsigned(need < 1 ? 1 : (need < most ? need : most));
  return cudaSuccess;
}

template <typename T>
int launch_dot(const void* a, const void* c, int64_t n, void* out, void* partials, void* ticket,
               cudaStream_t st) {
  unsigned blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return int(err);
  dot_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(c), n, static_cast<T*>(out),
      static_cast<T*>(partials), static_cast<unsigned*>(ticket));
  return int(cudaGetLastError());
}

template <typename T, int kForm>
int launch_xr(void* x, void* r, const void* p, const void* ap, const void* inv, int64_t n,
              const void* rz, const void* rr, const void* it, const void* tol2,
              const void* max_iters, void* sums, void* partials, void* ticket,
              cudaStream_t st) {
  unsigned blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return int(err);
  xr_kernel<T, kForm><<<blocks, kThreads, 0, st>>>(
      static_cast<T*>(x), static_cast<T*>(r), static_cast<const T*>(p),
      static_cast<const T*>(ap), static_cast<const T*>(inv), n, static_cast<const T*>(rz),
      static_cast<const T*>(rr), static_cast<const int64_t*>(it), static_cast<const T*>(tol2),
      static_cast<const int64_t*>(max_iters), static_cast<T*>(sums), static_cast<T*>(partials),
      static_cast<unsigned*>(ticket));
  return int(cudaGetLastError());
}

template <typename T, int kForm>
int launch_p(void* p, const void* r, const void* zin, int64_t n, void* rz, void* rr, void* it,
             const void* tol2, const void* max_iters, const void* sums, void* ticket,
             cudaStream_t st) {
  unsigned blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return int(err);
  p_kernel<T, kForm><<<blocks, kThreads, 0, st>>>(
      static_cast<T*>(p), static_cast<const T*>(r), static_cast<const T*>(zin), n,
      static_cast<T*>(rz), static_cast<T*>(rr), static_cast<int64_t*>(it),
      static_cast<const T*>(tol2), static_cast<const int64_t*>(max_iters),
      static_cast<const T*>(sums), static_cast<unsigned*>(ticket));
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_xr(int form, void* x, void* r, const void* p, const void* ap, const void* inv,
                int64_t n, const void* rz, const void* rr, const void* it, const void* tol2,
                const void* max_iters, void* sums, void* partials, void* ticket,
                cudaStream_t st) {
  switch (form) {
    case kIdentity:
      return launch_xr<T, kIdentity>(x, r, p, ap, inv, n, rz, rr, it, tol2, max_iters, sums,
                                     partials, ticket, st);
    case kJacobi:
      return launch_xr<T, kJacobi>(x, r, p, ap, inv, n, rz, rr, it, tol2, max_iters, sums,
                                   partials, ticket, st);
    case kRead:
      return launch_xr<T, kRead>(x, r, p, ap, inv, n, rz, rr, it, tol2, max_iters, sums,
                                 partials, ticket, st);
  }
  return int(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_p(int form, void* p, const void* r, const void* zin, int64_t n, void* rz, void* rr,
               void* it, const void* tol2, const void* max_iters, const void* sums,
               void* ticket, cudaStream_t st) {
  switch (form) {
    case kIdentity:
      return launch_p<T, kIdentity>(p, r, zin, n, rz, rr, it, tol2, max_iters, sums, ticket, st);
    case kJacobi:
      return launch_p<T, kJacobi>(p, r, zin, n, rz, rr, it, tol2, max_iters, sums, ticket, st);
    case kRead:
      return launch_p<T, kRead>(p, r, zin, n, rz, rr, it, tol2, max_iters, sums, ticket, st);
  }
  return int(cudaErrorInvalidValue);
}

// ---- the fused single-device form

namespace cg = cooperative_groups;

// W elements loaded and stored at once: one 16-B vector (W = 16 / sizeof(T)),
// or one element where the vectors are not all 16-B aligned.
template <typename T, int W>
struct Pack {
  T e[W];
};

template <typename T, int W>
struct Io {
  static __device__ __forceinline__ Pack<T, W> ld(const T* a, int64_t j) {
    Pack<T, W> v;
    v.e[0] = a[j];
    return v;
  }
  static __device__ __forceinline__ void st(T* a, int64_t j, const Pack<T, W>& v) { a[j] = v.e[0]; }
};
template <>
struct Io<double, 2> {
  static __device__ __forceinline__ Pack<double, 2> ld(const double* a, int64_t j) {
    const double2 v = reinterpret_cast<const double2*>(a)[j];
    return Pack<double, 2>{{v.x, v.y}};
  }
  static __device__ __forceinline__ void st(double* a, int64_t j, const Pack<double, 2>& v) {
    reinterpret_cast<double2*>(a)[j] = make_double2(v.e[0], v.e[1]);
  }
};
template <>
struct Io<float, 4> {
  static __device__ __forceinline__ Pack<float, 4> ld(const float* a, int64_t j) {
    const float4 v = reinterpret_cast<const float4*>(a)[j];
    return Pack<float, 4>{{v.x, v.y, v.z, v.w}};
  }
  static __device__ __forceinline__ void st(float* a, int64_t j, const Pack<float, 4>& v) {
    reinterpret_cast<float4*>(a)[j] = make_float4(v.e[0], v.e[1], v.e[2], v.e[3]);
  }
};

// One thread's vectors: first, first + stride, ... up to nvec; the fused
// kernels hold the first kHold.  Thread 0 also walks the ragged tail.
struct Share {
  int64_t first, stride, nvec;
  __device__ __forceinline__ explicit Share(int64_t nv)
      : first(int64_t(blockIdx.x) * kThreads + threadIdx.x),
        stride(int64_t(gridDim.x) * kThreads), nvec(nv) {}
  __device__ __forceinline__ int64_t at(int h) const { return first + h * stride; }
  __device__ __forceinline__ bool has(int h) const { return at(h) < nvec; }
  __device__ __forceinline__ bool tail() const { return first == 0; }
};

template <typename T, int W>
__device__ __forceinline__ T dot_add(const Pack<T, W>& a, const Pack<T, W>& c, T acc) {
#pragma unroll
  for (int e = 0; e < W; ++e) acc = fma_rn(a.e[e], c.e[e], acc);
  return acc;
}

// x += alpha p, r -= alpha ap in place; z = inv * r into i (kJacobi; z = r
// otherwise); acc gets r·z and r·r (kJacobi), else r·r.
template <typename T, int W, int kForm, int K>
__device__ __forceinline__ void update_xr(Pack<T, W>& x, Pack<T, W>& r, const Pack<T, W>& p,
                                          const Pack<T, W>& a, Pack<T, W>& i, T alpha,
                                          T (&acc)[K]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    x.e[e] = add_rn(x.e[e], mul_rn(alpha, p.e[e]));
    const T rn = sub_rn(r.e[e], mul_rn(alpha, a.e[e]));
    r.e[e] = rn;
    if (kForm == kJacobi) {
      i.e[e] = mul_rn(i.e[e], rn);
      acc[0] = fma_rn(rn, i.e[e], acc[0]);
    }
    acc[K - 1] = fma_rn(rn, rn, acc[K - 1]);
  }
}

// p = z + beta p.
template <typename T, int W>
__device__ __forceinline__ void update_p(Pack<T, W>& p, const Pack<T, W>& z, T beta) {
#pragma unroll
  for (int e = 0; e < W; ++e) p.e[e] = add_rn(z.e[e], mul_rn(beta, p.e[e]));
}

// ---- the walks: this thread's vectors from `from` on, U of each input
// loaded at once, and in thread 0 the tail past the last whole vector

// acc + a·c.
template <typename T, int W, int U>
__device__ __forceinline__ T walk_dot(const Share& s, int64_t from, const T* a, const T* c,
                                      int64_t n, T acc) {
  using IO = Io<T, W>;
  for (int64_t base = from; base < s.nvec; base += U * s.stride) {
    Pack<T, W> va[U], vc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = base + u * s.stride;
      if (j < s.nvec) va[u] = IO::ld(a, j), vc[u] = IO::ld(c, j);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * s.stride < s.nvec) acc = dot_add(va[u], vc[u], acc);
  }
  if (s.tail())
    for (int64_t i = s.nvec * W; i < n; ++i) acc = fma_rn(a[i], c[i], acc);
  return acc;
}

// x and r updated in place, acc as update_xr.
template <typename T, int W, int U, int kForm, int K>
__device__ __forceinline__ void walk_xr(const Share& s, int64_t from, T* x, T* r, const T* p,
                                        const T* ap, const T* inv, int64_t n, T alpha,
                                        T (&acc)[K]) {
  using IO = Io<T, W>;
  for (int64_t base = from; base < s.nvec; base += U * s.stride) {
    Pack<T, W> vx[U], vr[U], vp[U], va[U], vi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = base + u * s.stride;
      if (j < s.nvec) {
        vx[u] = IO::ld(x, j), vr[u] = IO::ld(r, j), vp[u] = IO::ld(p, j), va[u] = IO::ld(ap, j);
        if (kForm == kJacobi) vi[u] = IO::ld(inv, j);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = base + u * s.stride;
      if (j >= s.nvec) continue;
      update_xr<T, W, kForm, K>(vx[u], vr[u], vp[u], va[u], vi[u], alpha, acc);
      IO::st(x, j, vx[u]);
      IO::st(r, j, vr[u]);
    }
  }
  if (s.tail())
    for (int64_t i = s.nvec * W; i < n; ++i) {
      Pack<T, 1> vx{{x[i]}}, vr{{r[i]}}, vi{{kForm == kJacobi ? inv[i] : T(0)}};
      update_xr<T, 1, kForm, K>(vx, vr, Pack<T, 1>{{p[i]}}, Pack<T, 1>{{ap[i]}}, vi, alpha, acc);
      x[i] = vx.e[0];
      r[i] = vr.e[0];
    }
}

// p = z + beta p in place, z = r (kIdentity), zin * r (kJacobi) or zin (kRead).
template <typename T, int W, int U, int kForm>
__device__ __forceinline__ void walk_p(const Share& s, int64_t from, T* p, const T* r,
                                       const T* zin, int64_t n, T beta) {
  using IO = Io<T, W>;
  for (int64_t base = from; base < s.nvec; base += U * s.stride) {
    Pack<T, W> vp[U], vz[U], vi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = base + u * s.stride;
      if (j < s.nvec) {
        vp[u] = IO::ld(p, j);
        vz[u] = IO::ld(kForm == kRead ? zin : r, j);
        if (kForm == kJacobi) vi[u] = IO::ld(zin, j);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = base + u * s.stride;
      if (j >= s.nvec) continue;
      if (kForm == kJacobi)
#pragma unroll
        for (int e = 0; e < W; ++e) vz[u].e[e] = mul_rn(vi[u].e[e], vz[u].e[e]);
      update_p(vp[u], vz[u], beta);
      IO::st(p, j, vp[u]);
    }
  }
  if (s.tail())
    for (int64_t i = s.nvec * W; i < n; ++i) {
      const T z = kForm == kRead ? zin[i] : kForm == kJacobi ? mul_rn(zin[i], r[i]) : r[i];
      p[i] = add_rn(z, mul_rn(beta, p[i]));
    }
}

// The K sums of v over the block in a fixed order; every thread gets them.
template <typename T, int K>
__device__ __forceinline__ void block_totals(T (&v)[K]) {
  __shared__ T total[K];
  block_sums<T, K>(v);
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) total[k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = total[k];
}

// v[k] = every block's partials[k][b] folded in block order (every thread).
template <typename T, int K>
__device__ __forceinline__ void fold(T (&v)[K], const T* partials) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = T(0);
  for (int b = threadIdx.x; b < int(gridDim.x); b += kThreads)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = add_rn(v[k], __ldcg(partials + k * kMaxBlocks + b));
  block_totals<T, K>(v);
}

// The fused kernels' fold: the block's K partials into partials rows
// region..region+K-1, the grid's barrier, then every block folds them: every
// thread of every block gets the same K totals in v.
template <typename T, int K>
__device__ __forceinline__ void grid_totals(T (&v)[K], T* partials, int region) {
  block_sums<T, K>(v);
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) partials[(region + k) * kMaxBlocks + blockIdx.x] = v[k];
  cg::this_grid().sync();
  fold<T, K>(v, partials + region * kMaxBlocks);
}

// cg_step: the whole iteration (kIdentity or kJacobi); sums = [p·Ap, r·z, r·r].
template <typename T, int W, int kForm>
__global__ void __launch_bounds__(kThreads, 2)
step_kernel(T* __restrict__ x, T* __restrict__ r, T* __restrict__ p, const T* __restrict__ ap,
            const T* __restrict__ inv, int64_t n, T* rz, T* rr, int64_t* it, const T* tol2,
            const int64_t* max_iters, T* sums, T* __restrict__ partials) {
  using IO = Io<T, W>;
  using P = Pack<T, W>;
  // the state, read by every block before its first barrier and by none after
  const T rz_old = *rz;
  const int64_t it_old = *it;
  if (!is_active(rr, it, tol2, max_iters)) return;
  const Share s(n / W);
  P hp[kHold], ha[kHold], hx[kHold], hr[kHold], hi[kHold];
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) {
      const int64_t j = s.at(h);
      hp[h] = IO::ld(p, j), ha[h] = IO::ld(ap, j), hx[h] = IO::ld(x, j), hr[h] = IO::ld(r, j);
      if (kForm == kJacobi) hi[h] = IO::ld(inv, j);
    }
  // A: p·Ap, alpha
  T pap[1] = {T(0)};
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) pap[0] = dot_add(hp[h], ha[h], pap[0]);
  pap[0] = walk_dot<T, W, kWalkUnroll>(s, s.at(kHold), p, ap, n, pap[0]);
  grid_totals<T, 1>(pap, partials, 0);
  const T alpha = div_rn(rz_old, pap[0]);
  // B: x and r, z in registers, r·z and r·r
  constexpr int K = kForm == kJacobi ? 2 : 1;  // {r·z, r·r} or {r·r}
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = T(0);
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) {
      update_xr<T, W, kForm, K>(hx[h], hr[h], hp[h], ha[h], hi[h], alpha, acc);
      IO::st(x, s.at(h), hx[h]);
      IO::st(r, s.at(h), hr[h]);
    }
  walk_xr<T, W, kWalkUnroll, kForm, K>(s, s.at(kHold), x, r, p, ap, inv, n, alpha, acc);
  grid_totals<T, K>(acc, partials, 1);
  // C: beta, p
  const T beta = div_rn(acc[0], rz_old);
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) {
      update_p(hp[h], kForm == kJacobi ? hi[h] : hr[h], beta);
      IO::st(p, s.at(h), hp[h]);
    }
  walk_p<T, W, kWalkUnroll, kForm>(s, s.at(kHold), p, r, inv, n, beta);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sums[0] = pap[0];
    sums[1] = acc[0];  // identity: r·z = r·r
    sums[2] = acc[K - 1];
    *rz = acc[0];
    *rr = acc[K - 1];
    *it = it_old + 1;
  }
}

// cg_dot_xr: phases A and B of the general form; sums[0] = p·Ap, sums[2] = r·r.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2)
dot_xr_kernel(T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
              const T* __restrict__ ap, int64_t n, const T* rz, const T* rr, const int64_t* it,
              const T* tol2, const int64_t* max_iters, T* sums, T* __restrict__ partials) {
  using IO = Io<T, W>;
  using P = Pack<T, W>;
  const T rz_old = *rz;
  if (!is_active(rr, it, tol2, max_iters)) return;
  const Share s(n / W);
  P hp[kHold], ha[kHold], hx[kHold], hr[kHold];
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) {
      const int64_t j = s.at(h);
      hp[h] = IO::ld(p, j), ha[h] = IO::ld(ap, j), hx[h] = IO::ld(x, j), hr[h] = IO::ld(r, j);
    }
  T pap[1] = {T(0)};
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) pap[0] = dot_add(hp[h], ha[h], pap[0]);
  pap[0] = walk_dot<T, W, kWalkUnroll>(s, s.at(kHold), p, ap, n, pap[0]);
  grid_totals<T, 1>(pap, partials, 0);
  const T alpha = div_rn(rz_old, pap[0]);
  T acc[1] = {T(0)};
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) {
      update_xr<T, W, kRead, 1>(hx[h], hr[h], hp[h], ha[h], hx[h], alpha, acc);
      IO::st(x, s.at(h), hx[h]);
      IO::st(r, s.at(h), hr[h]);
    }
  walk_xr<T, W, kWalkUnroll, kRead, 1>(s, s.at(kHold), x, r, p, ap, nullptr, n, alpha, acc);
  // r·r: only block 0 needs the total
  block_sums<T, 1>(acc);
  if (threadIdx.x == 0) partials[kMaxBlocks + blockIdx.x] = acc[0];
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;
  fold<T, 1>(acc, partials + kMaxBlocks);
  if (threadIdx.x == 0) {
    sums[0] = pap[0];
    sums[2] = acc[0];
  }
}

// cg_dot_p: r·z, beta, p = z + beta p; then sums[1] = rz = r·z, rr = sums[2], it += 1.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 2)
dot_p_kernel(T* __restrict__ p, const T* __restrict__ r, const T* __restrict__ z, int64_t n,
             T* rz, T* rr, int64_t* it, const T* tol2, const int64_t* max_iters, T* sums,
             T* __restrict__ partials) {
  using IO = Io<T, W>;
  using P = Pack<T, W>;
  const T rz_old = *rz;
  const int64_t it_old = *it;
  if (!is_active(rr, it, tol2, max_iters)) return;
  const Share s(n / W);
  P hp[kHold], hr[kHold], hz[kHold];
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) {
      const int64_t j = s.at(h);
      hr[h] = IO::ld(r, j), hz[h] = IO::ld(z, j), hp[h] = IO::ld(p, j);
    }
  T rzn[1] = {T(0)};
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) rzn[0] = dot_add(hr[h], hz[h], rzn[0]);
  rzn[0] = walk_dot<T, W, kWalkUnroll>(s, s.at(kHold), r, z, n, rzn[0]);
  grid_totals<T, 1>(rzn, partials, 0);
  const T beta = div_rn(rzn[0], rz_old);
#pragma unroll
  for (int h = 0; h < kHold; ++h)
    if (s.has(h)) {
      update_p(hp[h], hz[h], beta);
      IO::st(p, s.at(h), hp[h]);
    }
  walk_p<T, W, kWalkUnroll, kRead>(s, s.at(kHold), p, r, z, n, beta);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sums[1] = rzn[0];
    *rz = rzn[0];
    *rr = sums[2];
    *it = it_old + 1;
  }
}

// The card's SMs and the most blocks of one kernel resident on each; sms -1
// where the device cannot launch cooperatively.
struct Residency {
  int sms, per_sm;
};

// One cooperative launch (every block resident at once) of `kernel` over
// nvec vectors: as many blocks as hold them at kHold a thread, at most the
// resident blocks and kMaxBlocks.  `cache` is the kernel's own (one per
// instantiation): filled at a device's first call, so that later calls
// (inside a stream capture too) make no query.
template <typename... Params, typename... Args>
int launch_coop(void (*kernel)(Params...), Residency* cache, int64_t nvec, cudaStream_t st,
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
  int64_t most = int64_t(cache[dev].sms) * cache[dev].per_sm;
  if (most > kMaxBlocks) most = kMaxBlocks;
  const int64_t per_block = int64_t(kThreads) * kHold;
  const int64_t need = (nvec + per_block - 1) / per_block;
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

// Whether every given pointer (NULL: none) is 16-B aligned: the vector loads.
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  return true;
}

// The fused entries' launches, W fixed.
template <typename T, int W>
struct Fused {
  template <int kForm>
  static int step(void* x, void* r, void* p, const void* ap, const void* inv, int64_t n, void* rz,
                  void* rr, void* it, const void* tol2, const void* max_iters, void* sums,
                  void* partials, cudaStream_t st) {
    static Residency cache[kMaxDevices];
    return launch_coop(step_kernel<T, W, kForm>, cache, n / W, st, static_cast<T*>(x),
                  static_cast<T*>(r), static_cast<T*>(p), static_cast<const T*>(ap),
                  static_cast<const T*>(inv), n, static_cast<T*>(rz), static_cast<T*>(rr),
                  static_cast<int64_t*>(it), static_cast<const T*>(tol2),
                  static_cast<const int64_t*>(max_iters), static_cast<T*>(sums),
                  static_cast<T*>(partials));
  }

  static int dot_xr(void* x, void* r, const void* p, const void* ap, int64_t n, const void* rz,
                    const void* rr, const void* it, const void* tol2, const void* max_iters,
                    void* sums, void* partials, cudaStream_t st) {
    static Residency cache[kMaxDevices];
    return launch_coop(dot_xr_kernel<T, W>, cache, n / W, st, static_cast<T*>(x),
                  static_cast<T*>(r), static_cast<const T*>(p), static_cast<const T*>(ap), n,
                  static_cast<const T*>(rz), static_cast<const T*>(rr),
                  static_cast<const int64_t*>(it), static_cast<const T*>(tol2),
                  static_cast<const int64_t*>(max_iters), static_cast<T*>(sums),
                  static_cast<T*>(partials));
  }

  static int dot_p(void* p, const void* r, const void* z, int64_t n, void* rz, void* rr, void* it,
                   const void* tol2, const void* max_iters, void* sums, void* partials,
                   cudaStream_t st) {
    static Residency cache[kMaxDevices];
    return launch_coop(dot_p_kernel<T, W>, cache, n / W, st, static_cast<T*>(p),
                  static_cast<const T*>(r), static_cast<const T*>(z), n, static_cast<T*>(rz),
                  static_cast<T*>(rr), static_cast<int64_t*>(it), static_cast<const T*>(tol2),
                  static_cast<const int64_t*>(max_iters), static_cast<T*>(sums),
                  static_cast<T*>(partials));
  }
};

// f(Fused<T, W>{}) with T double (is_f64) or float and W the vector width
// the pointers allow: one 16-B vector (2 doubles, 4 floats) or one element.
template <typename F>
int with_fused(int is_f64, bool vec, F f) {
  if (is_f64) return vec ? f(Fused<double, 2>{}) : f(Fused<double, 1>{});
  return vec ? f(Fused<float, 4>{}) : f(Fused<float, 1>{});
}

// A mask is tol2 and max_iters together, or neither.
bool bad_mask(const void* tol2, const void* max_iters) {
  return (tol2 == nullptr) != (max_iters == nullptr);
}

}  // namespace

// Every entry launches one kernel on `stream` and does not synchronise;
// float64 (is_f64 != 0) or float32 vectors and sums, int64 it and max_iters;
// `partials` holds 3 x 2048 elements and `ticket` (the phases') one unsigned
// that is 0 between launches (the launch's last block sets it back).
// Returns the launch's error, else cudaGetLastError() after it (0 on
// success), or cudaErrorInvalidValue for a bad size, form or mask (and the
// fused entries cudaErrorCooperativeLaunchTooLarge where the device cannot
// launch cooperatively).

// *out = a·c over n elements.
extern "C" int cg_dot(int is_f64, const void* a, const void* c, int64_t n, void* out,
                      void* partials, void* ticket, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_dot<double>(a, c, n, out, partials, ticket, st)
                : launch_dot<float>(a, c, n, out, partials, ticket, st);
}

// x += alpha p, r -= alpha ap (alpha = *rz / sums[0]); sums[1] = r·z (form
// 0: z = r, 1: z = inv * r) and sums[2] = r·r of the new r, or (form 2)
// sums[2] only.  Masked by tol2 / max_iters (NULL: unmasked).
extern "C" int cg_xr(int is_f64, int form, void* x, void* r, const void* p, const void* ap,
                     const void* inv, int64_t n, const void* rz, const void* rr, const void* it,
                     const void* tol2, const void* max_iters, void* sums, void* partials,
                     void* ticket, void* stream) {
  if (n <= 0 || bad_mask(tol2, max_iters) || (form == kJacobi) != (inv != nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? dispatch_xr<double>(form, x, r, p, ap, inv, n, rz, rr, it, tol2, max_iters,
                                      sums, partials, ticket, st)
                : dispatch_xr<float>(form, x, r, p, ap, inv, n, rz, rr, it, tol2, max_iters,
                                     sums, partials, ticket, st);
}

// p = z + (sums[1] / *rz) p with z = r (form 0), zin * r (1) or zin (2);
// then *rz = sums[1], *rr = sums[2], *it += 1.  Masked as cg_xr.
extern "C" int cg_p(int is_f64, int form, void* p, const void* r, const void* zin, int64_t n,
                    void* rz, void* rr, void* it, const void* tol2, const void* max_iters,
                    const void* sums, void* ticket, void* stream) {
  if (n <= 0 || bad_mask(tol2, max_iters) || (form == kIdentity) != (zin == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? dispatch_p<double>(form, p, r, zin, n, rz, rr, it, tol2, max_iters, sums,
                                     ticket, st)
                : dispatch_p<float>(form, p, r, zin, n, rz, rr, it, tol2, max_iters, sums,
                                    ticket, st);
}

// The fused form: one cooperative launch each (no ticket).  Vectors all 16-B
// aligned are loaded 16 B at a time, else one element at a time.

// The whole iteration for M = I (form 0) or Jacobi (form 1, z = inv * r):
// sums[0] = p·Ap, alpha = *rz / sums[0], x += alpha p, r -= alpha ap;
// sums[1] = r·z and sums[2] = r·r of the new r; p = z + (sums[1] / *rz) p;
// then *rz = sums[1], *rr = sums[2], *it += 1.  Masked by tol2 / max_iters
// (NULL: unmasked); masked off, nothing is written.
extern "C" int cg_step(int is_f64, int form, void* x, void* r, void* p, const void* ap,
                       const void* inv, int64_t n, void* rz, void* rr, void* it, const void* tol2,
                       const void* max_iters, void* sums, void* partials, void* stream) {
  if (n <= 0 || bad_mask(tol2, max_iters) || (form != kIdentity && form != kJacobi) ||
      (form == kJacobi) != (inv != nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_fused(is_f64, aligned16({x, r, p, ap, inv}), [&](auto l) {
    using L = decltype(l);
    auto step = form == kJacobi ? &L::template step<kJacobi> : &L::template step<kIdentity>;
    return step(x, r, p, ap, inv, n, rz, rr, it, tol2, max_iters, sums, partials, st);
  });
}

// The general form's first half: sums[0] = p·Ap, alpha = *rz / sums[0],
// x += alpha p, r -= alpha ap, sums[2] = r·r of the new r.  Masked as cg_step.
extern "C" int cg_dot_xr(int is_f64, void* x, void* r, const void* p, const void* ap, int64_t n,
                         const void* rz, const void* rr, const void* it, const void* tol2,
                         const void* max_iters, void* sums, void* partials, void* stream) {
  if (n <= 0 || bad_mask(tol2, max_iters)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_fused(is_f64, aligned16({x, r, p, ap}), [&](auto l) {
    return decltype(l)::dot_xr(x, r, p, ap, n, rz, rr, it, tol2, max_iters, sums, partials, st);
  });
}

// The second half, after z = M(r): sums[1] = r·z, p = z + (sums[1] / *rz) p;
// then *rz = sums[1], *rr = sums[2], *it += 1.  Masked as cg_step.
extern "C" int cg_dot_p(int is_f64, void* p, const void* r, const void* z, int64_t n, void* rz,
                        void* rr, void* it, const void* tol2, const void* max_iters, void* sums,
                        void* partials, void* stream) {
  if (n <= 0 || bad_mask(tol2, max_iters)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_fused(is_f64, aligned16({p, r, z}), [&](auto l) {
    return decltype(l)::dot_p(p, r, z, n, rz, rr, it, tol2, max_iters, sums, partials, st);
  });
}
