// F-2, the CG iteration's vector work around the matvec: three launches, no
// float atomics, two launches on the same data give the same bits.
//
// Replaces XLA's fusions of the JAX package's CG loop, which has no Pallas
// kernel of its own: spmv_acc_tpu/models/cg.py::_cg_loop, body :74-84 (the
// p·Ap reduction, the x/r/z update with its dot products, the p update) and
// cond :70-72 (dot(r, r) > tol2 and it < max_iters).  Eagerly the same
// iteration is about twenty launches (dots, axpys, the Jacobi multiply, the
// masks, the count); here it is three, or four and M's apply for a general
// preconditioner (spmv_acc_tpu_torch/ops/cg_update.py):
//   cg_dot: out = a·c (p·Ap; r·z in the general form);
//   cg_xr:  alpha = rz / p·Ap; x += alpha p; r -= alpha Ap; the sums r·z and
//           r·r of the new r, z = inv * r (Jacobi) or z = r formed in
//           registers, or r·r alone where z = M(r) is applied after;
//   cg_p:   beta = r·z / rz; p = z + beta p (z formed again, or read); then
//           rz = r·z, rr = r·r, it += 1.
// Masked (tol2 and max_iters given): every block reads active = rr > tol2
// and it < max_iters from the state the previous launch left, and where it
// is false the launch writes nothing at all.  So a captured graph of any
// number of iterations does only what the plain loop does, and the stop test
// reads the r·r that cg_xr summed, no extra dot.
//
// Sums: each thread walks a fixed share of the elements (a grid-stride walk,
// kUnroll elements loaded at once, FMAs in element order), the block sums it
// in a fixed tree (warp shuffles, then the warps), thread 0 writes the
// block's partial and takes an integer ticket (atomicAdd on an unsigned: the
// only atomic); the block that takes the last ticket folds every block's
// partial in block order, writes the result and sets the ticket back to 0.
// cg_p's last block writes the state the same way, once every block has read
// it.  The grid depends only on n and the card's SMs, so the order, and the
// bits, repeat.  The elementwise IEEE operations are written as __dmul_rn /
// __dadd_rn / __ddiv_rn (and the float32 ones), so nothing is contracted into
// an FMA: x, r and p round as the eager expressions round them.
//
// What bounds it on an H100: memory bytes.  An iteration with Jacobi must
// read p, Ap, x, r and inv once and write x, r and p: 8 vectors, 64 B a row
// in float64.  The three launches read 13 (p and Ap twice, r and inv again
// for z, p again in cg_p): the vectors of a solve the size of the bench's
// (2 MB each at 512^2) stay in the 50 MB L2 between the launches.  Loads are
// one element a thread at a time, consecutive threads on consecutive
// elements, kUnroll loads in flight; no alignment is assumed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;  // the wrapper's partials hold kMaxBlocks of each of two sums
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

// A mask is tol2 and max_iters together, or neither.
bool bad_mask(const void* tol2, const void* max_iters) {
  return (tol2 == nullptr) != (max_iters == nullptr);
}

}  // namespace

// Every entry launches one kernel on `stream` and does not synchronise;
// float64 (is_f64 != 0) or float32 vectors and sums, int64 it and max_iters;
// `partials` holds 2 x 1024 elements and `ticket` one unsigned that is 0
// between launches (the launch's last block sets it back).  Returns the
// launch's error, else cudaGetLastError() after it (0 on success), or
// cudaErrorInvalidValue for a bad size, form or mask.

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
