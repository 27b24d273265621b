// Training-mode BatchNorm over the trailing (channel) axis for Hopper (sm_90a):
// batch statistics, normalize, and the batch-statistics backward.
//
//     mean, var = moments(x)                     deterministic f32 tree sums
//     out = act(exact_mul(x - mean, inv * g) + b),  inv = 1 / sqrt(var + eps)
//     db = sum dy',  dg = sum dy' * xhat,  dx = g*inv*(dy' - db/R - xhat*dg/R)
//
// x is (R, C), channels contiguous (NHWC flattened); dy' is dy with the ReLU
// mask applied when act is relu.
//
// Replaces the four TPU kernels of mxnet_tpu/pallas_kernels/batchnorm_fused.py:
//   _stats_kernel       -> bn_stats_partials_kernel (+ bn_finalize_kernel)
//   _apply_kernel       -> bn_apply_kernel
//   _bwd_reduce_kernel  -> bn_bwd_partials_kernel   (+ bn_finalize_kernel)
//   _bwd_dx_kernel      -> bn_bwd_dx_kernel
// On the TPU the fold of the per-block partials and the mean/var formula ran
// as XLA ops; here they are a small second launch, bn_finalize_kernel, made
// by the same C entry point (bn_stats_*, bn_bwd_reduce_*).
//
// What bounds them on an H100: bytes. Each is one or two passes over R*C
// elements with a handful of f32 operations per element (stats: one read;
// apply: a read and a write; bwd partials: two reads; bwd dx: two reads and
// a write). The design keeps every pass at one read of each input and one
// write of each output: loads run along C, so neighbouring threads read
// neighbouring addresses (16-byte vectors in apply and dx, 8 bytes of bf16 /
// 16 bytes of f32 in the two folding kernels, whose per-thread stacks would
// spill with wider vectors), per-channel constants are computed once per
// thread, and no float atomics are used. A folding thread folds a strided
// set of 64-row blocks (enough of them that about 2^17 threads stay busy),
// so the partial rows the finalize folds are few and their traffic small. It
// is the simple form: no shared-memory staging, no cp.async or TMA
// pipelining.
//
// Bitwise contract (forward). out, mean and var equal the plain PyTorch
// version (kernels/batchnorm_fused.py:batchnorm_reference) bit for bit:
//  - every step uses __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn/__fsqrt_rn, so
//    nvcc cannot contract a product into an FMA; never build with fast math;
//  - sums follow the JAX package's tree exactly: fold_blocks folds each
//    64-row block by contiguous halves (row i with row i+32, then i+16, ...),
//    and fold_partials folds the NB block partials, padded with exact zeros
//    to a power of two P, by contiguous halves again. A contiguous-halves fold
//    of 2^L values equals a neighbour-pairwise fold of the same values taken
//    in bit-reversed index order, so one thread folds a set of values in
//    streaming order with a binary-counter stack of L partial sums. The zero
//    padding is added, not skipped (-0.0 + 0.0 is +0.0);
//  - squares and the normalize product use exact-product splitting (the top
//    12 significant bits by masking, the rest by subtraction), so every
//    partial product is exact, with a plain product for non-finite inputs;
//  - mean = sum / R and var = max(sumsq / R - exact_sq(mean), 0) divide by R
//    rounded to f32, in f32; a NaN variance stays NaN.
// The backward uses the same trees and the same rounded products, so it too
// equals the plain version's backward; its contract with the JAX package is a
// tolerance (the TPU kernel accumulated across row tiles in grid order).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int FOLD_BLOCK = 64;
constexpr int FOLD_LEVELS = 6;          // log2(FOLD_BLOCK)
constexpr int THREADS = 256;
constexpr int FOLD_VEC = 4;             // channels per thread, folding kernels
constexpr long long TARGET_THREADS = 1LL << 18;  // elementwise kernels
constexpr long long FOLD_THREADS = 1LL << 17;    // folding kernels
constexpr int MAX_LOG_K = 16;     // blocks per folding thread: at most 2^16
constexpr int MAX_LOG_G = 40;     // partial rows: at most 2^40
constexpr int FIN_CH = 16;        // finalize: channels per block
constexpr int FIN_LANES = 64;     // finalize: lanes per channel

// ---------------------------------------------------------------------------
// correctly rounded building blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool finite(float a) {
  return (__float_as_uint(a) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ float hi12(float a) {
  return __int_as_float(__float_as_int(a) & -4096);
}

__device__ __forceinline__ float exact_sq(float x) {
  if (!finite(x)) return __fmul_rn(x, x);
  const float xh = hi12(x);
  const float xl = __fsub_rn(x, xh);
  return __fadd_rn(__fmul_rn(xh, xh),
                   __fadd_rn(__fmul_rn(2.f, __fmul_rn(xh, xl)),
                             __fmul_rn(xl, xl)));
}

__device__ __forceinline__ float exact_mul(float a, float b) {
  if (!(finite(a) && finite(b))) return __fmul_rn(a, b);
  const float ah = hi12(a), bh = hi12(b);
  const float al = __fsub_rn(a, ah), bl = __fsub_rn(b, bh);
  return __fadd_rn(__fmul_rn(ah, bh),
                   __fadd_rn(__fmul_rn(ah, bl),
                             __fadd_rn(__fmul_rn(al, bh), __fmul_rn(al, bl))));
}

// max(v, 0) that keeps a NaN (jnp.maximum's semantics).
__device__ __forceinline__ float max0(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

__device__ __forceinline__ float inv_std(float var, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// ---------------------------------------------------------------------------
// vector loads and stores: V consecutive channels as floats
// ---------------------------------------------------------------------------

template <typename T, int V>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&o)[1]) {
    if constexpr (sizeof(T) == 2) o[0] = __bfloat162float(p[0]);
    else o[0] = p[0];
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    if constexpr (sizeof(T) == 2) p[0] = __float2bfloat16_rn(v[0]);
    else p[0] = v[0];
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = __bfloat162float(e[j]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(e[j]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  }
};

// ---------------------------------------------------------------------------
// the in-thread fold of one 64-row block
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int brev6(int j) {
  return ((j & 1) << 5) | ((j & 2) << 3) | ((j & 4) << 1) | ((j & 8) >> 1) |
         ((j & 16) >> 3) | ((j & 32) >> 5);
}

__host__ __device__ constexpr int trailing_ones(int j) {
  int n = 0;
  while (j & 1) {
    ++n;
    j >>= 1;
  }
  return n;
}

// Folds the two per-element quantities (u, v) that `elem(row, u, v)` gives
// for rows 0..63 of one block, each by contiguous halves. Rows are visited
// in bit-reversed order and merged like a binary counter: visit J merges the
// stack levels below trailing_ones(J), so the adds happen in the tree's
// pairs. Every index is a compile-time constant, so the stack lives in
// registers.
template <int J, int V, class Elem>
__device__ __forceinline__ void fold_step(float (&su)[FOLD_LEVELS + 1][V],
                                          float (&sv)[FOLD_LEVELS + 1][V],
                                          const Elem& elem) {
  if constexpr (J < FOLD_BLOCK) {
    float u[V], v[V];
    elem(brev6(J), u, v);
    constexpr int L = trailing_ones(J);
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        u[e] = __fadd_rn(su[l][e], u[e]);
        v[e] = __fadd_rn(sv[l][e], v[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      su[L][e] = u[e];
      sv[L][e] = v[e];
    }
    fold_step<J + 1, V>(su, sv, elem);
  }
}

// Folds, for thread row g of G, the 64-row blocks {g + kG : k < 2^logK} of
// its strided set: each block by fold_step, then the blocks by contiguous
// halves in streaming order (block g + kG with g + (k + K/2)G first), with
// exact zeros for blocks past NB. These are the first levels of
// fold_partials over the NB padded to P = G * 2^logK blocks, so the G
// results per channel are partial rows that bn_finalize_kernel folds on.
// `block(blk, u, v)` folds one block. The stack of block partials has a
// runtime index and lives in local memory; it is touched once per block.
template <int V, class Block>
__device__ __forceinline__ void fold_strided(long long g, long long G,
                                             long long NB, int logK,
                                             const Block& block,
                                             float (&u)[V], float (&v)[V]) {
  float su[MAX_LOG_K + 1][V], sv[MAX_LOG_K + 1][V];
  const int K = 1 << logK;
  for (int j = 0; j < K; ++j) {
    const int k = logK ? static_cast<int>(__brev(j) >> (32 - logK)) : 0;
    const long long blk = g + static_cast<long long>(k) * G;
    if (blk < NB) {
      block(blk, u, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) u[e] = v[e] = 0.f;
    }
    int l = 0;
    while ((j >> l) & 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        u[e] = __fadd_rn(su[l][e], u[e]);
        v[e] = __fadd_rn(sv[l][e], v[e]);
      }
      ++l;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      su[l][e] = u[e];
      sv[l][e] = v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    u[e] = su[logK][e];
    v[e] = sv[logK][e];
  }
}

// ---------------------------------------------------------------------------
// row 4: partials of sum(x) and sum(exact_sq(x))
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_stats_partials_kernel(const T* __restrict__ x, float* __restrict__ psum,
                         float* __restrict__ psq, long long R, int C, int CVn,
                         long long NB, long long G, int logK) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  const long long g = tid / CVn;
  if (g >= G) return;
  const int c0 = static_cast<int>(tid - g * CVn) * V;
  long long row0 = 0;
  auto elem = [&](int r, float (&u)[V], float (&v)[V]) {
    const long long row = row0 + r;
    if (row < R) {
      Vec<T, V>::load(x + row * C + c0, u);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) u[e] = 0.f;   // exact-zero row padding
    }
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = exact_sq(u[e]);
  };
  auto block = [&](long long blk, float (&u)[V], float (&v)[V]) {
    float su[FOLD_LEVELS + 1][V], sv[FOLD_LEVELS + 1][V];
    row0 = blk * FOLD_BLOCK;
    fold_step<0, V>(su, sv, elem);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      u[e] = su[FOLD_LEVELS][e];
      v[e] = sv[FOLD_LEVELS][e];
    }
  };
  float u[V], v[V];
  fold_strided<V>(g, G, NB, logK, block, u, v);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    psum[g * C + c0 + e] = u[e];
    psq[g * C + c0 + e] = v[e];
  }
}

// ---------------------------------------------------------------------------
// row 6: partials of sum(dy') and sum(dy' * xhat)
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_bwd_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ g_,
                       const float* __restrict__ b,
                       const float* __restrict__ mean,
                       const float* __restrict__ var, float eps, int relu,
                       float* __restrict__ pdb, float* __restrict__ pdg,
                       long long R, int C, int CVn, long long NB, long long G,
                       int logK) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  const long long g = tid / CVn;
  if (g >= G) return;
  const int c0 = static_cast<int>(tid - g * CVn) * V;
  float m[V], inv[V], gg[V], bb[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = mean[c0 + e];
    inv[e] = inv_std(var[c0 + e], eps);
    gg[e] = g_[c0 + e];
    bb[e] = b[c0 + e];
  }
  long long row0 = 0;
  auto elem = [&](int r, float (&u)[V], float (&v)[V]) {
    const long long row = row0 + r;
    if (row < R) {
      float xv[V];
      Vec<T, V>::load(x + row * C + c0, xv);
      Vec<T, V>::load(dy + row * C + c0, u);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xv[e], m[e]), inv[e]);
        if (relu) {
          const float y = __fadd_rn(__fmul_rn(xh, gg[e]), bb[e]);
          u[e] = __fmul_rn(u[e], y > 0.f ? 1.f : 0.f);
        }
        v[e] = __fmul_rn(u[e], xh);
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) u[e] = v[e] = 0.f;
    }
  };
  auto block = [&](long long blk, float (&u)[V], float (&v)[V]) {
    float su[FOLD_LEVELS + 1][V], sv[FOLD_LEVELS + 1][V];
    row0 = blk * FOLD_BLOCK;
    fold_step<0, V>(su, sv, elem);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      u[e] = su[FOLD_LEVELS][e];
      v[e] = sv[FOLD_LEVELS][e];
    }
  };
  float u[V], v[V];
  fold_strided<V>(g, G, NB, logK, block, u, v);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    pdb[g * C + c0 + e] = u[e];
    pdg[g * C + c0 + e] = v[e];
  }
}

// ---------------------------------------------------------------------------
// second launch of rows 4 and 6: fold the G partial rows of each channel
// ---------------------------------------------------------------------------

// Block (FIN_CH, T): threadIdx.x picks the channel, threadIdx.y = t one of T
// lanes (T a power of two, T <= G). Lane t folds partial rows
// {t + kT : k < G/T} by contiguous halves in streaming order -- the next
// log2(G/T) levels of the tree -- and the lanes finish the last log2(T)
// levels in shared memory. mode 0 writes mean and var, mode 1 the two sums.
__global__ void bn_finalize_kernel(const float* __restrict__ pa,
                                   const float* __restrict__ pb, int logK,
                                   int C, float Rf, int mode,
                                   float* __restrict__ oa,
                                   float* __restrict__ ob) {
  __shared__ float sha[FIN_LANES][FIN_CH + 1];
  __shared__ float shb[FIN_LANES][FIN_CH + 1];
  const int c = blockIdx.x * FIN_CH + threadIdx.x;
  const int t = threadIdx.y;
  const int T = blockDim.y;
  const long long K = 1LL << logK;
  float stka[MAX_LOG_G + 1], stkb[MAX_LOG_G + 1];
  for (long long j = 0; j < K; ++j) {
    const long long k =
        logK ? static_cast<long long>(
                   __brevll(static_cast<unsigned long long>(j)) >> (64 - logK))
             : 0;
    const long long row = t + k * T;
    float a = 0.f, b = 0.f;
    if (c < C) {
      a = pa[row * C + c];
      b = pb[row * C + c];
    }
    int l = 0;
    while ((j >> l) & 1) {
      a = __fadd_rn(stka[l], a);
      b = __fadd_rn(stkb[l], b);
      ++l;
    }
    stka[l] = a;
    stkb[l] = b;
  }
  sha[t][threadIdx.x] = stka[logK];
  shb[t][threadIdx.x] = stkb[logK];
  for (int half = T / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (t < half) {
      sha[t][threadIdx.x] = __fadd_rn(sha[t][threadIdx.x],
                                      sha[t + half][threadIdx.x]);
      shb[t][threadIdx.x] = __fadd_rn(shb[t][threadIdx.x],
                                      shb[t + half][threadIdx.x]);
    }
  }
  if (t != 0 || c >= C) return;
  const float sa = sha[0][threadIdx.x];
  const float sb = shb[0][threadIdx.x];
  if (mode == 0) {
    const float mu = __fdiv_rn(sa, Rf);
    oa[c] = mu;
    ob[c] = max0(__fsub_rn(__fdiv_rn(sb, Rf), exact_sq(mu)));
  } else {
    oa[c] = sa;
    ob[c] = sb;
  }
}

// ---------------------------------------------------------------------------
// row 5: out = act(exact_mul(x - mean, inv * g) + b)
// ---------------------------------------------------------------------------

// The grid has exactly CVn * lanes threads and strides by that, so each
// thread keeps one channel vector and computes its constants once.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, const float* __restrict__ mean,
                const float* __restrict__ var, float eps, int relu,
                T* __restrict__ out, long long nvec, int CVn,
                long long nthreads) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (tid >= nthreads) return;
  const int c0 = static_cast<int>(tid % CVn) * V;
  float m[V], s[V], bb[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = mean[c0 + e];
    s[e] = __fmul_rn(inv_std(var[c0 + e], eps), g[c0 + e]);
    bb[e] = b[c0 + e];
  }
  for (long long i = tid; i < nvec; i += nthreads) {
    float v[V];
    Vec<T, V>::load(x + i * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float y = __fadd_rn(exact_mul(__fsub_rn(v[e], m[e]), s[e]), bb[e]);
      v[e] = relu ? max0(y) : y;
    }
    Vec<T, V>::store(out + i * V, v);
  }
}

// ---------------------------------------------------------------------------
// row 7: dx = (g*inv) * ((dy' - db/R) - xhat * (dg/R))
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ g, const float* __restrict__ b,
                 const float* __restrict__ mean,
                 const float* __restrict__ var,
                 const float* __restrict__ db, const float* __restrict__ dg,
                 float eps, int relu, float Rf, T* __restrict__ dx,
                 long long nvec, int CVn, long long nthreads) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  if (tid >= nthreads) return;
  const int c0 = static_cast<int>(tid % CVn) * V;
  float m[V], inv[V], gg[V], bb[V], gi[V], dbr[V], dgr[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = mean[c0 + e];
    inv[e] = inv_std(var[c0 + e], eps);
    gg[e] = g[c0 + e];
    bb[e] = b[c0 + e];
    gi[e] = __fmul_rn(gg[e], inv[e]);
    dbr[e] = __fdiv_rn(db[c0 + e], Rf);
    dgr[e] = __fdiv_rn(dg[c0 + e], Rf);
  }
  for (long long i = tid; i < nvec; i += nthreads) {
    float xv[V], d[V];
    Vec<T, V>::load(x + i * V, xv);
    Vec<T, V>::load(dy + i * V, d);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float xh = __fmul_rn(__fsub_rn(xv[e], m[e]), inv[e]);
      float dyf = d[e];
      if (relu) {
        const float y = __fadd_rn(__fmul_rn(xh, gg[e]), bb[e]);
        dyf = __fmul_rn(dyf, y > 0.f ? 1.f : 0.f);
      }
      d[e] = __fmul_rn(gi[e], __fsub_rn(__fsub_rn(dyf, dbr[e]),
                                        __fmul_rn(xh, dgr[e])));
    }
    Vec<T, V>::store(dx + i * V, d);
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int grid_for(long long threads) {
  const long long blocks = (threads + THREADS - 1) / THREADS;
  return blocks > 0x7fffffffLL ? -1 : static_cast<int>(blocks);
}

// Threads of an elementwise launch: a whole number of channel rows.
long long elementwise_threads(long long R, int CVn) {
  long long lanes = TARGET_THREADS / CVn;
  if (lanes < 1) lanes = 1;
  if (lanes > R) lanes = R;
  return lanes * CVn;
}

// The fold plan of an (R, C) reduction: NB 64-row blocks, padded to
// P = 2^logP; G = P / 2^logK partial rows, with 2^logK blocks folded per
// thread, K the smallest that keeps about FOLD_THREADS threads busy.
struct FoldPlan {
  long long NB, G;
  int logP, logK, CVn, V;
};

FoldPlan fold_plan(long long R, int C, bool vec) {
  FoldPlan f;
  f.V = vec ? FOLD_VEC : 1;
  f.CVn = C / f.V;
  f.NB = (R + FOLD_BLOCK - 1) / FOLD_BLOCK;
  f.logP = 0;
  while ((1LL << f.logP) < f.NB) ++f.logP;
  f.logK = 0;
  while (f.logK < f.logP && f.logK < MAX_LOG_K &&
         ((1LL << (f.logP - f.logK)) * f.CVn) > FOLD_THREADS)
    ++f.logK;
  f.G = 1LL << (f.logP - f.logK);
  return f;
}

// The finalize launch over the plan's G partial rows.
int finalize(const FoldPlan& f, const float* pa, const float* pb, int C,
             float Rf, int mode, float* oa, float* ob, cudaStream_t stream) {
  const int logG = f.logP - f.logK;
  const int logT = logG < 6 ? logG : 6;      // FIN_LANES = 64
  if (logG - logT > MAX_LOG_G) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(FIN_CH, 1 << logT);
  bn_finalize_kernel<<<(C + FIN_CH - 1) / FIN_CH, block, 0, stream>>>(
      pa, pb, logG - logT, C, Rf, mode, oa, ob);
  return static_cast<int>(cudaGetLastError());
}

// Row 4: partials, then finalize (mean, var). scratch holds 2 * P * C floats.
template <typename T>
int stats(const void* x, float* scratch, float* mean, float* var, long long R,
          int C, cudaStream_t stream) {
  const bool vec = C % FOLD_VEC == 0 && aligned(x, FOLD_VEC * sizeof(T));
  const FoldPlan f = fold_plan(R, C, vec);
  float* psum = scratch;
  float* psq = scratch + f.G * C;
  const int grid = grid_for(f.G * f.CVn);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec)
    bn_stats_partials_kernel<T, FOLD_VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), psum, psq, R, C, f.CVn, f.NB, f.G, f.logK);
  else
    bn_stats_partials_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), psum, psq, R, C, f.CVn, f.NB, f.G, f.logK);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return finalize(f, psum, psq, C, static_cast<float>(R), 0, mean, var,
                  stream);
}

// Row 6: partials, then finalize (dbeta, dgamma). scratch as for stats.
template <typename T>
int bwd_reduce(const void* x, const void* dy, const float* g, const float* b,
               const float* mean, const float* var, float eps, int relu,
               float* scratch, float* db, float* dg, long long R, int C,
               cudaStream_t stream) {
  const bool vec = C % FOLD_VEC == 0 && aligned(x, FOLD_VEC * sizeof(T)) &&
                   aligned(dy, FOLD_VEC * sizeof(T));
  const FoldPlan f = fold_plan(R, C, vec);
  float* pdb = scratch;
  float* pdg = scratch + f.G * C;
  const int grid = grid_for(f.G * f.CVn);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec)
    bn_bwd_partials_kernel<T, FOLD_VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), g, b, mean, var,
        eps, relu, pdb, pdg, R, C, f.CVn, f.NB, f.G, f.logK);
  else
    bn_bwd_partials_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), g, b, mean, var,
        eps, relu, pdb, pdg, R, C, f.CVn, f.NB, f.G, f.logK);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return finalize(f, pdb, pdg, C, static_cast<float>(R), 1, db, dg, stream);
}

template <typename T>
int apply(const void* x, const float* g, const float* b, const float* mean,
          const float* var, float eps, int relu, void* out, long long R,
          int C, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec = C % VW == 0 && aligned(x, 16) && aligned(out, 16);
  const int V = vec ? VW : 1;
  const int CVn = C / V;
  const long long nthreads = elementwise_threads(R, CVn);
  const int grid = grid_for(nthreads);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long nvec = R * CVn;
  if (vec)
    bn_apply_kernel<T, VW><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), g, b, mean, var, eps, relu,
        static_cast<T*>(out), nvec, CVn, nthreads);
  else
    bn_apply_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), g, b, mean, var, eps, relu,
        static_cast<T*>(out), nvec, CVn, nthreads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dx(const void* x, const void* dy, const float* g, const float* b,
           const float* mean, const float* var, const float* db,
           const float* dg, float eps, int relu, float Rf, void* dx,
           long long R, int C, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool vec = C % VW == 0 && aligned(x, 16) && aligned(dy, 16) &&
                   aligned(dx, 16);
  const int V = vec ? VW : 1;
  const int CVn = C / V;
  const long long nthreads = elementwise_threads(R, CVn);
  const int grid = grid_for(nthreads);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long nvec = R * CVn;
  if (vec)
    bn_bwd_dx_kernel<T, VW><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), g, b, mean, var,
        db, dg, eps, relu, Rf, static_cast<T*>(dx), nvec, CVn, nthreads);
  else
    bn_bwd_dx_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), g, b, mean, var,
        db, dg, eps, relu, Rf, static_cast<T*>(dx), nvec, CVn, nthreads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of its launches; kernels run on `stream`
// and are not waited for. x, dy, out and dx are contiguous (R, C) tensors of
// one dtype (bf16 or f32); g, b, mean, var, db, dg are (C,) float32.
// R >= 1 and C >= 1.

// Row 4 and its finalize: mean and var of each column. scratch: 2 * P * C
// floats, P = ceil(R/64) rounded up to a power of two.
int bn_stats_bf16(const void* x, float* scratch, float* mean, float* var,
                  long long R, int C, void* stream) {
  return stats<__nv_bfloat16>(x, scratch, mean, var, R, C,
                              static_cast<cudaStream_t>(stream));
}

int bn_stats_f32(const void* x, float* scratch, float* mean, float* var,
                 long long R, int C, void* stream) {
  return stats<float>(x, scratch, mean, var, R, C,
                      static_cast<cudaStream_t>(stream));
}

int bn_apply_bf16(const void* x, const float* g, const float* b,
                  const float* mean, const float* var, float eps, int relu,
                  void* out, long long R, int C, void* stream) {
  return apply<__nv_bfloat16>(x, g, b, mean, var, eps, relu, out, R, C,
                              static_cast<cudaStream_t>(stream));
}

int bn_apply_f32(const void* x, const float* g, const float* b,
                 const float* mean, const float* var, float eps, int relu,
                 void* out, long long R, int C, void* stream) {
  return apply<float>(x, g, b, mean, var, eps, relu, out, R, C,
                      static_cast<cudaStream_t>(stream));
}

// Row 6 and its finalize: db = sum dy', dg = sum dy' * xhat. scratch as for
// bn_stats.
int bn_bwd_reduce_bf16(const void* x, const void* dy, const float* g,
                       const float* b, const float* mean, const float* var,
                       float eps, int relu, float* scratch, float* db,
                       float* dg, long long R, int C, void* stream) {
  return bwd_reduce<__nv_bfloat16>(x, dy, g, b, mean, var, eps, relu,
                                   scratch, db, dg, R, C,
                                   static_cast<cudaStream_t>(stream));
}

int bn_bwd_reduce_f32(const void* x, const void* dy, const float* g,
                      const float* b, const float* mean, const float* var,
                      float eps, int relu, float* scratch, float* db,
                      float* dg, long long R, int C, void* stream) {
  return bwd_reduce<float>(x, dy, g, b, mean, var, eps, relu, scratch, db, dg,
                           R, C, static_cast<cudaStream_t>(stream));
}

int bn_bwd_dx_bf16(const void* x, const void* dy, const float* g,
                   const float* b, const float* mean, const float* var,
                   const float* db, const float* dg, float eps, int relu,
                   float Rf, void* dx, long long R, int C, void* stream) {
  return bwd_dx<__nv_bfloat16>(x, dy, g, b, mean, var, db, dg, eps, relu, Rf,
                               dx, R, C, static_cast<cudaStream_t>(stream));
}

int bn_bwd_dx_f32(const void* x, const void* dy, const float* g,
                  const float* b, const float* mean, const float* var,
                  const float* db, const float* dg, float eps, int relu,
                  float Rf, void* dx, long long R, int C, void* stream) {
  return bwd_dx<float>(x, dy, g, b, mean, var, db, dg, eps, relu, Rf, dx, R,
                       C, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
