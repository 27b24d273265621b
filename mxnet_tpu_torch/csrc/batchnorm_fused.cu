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
//   _stats_kernel       -> bn_fold_kernel<StatsOp> (+ bn_finalize_kernel)
//   _apply_kernel       -> bn_apply_kernel
//   _bwd_reduce_kernel  -> bn_fold_kernel<BwdOp>   (+ bn_finalize_kernel)
//   _bwd_dx_kernel      -> bn_bwd_dx_kernel
// On the TPU the fold of the per-block partials and the mean/var formula ran
// as XLA ops; here they are a small second launch, bn_finalize_kernel, made
// by the same C entry point (bn_stats_*, bn_bwd_reduce_*).
//
// What bounds them on an H100: bytes. Each is one or two passes over R*C
// elements with a handful of f32 operations per element (stats: one read;
// apply: a read and a write; bwd reduce: two reads; bwd dx: two reads and
// a write). Apply and dx load 16-byte vectors along C from device memory.
//
// The two folds (rows 4 and 6) share one skeleton, bn_fold_kernel: one
// persistent block of FOLD_WARPS warps per SM walks a plan of items. An item
// is a slab of channels (Op::BS bytes of each row: 64 bf16 channels for the
// stats, 32 for the backward's two tensors) times one partial row c of
// G' = 2^logG; its warp h folds the 64-row blocks {c + G'h + G'Hk : k < K}
// (H = 2^logH warps, K = 2^logK blocks each). Each warp keeps its own ring
// of FOLD_STAGES stages in shared memory that its lane 0 fills by TMA, one
// 64-row box (of x, and of dy) per block, FOLD_STAGES blocks ahead of the
// fold, across item boundaries; so a block holds up to 192 KB of loads in
// flight per SM without spending registers on them, where the simple form
// (every thread folding 8 bytes a row through __ldg) held about a tenth of
// what the memory's latency asks for. The fold reads the staged box from
// shared memory, a 4-byte word (two bf16 or one f32 channel) per lane, so
// the access pattern no longer has to follow the tree: a warp reads whole
// 128-byte rows, conflict free, while the tree stays the JAX package's.
// Blocks past the tensor (the power-of-two padding) are not loaded; a
// block's rows past R are masked to exact zeros. When C's row pitch or a
// base is not 16-byte aligned, TMA cannot describe the tensor and the warps
// fill their stage with plain loads instead (the same fold).
//
// The tree, level by level (the fold_blocks/fold_partials tree exactly):
//  - a block's 64 rows by contiguous halves: lane (word w, row class j)
//    folds rows {j + JR m} over m in registers, in bit-reversed streaming
//    order with a binary-counter stack of compile-time indices, and
//    __shfl_down_sync folds the JR row classes (offsets JR/2 ... 1 in j);
//  - the K blocks of a warp, by contiguous halves in k (bit-reversed order
//    again; the stack of block sums is indexed by a switch on the counter's
//    trailing ones, so it too stays in registers); padding blocks add +0;
//  - the H warps of an item, by contiguous halves in h, in shared memory:
//    {c + G'm} is a subtree of the block tree, so the item's result is
//    partial row c;
//  - the G' partial rows, by contiguous halves, in bn_finalize_kernel (a
//    second launch: having the fold's last block do it measured slower).
// What bounds the folds now: the device memory's rate at the large shapes,
// and at the small ones the fixed cost of two launches and of filling the
// rings (a 7x7 batch-128 tensor is 6-26 MB, 2-8 us of bytes; the finalize
// launch alone takes about 2 us).
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
//    partial product is exact, with a plain product for non-finite inputs.
//    A bf16 value has 8 significant bits, so its split leaves a zero low
//    part and exact_sq(x) is the single product x*x, bit for bit: the bf16
//    stats fold takes that product;
//  - mean = sum / R and var = max(sumsq / R - exact_sq(mean), 0) divide by R
//    rounded to f32, in f32; a NaN variance stays NaN.
// The backward uses the same trees and the same rounded products, so it too
// equals the plain version's backward; its contract with the JAX package is a
// tolerance (the TPU kernel accumulated across row tiles in grid order).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int FOLD_BLOCK = 64;
constexpr int THREADS = 256;
constexpr long long TARGET_THREADS = 1LL << 18;  // elementwise kernels
constexpr int FOLD_WARPS = 8;         // warps of a fold block: H <= 8
constexpr int FOLD_STAGES = 3;        // ring depth of each warp
constexpr int FOLD_STAGE_BYTES = 8192;          // the boxes of one block
constexpr int FOLD_SMEM = 1024 + FOLD_WARPS * FOLD_STAGES * FOLD_STAGE_BYTES;
constexpr int MAX_LOG_K = 10;     // blocks per warp and item: at most 2^10
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
// rows 4 and 6: the persistent fold
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int brev_bits(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1) << (bits - 1 - i);
  return r;
}

__host__ __device__ constexpr int trailing_ones(int j) {
  int n = 0;
  while (j & 1) {
    ++n;
    j >>= 1;
  }
  return n;
}

__host__ __device__ constexpr int ilog2(int v) {
  int n = 0;
  while ((1 << n) < v) ++n;
  return n;
}

// How a warp reads a staged box of 64 rows x BS bytes of element type T:
// lane = j * LC + w reads the 4-byte word w (E channels) of rows
// {j + JR m : m < M}. JR consecutive rows are 128 bytes, so each read of
// the warp is one conflict-free 128-byte line.
template <typename T, int BS>
struct Lanes {
  static constexpr int E = 4 / sizeof(T);
  static constexpr int LC = BS / 4;
  static constexpr int JR = 32 / LC;
  static constexpr int M = FOLD_BLOCK / JR;
  static constexpr int LM = ilog2(M);
  static constexpr int S = BS / sizeof(T);   // channels of a slab
  static constexpr int N = 2 * E;            // folded values of a lane
};

template <typename T>
__device__ __forceinline__ T zero() {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(0.f);
  else return 0.f;
}

template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float (&f)[4 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    f[0] = __uint_as_float(w);
  }
}

// Row 4: u = x, v = x*x exactly (exact_sq; for bf16 the plain product, which
// equals it bit for bit, see the header).
template <typename T>
struct StatsOp {
  static constexpr int TENSORS = 1;
  static constexpr int BS = 128;
  __device__ __forceinline__ void slab(int, int) {}
  __device__ __forceinline__ void elem(float x, float, int, float& u,
                                       float& v) const {
    u = x;
    v = sizeof(T) == 2 ? __fmul_rn(x, x) : exact_sq(x);
  }
};

// Row 6: u = dy' (dy masked by relu(y) > 0), v = dy' * xhat.
template <typename T>
struct BwdOp {
  static constexpr int TENSORS = 2;
  static constexpr int BS = 64;
  static constexpr int E = 4 / sizeof(T);
  const float* g;
  const float* b;
  const float* mean;
  const float* var;
  float eps;
  int relu;
  float m[E], inv[E], gg[E], bb[E];
  // The constants of channels c0 .. c0+E-1 (zeros past C).
  __device__ __forceinline__ void slab(int c0, int C) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = c0 + e < C;
      m[e] = in ? mean[c0 + e] : 0.f;
      inv[e] = in ? inv_std(var[c0 + e], eps) : 0.f;
      gg[e] = in ? g[c0 + e] : 0.f;
      bb[e] = in ? b[c0 + e] : 0.f;
    }
  }
  __device__ __forceinline__ void elem(float x, float d, int e, float& u,
                                       float& v) const {
    const float xh = __fmul_rn(__fsub_rn(x, m[e]), inv[e]);
    if (relu) {
      const float y = __fadd_rn(__fmul_rn(xh, gg[e]), bb[e]);
      d = __fmul_rn(d, y > 0.f ? 1.f : 0.f);
    }
    u = d;
    v = __fmul_rn(d, xh);
  }
};

// Visit Jv of a lane's in-block fold: row j + JR*m, m = brev(Jv), merged
// into the binary-counter stack st (levels 0..LM, values u then v of each
// channel). Rows at or past `valid` are exact zeros when MASK.
template <int Jv, typename T, bool MASK, class Op>
__device__ __forceinline__ void fold_rows(
    const unsigned char* px, int j, int valid, const Op& op,
    float (&st)[Lanes<T, Op::BS>::LM + 1][Lanes<T, Op::BS>::N]) {
  using L = Lanes<T, Op::BS>;
  if constexpr (Jv < L::M) {
    constexpr int m = brev_bits(Jv, L::LM);
    constexpr int off = m * L::JR * Op::BS;
    float xs[L::E], ds[L::E], val[L::N];
    unpack<T>(*reinterpret_cast<const uint32_t*>(px + off), xs);
    if constexpr (Op::TENSORS == 2)
      unpack<T>(*reinterpret_cast<const uint32_t*>(px + FOLD_BLOCK * Op::BS +
                                                   off),
                ds);
#pragma unroll
    for (int e = 0; e < L::E; ++e) {
      op.elem(xs[e], Op::TENSORS == 2 ? ds[e] : 0.f, e, val[2 * e],
              val[2 * e + 1]);
      if (MASK && j + L::JR * m >= valid) val[2 * e] = val[2 * e + 1] = 0.f;
    }
    constexpr int T1 = trailing_ones(Jv);
#pragma unroll
    for (int l = 0; l < T1; ++l)
#pragma unroll
      for (int n = 0; n < L::N; ++n) val[n] = __fadd_rn(st[l][n], val[n]);
#pragma unroll
    for (int n = 0; n < L::N; ++n) st[T1][n] = val[n];
    fold_rows<Jv + 1, T, MASK>(px, j, valid, op, st);
  }
}

// One staged 64-row block: the lane's word of rows {j + JR m} folded in
// registers, then the JR row classes by shuffles. The lanes of row class 0
// hold the block's sums of their E channels.
template <typename T, bool MASK, class Op>
__device__ __forceinline__ void fold_block(
    const unsigned char* stage, int lane, int valid, const Op& op,
    float (&out)[Lanes<T, Op::BS>::N]) {
  using L = Lanes<T, Op::BS>;
  const int j = lane / L::LC;
  float st[L::LM + 1][L::N];
  fold_rows<0, T, MASK>(stage + j * Op::BS + (lane % L::LC) * 4, j, valid,
                        op, st);
#pragma unroll
  for (int n = 0; n < L::N; ++n) out[n] = st[L::LM][n];
#pragma unroll
  for (int o = L::JR / 2; o >= 1; o /= 2)
#pragma unroll
    for (int n = 0; n < L::N; ++n)
      out[n] = __fadd_rn(out[n],
                         __shfl_down_sync(0xffffffffu, out[n], o * L::LC));
}

// Pushes the value of visit J (t = trailing ones of J) onto the stack of
// block sums: it is folded with levels 0..t-1 and stored at level t. The
// switch keeps every index a compile-time constant.
template <int L, int N>
__device__ __forceinline__ void push(float (&stk)[MAX_LOG_K + 1][N],
                                     float (&v)[N], int t) {
  if constexpr (L < MAX_LOG_K) {
    if (t != L) {
      push<L + 1, N>(stk, v, t);
      return;
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = __fadd_rn(stk[l][n], v[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) stk[L][n] = v[n];
}

// The plan of a launch (kernels/batchnorm_fused.py:fold_plan): NB blocks
// padded to P = 2^(logG + logH + logK); items = ns << logG, item i being
// slab i % ns and partial row i / ns; pa, pb the (G', C) partial rows.
struct FoldArgs {
  long long R, NB;
  int C, ns, items, logG, logH, logK;
  float* pa;
  float* pb;
};

// A warp's stream of blocks to load: (item, J) in the order the fold visits
// them, skipping padding blocks (at or past NB).
struct Cursor {
  int item, J;
};

__device__ __forceinline__ long long block_of(const FoldArgs& a, int item,
                                              int h, int J) {
  const long long c = item / a.ns;
  const long long k = a.logK ? __brev(static_cast<unsigned>(J)) >>
                                   (32 - a.logK)
                             : 0;
  return c + (static_cast<long long>(h) << a.logG) +
         (k << (a.logG + a.logH));
}

__device__ __forceinline__ void cursor_next(const FoldArgs& a, int h,
                                            Cursor& q) {
  do {
    if (++q.J == (1 << a.logK)) {
      q.J = 0;
      q.item += gridDim.x;
    }
  } while (q.item < a.items && block_of(a, q.item, h, q.J) >= a.NB);
}

// Lane 0 fills `stage` with block blk of the slab from channel c0 on: a
// 64-row box of x (and of dy), completing on bar. The fence orders the
// warp's earlier reads of the stage before the TMA unit's writes.
template <class Op>
__device__ __forceinline__ void issue(const CUtensorMap* tmx,
                                      const CUtensorMap* tmdy,
                                      unsigned char* stage, uint64_t* bar,
                                      int c0, long long blk) {
  const int r0 = static_cast<int>(blk * FOLD_BLOCK);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, Op::TENSORS * FOLD_BLOCK * Op::BS);
  tma_load4(stage, tmx, c0, r0, 0, 0, bar);
  if constexpr (Op::TENSORS == 2)
    tma_load4(stage + FOLD_BLOCK * Op::BS, tmdy, c0, r0, 0, 0, bar);
}

template <typename T, bool TMA, class Op>
__global__ void __launch_bounds__(FOLD_WARPS * 32, 1)
bn_fold_kernel(const __grid_constant__ CUtensorMap tmx,
               const __grid_constant__ CUtensorMap tmdy,
               const T* __restrict__ x, const T* __restrict__ dy, Op op,
               FoldArgs a) {
  using L = Lanes<T, Op::BS>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[FOLD_WARPS][FOLD_STAGES];
  __shared__ float comb[2][FOLD_WARPS][2][L::S];
  unsigned char* ring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) &
                                    1023u);
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (TMA && lane == 0) {
    for (int st = 0; st < FOLD_STAGES; ++st) mbar_init(&full[h][st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool active = h < (1 << a.logH);
  const int K = 1 << a.logK;
  unsigned char* mine = ring + h * FOLD_STAGES * FOLD_STAGE_BYTES;
  const int w = lane % L::LC;

  // the warp's first FOLD_STAGES loads
  Cursor pq{static_cast<int>(blockIdx.x), -1};
  if (TMA && active) {
    cursor_next(a, h, pq);
    for (int st = 0; st < FOLD_STAGES && pq.item < a.items; ++st) {
      if (lane == 0)
        issue<Op>(&tmx, &tmdy, mine + st * FOLD_STAGE_BYTES, &full[h][st],
                  (pq.item % a.ns) * L::S, block_of(a, pq.item, h, pq.J));
      cursor_next(a, h, pq);
    }
  }

  int q = 0;   // real blocks consumed by this warp
  for (int item = blockIdx.x, t = 0; item < a.items;
       item += gridDim.x, ++t) {
    const int s = item % a.ns;
    const long long c = item / a.ns;
    op.slab(s * L::S + w * L::E, a.C);
    if (active) {
      float stk[MAX_LOG_K + 1][L::N];
      float v[L::N];
      for (int J = 0; J < K; ++J) {
        const long long blk = block_of(a, item, h, J);
        if (blk < a.NB) {
          const int st = q % FOLD_STAGES;
          unsigned char* stage = mine + st * FOLD_STAGE_BYTES;
          if constexpr (TMA) {
            mbar_wait(&full[h][st], (q / FOLD_STAGES) & 1);
          } else {
            // plain loads: the box TMA would have written, zeros outside
            __syncwarp();
            for (int i = lane; i < FOLD_BLOCK * L::S; i += 32) {
              const long long row = blk * FOLD_BLOCK + i / L::S;
              const int ch = s * L::S + i % L::S;
              const bool in = row < a.R && ch < a.C;
              T* sx = reinterpret_cast<T*>(stage) + i;
              *sx = in ? x[row * a.C + ch] : zero<T>();
              if constexpr (Op::TENSORS == 2)
                *reinterpret_cast<T*>(stage + FOLD_BLOCK * Op::BS +
                                      i * sizeof(T)) =
                    in ? dy[row * a.C + ch] : zero<T>();
            }
            __syncwarp();
          }
          const long long valid = a.R - blk * FOLD_BLOCK;
          if (valid < FOLD_BLOCK)
            fold_block<T, true>(stage, lane, static_cast<int>(valid), op, v);
          else
            fold_block<T, false>(stage, lane, FOLD_BLOCK, op, v);
          if constexpr (TMA) {
            __syncwarp();
            if (pq.item < a.items) {
              if (lane == 0)
                issue<Op>(&tmx, &tmdy, stage, &full[h][st],
                          (pq.item % a.ns) * L::S,
                          block_of(a, pq.item, h, pq.J));
              cursor_next(a, h, pq);
            }
          }
          ++q;
        } else {
#pragma unroll
          for (int n = 0; n < L::N; ++n) v[n] = 0.f;   // padding adds +0
        }
        push<0, L::N>(stk, v, __ffs(~J) - 1);
      }
      // after visit K-1, v is the fold of the warp's K blocks
      if (lane < L::LC)
#pragma unroll
        for (int e = 0; e < L::E; ++e) {
          comb[t & 1][h][0][w * L::E + e] = v[2 * e];
          comb[t & 1][h][1][w * L::E + e] = v[2 * e + 1];
        }
    }
    __syncthreads();
    if (h == 0) {
      // the item's H warps by contiguous halves: partial row c of slab s
      const int H = 1 << a.logH;
      for (int i = lane; i < 2 * L::S; i += 32) {
        const int u = i / L::S, ch = i % L::S;
        float f[FOLD_WARPS];
#pragma unroll
        for (int k = 0; k < FOLD_WARPS; ++k)
          f[k] = k < H ? comb[t & 1][k][u][ch] : 0.f;
#pragma unroll
        for (int half = FOLD_WARPS / 2; half >= 1; half /= 2)
          if (half < H)
#pragma unroll
            for (int k = 0; k < half; ++k) f[k] = __fadd_rn(f[k], f[k + half]);
        const int col = s * L::S + ch;
        if (col < a.C) (u ? a.pb : a.pa)[c * a.C + col] = f[0];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// second launch of rows 4 and 6: fold the G' partial rows of each channel
// ---------------------------------------------------------------------------

// Block (FIN_CH, T): threadIdx.x picks the channel, threadIdx.y = t one of T
// lanes (T a power of two, T <= G'). Lane t folds partial rows
// {t + kT : k < G'/T} by contiguous halves in streaming order -- the next
// log2(G'/T) levels of the tree -- and the lanes finish the last log2(T)
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

// The finalize launch over the plan's G' = 2^logG partial rows.
int finalize(int logG, const float* pa, const float* pb, int C, float Rf,
             int mode, float* oa, float* ob, cudaStream_t stream) {
  const int logT = logG < 6 ? logG : 6;      // FIN_LANES = 64
  if (logG - logT > MAX_LOG_G) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(FIN_CH, 1 << logT);
  bn_finalize_kernel<<<(C + FIN_CH - 1) / FIN_CH, block, 0, stream>>>(
      pa, pb, logG - logT, C, Rf, mode, oa, ob);
  return static_cast<int>(cudaGetLastError());
}

// The fold launch of rows 4 and 6 under the wrapper's plan (logG, logH,
// logK, grid): checks it against (R, C), then launches bn_fold_kernel by
// TMA where the tensors allow it, by plain loads where not. scratch holds
// the two (G', C) float arrays of partial rows.
template <typename T, class Op>
int fold(const void* x, const void* dy, const Op& op, float* scratch,
         long long R, int C, int logG, int logH, int logK, int grid,
         cudaStream_t stream) {
  using L = Lanes<T, Op::BS>;
  FoldArgs a;
  a.R = R;
  a.C = C;
  a.NB = (R + FOLD_BLOCK - 1) / FOLD_BLOCK;
  int logP = 0;
  while ((1LL << logP) < a.NB) ++logP;
  const long long ns = (C + L::S - 1) / L::S;
  if (R < 1 || C < 1 || R > 0x7fffffffLL - FOLD_BLOCK || logG < 0 ||
      logH < 0 || (1 << logH) > FOLD_WARPS || logK < 0 || logK > MAX_LOG_K ||
      logG + logH + logK != logP || logG > 30 ||
      (ns << logG) > 0x7fffffffLL || grid < 1 || grid > (ns << logG))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ns = static_cast<int>(ns);
  a.items = static_cast<int>(ns << logG);
  a.logG = logG;
  a.logH = logH;
  a.logK = logK;
  a.pa = scratch;
  a.pb = scratch + (1LL << logG) * C;
  const bool tma = (static_cast<long long>(C) * sizeof(T)) % 16 == 0 &&
                   aligned(x, 16) && (Op::TENSORS == 1 || aligned(dy, 16));
  // A runtime call before the tensor maps: it makes the device's context
  // current in this thread, which the driver's encoder needs (autograd's
  // backward thread may have made no CUDA call yet).
  auto kernel =
      tma ? bn_fold_kernel<T, true, Op> : bn_fold_kernel<T, false, Op>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FOLD_SMEM));
  if (err != 0) return err;
  CUtensorMap tmx, tmdy;
  memset(&tmx, 0, sizeof(tmx));
  memset(&tmdy, 0, sizeof(tmdy));
  if (tma) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(R), 1, 1};
    const cuuint32_t box[4] = {L::S, FOLD_BLOCK, 1, 1};
    const CUtensorMapDataType dt = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    err = encode_tiled(&tmx, x, 4, dims, box, nullptr, dt,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == 0 && Op::TENSORS == 2)
      err = encode_tiled(&tmdy, dy, 4, dims, box, nullptr, dt,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  kernel<<<grid, FOLD_WARPS * 32, FOLD_SMEM, stream>>>(
      tmx, tmdy, static_cast<const T*>(x), static_cast<const T*>(dy), op, a);
  return static_cast<int>(cudaGetLastError());
}

// Row 4: the fold, then finalize (mean, var).
template <typename T>
int stats(const void* x, float* scratch, float* mean, float* var, long long R,
          int C, int logG, int logH, int logK, int grid,
          cudaStream_t stream) {
  const int err = fold<T>(x, nullptr, StatsOp<T>{}, scratch, R, C, logG,
                          logH, logK, grid, stream);
  if (err != 0) return err;
  return finalize(logG, scratch, scratch + (1LL << logG) * C, C,
                  static_cast<float>(R), 0, mean, var, stream);
}

// Row 6: the fold, then finalize (dbeta, dgamma).
template <typename T>
int bwd_reduce(const void* x, const void* dy, const float* g, const float* b,
               const float* mean, const float* var, float eps, int relu,
               float* scratch, float* db, float* dg, long long R, int C,
               int logG, int logH, int logK, int grid, cudaStream_t stream) {
  BwdOp<T> op;
  op.g = g;
  op.b = b;
  op.mean = mean;
  op.var = var;
  op.eps = eps;
  op.relu = relu;
  const int err = fold<T>(x, dy, op, scratch, R, C, logG, logH, logK, grid,
                          stream);
  if (err != 0) return err;
  return finalize(logG, scratch, scratch + (1LL << logG) * C, C,
                  static_cast<float>(R), 1, db, dg, stream);
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

// Row 4 and its finalize: mean and var of each column, under the plan
// (logG, logH, logK, grid) of kernels/batchnorm_fused.py:fold_plan.
// scratch: 2 * 2^logG * C floats.
int bn_stats_bf16(const void* x, float* scratch, float* mean, float* var,
                  long long R, int C, int logG, int logH, int logK, int grid,
                  void* stream) {
  return stats<__nv_bfloat16>(x, scratch, mean, var, R, C, logG, logH, logK,
                              grid, static_cast<cudaStream_t>(stream));
}

int bn_stats_f32(const void* x, float* scratch, float* mean, float* var,
                 long long R, int C, int logG, int logH, int logK, int grid,
                 void* stream) {
  return stats<float>(x, scratch, mean, var, R, C, logG, logH, logK, grid,
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

// Row 6 and its finalize: db = sum dy', dg = sum dy' * xhat. Plan and
// scratch as for bn_stats.
int bn_bwd_reduce_bf16(const void* x, const void* dy, const float* g,
                       const float* b, const float* mean, const float* var,
                       float eps, int relu, float* scratch, float* db,
                       float* dg, long long R, int C, int logG, int logH,
                       int logK, int grid, void* stream) {
  return bwd_reduce<__nv_bfloat16>(x, dy, g, b, mean, var, eps, relu,
                                   scratch, db, dg, R, C, logG, logH, logK,
                                   grid, static_cast<cudaStream_t>(stream));
}

int bn_bwd_reduce_f32(const void* x, const void* dy, const float* g,
                      const float* b, const float* mean, const float* var,
                      float eps, int relu, float* scratch, float* db,
                      float* dg, long long R, int C, int logG, int logH,
                      int logK, int grid, void* stream) {
  return bwd_reduce<float>(x, dy, g, b, mean, var, eps, relu, scratch, db, dg,
                           R, C, logG, logH, logK, grid,
                           static_cast<cudaStream_t>(stream));
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
