// Flash attention for Hopper (sm_90a): the forward and the flash-2 backward
// pair.
//
//     o = softmax(q k^T * scale  [causal: col > row masked]) v,  q,k,v [B,H,S,D]
//
// Replaces the TPU kernels of mxnet_tpu/pallas_kernels/flash_attention.py:
//   _fwd_kernel (launched from _pallas_forward)  -> flash_fwd_*   (o, row lse)
//   _dq_kernel  (launched from _pallas_backward) -> flash_dq_*    dQ = sum_k dS K
//   _dkv_kernel (launched from _pallas_backward) -> flash_dkv_*   dV = sum_q P^T dO,
//                                                               dK = sum_q dS^T Q
// The TPU ran its grid in order, with the k (or q) axis innermost and the
// running state in VMEM scratch. Here one block owns one (batch*head, tile)
// and loops over the other axis itself, keeping the state in registers:
//   forward: a block per 64 query rows, 4 warps of 16 rows; k tiles of 64;
//   dQ:      a block per 64 query rows, looping over k tiles of 64;
//   dK/dV:   a block per 64 keys, 4 warps of 16 keys; q tiles of 32.
// dQ and dK/dV stay two launches, as on the TPU: neither needs float atomics,
// so two launches on the same inputs give the same bits.
//
// What bounds them on an H100: at the transformer LM's shapes (S = 2048,
// D = 128) each launch does O(S^2 D) tensor-core operations against O(S D)
// bytes, so they are bound by operations (989 TFLOP/s bf16). The design keeps
// the S x S score matrix out of device memory in both directions and feeds
// the tensor cores with mma.sync (m16n8k16, bf16 in, f32 accumulate); K/V
// (or Q/dO) tiles are double-buffered in shared memory with cp.async, so the
// next tile's load overlaps this tile's math. No wgmma, TMA or warp
// specialisation yet: this is the simple form.
//
// Numerics mirror the TPU kernels' rounding points: s = (q.k) * scale in f32
// after the dot (q is not pre-scaled); p = expf(s - m) in f32, rounded to the
// input dtype before P@V (forward) and before P^T@dO (dK/dV); dS =
// p * (dp - delta) * scale, each op rounded in f32, then rounded to the
// input dtype before dS@K and dS^T@Q; o is divided by l in f32 and only then
// cast; lse = m + log(l) in f32. Accurate expf and logf (no fast math).
// delta = rowsum(dO * O) comes in from the caller, as on the TPU.
//
// Masking: causal is left-aligned (col > row masked; the caller only passes
// Sq == Sk then). Tiles entirely above the diagonal are skipped. Padded rows
// and columns of a ragged last tile (S not a multiple of the tile) are loaded
// as zeros, masked out of every sum (p = 0), and never stored. Every row's
// first k tile holds its column 0, so the running max is finite after it and
// no exp(-inf - -inf) forms.
//
// f32 inputs run on the CUDA cores in full f32 (no TF32): one warp per
// query row (forward, dQ) or per key (dK/dV), one lane per key (or query) of
// a 32-wide tile, with the same tile-by-tile update as the TPU kernel.
//
// Layout: each tensor is [B, H, S, D] given by three element strides (batch,
// head, sequence) with the last dim contiguous; the wrapper checks that rows
// are 16-byte aligned. lse and delta are contiguous f32 [B*H, Sq].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;   // bf16 kernels: 4 warps
constexpr int BM = 64;         // query rows per forward / dQ block
constexpr int BN = 64;         // keys per k tile, and per dK/dV block
constexpr int BQ = 32;         // query rows per q tile of dK/dV
constexpr int F32_ROWS = 8;    // f32 kernels: warps (rows or keys) per block
constexpr int F32_TILE = 32;   // f32 kernels: keys (or queries) per tile

struct View {
  long long sb, sh, ss;        // element strides of batch, head, sequence
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;            // dO (backward)
  void* out;                   // o (forward) or dQ
  void* dk;
  void* dv;
  float* lse;                  // [B*H, Sq]: written by the forward
  const float* delta;          // [B*H, Sq]: rowsum(dO * O)
  View vq, vk, vv, vdo, vout, vdk, vdv;
  int H, Sq, Sk, causal;
  float scale;
};

__device__ __forceinline__ long long head_offset(const View& v, int bh,
                                                 int H) {
  return static_cast<long long>(bh / H) * v.sb +
         static_cast<long long>(bh % H) * v.sh;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows r0 .. r0+ROWS-1 of a [S, D] head (row stride ss) into shared memory
// with row pitch LD; rows at or past `rows` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int rows) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;             // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += blockDim.x) {
    int r = i / CPR;
    int c = (i - r * CPR) * 8;
    int gr = r0 + r;
    bool ok = gr < rows;
    cp_async16(dst + r * LD + c, ok ? src + gr * ss + c : src, ok ? 16 : 0);
  }
}

// A-operand fragments of the 16 x 16 block at (row0, col0) of a row-major
// shared tile with pitch LD.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int col0) {
  int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8);
}

// B-operand fragments of two 8-column n-tiles (n0, n0+8) at k-step k0, where
// the shared tile is stored [n][k] (B^T row-major): b[0..1] for n0,
// b[2..3] for n0+8.
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0) {
  int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LD + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same where the shared tile is stored [k][n] (B row-major).
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0) {
  int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                       n0 + ((lane >> 4) & 1) * 8);
}

// Last k tile (exclusive) that a block of query rows q0 .. q0+BM-1 visits.
__device__ __forceinline__ int k_tiles_for(const Params& p, int q0) {
  int n = (p.Sk + BN - 1) / BN;
  if (p.causal) {
    int last = min(q0 + BM, p.Sq) - 1;
    n = min(n, last / BN + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// bf16 forward
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem() { return (BM + 4 * BN) * (D + 8) * 2; }

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LD;               // 2 buffers of BN x LD
  bf16* Vs = Ks + 2 * BN * LD;           // 2 buffers of BN x LD

  const int bh = blockIdx.y;
  // heavy (late, causal) tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qh = static_cast<const bf16*>(p.q) + head_offset(p.vq, bh, p.H);
  const bf16* kh = static_cast<const bf16*>(p.k) + head_offset(p.vk, bh, p.H);
  const bf16* vh = static_cast<const bf16*>(p.v) + head_offset(p.vv, bh, p.H);
  const int nk = k_tiles_for(p, q0);

  load_rows<D, BM>(Qs, qh, p.vq.ss, q0, p.Sq);
  load_rows<D, BN>(Ks, kh, p.vk.ss, 0, p.Sk);
  load_rows<D, BN>(Vs, vh, p.vv.ss, 0, p.Sk);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0+8

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      int b = (j + 1) & 1;
      load_rows<D, BN>(Ks + b * BN * LD, kh, p.vk.ss, (j + 1) * BN, p.Sk);
      load_rows<D, BN>(Vs + b * BN * LD, vh, p.vv.ss, (j + 1) * BN, p.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        frag_a<LD>(qf[kk], Qs, warp * 16, kk * 16);
    }
    const bf16* Kt = Ks + (j & 1) * BN * LD;
    const bf16* Vt = Vs + (j & 1) * BN * LD;

    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t b[4];
        frag_b_nk<LD>(b, Kt, nn * 16, kk * 16);
        mma_bf16(s[2 * nn], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * nn + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask, running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int col = j * BN + nt * 8 + 2 * t + (i & 1);
        int row = row0 + (i >> 1) * 8;
        float x = __fmul_rn(s[nt][i], p.scale);
        if (col >= p.Sk || (p.causal && col > row)) x = -INFINITY;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(__fsub_rn(m[r], mx[r]));
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = expf(__fsub_rn(s[nt][i], mx[i >> 1]));
        s[nt][i] = e;
        rs[i >> 1] = __fadd_rn(rs[i >> 1], e);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 1));
      rs[r] = __fadd_rn(rs[r], __shfl_xor_sync(0xffffffffu, rs[r], 2));
      l[r] = __fadd_rn(__fmul_rn(corr[r], l[r]), rs[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] = __fmul_rn(o[dt][0], corr[0]);
      o[dt][1] = __fmul_rn(o[dt][1], corr[0]);
      o[dt][2] = __fmul_rn(o[dt][2], corr[1]);
      o[dt][3] = __fmul_rn(o[dt][3], corr[1]);
    }

    // o += bf16(p) @ v
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        frag_b_kn<LD>(b, Vt, kk * 16, dd * 16);
        mma_bf16(o[2 * dd], a, b[0], b[1]);
        mma_bf16(o[2 * dd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* oh = static_cast<bf16*>(p.out) + head_offset(p.vout, bh, p.H);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row0 + r * 8;
    if (row >= p.Sq) continue;
    bf16* orow = oh + row * p.vout.ss;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      __nv_bfloat162 v = __floats2bfloat162_rn(
          __fdiv_rn(o[dt][2 * r], l[r]), __fdiv_rn(o[dt][2 * r + 1], l[r]));
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t) = v;
    }
    if (t == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + row] =
          __fadd_rn(m[r], logf(l[r]));
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem() { return (2 * BM + 4 * BN) * (D + 8) * 2; }

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_bf16_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + BM * LD;               // dO rows
  bf16* Ks = Os + BM * LD;               // 2 buffers
  bf16* Vs = Ks + 2 * BN * LD;           // 2 buffers

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qh = static_cast<const bf16*>(p.q) + head_offset(p.vq, bh, p.H);
  const bf16* kh = static_cast<const bf16*>(p.k) + head_offset(p.vk, bh, p.H);
  const bf16* vh = static_cast<const bf16*>(p.v) + head_offset(p.vv, bh, p.H);
  const bf16* doh =
      static_cast<const bf16*>(p.dout) + head_offset(p.vdo, bh, p.H);
  const int nk = k_tiles_for(p, q0);

  load_rows<D, BM>(Qs, qh, p.vq.ss, q0, p.Sq);
  load_rows<D, BM>(Os, doh, p.vdo.ss, q0, p.Sq);
  load_rows<D, BN>(Ks, kh, p.vk.ss, 0, p.Sk);
  load_rows<D, BN>(Vs, vh, p.vv.ss, 0, p.Sk);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row0 + r * 8;
    long long at = static_cast<long long>(bh) * p.Sq + row;
    lse[r] = row < p.Sq ? p.lse[at] : 0.f;
    delta[r] = row < p.Sq ? p.delta[at] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      int b = (j + 1) & 1;
      load_rows<D, BN>(Ks + b * BN * LD, kh, p.vk.ss, (j + 1) * BN, p.Sk);
      load_rows<D, BN>(Vs + b * BN * LD, vh, p.vv.ss, (j + 1) * BN, p.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (j & 1) * BN * LD;
    const bf16* Vt = Vs + (j & 1) * BN * LD;

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a<LD>(aq, Qs, warp * 16, kk * 16);
      frag_a<LD>(ao, Os, warp * 16, kk * 16);
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t b[4];
        frag_b_nk<LD>(b, Kt, nn * 16, kk * 16);
        mma_bf16(s[2 * nn], aq, b[0], b[1]);
        mma_bf16(s[2 * nn + 1], aq, b[2], b[3]);
        frag_b_nk<LD>(b, Vt, nn * 16, kk * 16);
        mma_bf16(dp[2 * nn], ao, b[0], b[1]);
        mma_bf16(dp[2 * nn + 1], ao, b[2], b[3]);
      }
    }
    // dS = p * (dp - delta) * scale, p = exp(s*scale - lse); 0 where masked
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int col = j * BN + nt * 8 + 2 * t + (i & 1);
        int row = row0 + (i >> 1) * 8;
        bool keep = col < p.Sk && !(p.causal && col > row);
        float pv = keep ? expf(__fsub_rn(__fmul_rn(s[nt][i], p.scale),
                                         lse[i >> 1]))
                        : 0.f;
        s[nt][i] = __fmul_rn(__fmul_rn(pv, __fsub_rn(dp[nt][i],
                                                     delta[i >> 1])),
                             p.scale);
      }
    }
    // dq += bf16(dS) @ K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        frag_b_kn<LD>(b, Kt, kk * 16, dd * 16);
        mma_bf16(dq[2 * dd], a, b[0], b[1]);
        mma_bf16(dq[2 * dd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* dqh = static_cast<bf16*>(p.out) + head_offset(p.vout, bh, p.H);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = row0 + r * 8;
    if (row >= p.Sq) continue;
    bf16* drow = dqh + row * p.vout.ss;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(drow + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(dq[dt][2 * r], dq[dt][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dK / dV
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem() {
  return (2 * BN + 4 * BQ) * (D + 8) * 2 + 4 * BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_bf16_kernel(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;               // 2 buffers of BQ x LD
  bf16* Os = Qs + 2 * BQ * LD;           // dO: 2 buffers of BQ x LD
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * LD);  // 2 x BQ lse
  float* Ds = Ls + 2 * BQ;                                 // 2 x BQ delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qh = static_cast<const bf16*>(p.q) + head_offset(p.vq, bh, p.H);
  const bf16* kh = static_cast<const bf16*>(p.k) + head_offset(p.vk, bh, p.H);
  const bf16* vh = static_cast<const bf16*>(p.v) + head_offset(p.vv, bh, p.H);
  const bf16* doh =
      static_cast<const bf16*>(p.dout) + head_offset(p.vdo, bh, p.H);
  const float* lseh = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* deltah = p.delta + static_cast<long long>(bh) * p.Sq;
  // causal: query rows before k0 see none of this block's keys
  const int t0 = p.causal ? k0 / BQ : 0;
  const int nq = (p.Sq + BQ - 1) / BQ;

  auto load_q_tile = [&](int tq, int b) {
    load_rows<D, BQ>(Qs + b * BQ * LD, qh, p.vq.ss, tq * BQ, p.Sq);
    load_rows<D, BQ>(Os + b * BQ * LD, doh, p.vdo.ss, tq * BQ, p.Sq);
    for (int i = threadIdx.x; i < 2 * BQ; i += blockDim.x) {
      int r = i % BQ;
      int gr = tq * BQ + r;
      bool ok = gr < p.Sq;
      const float* src = i < BQ ? lseh : deltah;
      float* dst = (i < BQ ? Ls : Ds) + b * BQ + r;
      cp_async4(dst, ok ? src + gr : src, ok ? 4 : 0);
    }
  };

  load_rows<D, BN>(Ks, kh, p.vk.ss, k0, p.Sk);
  load_rows<D, BN>(Vs, vh, p.vv.ss, k0, p.Sk);
  if (t0 < nq) load_q_tile(t0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;   // this thread's keys: key0, key0+8

  for (int tq = t0; tq < nq; ++tq) {
    const int buf = (tq - t0) & 1;
    if (tq + 1 < nq) {
      load_q_tile(tq + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ * LD;
    const bf16* Ot = Os + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Ds + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<LD>(ak, Ks, warp * 16, kk * 16);
      frag_a<LD>(av, Vs, warp * 16, kk * 16);
#pragma unroll
      for (int nn = 0; nn < BQ / 16; ++nn) {
        uint32_t b[4];
        frag_b_nk<LD>(b, Qt, nn * 16, kk * 16);
        mma_bf16(st[2 * nn], ak, b[0], b[1]);
        mma_bf16(st[2 * nn + 1], ak, b[2], b[3]);
        frag_b_nk<LD>(b, Ot, nn * 16, kk * 16);
        mma_bf16(dpt[2 * nn], av, b[0], b[1]);
        mma_bf16(dpt[2 * nn + 1], av, b[2], b[3]);
      }
    }
    // P^T and dS^T; 0 where masked or past the last query row
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int c = nt * 8 + 2 * t + (i & 1);
        int row = tq * BQ + c;
        int key = key0 + (i >> 1) * 8;
        bool keep = row < p.Sq && !(p.causal && key > row);
        float pv = keep ? expf(__fsub_rn(__fmul_rn(st[nt][i], p.scale), Lt[c]))
                        : 0.f;
        st[nt][i] = pv;
        dpt[nt][i] = __fmul_rn(__fmul_rn(pv, __fsub_rn(dpt[nt][i], Dt[c])),
                               p.scale);
      }
    }
    // dV += bf16(P^T) @ dO;  dK += bf16(dS^T) @ Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                        pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                        pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                        pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      uint32_t ad[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                        pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                        pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                        pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        frag_b_kn<LD>(b, Ot, kk * 16, dd * 16);
        mma_bf16(dv[2 * dd], ap, b[0], b[1]);
        mma_bf16(dv[2 * dd + 1], ap, b[2], b[3]);
        frag_b_kn<LD>(b, Qt, kk * 16, dd * 16);
        mma_bf16(dk[2 * dd], ad, b[0], b[1]);
        mma_bf16(dk[2 * dd + 1], ad, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* dkh = static_cast<bf16*>(p.dk) + head_offset(p.vdk, bh, p.H);
  bf16* dvh = static_cast<bf16*>(p.dv) + head_offset(p.vdv, bh, p.H);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int key = key0 + r * 8;
    if (key >= p.Sk) continue;
    bf16* krow = dkh + key * p.vdk.ss;
    bf16* vrow = dvh + key * p.vdv.ss;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(krow + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 kernels (CUDA cores, full f32): one warp per row, one lane per column
// of a 32-wide tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows r0 .. r0+ROWS-1 of a [S, D] f32 head into shared memory (pitch LD);
// zero past `rows`. Plain loads: the f32 kernels serve checks, not speed.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows32(float* dst, const float* src,
                                            long long ss, int r0, int rows) {
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    int r = i / D, c = i - r * D;
    int gr = r0 + r;
    dst[r * LD + c] = gr < rows ? src[gr * ss + c] : 0.f;
  }
}

// row . tile[lane] over D, sequential FMA
template <int D, int LD>
__device__ __forceinline__ float dot_row(const float* a, const float* tile,
                                         int lane) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], tile[lane * LD + d], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_fwd_f32_kernel(Params p) {
  constexpr int LD = D + 1, T = F32_TILE, R = F32_ROWS, E = D / 32;
  __shared__ float Qs[R * D], Ks[T * LD], Vs[T * D];
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * R, row = r0 + warp;
  const float* qh = static_cast<const float*>(p.q) + head_offset(p.vq, bh, p.H);
  const float* kh = static_cast<const float*>(p.k) + head_offset(p.vk, bh, p.H);
  const float* vh = static_cast<const float*>(p.v) + head_offset(p.vv, bh, p.H);
  int nk = (p.Sk + T - 1) / T;
  if (p.causal) nk = min(nk, (min(r0 + R, p.Sq) - 1) / T + 1);

  load_rows32<D, D, R>(Qs, qh, p.vq.ss, r0, p.Sq);
  float o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    load_rows32<D, LD, T>(Ks, kh, p.vk.ss, j * T, p.Sk);
    load_rows32<D, D, T>(Vs, vh, p.vv.ss, j * T, p.Sk);
    __syncthreads();
    int col = j * T + lane;
    float s = __fmul_rn(dot_row<D, LD>(Qs + warp * D, Ks, lane), p.scale);
    if (col >= p.Sk || (p.causal && col > row)) s = -INFINITY;
    float mn = fmaxf(m, warp_max(s));
    float pv = expf(__fsub_rn(s, mn));
    float corr = expf(__fsub_rn(m, mn));
    l = __fadd_rn(__fmul_rn(corr, l), warp_sum(pv));
    m = mn;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float acc = 0.f;
      for (int jj = 0; jj < T; ++jj)
        acc = fmaf(__shfl_sync(0xffffffffu, pv, jj), Vs[jj * D + e * 32 + lane],
                   acc);
      o[e] = __fadd_rn(__fmul_rn(corr, o[e]), acc);
    }
  }
  if (row < p.Sq) {
    float* orow = static_cast<float*>(p.out) + head_offset(p.vout, bh, p.H) +
                  row * p.vout.ss;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e * 32 + lane] = __fdiv_rn(o[e], l);
    if (lane == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + row] = __fadd_rn(m, logf(l));
  }
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_dq_f32_kernel(Params p) {
  constexpr int LD = D + 1, T = F32_TILE, R = F32_ROWS, E = D / 32;
  __shared__ float Qs[R * D], Os[R * D], Ks[T * LD], Vs[T * LD];
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * R, row = r0 + warp;
  const float* qh = static_cast<const float*>(p.q) + head_offset(p.vq, bh, p.H);
  const float* kh = static_cast<const float*>(p.k) + head_offset(p.vk, bh, p.H);
  const float* vh = static_cast<const float*>(p.v) + head_offset(p.vv, bh, p.H);
  const float* doh =
      static_cast<const float*>(p.dout) + head_offset(p.vdo, bh, p.H);
  int nk = (p.Sk + T - 1) / T;
  if (p.causal) nk = min(nk, (min(r0 + R, p.Sq) - 1) / T + 1);
  long long at = static_cast<long long>(bh) * p.Sq + row;
  const float lse = row < p.Sq ? p.lse[at] : 0.f;
  const float delta = row < p.Sq ? p.delta[at] : 0.f;

  load_rows32<D, D, R>(Qs, qh, p.vq.ss, r0, p.Sq);
  load_rows32<D, D, R>(Os, doh, p.vdo.ss, r0, p.Sq);
  float dq[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dq[e] = 0.f;
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    load_rows32<D, LD, T>(Ks, kh, p.vk.ss, j * T, p.Sk);
    load_rows32<D, LD, T>(Vs, vh, p.vv.ss, j * T, p.Sk);
    __syncthreads();
    int col = j * T + lane;
    bool keep = col < p.Sk && !(p.causal && col > row);
    float s = __fmul_rn(dot_row<D, LD>(Qs + warp * D, Ks, lane), p.scale);
    float dp = dot_row<D, LD>(Os + warp * D, Vs, lane);
    float pv = keep ? expf(__fsub_rn(s, lse)) : 0.f;
    float ds = __fmul_rn(__fmul_rn(pv, __fsub_rn(dp, delta)), p.scale);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float acc = 0.f;
      for (int jj = 0; jj < T; ++jj)
        acc = fmaf(__shfl_sync(0xffffffffu, ds, jj),
                   Ks[jj * LD + e * 32 + lane], acc);
      dq[e] = __fadd_rn(dq[e], acc);
    }
  }
  if (row < p.Sq) {
    float* drow = static_cast<float*>(p.out) + head_offset(p.vout, bh, p.H) +
                  row * p.vout.ss;
#pragma unroll
    for (int e = 0; e < E; ++e) drow[e * 32 + lane] = dq[e];
  }
}

template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_dkv_f32_kernel(Params p) {
  constexpr int LD = D + 1, T = F32_TILE, R = F32_ROWS, E = D / 32;
  __shared__ float Ks[R * D], Vs[R * D], Qs[T * LD], Os[T * LD], Ls[T], Ds[T];
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * R, key = k0 + warp;
  const float* qh = static_cast<const float*>(p.q) + head_offset(p.vq, bh, p.H);
  const float* kh = static_cast<const float*>(p.k) + head_offset(p.vk, bh, p.H);
  const float* vh = static_cast<const float*>(p.v) + head_offset(p.vv, bh, p.H);
  const float* doh =
      static_cast<const float*>(p.dout) + head_offset(p.vdo, bh, p.H);
  const float* lseh = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* deltah = p.delta + static_cast<long long>(bh) * p.Sq;
  const int t0 = p.causal ? k0 / T : 0;
  const int nq = (p.Sq + T - 1) / T;

  load_rows32<D, D, R>(Ks, kh, p.vk.ss, k0, p.Sk);
  load_rows32<D, D, R>(Vs, vh, p.vv.ss, k0, p.Sk);
  float dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dk[e] = dv[e] = 0.f;
  for (int tq = t0; tq < nq; ++tq) {
    __syncthreads();
    load_rows32<D, LD, T>(Qs, qh, p.vq.ss, tq * T, p.Sq);
    load_rows32<D, LD, T>(Os, doh, p.vdo.ss, tq * T, p.Sq);
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      int gr = tq * T + i;
      Ls[i] = gr < p.Sq ? lseh[gr] : 0.f;
      Ds[i] = gr < p.Sq ? deltah[gr] : 0.f;
    }
    __syncthreads();
    int row = tq * T + lane;
    bool keep = row < p.Sq && !(p.causal && key > row);
    float s = __fmul_rn(dot_row<D, LD>(Ks + warp * D, Qs, lane), p.scale);
    float dp = dot_row<D, LD>(Vs + warp * D, Os, lane);
    float pv = keep ? expf(__fsub_rn(s, Ls[lane])) : 0.f;
    float ds = __fmul_rn(__fmul_rn(pv, __fsub_rn(dp, Ds[lane])), p.scale);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float av = 0.f, ak = 0.f;
      for (int ii = 0; ii < T; ++ii) {
        av = fmaf(__shfl_sync(0xffffffffu, pv, ii),
                  Os[ii * LD + e * 32 + lane], av);
        ak = fmaf(__shfl_sync(0xffffffffu, ds, ii),
                  Qs[ii * LD + e * 32 + lane], ak);
      }
      dv[e] = __fadd_rn(dv[e], av);
      dk[e] = __fadd_rn(dk[e], ak);
    }
  }
  if (key < p.Sk) {
    float* krow = static_cast<float*>(p.dk) + head_offset(p.vdk, bh, p.H) +
                  key * p.vdk.ss;
    float* vrow = static_cast<float*>(p.dv) + head_offset(p.vdv, bh, p.H) +
                  key * p.vdv.ss;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      krow[e * 32 + lane] = dk[e];
      vrow[e * 32 + lane] = dv[e];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plumbing
// ---------------------------------------------------------------------------

View view_at(const long long* st, int i) {
  return View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename K>
int launch(K kernel, int smem, dim3 grid, int threads, const Params& p,
           void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

enum Which { FWD = 0, DQ = 1, DKV = 2 };

int run(Which which, int f32, int D, const Params& p, int BH, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = which == DKV ? p.Sk : p.Sq;
  if (f32) {
    dim3 grid((rows + F32_ROWS - 1) / F32_ROWS, BH);
    const int th = F32_ROWS * 32;
    if (which == FWD)
      return D == 64 ? launch(flash_fwd_f32_kernel<64>, 0, grid, th, p, stream)
                     : launch(flash_fwd_f32_kernel<128>, 0, grid, th, p, stream);
    if (which == DQ)
      return D == 64 ? launch(flash_dq_f32_kernel<64>, 0, grid, th, p, stream)
                     : launch(flash_dq_f32_kernel<128>, 0, grid, th, p, stream);
    return D == 64 ? launch(flash_dkv_f32_kernel<64>, 0, grid, th, p, stream)
                   : launch(flash_dkv_f32_kernel<128>, 0, grid, th, p, stream);
  }
  if (which == FWD) {
    dim3 grid((rows + BM - 1) / BM, BH);
    return D == 64 ? launch(flash_fwd_bf16_kernel<64>, fwd_smem<64>(), grid,
                            THREADS, p, stream)
                   : launch(flash_fwd_bf16_kernel<128>, fwd_smem<128>(), grid,
                            THREADS, p, stream);
  }
  if (which == DQ) {
    dim3 grid((rows + BM - 1) / BM, BH);
    return D == 64 ? launch(flash_dq_bf16_kernel<64>, dq_smem<64>(), grid,
                            THREADS, p, stream)
                   : launch(flash_dq_bf16_kernel<128>, dq_smem<128>(), grid,
                            THREADS, p, stream);
  }
  dim3 grid((rows + BN - 1) / BN, BH);
  return D == 64 ? launch(flash_dkv_bf16_kernel<64>, dkv_smem<64>(), grid,
                          THREADS, p, stream)
                 : launch(flash_dkv_bf16_kernel<128>, dkv_smem<128>(), grid,
                          THREADS, p, stream);
}

Params base(const void* q, const void* k, const void* v, int H, int Sq,
            int Sk, int causal, float scale, const long long* st) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.vq = view_at(st, 0);
  p.vk = view_at(st, 1);
  p.vv = view_at(st, 2);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch, runs on `stream` and is
// not waited for. `f32` selects float32 tensors (else bfloat16); D is 64 or
// 128. `strides` (host memory) holds (batch, head, sequence) element strides
// of each [B, H, S, D] tensor in argument order; every row is 16-byte
// aligned with a contiguous last dim. lse and delta are contiguous f32
// [B*H, Sq]. B*H >= 1, Sq >= 1, Sk >= 1.

// Forward: o [B,H,Sq,D] and lse. strides: q, k, v, o.
int flash_fwd(int f32, const void* q, const void* k, const void* v, void* o,
              float* lse, int BH, int H, int Sq, int Sk, int D, int causal,
              float scale, const long long* strides, void* stream) {
  Params p = base(q, k, v, H, Sq, Sk, causal, scale, strides);
  p.out = o;
  p.vout = view_at(strides, 3);
  p.lse = lse;
  return run(FWD, f32, D, p, BH, stream);
}

// dQ. strides: q, k, v, dO, dQ.
int flash_dq(int f32, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta, void* dq,
             int BH, int H, int Sq, int Sk, int D, int causal, float scale,
             const long long* strides, void* stream) {
  Params p = base(q, k, v, H, Sq, Sk, causal, scale, strides);
  p.dout = dout;
  p.vdo = view_at(strides, 3);
  p.out = dq;
  p.vout = view_at(strides, 4);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  return run(DQ, f32, D, p, BH, stream);
}

// dK and dV. strides: q, k, v, dO, dK, dV.
int flash_dkv(int f32, const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              void* dk, void* dv, int BH, int H, int Sq, int Sk, int D,
              int causal, float scale, const long long* strides,
              void* stream) {
  Params p = base(q, k, v, H, Sq, Sk, causal, scale, strides);
  p.dout = dout;
  p.vdo = view_at(strides, 3);
  p.dk = dk;
  p.vdk = view_at(strides, 4);
  p.dv = dv;
  p.vdv = view_at(strides, 5);
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  return run(DKV, f32, D, p, BH, stream);
}

}  // extern "C"
