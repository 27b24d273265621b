// Fused scale-bias-ReLU + 3x3 convolution for Hopper (sm_90a): the forward
// and its backward pair.
//
//     out = conv3x3(relu(x * s + b), W)      stride 1, SAME padding, NHWC
//
// Replaces the TPU kernels of mxnet_tpu/pallas_kernels/conv_fused.py:
//   _fwd_kernel    (launched from _pallas_forward)   -> conv_fused_fwd_*
//   _bwd_dx_kernel (launched from _pallas_backward)  -> conv_fused_bwd_dx_*
//                                                      + conv_fused_bwd_finalize
//   _bwd_dw_kernel (launched from _pallas_backward)  -> conv_fused_bwd_dw_*
//                                                      + conv_fused_dw_reduce
// The normalize/ReLU chain of the preceding BatchNorm is applied while an
// input tile is loaded into shared memory, so the activated tensor never
// exists in device memory, in either direction.
//
// What bounds them on an H100: each launch does 2*N*H*W*9*Ci*Co operations
// against one read of x (and dy) and W and one write of the result; in bf16
// the two bounds are about equal at ResNet-50's shapes. The design keeps the
// bytes at that floor (each block reads its input tile plus a one-pixel halo
// once per channel chunk; all nine taps then read it from shared memory) and
// feeds the tensor cores with mma.sync (m16n8k16, bf16 in, f32 accumulate).
// It is the simple form: no TMA, no wgmma, no pipelining of the loads
// against the math; those come later.
//
// Forward, implicit GEMM: rows are output pixels, columns output channels,
// and the reduction runs over (tap, input channel) with the weight matrix
// laid out tap-major as (9*Ci, Co), row (ky*3+kx)*Ci + ci -- the same order
// as the TPU kernel's im2col patches.
//
// d-input: the same implicit GEMM with the roles swapped. The operand is dy
// (Co channels, loaded as it is), the weights are W flipped in space and
// transposed to (9*Co, Ci) (the wrapper prepares them, as _pallas_backward
// does), and the result dz has Ci channels. The epilogue recomputes
// pre = x*s + b with the forward's roundings, masks dz with pre > 0, writes
// dx = dpre*s, and folds dpre*x and dpre into per-block, per-channel f32
// partials. The TPU summed those across its sequential grid; here a second
// launch (finalize) folds the block partials in a fixed order into ds, db.
//
// d-weight: a GEMM with M = 9*Ci (tap, input channel), N = Co and K = the
// N*H*W output pixels. Operand A is z = relu(x*s + b) over the pixel's
// shifted neighbourhood, built on the halo load with the forward's rule;
// operand B is the dy rows. K runs to 401408 at 56x56 while M x N is only
// 576 x 64, so K is split over a fixed partition of the pixel tiles: each
// block sums its share into f32 partials and a reduce launch adds the
// partials in a fixed order. No float atomics anywhere, so every run gives
// the same bits.
//
// The batch is walked as one tall "virtual" image: image n occupies virtual
// rows n*(H+1) .. n*(H+1)+H-1 and virtual row n*(H+1)+H is a zero separator
// that serves as the bottom padding of image n and the top padding of image
// n+1. A block owns a TH x TW tile of that virtual image, so small feature
// maps (7x7) share a block across images instead of leaving most of a tile
// empty. Outputs on separator rows or past the right edge are not stored
// (and take no part in the backward sums).
//
// Padding lives in activated space: the halo outside the image is zero after
// the activation, not relu(0*s+b).
//
// Numerics follow the TPU kernel's _act/_compute_dtype: for bf16 input, s
// and b are rounded to bf16, then x*s and +b are each rounded to bf16 (no
// FMA contraction); for f32 the product and sum are separate f32 ops.
// Accumulation is f32. The f32 kernels run on the CUDA cores with FMA (no
// TF32), so their results differ from a float32 reference only by
// summation order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;                 // output tile: virtual rows
constexpr int TW = 8;                  // output tile: columns (128 pixels)
constexpr int TP = TH * TW;
constexpr int BN = 64;                 // output channels per block
constexpr int HALO_W = TW + 2;
constexpr int HALO_P = (TH + 2) * HALO_W;  // 180 halo pixels
constexpr int THREADS = 256;
constexpr int DW_THREADS = 288;        // d-weight: one warp per tap
constexpr unsigned FULL = 0xffffffffu;

// bf16 kernels: 32 input channels per chunk; rows padded so that ldmatrix
// row addresses fall in distinct banks (80-byte and 144-byte strides).
constexpr int CK16 = 32;
constexpr int LDH16 = CK16 + 8;
constexpr int LDB16 = BN + 8;
constexpr int SMEM16 = (HALO_P * LDH16 + 9 * CK16 * LDB16) * 2;
constexpr int SMEM_DW16 = (HALO_P * LDH16 + TP * LDB16) * 2;

// f32 kernels: 16 input channels per chunk.
constexpr int CK32 = 16;
constexpr int LDH32 = CK32 + 1;
constexpr int LDB32 = BN + 4;
constexpr int SMEM32 = (HALO_P * LDH32 + 9 * CK32 * LDB32) * 4;
constexpr int SMEM_DW32 = (HALO_P * LDH32 + TP * LDB32) * 4;

struct Geom {
  int N, H, W;
  int Ci, Co;     // channels of the tile operand and of the result
  int V;          // virtual rows: N*(H+1) - 1
  int col_tiles;  // ceil(W / TW)
  int relu;       // the ReLU of the fused activation
  int act;        // apply the scale-bias(-ReLU) on the halo load
  int xvec;       // rows of the halo operand may be read 16 bytes at a time
  int wvec;       // rows of w (or of dy, in d-weight) likewise
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float act32(float x, float s, float b, int relu) {
  float v = __fadd_rn(__fmul_rn(x, s), b);
  return (relu && v < 0.f) ? 0.f : v;
}

// s16 and b16 are s and b already rounded to bf16.
__device__ __forceinline__ float act16(float x, float s16, float b16,
                                       int relu) {
  float v = bf16_round(__fmul_rn(x, s16));
  v = bf16_round(__fadd_rn(v, b16));
  return (relu && v < 0.f) ? 0.f : v;
}

// Locates halo pixel p of the tile whose top-left output is (r0, c0).
// Returns the element offset of that pixel's channel 0 in the tile operand,
// or -1 where the pixel is padding (outside the image, or on a separator).
__device__ __forceinline__ long long halo_offset(const Geom& g, int r0,
                                                 int c0, int p) {
  int hy = p / HALO_W;
  int vr = r0 - 1 + hy;
  int c = c0 - 1 + (p - hy * HALO_W);
  if (vr < 0 || vr >= g.V || c < 0 || c >= g.W) return -1;
  int n = vr / (g.H + 1);
  int h = vr - n * (g.H + 1);
  if (h >= g.H) return -1;
  return ((static_cast<long long>(n) * g.H + h) * g.W + c) * g.Ci;
}

// Output pixel m of the tile -> element offset of its channel 0 in a tensor
// of g.Co channels, or -1 where nothing is stored.
__device__ __forceinline__ long long out_offset(const Geom& g, int r0, int c0,
                                                int m) {
  int vr = r0 + m / TW;
  int c = c0 + m % TW;
  if (vr >= g.V || c >= g.W) return -1;
  int n = vr / (g.H + 1);
  int h = vr - n * (g.H + 1);
  if (h >= g.H) return -1;
  return ((static_cast<long long>(n) * g.H + h) * g.W + c) * g.Co;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// ---------------------------------------------------------------------------
// Shared-memory fills (any block size)
// ---------------------------------------------------------------------------

// Halo tile of channels ci0 .. ci0+CK16 of the operand, activated when g.act.
__device__ void fill_halo16(__nv_bfloat16* Hs, const __nv_bfloat16* x,
                            const float* s, const float* b, const Geom& g,
                            int r0, int c0, int ci0) {
  constexpr int VPP = CK16 / 8;  // 16-byte vectors per halo pixel
  for (int idx = threadIdx.x; idx < HALO_P * VPP; idx += blockDim.x) {
    int p = idx / VPP;
    int v = idx - p * VPP;
    int ci = ci0 + v * 8;
    long long off = halo_offset(g, r0, c0, p);
    __align__(16) __nv_bfloat16 o[8];
    if (off >= 0 && g.xvec && ci + 8 <= g.Ci) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + off + ci));
      if (g.act) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v16 = act16(__bfloat162float(e[j]),
                            bf16_round(__ldg(s + ci + j)),
                            bf16_round(__ldg(b + ci + j)), g.relu);
          o[j] = __float2bfloat16_rn(v16);
        }
      } else {
        *reinterpret_cast<uint4*>(o) = raw;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v16 = 0.f;
        if (off >= 0 && ci + j < g.Ci) {
          v16 = __bfloat162float(x[off + ci + j]);
          if (g.act)
            v16 = act16(v16, bf16_round(__ldg(s + ci + j)),
                        bf16_round(__ldg(b + ci + j)), g.relu);
        }
        o[j] = __float2bfloat16_rn(v16);
      }
    }
    *reinterpret_cast<uint4*>(Hs + p * LDH16 + v * 8) =
        *reinterpret_cast<const uint4*>(o);
  }
}

// Weight chunk: rows tap*CK16 + j hold W[(tap*Ci + ci0 + j), co0 .. co0+BN).
__device__ void fill_w16(__nv_bfloat16* Bs, const __nv_bfloat16* w,
                         const Geom& g, int ci0, int co0) {
  constexpr int VPR = BN / 8;
  for (int idx = threadIdx.x; idx < 9 * CK16 * VPR; idx += blockDim.x) {
    int kr = idx / VPR;
    int v = idx - kr * VPR;
    int tap = kr / CK16;
    int ci = ci0 + (kr - tap * CK16);
    int co = co0 + v * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ci < g.Ci) {
      const __nv_bfloat16* src =
          w + (static_cast<long long>(tap) * g.Ci + ci) * g.Co + co;
      if (g.wvec && co + 8 <= g.Co) {
        val = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = (co + j < g.Co) ? src[j] : __float2bfloat16_rn(0.f);
        val = *reinterpret_cast<const uint4*>(o);
      }
    }
    *reinterpret_cast<uint4*>(Bs + kr * LDB16 + v * 8) = val;
  }
}

// dy rows of the tile's output pixels: Ds[m][0 .. BN) = dy[pixel m,
// co0 ..], zero where pixel m is not stored or the channel is past Co.
__device__ void fill_dy16(__nv_bfloat16* Ds, const __nv_bfloat16* dy,
                          const Geom& g, int r0, int c0, int co0) {
  constexpr int VPR = BN / 8;
  for (int idx = threadIdx.x; idx < TP * VPR; idx += blockDim.x) {
    int m = idx / VPR;
    int v = idx - m * VPR;
    int co = co0 + v * 8;
    long long off = out_offset(g, r0, c0, m);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (off >= 0) {
      if (g.wvec && co + 8 <= g.Co) {
        val = __ldg(reinterpret_cast<const uint4*>(dy + off + co));
      } else {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = (co + j < g.Co) ? dy[off + co + j] : __float2bfloat16_rn(0.f);
        val = *reinterpret_cast<const uint4*>(o);
      }
    }
    *reinterpret_cast<uint4*>(Ds + m * LDB16 + v * 8) = val;
  }
}

__device__ void fill_halo32(float* Hs, const float* x, const float* s,
                            const float* b, const Geom& g, int r0, int c0,
                            int ci0) {
  constexpr int VPP = CK32 / 4;
  for (int idx = threadIdx.x; idx < HALO_P * VPP; idx += blockDim.x) {
    int p = idx / VPP;
    int v = idx - p * VPP;
    int ci = ci0 + v * 4;
    long long off = halo_offset(g, r0, c0, p);
    float o[4];
    if (off >= 0 && g.xvec && ci + 4 <= g.Ci) {
      float4 raw = __ldg(reinterpret_cast<const float4*>(x + off + ci));
      o[0] = raw.x;
      o[1] = raw.y;
      o[2] = raw.z;
      o[3] = raw.w;
      if (g.act) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = act32(o[j], __ldg(s + ci + j), __ldg(b + ci + j), g.relu);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = 0.f;
        if (off >= 0 && ci + j < g.Ci) {
          o[j] = x[off + ci + j];
          if (g.act)
            o[j] = act32(o[j], __ldg(s + ci + j), __ldg(b + ci + j), g.relu);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Hs[p * LDH32 + v * 4 + j] = o[j];
  }
}

__device__ void fill_w32(float* Bs, const float* w, const Geom& g, int ci0,
                         int co0) {
  constexpr int VPR = BN / 4;
  for (int idx = threadIdx.x; idx < 9 * CK32 * VPR; idx += blockDim.x) {
    int kr = idx / VPR;
    int v = idx - kr * VPR;
    int tap = kr / CK32;
    int ci = ci0 + (kr - tap * CK32);
    int co = co0 + v * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ci < g.Ci) {
      const float* src =
          w + (static_cast<long long>(tap) * g.Ci + ci) * g.Co + co;
      if (g.wvec && co + 4 <= g.Co) {
        val = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        val.x = (co < g.Co) ? src[0] : 0.f;
        val.y = (co + 1 < g.Co) ? src[1] : 0.f;
        val.z = (co + 2 < g.Co) ? src[2] : 0.f;
        val.w = (co + 3 < g.Co) ? src[3] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(Bs + kr * LDB32 + v * 4) = val;
  }
}

__device__ void fill_dy32(float* Ds, const float* dy, const Geom& g, int r0,
                          int c0, int co0) {
  constexpr int VPR = BN / 4;
  for (int idx = threadIdx.x; idx < TP * VPR; idx += blockDim.x) {
    int m = idx / VPR;
    int v = idx - m * VPR;
    int co = co0 + v * 4;
    long long off = out_offset(g, r0, c0, m);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off >= 0) {
      const float* src = dy + off + co;
      if (g.wvec && co + 4 <= g.Co) {
        val = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        val.x = (co < g.Co) ? src[0] : 0.f;
        val.y = (co + 1 < g.Co) ? src[1] : 0.f;
        val.z = (co + 2 < g.Co) ? src[2] : 0.f;
        val.w = (co + 3 < g.Co) ? src[3] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(Ds + m * LDB32 + v * 4) = val;
  }
}

// ---------------------------------------------------------------------------
// bf16 implicit GEMM core (forward and d-input): tensor cores
// ---------------------------------------------------------------------------

// Accumulates the block's 128 x 64 output tile into acc: warp (warp_m,
// warp_n) owns pixels warp_m*32 .. +32 and channels warp_n*32 .. +32.
__device__ __forceinline__ void core16(float (&acc)[2][4][4],
                                       const __nv_bfloat16* x, const float* s,
                                       const float* b, const __nv_bfloat16* w,
                                       const Geom& g, int r0, int c0, int co0,
                                       __nv_bfloat16* Hs, __nv_bfloat16* Bs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp & 3;   // 4 warps over the 128 pixels (32 each)
  const int warp_n = warp >> 2;  // 2 warps over the 64 channels (32 each)
  const int q = lane >> 3;       // ldmatrix: which 8x8 matrix this lane
  const int r = lane & 7;        //           addresses, and which row

  // Halo pixel of this lane's ldmatrix row for tap (0, 0), per m16 tile.
  // With TW = 8, m16 tile i of the warp covers tile rows warp_m*4 + 2i and
  // +1, and the lane's row r is column r.
  int a_pix[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a_pix[i] = (warp_m * 4 + i * 2 + (q & 1)) * HALO_W + r;
  const int a_col = (q >> 1) * 8;
  const int b_row = (q & 1) * 8 + r;
  const int b_col = warp_n * 32 + (q >> 1) * 8;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int ci0 = 0; ci0 < g.Ci; ci0 += CK16) {
    fill_halo16(Hs, x, s, b, g, r0, c0, ci0);
    fill_w16(Bs, w, g, ci0, co0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * HALO_W + (tap % 3);
#pragma unroll
      for (int kk = 0; kk < CK16; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(a[i], Hs + (a_pix[i] + shift) * LDH16 + kk + a_col);
        uint32_t bf[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          ldsm_x4_trans(bf[jj], Bs + (tap * CK16 + kk + b_row) * LDB16 +
                                    b_col + jj * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            mma_bf16(acc[i][jj * 2], a[i], bf[jj][0], bf[jj][1]);
            mma_bf16(acc[i][jj * 2 + 1], a[i], bf[jj][2], bf[jj][3]);
          }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 2)
conv_fused_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ s,
                       const float* __restrict__ b,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = Hs + HALO_P * LDH16;

  const int rt = blockIdx.x / g.col_tiles;
  const int r0 = rt * TH;
  const int c0 = (blockIdx.x - rt * g.col_tiles) * TW;
  const int co0 = blockIdx.y * BN;

  float acc[2][4][4];
  core16(acc, x, s, b, w, g, r0, c0, co0, Hs, Bs);

  // Epilogue: accumulator (row g, cols 2t, 2t+1) and (row g+8, same cols).
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const bool pair_ok = (g.Co % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp_m * 32 + i * 16 + half * 8 + gq;
      const long long off = out_offset(g, r0, c0, m);
      if (off < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + warp_n * 32 + j * 8 + 2 * t;
        const float v0 = acc[i][j][half * 2];
        const float v1 = acc[i][j][half * 2 + 1];
        if (pair_ok && co + 1 < g.Co) {
          *reinterpret_cast<__nv_bfloat162*>(out + off + co) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < g.Co) out[off + co] = __float2bfloat16_rn(v0);
          if (co + 1 < g.Co) out[off + co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// d-input. Geometry of the GEMM: the tile operand is dy (g.Ci = the
// convolution's Co), w is the flipped, transposed (9*Co, Ci) weight, and
// the result has g.Co = the convolution's Ci channels, like x and dx.
// part holds 2 x gridDim.x x g.Co floats: the block partials of ds, then
// of db.
__global__ void __launch_bounds__(THREADS, 2)
conv_bwd_dx_bf16_kernel(const __nv_bfloat16* __restrict__ dy,
                        const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ s,
                        const float* __restrict__ b,
                        __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ part, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = Hs + HALO_P * LDH16;

  const int rt = blockIdx.x / g.col_tiles;
  const int r0 = rt * TH;
  const int c0 = (blockIdx.x - rt * g.col_tiles) * TW;
  const int co0 = blockIdx.y * BN;

  float acc[2][4][4];
  core16(acc, dy, nullptr, nullptr, wt, g, r0, c0, co0, Hs, Bs);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int gq = lane >> 2;
  const int t = lane & 3;
  float ps[4][2], pb[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) ps[j][e] = pb[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp_m * 32 + i * 16 + half * 8 + gq;
      const long long off = out_offset(g, r0, c0, m);
      if (off < 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = co0 + warp_n * 32 + j * 8 + 2 * t + e;
          if (c >= g.Co) continue;
          const float dz = acc[i][j][half * 2 + e];
          const float xv = __bfloat162float(x[off + c]);
          const float sv = __ldg(s + c);
          float dpre = dz;
          if (g.relu) {
            const float pre = act16(xv, bf16_round(sv),
                                    bf16_round(__ldg(b + c)), 0);
            dpre = __fmul_rn(dz, pre > 0.f ? 1.f : 0.f);
          }
          dx[off + c] = __float2bfloat16_rn(__fmul_rn(dpre, sv));
          ps[j][e] = __fadd_rn(ps[j][e], __fmul_rn(dpre, xv));
          pb[j][e] = __fadd_rn(pb[j][e], dpre);
        }
      }
    }
  }
  // fold the 8 lanes that share a channel (lane bits 2..4); each pair of
  // lanes adds the same two values, so all eight end with the same sum
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int d = 4; d < 32; d <<= 1) {
        ps[j][e] = __fadd_rn(ps[j][e], __shfl_xor_sync(FULL, ps[j][e], d));
        pb[j][e] = __fadd_rn(pb[j][e], __shfl_xor_sync(FULL, pb[j][e], d));
      }
  float* red = reinterpret_cast<float*>(smem);   // [4 warp_m][BN][2]
  if (gq == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = warp_n * 32 + j * 8 + 2 * t + e;
        red[(warp_m * BN + cl) * 2] = ps[j][e];
        red[(warp_m * BN + cl) * 2 + 1] = pb[j][e];
      }
  }
  __syncthreads();
  if (threadIdx.x < BN && co0 + threadIdx.x < g.Co) {
    float vs = 0.f, vb = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vs = __fadd_rn(vs, red[(k * BN + threadIdx.x) * 2]);
      vb = __fadd_rn(vb, red[(k * BN + threadIdx.x) * 2 + 1]);
    }
    const long long T = gridDim.x;
    part[blockIdx.x * static_cast<long long>(g.Co) + co0 + threadIdx.x] = vs;
    part[(T + blockIdx.x) * g.Co + co0 + threadIdx.x] = vb;
  }
}

// d-weight, bf16. Block (ks, ci chunk, co block) sums tiles
// [ks*tps, ks*tps + tps) of the virtual image into part[ks] (9*Ci x Co,
// f32). Warp `tap` owns the (CK16 x BN) slice of its tap: A is the
// transposed halo (channels x pixels shifted by the tap), B the dy rows.
__global__ void __launch_bounds__(DW_THREADS)
conv_bwd_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ s,
                        const float* __restrict__ b,
                        const __nv_bfloat16* __restrict__ dy,
                        float* __restrict__ part, Geom g, int tps,
                        int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ds = Hs + HALO_P * LDH16;

  const int ks = blockIdx.x;
  const int ci0 = blockIdx.y * CK16;
  const int co0 = blockIdx.z * BN;
  const int lane = threadIdx.x & 31;
  const int tap = threadIdx.x >> 5;
  const int ky = tap / 3, kx = tap % 3;
  const int q = lane >> 3;
  const int r = lane & 7;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int t_end = min(n_tiles, (ks + 1) * tps);
  for (int tile = ks * tps; tile < t_end; ++tile) {
    const int rt = tile / g.col_tiles;
    const int r0 = rt * TH;
    const int c0 = (tile - rt * g.col_tiles) * TW;
    fill_halo16(Hs, x, s, b, g, r0, c0, ci0);
    fill_dy16(Ds, dy, g, r0, c0, co0);
    __syncthreads();
#pragma unroll 2
    for (int st = 0; st < TP / 16; ++st) {
      // A (16 channels x 16 pixels) from the halo rows of pixels
      // st*16 + (q>>1)*8 + r, i.e. tile row 2*st + (q>>1), column r
      const int hp = (2 * st + (q >> 1) + ky) * HALO_W + r + kx;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_trans(a[i], Hs + hp * LDH16 + i * 16 + (q & 1) * 8);
      uint32_t bf[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ldsm_x4_trans(bf[jj], Ds + (st * 16 + (q & 1) * 8 + r) * LDB16 +
                                  jj * 16 + (q >> 1) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          mma_bf16(acc[i][jj * 2], a[i], bf[jj][0], bf[jj][1]);
          mma_bf16(acc[i][jj * 2 + 1], a[i], bf[jj][2], bf[jj][3]);
        }
    }
    __syncthreads();
  }

  const int gq = lane >> 2;
  const int t = lane & 3;
  float* dst = part + static_cast<long long>(ks) * 9 * g.Ci * g.Co;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + i * 16 + half * 8 + gq;
      if (ci >= g.Ci) continue;
      float* row = dst + (static_cast<long long>(tap) * g.Ci + ci) * g.Co;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + j * 8 + 2 * t + e;
          if (co < g.Co) row[co] = acc[i][j][half * 2 + e];
        }
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full float32 FMA
// ---------------------------------------------------------------------------

// Thread (tm, tn) owns tile row tm (8 pixels) and channels co0 + 4*tn .. +3.
__device__ __forceinline__ void core32(float (&acc)[TW][4], const float* x,
                                       const float* s, const float* b,
                                       const float* w, const Geom& g, int r0,
                                       int c0, int co0, float* Hs,
                                       float* Bs) {
  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TW; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < g.Ci; ci0 += CK32) {
    fill_halo32(Hs, x, s, b, g, r0, c0, ci0);
    fill_w32(Bs, w, g, ci0, co0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* hrow = Hs + ((tm + tap / 3) * HALO_W + tap % 3) * LDH32;
      const float* brow = Bs + tap * CK32 * LDB32 + tn * 4;
#pragma unroll 4
      for (int j = 0; j < CK32; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(brow + j * LDB32);
#pragma unroll
        for (int i = 0; i < TW; ++i) {
          const float a = hrow[i * LDH32 + j];
          acc[i][0] = fmaf(a, bv.x, acc[i][0]);
          acc[i][1] = fmaf(a, bv.y, acc[i][1]);
          acc[i][2] = fmaf(a, bv.z, acc[i][2]);
          acc[i][3] = fmaf(a, bv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 2)
conv_fused_f32_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      const float* __restrict__ b, const float* __restrict__ w,
                      float* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Hs = reinterpret_cast<float*>(smem);
  float* Bs = Hs + HALO_P * LDH32;

  const int rt = blockIdx.x / g.col_tiles;
  const int r0 = rt * TH;
  const int c0 = (blockIdx.x - rt * g.col_tiles) * TW;
  const int co0 = blockIdx.y * BN;

  float acc[TW][4];
  core32(acc, x, s, b, w, g, r0, c0, co0, Hs, Bs);

  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
  const int co = co0 + tn * 4;
  const bool quad_ok = (g.Co % 4) == 0 && co + 4 <= g.Co;
#pragma unroll
  for (int i = 0; i < TW; ++i) {
    const long long off = out_offset(g, r0, c0, tm * TW + i);
    if (off < 0) continue;
    if (quad_ok) {
      *reinterpret_cast<float4*>(out + off + co) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (co + j < g.Co) out[off + co + j] = acc[i][j];
    }
  }
}

// d-input, f32 (geometry as conv_bwd_dx_bf16_kernel).
__global__ void __launch_bounds__(THREADS, 2)
conv_bwd_dx_f32_kernel(const float* __restrict__ dy,
                       const float* __restrict__ wt,
                       const float* __restrict__ x,
                       const float* __restrict__ s,
                       const float* __restrict__ b, float* __restrict__ dx,
                       float* __restrict__ part, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Hs = reinterpret_cast<float*>(smem);
  float* Bs = Hs + HALO_P * LDH32;

  const int rt = blockIdx.x / g.col_tiles;
  const int r0 = rt * TH;
  const int c0 = (blockIdx.x - rt * g.col_tiles) * TW;
  const int co0 = blockIdx.y * BN;

  float acc[TW][4];
  core32(acc, dy, nullptr, nullptr, wt, g, r0, c0, co0, Hs, Bs);

  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
  float ps[4], pb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ps[j] = pb[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TW; ++i) {
    const long long off = out_offset(g, r0, c0, tm * TW + i);
    if (off < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = co0 + tn * 4 + j;
      if (c >= g.Co) continue;
      const float dz = acc[i][j];
      const float xv = x[off + c];
      const float sv = __ldg(s + c);
      float dpre = dz;
      if (g.relu) {
        const float pre = act32(xv, sv, __ldg(b + c), 0);
        dpre = __fmul_rn(dz, pre > 0.f ? 1.f : 0.f);
      }
      dx[off + c] = __fmul_rn(dpre, sv);
      ps[j] = __fadd_rn(ps[j], __fmul_rn(dpre, xv));
      pb[j] = __fadd_rn(pb[j], dpre);
    }
  }
  // a warp holds tile rows tm = 2w and 2w+1 (lane bit 4); fold the pair
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ps[j] = __fadd_rn(ps[j], __shfl_xor_sync(FULL, ps[j], 16));
    pb[j] = __fadd_rn(pb[j], __shfl_xor_sync(FULL, pb[j], 16));
  }
  float* red = reinterpret_cast<float*>(smem);   // [8 warps][BN][2]
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 16) == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[(warp * BN + tn * 4 + j) * 2] = ps[j];
      red[(warp * BN + tn * 4 + j) * 2 + 1] = pb[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < BN && co0 + threadIdx.x < g.Co) {
    float vs = 0.f, vb = 0.f;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) {
      vs = __fadd_rn(vs, red[(k * BN + threadIdx.x) * 2]);
      vb = __fadd_rn(vb, red[(k * BN + threadIdx.x) * 2 + 1]);
    }
    const long long T = gridDim.x;
    part[blockIdx.x * static_cast<long long>(g.Co) + co0 + threadIdx.x] = vs;
    part[(T + blockIdx.x) * g.Co + co0 + threadIdx.x] = vb;
  }
}

// d-weight, f32. Warp `tap`; lane (ci4, co8) owns channels ci0 + 4*ci4 ..
// +3 by co0 + 8*co8 .. +7 of its tap.
__global__ void __launch_bounds__(DW_THREADS)
conv_bwd_dw_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ s,
                       const float* __restrict__ b,
                       const float* __restrict__ dy, float* __restrict__ part,
                       Geom g, int tps, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Hs = reinterpret_cast<float*>(smem);
  float* Ds = Hs + HALO_P * LDH32;

  const int ks = blockIdx.x;
  const int ci0 = blockIdx.y * CK32;
  const int co0 = blockIdx.z * BN;
  const int lane = threadIdx.x & 31;
  const int tap = threadIdx.x >> 5;
  const int ky = tap / 3, kx = tap % 3;
  const int ci4 = lane >> 3;
  const int co8 = lane & 7;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int t_end = min(n_tiles, (ks + 1) * tps);
  for (int tile = ks * tps; tile < t_end; ++tile) {
    const int rt = tile / g.col_tiles;
    const int r0 = rt * TH;
    const int c0 = (tile - rt * g.col_tiles) * TW;
    fill_halo32(Hs, x, s, b, g, r0, c0, ci0);
    fill_dy32(Ds, dy, g, r0, c0, co0);
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < TP; ++p) {
      const float* hrow =
          Hs + ((p / TW + ky) * HALO_W + p % TW + kx) * LDH32 + ci4 * 4;
      const float4 b0 = *reinterpret_cast<const float4*>(
          Ds + p * LDB32 + co8 * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(
          Ds + p * LDB32 + co8 * 8 + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = hrow[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* dst = part + static_cast<long long>(ks) * 9 * g.Ci * g.Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ci4 * 4 + i;
    if (ci >= g.Ci) continue;
    float* row = dst + (static_cast<long long>(tap) * g.Ci + ci) * g.Co;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + co8 * 8 + j;
      if (co < g.Co) row[co] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Second passes: fixed-order folds of the block partials
// ---------------------------------------------------------------------------

// ds[c], db[c] = the sums over T block partials: warp w of the block adds
// partials w, w+32, ... in order, then lane c's 32 warp sums are added in
// warp order.
__global__ void __launch_bounds__(1024)
conv_bwd_finalize_kernel(const float* __restrict__ part, int T, int C,
                         float* __restrict__ ds, float* __restrict__ db) {
  __shared__ float red[2][32][33];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float vs = 0.f, vb = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int t = w; t < T; t += 32) {
      vs = __fadd_rn(vs, part[static_cast<long long>(t) * C + c]);
      vb = __fadd_rn(vb, part[(static_cast<long long>(T) + t) * C + c]);
    }
  }
  red[0][w][lane] = vs;
  red[1][w][lane] = vb;
  __syncthreads();
  if (w == 0 && c < C) {
    float s = 0.f, b = 0.f;
    for (int k = 0; k < 32; ++k) {
      s = __fadd_rn(s, red[0][k][lane]);
      b = __fadd_rn(b, red[1][k][lane]);
    }
    ds[c] = s;
    db[c] = b;
  }
}

// out[e] = part[0][e] + part[1][e] + ... in split order.
__global__ void __launch_bounds__(256)
conv_dw_reduce_kernel(const float* __restrict__ part, int nsplit, long long n,
                      float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    float v = 0.f;
    for (int k = 0; k < nsplit; ++k) v = __fadd_rn(v, part[k * n + e]);
    out[e] = v;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

Geom make_geom(int N, int H, int W, int Ci, int Co, int relu, int act,
               const void* tile_operand, const void* w_operand,
               int vec_elems) {
  Geom g;
  g.N = N;
  g.H = H;
  g.W = W;
  g.Ci = Ci;
  g.Co = Co;
  g.V = N * (H + 1) - 1;
  g.col_tiles = (W + TW - 1) / TW;
  g.relu = relu;
  g.act = act;
  g.xvec = (Ci % vec_elems == 0) &&
           (reinterpret_cast<uintptr_t>(tile_operand) % 16 == 0);
  g.wvec = (Co % vec_elems == 0) &&
           (reinterpret_cast<uintptr_t>(w_operand) % 16 == 0);
  return g;
}

long long tiles_of(const Geom& g) {
  return static_cast<long long>((g.V + TH - 1) / TH) * g.col_tiles;
}

template <typename K>
int set_smem(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T>
using FwdFn = void (*)(const T*, const float*, const float*, const T*, T*,
                       Geom);
template <typename T>
using DxFn = void (*)(const T*, const T*, const T*, const float*,
                      const float*, T*, float*, Geom);
template <typename T>
using DwFn = void (*)(const T*, const float*, const float*, const T*, float*,
                      Geom, int, int);

template <typename T>
int launch_fwd(FwdFn<T> kernel, int smem, int vec_elems, const void* x,
               const float* s, const float* b, const void* w, void* out,
               int N, int H, int W, int Ci, int Co, int relu, void* stream) {
  Geom g = make_geom(N, H, W, Ci, Co, relu, 1, x, w, vec_elems);
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const long long blocks = tiles_of(g);
  const int co_tiles = (Co + BN - 1) / BN;
  if (blocks > 0x7fffffffLL || co_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks), co_tiles);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), s, b, static_cast<const T*>(w),
      static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx(DxFn<T> kernel, int smem, int vec_elems, const void* dy,
              const void* wt, const void* x, const float* s, const float* b,
              void* dx, float* part, int N, int H, int W, int Ci, int Co,
              int relu, void* stream) {
  // the GEMM reads dy (Co channels) and produces Ci channels
  Geom g = make_geom(N, H, W, Co, Ci, relu, 0, dy, wt, vec_elems);
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const long long blocks = tiles_of(g);
  const int c_tiles = (Ci + BN - 1) / BN;
  if (blocks > 0x7fffffffLL || c_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks), c_tiles);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dy), static_cast<const T*>(wt),
      static_cast<const T*>(x), s, b, static_cast<T*>(dx), part, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(DwFn<T> kernel, int smem, int vec_elems, int ck, const void* x,
              const float* s, const float* b, const void* dy, float* part,
              int N, int H, int W, int Ci, int Co, int relu, int nsplit,
              int tps, void* stream) {
  Geom g = make_geom(N, H, W, Ci, Co, relu, 1, x, dy, vec_elems);
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  const long long n_tiles = tiles_of(g);
  if (n_tiles > 0x7fffffffLL || nsplit <= 0 || tps <= 0 ||
      static_cast<long long>(nsplit) * tps < n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ci_tiles = (Ci + ck - 1) / ck;
  const int co_tiles = (Co + BN - 1) / BN;
  if (ci_tiles > 65535 || co_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(nsplit, ci_tiles, co_tiles);
  kernel<<<grid, DW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), s, b, static_cast<const T*>(dy), part, g, tps,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch. Pointers are device
// pointers to contiguous tensors; every kernel runs on `stream` and is not
// waited for. N, H, W, Ci, Co are the convolution's: x (N,H,W,Ci), s and b
// (Ci,) float32, dy and out (N,H,W,Co).

// Forward: w (9*Ci, Co) tap-major; x, w and out share the dtype.
int conv_fused_fwd_bf16(const void* x, const float* s, const float* b,
                        const void* w, void* out, int N, int H, int W, int Ci,
                        int Co, int relu, void* stream) {
  return launch_fwd<__nv_bfloat16>(conv_fused_bf16_kernel, SMEM16, 8, x, s,
                                   b, w, out, N, H, W, Ci, Co, relu, stream);
}

int conv_fused_fwd_f32(const void* x, const float* s, const float* b,
                       const void* w, void* out, int N, int H, int W, int Ci,
                       int Co, int relu, void* stream) {
  return launch_fwd<float>(conv_fused_f32_kernel, SMEM32, 4, x, s, b, w, out,
                           N, H, W, Ci, Co, relu, stream);
}

// d-input: wt (9*Co, Ci) is W flipped in space and transposed; dx like x;
// part (2, T, Ci) float32 with T = ceil((N*(H+1)-1)/16) * ceil(W/8).
int conv_fused_bwd_dx_bf16(const void* dy, const void* wt, const void* x,
                           const float* s, const float* b, void* dx,
                           float* part, int N, int H, int W, int Ci, int Co,
                           int relu, void* stream) {
  return launch_dx<__nv_bfloat16>(conv_bwd_dx_bf16_kernel, SMEM16, 8, dy, wt,
                                  x, s, b, dx, part, N, H, W, Ci, Co, relu,
                                  stream);
}

int conv_fused_bwd_dx_f32(const void* dy, const void* wt, const void* x,
                          const float* s, const float* b, void* dx,
                          float* part, int N, int H, int W, int Ci, int Co,
                          int relu, void* stream) {
  return launch_dx<float>(conv_bwd_dx_f32_kernel, SMEM32, 4, dy, wt, x, s, b,
                          dx, part, N, H, W, Ci, Co, relu, stream);
}

// ds, db (C,) float32 from the (2, T, C) partials of the d-input kernel.
int conv_fused_bwd_finalize(const float* part, int T, int C, float* ds,
                            float* db, void* stream) {
  if (T <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  conv_bwd_finalize_kernel<<<(C + 31) / 32, 1024, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      part, T, C, ds, db);
  return static_cast<int>(cudaGetLastError());
}

// d-weight: part (nsplit, 9*Ci, Co) float32; split k sums pixel tiles
// [k*tps, (k+1)*tps) of the T above (nsplit*tps >= T).
int conv_fused_bwd_dw_bf16(const void* x, const float* s, const float* b,
                           const void* dy, float* part, int N, int H, int W,
                           int Ci, int Co, int relu, int nsplit, int tps,
                           void* stream) {
  return launch_dw<__nv_bfloat16>(conv_bwd_dw_bf16_kernel, SMEM_DW16, 8, CK16,
                                  x, s, b, dy, part, N, H, W, Ci, Co, relu,
                                  nsplit, tps, stream);
}

int conv_fused_bwd_dw_f32(const void* x, const float* s, const float* b,
                          const void* dy, float* part, int N, int H, int W,
                          int Ci, int Co, int relu, int nsplit, int tps,
                          void* stream) {
  return launch_dw<float>(conv_bwd_dw_f32_kernel, SMEM_DW32, 4, CK32, x, s, b,
                          dy, part, N, H, W, Ci, Co, relu, nsplit, tps,
                          stream);
}

// out (n,) float32 = the sum of the nsplit (n,) partials, in split order.
int conv_fused_dw_reduce(const float* part, int nsplit, long long n,
                         float* out, void* stream) {
  if (nsplit <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  conv_dw_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(part, nsplit,
                                                               n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
