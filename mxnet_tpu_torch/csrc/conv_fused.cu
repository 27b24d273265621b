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
// the two bounds are about equal at ResNet-50's shapes. The forward and
// d-input kernels keep the bytes at that floor (each block reads its input
// tile plus a one-pixel halo once per channel chunk; all nine taps then read
// it from shared memory) and feed the tensor cores with mma.sync (m16n8k16,
// bf16 in, f32 accumulate). They are the simple form: no TMA, no wgmma, no
// pipelining of the loads against the math. The bf16 d-weight kernel is
// built for Hopper: a warp-specialised, persistent block with a ring of
// tiles feeding wgmma (below).
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
// split sums its share into f32 partials and a reduce launch adds the
// partials in a fixed order. No float atomics anywhere, so every run gives
// the same bits. In bf16 one block per SM walks work items of 64 input x 64
// output channels x all nine taps (planned by dw_plan in
// kernels/conv_fused.py). A producer warpgroup loads each tile's halo and
// dy rows with TMA into a 4-stage shared-memory ring; three consumer
// warpgroups, one per kernel column, activate the halo in place and run
// wgmma m64n64k16 with A -- the halo, transposed and shifted by the tap --
// taken from registers by ldmatrix (a descriptor cannot describe a window
// that moves by a pixel per tap; the three taps of a column share each
// halo row's fragment) and B, the dy rows, read once per warpgroup from the
// 128-byte-swizzled stage. The stages are the only traffic between the
// warpgroups, through mbarriers. What bounds it on an H100 is in PERF.md.
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

#include <cuda.h>
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
constexpr int DW_THREADS = 288;        // f32 d-weight: one warp per tap
constexpr unsigned FULL = 0xffffffffu;

// bf16 kernels: 32 input channels per chunk; rows padded so that ldmatrix
// row addresses fall in distinct banks (80-byte and 144-byte strides).
constexpr int CK16 = 32;
constexpr int LDH16 = CK16 + 8;
constexpr int LDB16 = BN + 8;
constexpr int SMEM16 = (HALO_P * LDH16 + 9 * CK16 * LDB16) * 2;

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

// ---------------------------------------------------------------------------
// d-weight, bf16: persistent, warp-specialised, TMA + wgmma
// ---------------------------------------------------------------------------

// A work item is (K-split ks, ci chunk, co block): 64 input channels x 64
// output channels x all nine taps, summed over pixel tiles [ks*tps,
// min(T, ks*tps + tps)) into part[ks]. Items are numbered ks-major (item =
// (ks * ci_chunks + cc) * co_blocks + cb), so the blocks in flight share
// pixel tiles and find them in L2; block i takes items i, i + gridDim.x, ...
//
// The block is four warpgroups. In warpgroup 3, the producer, 26 lanes each
// issue one TMA box of a tile into the next free stage of a DWB_STAGES-deep
// ring: a halo row (10 pixels x 64 channels) or two dy rows of the tile (16
// pixels x 64 channels), at coordinates (channel, column, row, image) of
// the NHWC tensor, so that the zero fill of a box outside the tensor
// supplies the padding, the separator rows and the channels past C. The
// first warp also writes the stage's tables (which halo rows lie in an
// image; the item's s and b rounded to bf16). Warpgroup kx (0..2) is a
// consumer that owns the three taps (0..2, kx): an m64n64 accumulator per
// tap, rows = input channels, columns = output channels. The 384 consumer
// threads activate each tile's halo in place (act16's roundings, padding
// left at zero as fill_halo16 leaves it) while the tile before it runs on
// the tensor cores, meet at a named barrier, and run the tile's wgmma
// k-steps. Stage handshakes are mbarriers: full (the boxes' bytes and the
// producer's arrival) and empty (the consumer threads, after their last
// read). setmaxnreg moves registers from the producer to the consumers.
//
// Shared memory of a stage: the dy tile, 128 pixel rows of 128 bytes (one
// box per two tile rows), then 18 halo rows of 16 pixel slots (10 used),
// each 128-byte pixel row in the 128-byte swizzle the boxes are written
// in: 16-byte chunk c of pixel slot k sits at chunk c ^ (k % 8). A box in
// that swizzle must start on 1024 bytes, hence the 16-slot halo rows.
constexpr int DWB_CK = 64;                         // input channels per item
constexpr int DWB_DY_BYTES = TP * BN * 2;          // 8 boxes of 2048 bytes
constexpr int DWB_HROW = 16;                       // pixel slots per halo row
constexpr int DWB_HALO_BYTES = (TH + 2) * DWB_HROW * DWB_CK * 2;
constexpr int DWB_STAGE = DWB_DY_BYTES + DWB_HALO_BYTES;   // 53248
constexpr int DWB_STAGES = 4;
// Boxes: a halo row (10 pixels), or a pair of dy rows (16 pixels; a pair
// of halo rows in one box would land 10 slots apart, not DWB_HROW).
constexpr int DWB_DY_BOX_ROWS = 2;
constexpr int DWB_HALO_BOXES = TH + 2;
constexpr int DWB_DY_BOXES = TH / DWB_DY_BOX_ROWS;
constexpr int DWB_BOXES = DWB_HALO_BOXES + DWB_DY_BOXES;   // 26
constexpr int DWB_TX = TH * TW * BN * 2 + (TH + 2) * HALO_W * DWB_CK * 2;
constexpr int DWB_CONSUMERS = 3;
constexpr int DWB_THREADS = 128 * (DWB_CONSUMERS + 1);
// registers per thread after setmaxnreg: the consumers hold three m64n64
// f32 accumulators (96) and six halo-row halves of A fragments (12)
constexpr int DWB_PRODUCER_REGS = 40;
constexpr int DWB_CONSUMER_REGS = 152;
static_assert(DWB_PRODUCER_REGS * 128 +
                  DWB_CONSUMER_REGS * 128 * DWB_CONSUMERS <= 65536,
              "register file");
// the ring, plus slack to align it to the 1024-byte swizzle atom
constexpr int SMEM_DWB = DWB_STAGES * DWB_STAGE + 1024;

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned tx) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(tx)
      : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A
// wait that never ends is a fault in the kernel: trap rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// One TMA box of a 4-D (channel, column, row, image) tensor map into shared
// memory, completing on `bar`. Coordinates may lie outside the tensor:
// those elements are written as zeros.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          int c, int w, int h, int n,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory descriptor of a K x 64 bf16 operand stored N-major (one
// 128-byte row per k) in the 128-byte swizzle, from a 1024-byte aligned
// base. Groups of 8 rows are 1024 bytes apart; both offset fields say so
// (the leading one is not read at N = 64).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

// d += A (64 x 16, registers, the mma.m16n8k16 A fragment of each warp's 16
// rows) * B (16 x 64, shared memory, N-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// act16 on a pair of bf16 (low half first): x*s and +b each rounded to
// bf16 (bf16 operands: the f32 product and sum of act16 are exact before
// that rounding, so the bits are act16's), then the ReLU. max.NaN keeps a
// NaN as act16 does; it maps -0 to +0, which adds nothing to any sum.
__device__ __forceinline__ uint32_t act_pair(uint32_t w, uint32_t s2,
                                             uint32_t b2, int relu) {
  uint32_t v;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(v) : "r"(w), "r"(s2));
  asm("add.rn.bf16x2 %0, %0, %1;\n" : "+r"(v) : "r"(b2));
  if (relu) asm("max.NaN.bf16x2 %0, %0, %1;\n" : "+r"(v) : "r"(0u));
  return v;
}

// Virtual row vr (0 <= vr < 2^24) -> image n, and the row h within it (h ==
// H on a separator): a float estimate of vr / (H+1), corrected by one.
__device__ __forceinline__ int dwb_image(int vr, int h1, float inv_h1,
                                         int& h) {
  int n = __float2int_rz(__fmul_rn(static_cast<float>(vr) + 0.5f, inv_h1));
  h = vr - n * h1;
  if (h < 0) {
    --n;
    h += h1;
  } else if (h >= h1) {
    ++n;
    h -= h1;
  }
  return n;
}

// The work items of one block, in order, and a position in them.
struct DwbCursor {
  int item, tile, t_end, ci0, co0;
};

struct DwbWalk {
  int n_items, per_split, co_blocks, tps, n_tiles;

  __device__ __forceinline__ void begin(DwbCursor& c, int item) const {
    c.item = item;
    if (item >= n_items) return;
    const int ks = item / per_split;
    const int rem = item - ks * per_split;
    const int cc = rem / co_blocks;
    c.ci0 = cc * DWB_CK;
    c.co0 = (rem - cc * co_blocks) * BN;
    c.tile = ks * tps;
    c.t_end = min(n_tiles, c.tile + tps);
  }
  __device__ __forceinline__ void next(DwbCursor& c) const {
    if (++c.tile == c.t_end) begin(c, c.item + gridDim.x);
  }
  __device__ __forceinline__ bool valid(const DwbCursor& c) const {
    return c.item < n_items;
  }
};

// The (image, row) coordinates of a box whose first virtual row is vr.
// Rows that lie in no image -- before the first, a separator, after the
// last -- fall outside the tensor and read as zeros: a separator starts a
// box as row -1 of the next image, and a box that runs past an image's
// last row reads row H, outside, which is the separator.
__device__ __forceinline__ void dwb_box_rows(int vr, const Geom& g,
                                             float inv_h1, int& n, int& h) {
  if (vr < 0) {
    n = 0;
    h = vr;
  } else if (vr >= g.V) {
    n = g.N;
    h = 0;
  } else {
    n = dwb_image(vr, g.H + 1, inv_h1, h);
    if (h == g.H) {
      ++n;
      h = -1;
    }
  }
}

// Lane `box` (0 .. DWB_BOXES-1) of the producer issues one box of the tile
// at (r0, c0): halo row `box` (virtual row r0 - 1 + box) or dy box
// `box - DWB_HALO_BOXES` (tile rows 2k and 2k+1).
__device__ __forceinline__ void dwb_issue(unsigned char* stage,
                                          uint64_t* full,
                                          const CUtensorMap* tmx,
                                          const CUtensorMap* tmdy,
                                          const Geom& g, float inv_h1,
                                          int r0, int c0, int ci0, int co0,
                                          int box) {
  int n, h;
  if (box < DWB_HALO_BOXES) {
    dwb_box_rows(r0 - 1 + box, g, inv_h1, n, h);
    tma_load4(stage + DWB_DY_BYTES + box * DWB_HROW * DWB_CK * 2, tmx, ci0,
              c0 - 1, h, n, full);
  } else {
    const int row = (box - DWB_HALO_BOXES) * DWB_DY_BOX_ROWS;
    dwb_box_rows(r0 + row, g, inv_h1, n, h);
    tma_load4(stage + row * TW * BN * 2, tmdy, co0, c0, h, n, full);
  }
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(a));
  return r;
}

__device__ __forceinline__ void sts128(uint32_t a, uint4 r) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(r.x), "r"(r.y), "r"(r.z), "r"(r.w)
               : "memory");
}

// Consumer thread ct (0 .. 383) activates, in place, chunk ct % 8
// (channels ci0 + 8 (ct % 8) ..) of halo pixel p = ct / 8 + 48j (row p /
// 10, column p % 10) if it lies in an image; otherwise it stays zero. The
// stage's sb holds the item's s and b as bf16 pairs.
constexpr int DWB_ACT_J = (HALO_P * 8 + 383) / 384;   // 4 chunks per thread

__device__ __forceinline__ void dwb_activate(uint32_t halo,
                                             const uint8_t* rowok,
                                             const uint32_t (*sb)[32],
                                             const Geom& g, int c0, int ct,
                                             int j) {
  const int v = ct & 7;
  const int p = (ct >> 3) + 48 * j;
  const int hr = p / HALO_W;
  const int hc = p - hr * HALO_W;
  const unsigned c = static_cast<unsigned>(c0 - 1 + hc);
  if (p >= HALO_P || !rowok[hr] || c >= static_cast<unsigned>(g.W)) return;
  const uint32_t addr =
      halo + (hr * DWB_HROW + hc) * DWB_CK * 2 + ((v ^ (hc & 7)) << 4);
  const uint4 x = lds128(addr);
  const uint4 s2 = reinterpret_cast<const uint4*>(sb[0])[v];
  const uint4 b2 = reinterpret_cast<const uint4*>(sb[1])[v];
  sts128(addr, make_uint4(act_pair(x.x, s2.x, b2.x, g.relu),
                          act_pair(x.y, s2.y, b2.y, g.relu),
                          act_pair(x.z, s2.z, b2.z, g.relu),
                          act_pair(x.w, s2.w, b2.w, g.relu)));
}

// The A fragment of tap (ky, kx) for k-step st covers 16 channels (the
// warp's) x the 16 pixels of tile rows 2st and 2st+1 shifted by the tap:
// halo rows R = 2st + ky and R+1 at columns kx .. kx+7. Its registers are
// two halves, one per halo row ({a0, a1} row R, {a2, a3} row R+1), and
// the three taps of a column kx share them: (0, kx) takes rows 2st, 2st+1,
// (1, kx) rows 2st+1, 2st+2, (2, kx) rows 2st+2, 2st+3. So a consumer
// warpgroup owns a column of taps and loads each halo row's half once:
// dwb_load_rows brings rows R and R+1 (one ldmatrix.x4; the lane's row is
// halo row R + (q>>1), column r + kx).
__device__ __forceinline__ void dwb_load_rows(uint32_t (&lo)[2],
                                              uint32_t (&hi)[2],
                                              const unsigned char* halo,
                                              int R, int kx, int warp, int q,
                                              int r) {
  const int slot = r + kx;
  uint32_t f[4];
  ldsm_x4_trans(f, halo + ((R + (q >> 1)) * DWB_HROW + slot) * DWB_CK * 2 +
                       (((warp * 2 + (q & 1)) ^ (slot & 7)) * 16));
  lo[0] = f[0];
  lo[1] = f[1];
  hi[0] = f[2];
  hi[1] = f[3];
}

__global__ void __launch_bounds__(DWB_THREADS, 1)
conv_bwd_dw_bf16_kernel(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmdy,
                        const float* __restrict__ s,
                        const float* __restrict__ b,
                        float* __restrict__ part, Geom g, int tps,
                        int n_tiles, int nsplit) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[DWB_STAGES], empty[DWB_STAGES];
  __shared__ uint8_t rowok[DWB_STAGES][TH + 2];
  __shared__ __align__(16) uint32_t sb[DWB_STAGES][2][32];
  // the swizzle works on shared-memory address bits: align the ring there
  unsigned char* ring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) &
                                    1023u);

  if (threadIdx.x == 0) {
    for (int i = 0; i < DWB_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], DWB_CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  DwbWalk walk;
  walk.co_blocks = (g.Co + BN - 1) / BN;
  walk.per_split = (g.Ci + DWB_CK - 1) / DWB_CK * walk.co_blocks;
  walk.n_items = nsplit * walk.per_split;
  walk.tps = tps;
  walk.n_tiles = n_tiles;

  if (threadIdx.x >= DWB_CONSUMERS * 128) {
    // ---- producer warpgroup: its first warp writes the stage tables, and
    // lanes 0 .. DWB_BOXES-1 issue the boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        DWB_PRODUCER_REGS));
    const int pt = threadIdx.x - DWB_CONSUMERS * 128;
    if (pt >= 32 && pt >= DWB_BOXES) return;
    const float inv_h1 = 1.f / static_cast<float>(g.H + 1);
    DwbCursor in;
    walk.begin(in, blockIdx.x);
    for (int n = 0; walk.valid(in); walk.next(in), ++n) {
      const int stg = n % DWB_STAGES;
      mbar_wait(&empty[stg], ((n / DWB_STAGES) & 1) ^ 1);
      const int rt = in.tile / g.col_tiles;
      const int r0 = rt * TH;
      const int c0 = (in.tile - rt * g.col_tiles) * TW;
      if (pt < 32) {
        // the first warp also writes the stage's tables: rowok (in
        // dwb_issue) and the item's s, b as bf16 pairs; the arrival below
        // publishes them with the boxes' bytes
        float sv[2], bv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = in.ci0 + 2 * pt + e;
          sv[e] = ci < g.Ci ? __ldg(s + ci) : 0.f;
          bv[e] = ci < g.Ci ? __ldg(b + ci) : 0.f;
        }
        const __nv_bfloat162 sp = __floats2bfloat162_rn(sv[0], sv[1]);
        const __nv_bfloat162 bp = __floats2bfloat162_rn(bv[0], bv[1]);
        sb[stg][0][pt] = *reinterpret_cast<const uint32_t*>(&sp);
        sb[stg][1][pt] = *reinterpret_cast<const uint32_t*>(&bp);
        if (pt < TH + 2) {
          int n, h;
          dwb_box_rows(r0 - 1 + pt, g, inv_h1, n, h);
          rowok[stg][pt] = h >= 0 && n < g.N;
        }
        __syncwarp();
        if (pt == 0) mbar_expect_tx(&full[stg], DWB_TX);
      }
      if (pt < DWB_BOXES)
        dwb_issue(ring + stg * DWB_STAGE, &full[stg], &tmx, &tmdy, g,
                  inv_h1, r0, c0, in.ci0, in.co0, pt);
    }
  } else {
    // ---- consumer warpgroup kx: taps (0..2, kx)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        DWB_CONSUMER_REGS));
    const int kx = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;   // input channels warp*16 ..
    const int lane = threadIdx.x & 31;
    const int q = lane >> 3;
    const int r = lane & 7;
    const int gq = lane >> 2;
    const int t = lane & 3;
    const bool pair_ok = (g.Co % 2) == 0;
    float acc[3][8][4];
    int it = 0;
    DwbCursor c;
    for (walk.begin(c, blockIdx.x); walk.valid(c);) {
      const int item = c.item;
      const int ks = c.tile / tps;
      const int ci0 = c.ci0;
      const int co0 = c.co0;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k][j][e] = 0.f;

      for (; walk.valid(c) && c.item == item; walk.next(c), ++it) {
        const int stg = it % DWB_STAGES;
        const unsigned char* dyt = ring + stg * DWB_STAGE;
        const unsigned char* halo = dyt + DWB_DY_BYTES;
        if (it == 0) {
          // the block's first tile; every later one is activated while
          // the tile before it runs on the tensor cores
          mbar_wait(&full[stg], 0);
          __syncwarp();
          const int rt = c.tile / g.col_tiles;
#pragma unroll
          for (int j = 0; j < DWB_ACT_J; ++j)
            dwb_activate(smem_addr(halo), rowok[stg], sb[stg], g,
                         (c.tile - rt * g.col_tiles) * TW, threadIdx.x, j);
        }
        // every consumer's share of this tile activated before any A
        // fragment is read
        asm volatile("bar.sync 1, %0;\n" ::"n"(DWB_CONSUMERS * 128)
                     : "memory");
        DwbCursor nx = c;
        walk.next(nx);
        const int nstg = (it + 1) % DWB_STAGES;
        const uint32_t nhalo =
            smem_addr(ring + nstg * DWB_STAGE + DWB_DY_BYTES);
        int nc0 = 0;
        if (walk.valid(nx)) {
          const int rt = nx.tile / g.col_tiles;
          nc0 = (nx.tile - rt * g.col_tiles) * TW;
        }
        // the halves of halo rows, in six slots (row % 6): a k-step reads
        // rows 2st .. 2st+3 while rows 2st+4 and 2st+5 load into the slots
        // of the previous step's rows
        uint32_t hf[6][2];
        dwb_load_rows(hf[0], hf[1], halo, 0, kx, warp, q, r);
        dwb_load_rows(hf[2], hf[3], halo, 2, kx, warp, q, r);
#pragma unroll
        for (int st = 0; st < TP / 16; ++st) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) reg_fence(acc[k][j][e]);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
          const uint64_t desc = sw128_desc(dyt + st * 16 * BN * 2);
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int R = 2 * st + ky;
            const uint32_t a[4] = {hf[R % 6][0], hf[R % 6][1],
                                   hf[(R + 1) % 6][0], hf[(R + 1) % 6][1]};
            wgmma_rs(acc[ky], a, desc);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // a quarter of the next tile's activation under each of the
          // first four k-steps
          if (st < DWB_ACT_J && walk.valid(nx)) {
            if (st == 0) {
              mbar_wait(&full[nstg], ((it + 1) / DWB_STAGES) & 1);
              __syncwarp();
            }
            dwb_activate(nhalo, rowok[nstg], sb[nstg], g, nc0, threadIdx.x,
                         st);
          }
          if (st + 1 < TP / 16) {
            // the previous step's group has read rows 2st-2 and 2st-1
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
            dwb_load_rows(hf[(2 * st + 4) % 6], hf[(2 * st + 5) % 6], halo,
                          2 * st + 4, kx, warp, q, r);
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) reg_fence(acc[k][j][e]);
        // the activation's generic-proxy writes come before the next boxes'
        // async-proxy writes into this stage
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&empty[stg]);
      }

      // accumulator [ky][n8 block j][e]: input channel ci0 + warp*16 + gq
      // (+8 for e >= 2), output channel co0 + j*8 + 2t (+1 for odd e)
      float* dst = part + static_cast<long long>(ks) * 9 * g.Ci * g.Co;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ci = ci0 + warp * 16 + half * 8 + gq;
          if (ci >= g.Ci) continue;
          float* row =
              dst + (static_cast<long long>(ky * 3 + kx) * g.Ci + ci) * g.Co;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int co = co0 + j * 8 + 2 * t;
            const float v0 = acc[ky][j][half * 2];
            const float v1 = acc[ky][j][half * 2 + 1];
            if (pair_ok && co + 1 < g.Co) {
              *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
            } else {
              if (co < g.Co) row[co] = v0;
              if (co + 1 < g.Co) row[co + 1] = v1;
            }
          }
        }
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

int launch_dw_f32(const void* x, const float* s, const float* b,
                  const void* dy, float* part, int N, int H, int W, int Ci,
                  int Co, int relu, int nsplit, int tps, void* stream) {
  Geom g = make_geom(N, H, W, Ci, Co, relu, 1, x, dy, 4);
  int err = set_smem(conv_bwd_dw_f32_kernel, SMEM_DW32);
  if (err != 0) return err;
  const long long n_tiles = tiles_of(g);
  if (n_tiles > 0x7fffffffLL || nsplit <= 0 || tps <= 0 ||
      static_cast<long long>(nsplit) * tps < n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ci_tiles = (Ci + CK32 - 1) / CK32;
  const int co_tiles = (Co + BN - 1) / BN;
  if (ci_tiles > 65535 || co_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(nsplit, ci_tiles, co_tiles);
  conv_bwd_dw_f32_kernel<<<grid, DW_THREADS, SMEM_DW32,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), s, b, static_cast<const float*>(dy), part,
      g, tps, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// does not link the driver.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor map of a contiguous bf16 NHWC tensor as (channel, column, row,
// image), with boxes of 64 channels x box_w columns x box_h rows, written in
// the 128-byte swizzle; elements outside the tensor read as zero.
int encode_nhwc(CUtensorMap* map, const void* base, int N, int H, int W,
                int C, int box_w, int box_h) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(DWB_CK),
                             static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch_dw_bf16(const void* x, const float* s, const float* b,
                   const void* dy, float* part, int N, int H, int W, int Ci,
                   int Co, int relu, int nsplit, int tps, int grid,
                   void* stream) {
  // the boxes' rows: channel counts a multiple of 8, 16-byte aligned bases
  if (Ci % 8 != 0 || Co % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g = make_geom(N, H, W, Ci, Co, relu, 1, x, dy, 8);
  int err = set_smem(conv_bwd_dw_bf16_kernel, SMEM_DWB);
  if (err != 0) return err;
  const long long n_tiles = tiles_of(g);
  const long long items = static_cast<long long>(nsplit) *
                          ((Ci + DWB_CK - 1) / DWB_CK) * ((Co + BN - 1) / BN);
  // every split must hold at least one tile: each writes its whole partial
  if (n_tiles > 0x7fffffffLL || nsplit <= 0 || tps <= 0 ||
      static_cast<long long>(nsplit) * tps < n_tiles ||
      static_cast<long long>(nsplit - 1) * tps >= n_tiles || grid <= 0 ||
      grid > items)
    return static_cast<int>(cudaErrorInvalidValue);
  // dwb_image's float estimate is exact below 2^24 virtual rows
  if (items > 0x7fffffffLL || g.V >= (1 << 24))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tmx, tmdy;
  err = encode_nhwc(&tmx, x, N, H, W, Ci, HALO_W, 1);
  if (err != 0) return err;
  err = encode_nhwc(&tmdy, dy, N, H, W, Co, TW, DWB_DY_BOX_ROWS);
  if (err != 0) return err;
  conv_bwd_dw_bf16_kernel<<<grid, DWB_THREADS, SMEM_DWB,
                            static_cast<cudaStream_t>(stream)>>>(
      tmx, tmdy, s, b, part, g, tps, static_cast<int>(n_tiles), nsplit);
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
// [k*tps, (k+1)*tps) of the T above ((nsplit-1)*tps < T <= nsplit*tps).
// bf16: Ci and Co multiples of 8 and x, dy 16-byte aligned; `grid`
// persistent blocks (at most one per SM) walk the nsplit x ceil(Ci/64) x
// ceil(Co/64) work items.
int conv_fused_bwd_dw_bf16(const void* x, const float* s, const float* b,
                           const void* dy, float* part, int N, int H, int W,
                           int Ci, int Co, int relu, int nsplit, int tps,
                           int grid, void* stream) {
  return launch_dw_bf16(x, s, b, dy, part, N, H, W, Ci, Co, relu, nsplit,
                        tps, grid, stream);
}

int conv_fused_bwd_dw_f32(const void* x, const float* s, const float* b,
                          const void* dy, float* part, int N, int H, int W,
                          int Ci, int Co, int relu, int nsplit, int tps,
                          void* stream) {
  return launch_dw_f32(x, s, b, dy, part, N, H, W, Ci, Co, relu, nsplit, tps,
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
