// Fused scale-bias-ReLU + 3x3 convolution for Hopper (sm_90a).
//
//     out = conv3x3(relu(x * s + b), W)      stride 1, SAME padding, NHWC
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/conv_fused.py:_fwd_kernel
// (launched from _pallas_forward). The normalize/ReLU chain of the preceding
// BatchNorm is applied while the input tile is loaded into shared memory, so
// the activated tensor never exists in device memory.
//
// What bounds it on an H100: at the ResNet-50 shapes each launch does
// 2*N*H*W*9*Ci*Co operations against one read of x and W and one write of
// out; in bf16 the two bounds are about equal (compute ~7.5 us, bytes
// ~7.7 us per launch at batch 32). The design keeps the bytes at that floor
// (each block reads its input tile plus a one-pixel halo once per channel
// chunk and applies the activation once there; all nine taps then read the
// tile from shared memory) and feeds the tensor cores with mma.sync
// (m16n8k16, bf16 in, f32 accumulate). It is the simple form: no TMA, no
// wgmma, no pipelining of the loads against the math; those come later.
//
// Implicit GEMM: rows are output pixels, columns output channels, and the
// reduction runs over (tap, input channel) with the weight matrix laid out
// tap-major as (9*Ci, Co), row (ky*3+kx)*Ci + ci -- the same order as the TPU
// kernel's im2col patches.
//
// The batch is walked as one tall "virtual" image: image n occupies virtual
// rows n*(H+1) .. n*(H+1)+H-1 and virtual row n*(H+1)+H is a zero separator
// that serves as the bottom padding of image n and the top padding of image
// n+1. A block owns a TH x TW tile of that virtual image, so small feature
// maps (7x7) share a block across images instead of leaving most of a tile
// empty. Outputs on separator rows or past the right edge are not stored.
//
// Padding lives in activated space: the halo outside the image is zero after
// the activation, not relu(0*s+b).
//
// Numerics follow the TPU kernel's _act/_compute_dtype: for bf16 input, s
// and b are rounded to bf16, then x*s and +b are each rounded to bf16 (no
// FMA contraction); for f32 the product and sum are separate f32 ops.
// Accumulation is f32. The f32 kernel runs on the CUDA cores with FMA (no
// TF32), so its result differs from a float32 reference only by summation
// order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;                 // output tile: virtual rows
constexpr int TW = 8;                  // output tile: columns (128 pixels)
constexpr int BN = 64;                 // output channels per block
constexpr int HALO_W = TW + 2;
constexpr int HALO_P = (TH + 2) * HALO_W;  // 180 halo pixels
constexpr int THREADS = 256;

// bf16 kernel: 32 input channels per chunk; rows padded so that ldmatrix
// row addresses fall in distinct banks (80-byte and 144-byte strides).
constexpr int CK16 = 32;
constexpr int LDH16 = CK16 + 8;
constexpr int LDB16 = BN + 8;
constexpr int SMEM16 = (HALO_P * LDH16 + 9 * CK16 * LDB16) * 2;

// f32 kernel: 16 input channels per chunk.
constexpr int CK32 = 16;
constexpr int LDH32 = CK32 + 1;
constexpr int LDB32 = BN + 4;
constexpr int SMEM32 = (HALO_P * LDH32 + 9 * CK32 * LDB32) * 4;

struct Geom {
  int N, H, W, Ci, Co;
  int V;          // virtual rows: N*(H+1) - 1
  int col_tiles;  // ceil(W / TW)
  int relu;
  int xvec;       // x rows may be read 16 bytes at a time
  int wvec;       // w rows may be read 16 bytes at a time
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
// Returns the element offset of that pixel's channel 0 in x, or -1 where the
// pixel is padding (outside the image, or on a separator row).
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

// Output pixel m of the tile -> element offset of its channel 0 in out, or
// -1 where nothing is stored.
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
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ void fill_halo16(__nv_bfloat16* Hs, const __nv_bfloat16* x,
                            const float* s, const float* b, const Geom& g,
                            int r0, int c0, int ci0) {
  constexpr int VPP = CK16 / 8;  // 16-byte vectors per halo pixel
  for (int idx = threadIdx.x; idx < HALO_P * VPP; idx += THREADS) {
    int p = idx / VPP;
    int v = idx - p * VPP;
    int ci = ci0 + v * 8;
    long long off = halo_offset(g, r0, c0, p);
    __align__(16) __nv_bfloat16 o[8];
    if (off >= 0 && g.xvec && ci + 8 <= g.Ci) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + off + ci));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v16 = act16(__bfloat162float(e[j]),
                          bf16_round(__ldg(s + ci + j)),
                          bf16_round(__ldg(b + ci + j)), g.relu);
        o[j] = __float2bfloat16_rn(v16);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v16 = 0.f;
        if (off >= 0 && ci + j < g.Ci)
          v16 = act16(__bfloat162float(x[off + ci + j]),
                      bf16_round(__ldg(s + ci + j)),
                      bf16_round(__ldg(b + ci + j)), g.relu);
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
  for (int idx = threadIdx.x; idx < 9 * CK16 * VPR; idx += THREADS) {
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

  float acc[2][4][4];
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

  // Epilogue: accumulator (row g, cols 2t, 2t+1) and (row g+8, same cols).
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

// ---------------------------------------------------------------------------
// f32: CUDA cores, full float32 FMA
// ---------------------------------------------------------------------------

__device__ void fill_halo32(float* Hs, const float* x, const float* s,
                            const float* b, const Geom& g, int r0, int c0,
                            int ci0) {
  constexpr int VPP = CK32 / 4;
  for (int idx = threadIdx.x; idx < HALO_P * VPP; idx += THREADS) {
    int p = idx / VPP;
    int v = idx - p * VPP;
    int ci = ci0 + v * 4;
    long long off = halo_offset(g, r0, c0, p);
    float o[4];
    if (off >= 0 && g.xvec && ci + 4 <= g.Ci) {
      float4 raw = __ldg(reinterpret_cast<const float4*>(x + off + ci));
      o[0] = act32(raw.x, __ldg(s + ci), __ldg(b + ci), g.relu);
      o[1] = act32(raw.y, __ldg(s + ci + 1), __ldg(b + ci + 1), g.relu);
      o[2] = act32(raw.z, __ldg(s + ci + 2), __ldg(b + ci + 2), g.relu);
      o[3] = act32(raw.w, __ldg(s + ci + 3), __ldg(b + ci + 3), g.relu);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = (off >= 0 && ci + j < g.Ci)
                   ? act32(x[off + ci + j], __ldg(s + ci + j),
                           __ldg(b + ci + j), g.relu)
                   : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) Hs[p * LDH32 + v * 4 + j] = o[j];
  }
}

__device__ void fill_w32(float* Bs, const float* w, const Geom& g, int ci0,
                         int co0) {
  constexpr int VPR = BN / 4;
  for (int idx = threadIdx.x; idx < 9 * CK32 * VPR; idx += THREADS) {
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

  // Thread (tm, tn) owns tile row tm (8 pixels) and channels 4*tn .. +3.
  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;

  float acc[TW][4];
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

template <typename T>
using KernelFn = void (*)(const T*, const float*, const float*, const T*, T*,
                          Geom);

template <typename T>
int launch(KernelFn<T> kernel, int smem, int vec_elems, const void* x,
           const float* s, const float* b, const void* w, void* out, int N,
           int H, int W, int Ci, int Co, int relu, void* stream) {
  Geom g;
  g.N = N;
  g.H = H;
  g.W = W;
  g.Ci = Ci;
  g.Co = Co;
  g.V = N * (H + 1) - 1;
  g.col_tiles = (W + TW - 1) / TW;
  g.relu = relu;
  g.xvec = (Ci % vec_elems == 0) &&
           (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  g.wvec = (Co % vec_elems == 0) &&
           (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((g.V + TH - 1) / TH) * g.col_tiles;
  const int co_tiles = (Co + BN - 1) / BN;
  if (blocks > 0x7fffffffLL || co_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks), co_tiles);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), s, b, static_cast<const T*>(w),
      static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch. Pointers are device
// pointers to contiguous tensors: x (N,H,W,Ci), s and b (Ci,) float32,
// w (9*Ci, Co) tap-major, out (N,H,W,Co); x, w and out share the dtype.
// The kernel runs on `stream` and is not waited for.

int conv_fused_fwd_bf16(const void* x, const float* s, const float* b,
                        const void* w, void* out, int N, int H, int W, int Ci,
                        int Co, int relu, void* stream) {
  return launch<__nv_bfloat16>(conv_fused_bf16_kernel, SMEM16, 8, x, s, b, w,
                               out, N, H, W, Ci, Co, relu, stream);
}

int conv_fused_fwd_f32(const void* x, const float* s, const float* b,
                       const void* w, void* out, int N, int H, int W, int Ci,
                       int Co, int relu, void* stream) {
  return launch<float>(conv_fused_f32_kernel, SMEM32, 4, x, s, b, w, out, N,
                       H, W, Ci, Co, relu, stream);
}

}  // extern "C"
