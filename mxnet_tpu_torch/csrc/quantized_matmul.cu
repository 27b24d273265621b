// int8 x int8 -> int32 matrix product for Hopper (sm_90a), with an optional
// per-output-channel f32 dequantize in the epilogue.
//
//     out[m, n] = sum_k x[m, k] * w[k, n]                    (int32)
//     out[m, n] = float(sum_k x[m, k] * w[k, n]) * scales[n]  (scaled, f32)
//
// Replaces the TPU kernels of mxnet_tpu/pallas_kernels/quantized_matmul.py:
//   _mm_kernel        (launched from _pallas_matmul) -> qmm_s32
//   _mm_scaled_kernel (launched from _pallas_matmul) -> qmm_scaled
// The TPU ran a (M/TM, N/TN, K/TK) grid in order and carried the int32 sum
// from one K step to the next in VMEM scratch. Here one block owns a 128 x 64
// output tile and loops over K itself, the sum in registers: 4 warps of
// 64 x 32, each step an mma.sync m16n8k32 (s8 x s8 -> s32). The A (x) and B
// (w) tiles of 64 bytes of K are double-buffered in shared memory with
// cp.async, so the next tile's load overlaps this tile's products; rows are
// padded to 80 bytes so that ldmatrix reads eight rows without bank
// conflicts. No wgmma, TMA or persistent schedule yet: this is the simple
// form.
//
// What bounds it on an H100: at int8 ResNet-50's shapes most products have
// N <= 256 and K <= 4608, so the bytes moved (M*K + K*N read, 4*M*N written)
// take longer at 3.35 TB/s than the operations at 1979 TOPS: they are bound
// by bytes, and the f32 or int32 output is most of the bytes. The design
// reads each operand tile once per block and writes each output once.
//
// Operand layout: the int8 mma takes A row-major and B column-major, so
// both operands are K-contiguous: x[m, k] at x[m * lda + k] and w[k, n] at
// w[k + n * ldb]. Where K, lda and ldb are multiples of 16 and both base
// pointers 16-byte aligned, tiles load as 16-byte cp.async chunks (the
// chunk past M, N or K is zero-filled by the copy, which reads nothing); the
// quantized convolutions' im2col pads K to a multiple of 16 for this (147 ->
// 160 at ResNet-50's stem). Any other shape (odd K, K = 147 unpadded, a
// misaligned view) takes the byte path:
// guarded one-byte loads into the same tiles, zeros past every edge. Neither
// path reads past a row. Zeros add nothing to an integer sum.
//
// Numerics: the int32 sum is exact. Integer mma without .satfinite wraps
// on overflow as XLA's int32 dot does; at ResNet-50 K <= 4608, so |acc| <=
// 4608 * 127^2 ~ 7.4e7, far from 2^31. The scaled epilogue converts with
// round-to-nearest (__int2float_rn: |acc| can exceed 2^24) and multiplies
// once (__fmul_rn), as the plain version's acc.to(float32) * scales does, so
// both outputs equal the plain version bit for bit. The bias is not fused:
// the callers add it after the product, as the JAX package does, and a fused
// add could be contracted into one FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;     // 4 warps, 2 (M) x 2 (N)
constexpr int BM = 128;          // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 64;           // bytes of K per tile
constexpr int PITCH = BK + 16;   // shared row pitch: conflict-free ldmatrix
constexpr int WM = 64;           // rows per warp: 4 m16 tiles
constexpr int WN = 32;           // columns per warp: 4 n8 tiles

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* scales;           // scaled kernel only
  void* out;                     // [M, N] contiguous: int32 or f32
  int M, N, K;
  long long lda, ldb;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (rows x BK) tile of a K-contiguous operand into shared memory:
// row r of the tile is operand row row0 + r (x's m, or w's n), bytes k0 ..
// k0 + BK of it. VEC: 16-byte cp.async chunks (K, ld and base 16-aligned);
// else guarded byte loads.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(int8_t (*tile)[PITCH],
                                          const int8_t* base, long long ld,
                                          int row0, int nrows, int k0, int K) {
  if (VEC) {
    constexpr int CHUNKS = ROWS * (BK / 16);
#pragma unroll
    for (int i = 0; i < CHUNKS / THREADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c / (BK / 16);
      const int kc = k0 + (c % (BK / 16)) * 16;
      const bool ok = row0 + r < nrows && kc < K;
      const int8_t* src =
          ok ? base + static_cast<long long>(row0 + r) * ld + kc : base;
      cp_async16(&tile[r][(c % (BK / 16)) * 16], src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * BK / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / BK;
      const int k = k0 + e % BK;
      int8_t v = 0;
      if (row0 + r < nrows && k < K)
        v = base[static_cast<long long>(row0 + r) * ld + k];
      tile[r][e % BK] = v;
    }
  }
}

template <bool SCALED, bool VEC>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[2][BM][PITCH];
  __shared__ __align__(16) int8_t Bs[2][BN][PITCH];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * WM;
  const int wn = (warp & 1) * WN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = p.K > 0 ? (p.K + BK - 1) / BK : 1;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load_tile<BM, VEC>(As[0], p.x, p.lda, m0, p.M, 0, p.K);
  load_tile<BN, VEC>(Bs[0], p.w, p.ldb, n0, p.N, 0, p.K);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile<BM, VEC>(As[s ^ 1], p.x, p.lda, m0, p.M, (kt + 1) * BK, p.K);
      load_tile<BN, VEC>(Bs[s ^ 1], p.w, p.ldb, n0, p.N, (kt + 1) * BK, p.K);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt],
                &As[s][wm + mt * 16 + (lane & 15)][kk + (lane >> 4) * 16]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, &Bs[s][wn + np * 16 + (lane & 7) + (lane >> 4) * 8]
                       [kk + ((lane >> 3) & 1) * 16]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();
  }

  // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + g + half * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + nt * 8 + 2 * t + j;
          if (n >= p.N) continue;
          const long long o = static_cast<long long>(m) * p.N + n;
          const int v = acc[mt][nt][half * 2 + j];
          if (SCALED)
            static_cast<float*>(p.out)[o] =
                __fmul_rn(__int2float_rn(v), p.scales[n]);
          else
            static_cast<int*>(p.out)[o] = v;
        }
      }
    }
  }
}

template <bool SCALED>
int run(const Params& p, void* stream) {
  if (p.M <= 0 || p.N <= 0) return 0;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = p.K % 16 == 0 && p.lda % 16 == 0 && p.ldb % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    qmm_kernel<SCALED, true><<<grid, THREADS, 0, s>>>(p);
  else
    qmm_kernel<SCALED, false><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make(const int8_t* x, const int8_t* w, const float* scales, void* out,
            int M, int N, int K, long long lda, long long ldb) {
  Params p;
  p.x = x;
  p.w = w;
  p.scales = scales;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  return p;
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch, runs on `stream` and is
// not waited for. x[m, k] is at x[m * lda + k], w[k, n] at w[k + n * ldb];
// out is a contiguous [M, N] int32 (qmm_s32) or f32 (qmm_scaled) tensor;
// scales holds N f32 values.

int qmm_s32(const int8_t* x, const int8_t* w, int* out, int M, int N, int K,
            long long lda, long long ldb, void* stream) {
  return run<false>(make(x, w, nullptr, out, M, N, K, lda, ldb), stream);
}

int qmm_scaled(const int8_t* x, const int8_t* w, const float* scales,
               float* out, int M, int N, int K, long long lda, long long ldb,
               void* stream) {
  return run<true>(make(x, w, scales, out, M, N, K, lda, ldb), stream);
}

}  // extern "C"
