// 2-bit gradient compression with error feedback, for Hopper (sm_90a).
//
// Replaces the TPU kernels of mxnet_tpu/pallas_kernels/compression.py:
// _quant_kernel (launched from quantize_2bit) and _dequant_kernel
// (launched from dequantize_2bit).
//
//     quantize:    r = residual + grad
//                  code 3 where r >= thr, 2 where r <= -thr, else 0
//                  new_residual = (r - pos * thr) + neg * thr
//                  16 codes per int32 word, value i of a group at bit-pair
//                  15 - i; ceil(n / 16) words, the tail padded with code 0
//     dequantize:  each bit-pair -> +thr (3), -thr (2) or 0, float32, n values
//
// The TPU kernel transposed the padded values into a (16, words) tile so
// that the shift-or ran across lanes; here one thread owns one word: it
// reads that word's 16 gradient and residual values (16-byte vector loads
// where every pointer is 16-byte aligned, scalar loads otherwise, and only
// up to n in the tail word), writes their 16 new residuals and builds the
// word in a uint32_t (3 << 30 does not fit a signed int). Dequantize is the
// same walk backwards, with four 16-byte float32 stores per full word.
//
// What bounds it on an H100: bytes. Quantize reads grad and residual and
// writes the residual and 1/8 of a 4-byte word per value: 6.125 bytes per
// value in bf16, 12.125 in f32, against a handful of operations.
// Dequantize reads 1/8 word and writes 4 bytes per value. The grid-stride
// loop keeps every load and store a 16-byte transaction on aligned data.
//
// Numerics: the words and residuals must equal the plain PyTorch version
// bit for bit, which runs each op as its own elementwise kernel and rounds
// to the gradient's dtype after every op. So every op here is a separate
// correctly rounded __fadd_rn / __fsub_rn, rounded to bf16 after each op in
// the bf16 kernel, with the zero terms included: for code 0 and r = -0.0
// the residual is (-0.0 - 0.0) + 0.0 = +0.0, not r. The threshold arrives
// already rounded to the gradient's dtype (a weak scalar in JAX). NaN
// compares false both ways and gives code 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 16;

__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rnd(float v, const float*) { return v; }

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }

template <typename T>
__global__ void __launch_bounds__(256)
codec_quantize_kernel(const T* __restrict__ grad, const T* __restrict__ res,
                      T* __restrict__ new_res, uint32_t* __restrict__ words,
                      long long n, long long nwords, float thr, bool vec) {
  constexpr int CHUNKS = GROUP * sizeof(T) / 16;   // uint4 per group
  const T* tag = nullptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < nwords; w += stride) {
    const long long e0 = w * GROUP;
    const long long left = n - e0;
    const int cnt = left < GROUP ? static_cast<int>(left) : GROUP;
    __align__(16) T gv[GROUP];
    __align__(16) T rv[GROUP];
    if (vec && cnt == GROUP) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        reinterpret_cast<uint4*>(gv)[c] =
            __ldg(reinterpret_cast<const uint4*>(grad + e0) + c);
        reinterpret_cast<uint4*>(rv)[c] =
            __ldg(reinterpret_cast<const uint4*>(res + e0) + c);
      }
    } else {
      for (int k = 0; k < cnt; ++k) {
        gv[k] = grad[e0 + k];
        rv[k] = res[e0 + k];
      }
    }
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      if (k < cnt) {
        const float r = rnd(__fadd_rn(to_f(rv[k]), to_f(gv[k])), tag);
        const bool pos = r >= thr;
        const bool neg = r <= -thr;
        const uint32_t code = pos ? 3u : (neg ? 2u : 0u);
        float nr = rnd(__fsub_rn(r, pos ? thr : 0.f), tag);
        nr = rnd(__fadd_rn(nr, neg ? thr : 0.f), tag);
        from_f(nr, rv + k);
        word |= code << (2 * (GROUP - 1 - k));
      }
    }
    if (vec && cnt == GROUP) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        reinterpret_cast<uint4*>(new_res + e0)[c] =
            reinterpret_cast<const uint4*>(rv)[c];
    } else {
      for (int k = 0; k < cnt; ++k) new_res[e0 + k] = rv[k];
    }
    words[w] = word;
  }
}

__global__ void __launch_bounds__(256)
codec_dequantize_kernel(const uint32_t* __restrict__ words,
                        float* __restrict__ out, long long n, long long nwords,
                        float thr, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       w < nwords; w += stride) {
    const uint32_t word = __ldg(words + w);
    const long long e0 = w * GROUP;
    const long long left = n - e0;
    const int cnt = left < GROUP ? static_cast<int>(left) : GROUP;
    __align__(16) float v[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const uint32_t code = (word >> (2 * (GROUP - 1 - k))) & 3u;
      v[k] = code == 3u ? thr : (code == 2u ? -thr : 0.f);
    }
    if (vec && cnt == GROUP) {
#pragma unroll
      for (int c = 0; c < GROUP / 4; ++c)
        reinterpret_cast<float4*>(out + e0)[c] =
            reinterpret_cast<const float4*>(v)[c];
    } else {
      for (int k = 0; k < cnt; ++k) out[e0 + k] = v[k];
    }
  }
}

int grid(long long nwords) {
  long long blocks = (nwords + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<int>(blocks);
}

bool aligned(const void* a, const void* b = nullptr,
             const void* c = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) & 15) == 0;
}

template <typename T>
int quantize(const void* grad, const void* res, void* new_res, void* words,
             long long n, float thr, void* stream) {
  if (n <= 0) return 0;
  const long long nwords = (n + GROUP - 1) / GROUP;
  codec_quantize_kernel<T><<<grid(nwords), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(grad), static_cast<const T*>(res),
      static_cast<T*>(new_res), static_cast<uint32_t*>(words), n, nwords,
      thr, aligned(grad, res, new_res));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch. All pointers are device
// pointers to contiguous 1-D tensors that do not overlap: grad, res and
// new_res hold n values of the kernel's dtype, words ceil(n / 16) int32.
// thr is the threshold rounded to that dtype. Runs on `stream`, not waited
// for.

int quantize_2bit_bf16(const void* grad, const void* res, void* new_res,
                       void* words, long long n, float thr, void* stream) {
  return quantize<__nv_bfloat16>(grad, res, new_res, words, n, thr, stream);
}

int quantize_2bit_f32(const void* grad, const void* res, void* new_res,
                      void* words, long long n, float thr, void* stream) {
  return quantize<float>(grad, res, new_res, words, n, thr, stream);
}

// words: ceil(n / 16) int32; out: n float32; thr: the float32 threshold.
int dequantize_2bit_f32(const void* words, void* out, long long n, float thr,
                        void* stream) {
  if (n <= 0) return 0;
  const long long nwords = (n + GROUP - 1) / GROUP;
  codec_dequantize_kernel<<<grid(nwords), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<float*>(out), n,
      nwords, thr, aligned(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
