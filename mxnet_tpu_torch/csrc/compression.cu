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
// One launch serves a list of up to MAX_SEGS tensors (segments): a
// compressed store encodes every large gradient of a push in one quantize
// launch and decodes them in one dequantize launch. The segment table goes
// by value, a __grid_constant__ parameter (pointers, n, and the prefix of
// chunk counts); a longer list takes further launches. A TPU grid runs in
// order on one core and a TPU call costs little; here a launch per tensor
// costs ~4 us of ramp, partial wave and drain against well under 1 us of
// bytes for most of ResNet-50's 54 compressed tensors, so the list is one
// flat walk.
//
// The walk: a chunk is a run of whole words inside one segment (quantize:
// SLAB bytes of the gradient, 128 words in bf16, 64 in f32; dequantize:
// D_WORDS words), numbered across the segments in order. A persistent grid
// of about BLOCKS_PER_SM blocks of WARPS warps per SM (capped at the chunk
// count; the wrapper's codec_plan sizes it) hands chunk c to warp c mod W
// of the W warps; a warp finds a chunk's segment by advancing a cursor
// over the prefix. Chunks never cross a segment, so each segment's words
// start at its own word 0.
//
// Quantize: each warp keeps a ring of Q_STAGES stages in shared memory that
// its lane 0 fills with 1-D bulk copies (cp.async.bulk, TMA with no tensor
// map: no encoder, no context needed on the host), the chunk's gradient and
// residual slabs, Q_STAGES chunks ahead of the compute, completing on the
// stage's mbarrier. The warp computes from shared memory: lane l takes the
// 16-byte units l, l + 32, ... (8 bf16 or 4 f32 values each), writes their
// new residuals as coalesced 16-byte stores, and the lanes of one word
// (2 in bf16, 4 in f32) OR their codes by shuffles; the first writes the
// word. Dequantize: lane l reads words l, l + 32, ... of the chunk
// (coalesced); each lane then expands 16-byte units of the chunk's values
// (unit u takes its word from lane (u / 4) mod 32 by shuffle) into a
// shared stage, and lane 0 writes the stage to device memory as one bulk
// store (cp.async.bulk.global.shared::cta), a ring of D_STAGES stages per
// warp so that a store drains while the next chunk expands.
//
// Alignment and tails: a bulk copy needs 16-byte addresses and sizes. A
// segment whose pointers are not 16-byte aligned (grad, residual and new
// residual; the output of a dequantize), and the final partial word of a
// segment, take a scalar route inside the same launch: lane l handles
// value v0 + l, the 16 lanes of a word OR their codes by shuffles.
//
// What bounds them on an H100: bytes. Quantize reads grad and residual and
// writes the residual and a 4-byte word per 16 values: 6.25 bytes per
// value in bf16, 12.25 in f32, against a handful of operations;
// dequantize reads 0.25 and writes 4 bytes per value. The ring keeps
// WARPS * BLOCKS_PER_SM * Q_STAGES * Q_STAGE = 192 KB of loads in flight
// per SM without registers. Over ResNet-50's 54 compressed gradients (one
// train_kv step, bf16, one launch each) the two kernels run at 76-79% of
// the bound on an H100 SXM at 700 W (PERF.md, rows 14 and 15); a tensor
// alone still pays ~3-4 us of launch, ramp and drain, which the grouped
// launch pays once for the whole list.
//
// Measured before keeping (chip_codec_probe.py, in turns on one card, ms
// per step): the quantize ring at 2 stages and 3 blocks an SM (as_is,
// 0.0611 / 0.0627) against 3 stages at 2 blocks (b2s3, 0.0635 / 0.0618)
// and against no ring, each lane's 8 gradient and 8 residual units
// loaded as 16-byte __ldg loads, all in flight before the compute, at 8
// blocks an SM (vec8, 0.0612 / 0.0617): within noise of each other, so the
// ring stays. Writing the dequantized units straight from registers
// (dq_direct, 0.0438 / 0.0438) lost to the staged bulk store (0.0408 /
// 0.0409).
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

#include "sm90.cuh"

namespace {

constexpr int GROUP = 16;                  // values per word
constexpr int WARPS = 4;                   // warps per block
constexpr int MAX_SEGS = 64;               // segments per launch
constexpr int SLAB = 4096;                 // bytes of one tensor per chunk
constexpr int Q_STAGES = 2;
constexpr int Q_STAGE = 2 * SLAB;          // gradient and residual slabs
constexpr int Q_SMEM = WARPS * Q_STAGES * Q_STAGE;
constexpr int D_WORDS = 128;               // words per dequantize chunk
constexpr int D_STAGES = 2;
constexpr int D_STAGE = D_WORDS * GROUP * 4;
constexpr int D_SMEM = WARPS * D_STAGES * D_STAGE;
constexpr unsigned FULL = 0xffffffffu;

// One quantize segment: n values of grad and res in, n of new_res and
// ceil(n / 16) words out; `first` is its first chunk in the launch.
struct QSeg {
  const void* grad;
  const void* res;
  void* new_res;
  uint32_t* words;
  long long n;
  long long first;
};

// One dequantize segment: ceil(n / 16) words in, n float32 out.
struct DSeg {
  const uint32_t* words;
  float* out;
  long long n;
  long long first;
};

// A launch's segments, by value. Bit s of `bulk` says that segment s takes
// the bulk route (its pointers 16-byte aligned).
template <typename Seg>
struct Table {
  int nseg;
  int chunks;
  unsigned long long bulk;
  float thr;
  Seg seg[MAX_SEGS];
};

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

// The code of one value, its new residual written to *out.
template <typename T>
__device__ __forceinline__ uint32_t encode(T g, T r, float thr, T* out) {
  const T* tag = nullptr;
  const float x = rnd(__fadd_rn(to_f(r), to_f(g)), tag);
  const bool pos = x >= thr;
  const bool neg = x <= -thr;
  float nr = rnd(__fsub_rn(x, pos ? thr : 0.f), tag);
  nr = rnd(__fadd_rn(nr, neg ? thr : 0.f), tag);
  from_f(nr, out);
  return pos ? 3u : (neg ? 2u : 0u);
}

__device__ __forceinline__ float decode(uint32_t word, int k, float thr) {
  const uint32_t code = (word >> (2 * (GROUP - 1 - k))) & 3u;
  return code == 3u ? thr : (code == 2u ? -thr : 0.f);
}

// The segment of chunk c: advances cursor s (chunks only grow along a
// warp's walk, and every segment has at least one chunk).
template <typename Seg>
__device__ __forceinline__ int seg_of(const Table<Seg>& t, int c, int s) {
  while (s + 1 < t.nseg && c >= t.seg[s + 1].first) ++s;
  return s;
}

// The scalar route of quantize over values [v0, v1) of one segment, v0 at
// a word's start: lane l takes value v0 + l (+ 32k); the 16 lanes of a word
// OR their codes, and the word's first lane writes it.
template <typename T>
__device__ void quantize_scalar(const QSeg& g, long long v0, long long v1,
                                float thr, int lane) {
  const T* grad = static_cast<const T*>(g.grad);
  const T* res = static_cast<const T*>(g.res);
  T* new_res = static_cast<T*>(g.new_res);
  for (; v0 < v1; v0 += 32) {
    const long long v = v0 + lane;
    uint32_t bits = 0u;
    if (v < v1)
      bits = encode(grad[v], res[v], thr, new_res + v)
             << (2 * (GROUP - 1 - lane % GROUP));
#pragma unroll
    for (int o = GROUP / 2; o >= 1; o /= 2) bits |= __shfl_xor_sync(FULL, bits, o);
    if (lane % GROUP == 0 && v < v1) g.words[v / GROUP] = bits;
  }
}

template <typename T>
__device__ __forceinline__ void quantize_issue(const QSeg& g, bool bulk,
                                               long long w0, int cw,
                                               unsigned char* stage,
                                               uint64_t* bar) {
  // the chunk's whole words go by bulk copy; the rest by the scalar route
  long long fw = g.n / GROUP - w0;
  fw = fw < 0 ? 0 : (fw > cw ? cw : fw);
  if (bulk && fw > 0) {
    const unsigned bytes = static_cast<unsigned>(fw * GROUP * sizeof(T));
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(stage, static_cast<const T*>(g.grad) + w0 * GROUP, bytes, bar);
    bulk_load(stage + SLAB, static_cast<const T*>(g.res) + w0 * GROUP, bytes,
              bar);
  } else {
    mbar_arrive(bar);
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
codec_quantize_kernel(const __grid_constant__ Table<QSeg> t) {
  constexpr int CW = SLAB / (GROUP * static_cast<int>(sizeof(T)));
  constexpr int VPU = 16 / static_cast<int>(sizeof(T));   // values a unit
  constexpr int UPW = GROUP / VPU;                         // units a word
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[WARPS][Q_STAGES];
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* ring = smem_raw + h * Q_STAGES * Q_STAGE;
  if (lane == 0) {
    for (int st = 0; st < Q_STAGES; ++st) mbar_init(&full[h][st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int step = gridDim.x * WARPS;
  // the producer's cursor runs Q_STAGES chunks ahead of the compute
  int pc = blockIdx.x * WARPS + h, ps = 0;
  for (int st = 0; st < Q_STAGES && pc < t.chunks; ++st, pc += step) {
    ps = seg_of(t, pc, ps);
    if (lane == 0)
      quantize_issue<T>(t.seg[ps], (t.bulk >> ps) & 1, (pc - t.seg[ps].first) *
                        static_cast<long long>(CW), CW, ring + st * Q_STAGE,
                        &full[h][st]);
  }

  int s = 0, q = 0;
  for (int c = blockIdx.x * WARPS + h; c < t.chunks; c += step, ++q) {
    s = seg_of(t, c, s);
    const QSeg& g = t.seg[s];
    const long long w0 = (c - g.first) * static_cast<long long>(CW);
    long long fw = g.n / GROUP - w0;
    fw = fw < 0 ? 0 : (fw > CW ? CW : fw);
    const bool bulk = ((t.bulk >> s) & 1) && fw > 0;
    const int st = q % Q_STAGES;
    unsigned char* stage = ring + st * Q_STAGE;
    mbar_wait(&full[h][st], (q / Q_STAGES) & 1);
    if (bulk) {
      const uint4* gs = reinterpret_cast<const uint4*>(stage);
      const uint4* rs = reinterpret_cast<const uint4*>(stage + SLAB);
      uint4* out = reinterpret_cast<uint4*>(static_cast<T*>(g.new_res) +
                                            w0 * GROUP);
      const int units = static_cast<int>(fw) * UPW;
      for (int base = 0; base < units; base += 32) {
        const int u = base + lane;
        uint32_t bits = 0u;
        if (u < units) {
          const uint4 gv = gs[u];
          uint4 rv = rs[u];
          const T* ge = reinterpret_cast<const T*>(&gv);
          T* re = reinterpret_cast<T*>(&rv);
#pragma unroll
          for (int k = 0; k < VPU; ++k)
            bits |= encode(ge[k], re[k], t.thr, re + k)
                    << (2 * (GROUP - 1 - (u % UPW) * VPU - k));
          out[u] = rv;
        }
#pragma unroll
        for (int o = 1; o < UPW; o *= 2) bits |= __shfl_xor_sync(FULL, bits, o);
        if (u < units && lane % UPW == 0) g.words[w0 + u / UPW] = bits;
      }
    }
    // the rest of the chunk: a misaligned segment's words, the last partial
    // word
    long long v1 = (w0 + CW) * GROUP;
    v1 = v1 < g.n ? v1 : g.n;
    quantize_scalar<T>(g, (w0 + (bulk ? fw : 0)) * GROUP, v1, t.thr, lane);
    __syncwarp();
    if (pc < t.chunks) {
      ps = seg_of(t, pc, ps);
      if (lane == 0)
        quantize_issue<T>(t.seg[ps], (t.bulk >> ps) & 1,
                          (pc - t.seg[ps].first) * static_cast<long long>(CW),
                          CW, stage, &full[h][st]);
      pc += step;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
codec_dequantize_kernel(const __grid_constant__ Table<DSeg> t) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ring = reinterpret_cast<float*>(smem_raw + h * D_STAGES * D_STAGE);
  const float thr = t.thr;
  int s = 0, q = 0;
  for (int c = blockIdx.x * WARPS + h; c < t.chunks;
       c += gridDim.x * WARPS) {
    s = seg_of(t, c, s);
    const DSeg& g = t.seg[s];
    const long long w0 = (c - g.first) * static_cast<long long>(D_WORDS);
    long long fw = g.n / GROUP - w0;
    fw = fw < 0 ? 0 : (fw > D_WORDS ? D_WORDS : fw);
    const bool bulk = ((t.bulk >> s) & 1) && fw > 0;
    if (bulk) {
      const int nw = static_cast<int>(fw);
      uint32_t wd[D_WORDS / 32];
#pragma unroll
      for (int k = 0; k < D_WORDS / 32; ++k)
        wd[k] = lane + 32 * k < nw ? __ldg(g.words + w0 + lane + 32 * k) : 0u;
      float* stage = ring + (q % D_STAGES) * (D_STAGE / 4);
      // the bulk store that last read this stage is done reading it
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(D_STAGES - 1)
                     : "memory");
      __syncwarp();
      // unit u = 32 i + lane, i = 4 k + j: values 4u .. 4u + 3 of the
      // chunk, quarter u % 4 of word u / 4 = 32 k + 8 j + lane / 4, which
      // lane 8 j + lane / 4 holds in wd[k]
      const int k0 = 4 * (lane % 4);
#pragma unroll
      for (int k = 0; k < D_WORDS / 32; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * k + j;
          if (8 * i < nw) {
            const uint32_t word = __shfl_sync(FULL, wd[k], 8 * j + lane / 4);
            if (8 * i + lane / 4 < nw)
              reinterpret_cast<float4*>(stage)[32 * i + lane] = make_float4(
                  decode(word, k0, thr), decode(word, k0 + 1, thr),
                  decode(word, k0 + 2, thr), decode(word, k0 + 3, thr));
          }
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        bulk_store(g.out + w0 * GROUP, stage,
                   static_cast<unsigned>(nw) * GROUP * 4u);
        tma_store_commit();
      }
      ++q;
    }
    // the rest of the chunk: a misaligned segment's words, the last partial
    // word
    long long v1 = (w0 + D_WORDS) * GROUP;
    v1 = v1 < g.n ? v1 : g.n;
    for (long long v0 = (w0 + (bulk ? fw : 0)) * GROUP; v0 < v1; v0 += 32) {
      const long long v = v0 + lane;
      if (v < v1)
        g.out[v] = decode(__ldg(g.words + v / GROUP),
                          static_cast<int>(v % GROUP), thr);
    }
  }
  // the shared stages outlive their bulk stores
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Checks the table's segments (1..MAX_SEGS, n > 0, `first` the prefix of
// ceil(ceil(n / 16) / words_per_chunk)) and the grid; fills chunks. Returns
// 0 or a cudaError_t.
template <typename Seg>
int check_table(Table<Seg>& t, int words_per_chunk, int grid) {
  if (t.nseg < 1 || t.nseg > MAX_SEGS)
    return static_cast<int>(cudaErrorInvalidValue);
  long long chunks = 0;
  for (int s = 0; s < t.nseg; ++s) {
    const long long n = t.seg[s].n;
    if (n <= 0 || t.seg[s].first != chunks)
      return static_cast<int>(cudaErrorInvalidValue);
    chunks += ((n + GROUP - 1) / GROUP + words_per_chunk - 1) /
              words_per_chunk;
  }
  if (chunks > 0x7fffffffLL || grid < 1 ||
      grid > (chunks + WARPS - 1) / WARPS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  t.chunks = static_cast<int>(chunks);
  return 0;
}

template <typename T>
int quantize_group(const QSeg* segs, int nseg, float thr, int grid,
                   void* stream) {
  // The runtime call first, as in the port's other launchers.
  auto kernel = codec_quantize_kernel<T>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM));
  if (err != 0) return err;
  Table<QSeg> t = {};
  t.nseg = nseg;
  t.thr = thr;
  for (int s = 0; s < nseg && s < MAX_SEGS; ++s) {
    t.seg[s] = segs[s];
    if (aligned16(segs[s].grad) && aligned16(segs[s].res) &&
        aligned16(segs[s].new_res))
      t.bulk |= 1ull << s;
  }
  err = check_table(t, SLAB / (GROUP * static_cast<int>(sizeof(T))), grid);
  if (err != 0) return err;
  kernel<<<grid, WARPS * 32, Q_SMEM, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or a cudaError_t. `segs` is a host array of nseg (1 to 64)
// segments; every pointer in it is a device pointer to a contiguous
// 1-D tensor, no two overlapping: grad, res and new_res hold n values of
// the kernel's dtype, words ceil(n / 16) int32. `first` is the segment's
// first chunk: the sum over the earlier segments of their chunks,
// ceil(ceil(n / 16) / chunk words) with 4096 / (16 * sizeof(dtype)) words a
// chunk. thr is the threshold rounded to that dtype; grid (1 to ceil(chunks
// / 4)) the number of blocks. Runs on `stream`, not waited for.

int quantize_2bit_group_bf16(const void* segs, int nseg, float thr, int grid,
                             void* stream) {
  return quantize_group<__nv_bfloat16>(static_cast<const QSeg*>(segs), nseg,
                                       thr, grid, stream);
}

int quantize_2bit_group_f32(const void* segs, int nseg, float thr, int grid,
                            void* stream) {
  return quantize_group<float>(static_cast<const QSeg*>(segs), nseg, thr,
                               grid, stream);
}

// The same for decoding: words ceil(n / 16) int32 in, out n float32, with
// 128 words a chunk; thr is the float32 threshold.
int dequantize_2bit_group_f32(const void* segs, int nseg, float thr, int grid,
                              void* stream) {
  auto kernel = codec_dequantize_kernel;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM));
  if (err != 0) return err;
  const DSeg* in = static_cast<const DSeg*>(segs);
  Table<DSeg> t = {};
  t.nseg = nseg;
  t.thr = thr;
  for (int s = 0; s < nseg && s < MAX_SEGS; ++s) {
    t.seg[s] = in[s];
    if (aligned16(in[s].out)) t.bulk |= 1ull << s;
  }
  err = check_table(t, D_WORDS, grid);
  if (err != 0) return err;
  kernel<<<grid, WARPS * 32, D_SMEM, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
