// Packed multi-tensor SGD and Adam apply for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/optimizer_apply.py:
// _apply_kernel (launched from _pallas_apply), for SGD's step_fn:
//
//     g  = clip(grad * rescale)
//     t  = lr * (g + wd * w)
//     momentum 0:  w' = w - t
//     otherwise:   m' = momentum * m - t;   w' = w + m'
//
// and for Adam's (lr is the bias-corrected rate the host computed):
//
//     g  = clip(grad * rescale) + wd * w
//     m' = (b1 * m) + ((1 - b1) * g)
//     v' = (b2 * v) + (((1 - b2) * g) * g)
//     w' = w - ((lr * m') / (sqrt(v') + eps))
//
// One launch per bucket of parallel/overlap.bucket_plan (dtype-homogeneous,
// size-capped). The bucket is one 1-D index space: its tensors laid end to
// end, each padded to whole 16-byte vectors. The TPU kernel needed the
// bucket concatenated into one operand (and split again after); here a
// segment table (each tensor's weight, gradient and momentum pointers, its
// size, its first vector, its lr and wd) lets every thread read and write
// the tensors where they live, so there are no packing copies and the
// update is in place. The table has two state slots: SGD's momentum uses
// the first, Adam's m and v both.
//
// What bounds it on an H100: bytes. Per element SGD reads w, g (and m) and
// writes w (and m): 5 x 2 bytes in bf16 with momentum, against ~10 flops;
// Adam reads w, g, m, v and writes w, m, v: 7 x 2 bytes, against ~16.
// The design streams 16-byte vectors through a grid-stride loop; the
// segment of a vector comes from a binary search of the table (a few
// cached loads).
//
// Numerics: the result must equal the per-parameter PyTorch chain bit for
// bit. PyTorch runs each op of the chain as its own elementwise kernel,
// computing in float32 and rounding to the tensor dtype after every op. So
// every op here is a separate correctly rounded __fmul_rn/__fadd_rn/
// __fsub_rn (no FMA contraction), rounded to bf16 after each op in the bf16
// kernel. The scalars arrive already rounded to the weight's dtype, as the
// optimizer rounds them (base.weak_scalar). The clip is max-then-min and
// keeps NaN, as torch.clamp does. Adam's square root is __fsqrt_rn and its
// division __fdiv_rn (no rsqrt, no multiply by a reciprocal), each rounded
// to the dtype like the other ops.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Hyper {
  float rescale, mom, clip;
  int has_mom, has_clip;
};

struct AdamHyper {
  float rescale, b1, omb1, b2, omb2, eps, clip;   // omb = 1 - beta
  int has_clip;
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

// One element of SGD's step_fn; T selects the rounding after each op.
template <typename T>
__device__ __forceinline__ void sgd_one(float w, float g, float m, float lr,
                                        float wd, const Hyper& h, float* w_out,
                                        float* m_out) {
  const T* tag = nullptr;
  float gg = rnd(__fmul_rn(g, h.rescale), tag);
  if (h.has_clip) {
    gg = (gg < -h.clip) ? -h.clip : gg;   // max(g, -clip), NaN kept
    gg = (gg > h.clip) ? h.clip : gg;     // then min(., clip)
  }
  float t = rnd(__fmul_rn(wd, w), tag);
  t = rnd(__fadd_rn(gg, t), tag);
  t = rnd(__fmul_rn(lr, t), tag);
  if (h.has_mom) {
    float m2 = rnd(__fmul_rn(h.mom, m), tag);
    m2 = rnd(__fsub_rn(m2, t), tag);
    *w_out = rnd(__fadd_rn(w, m2), tag);
    *m_out = m2;
  } else {
    *w_out = rnd(__fsub_rn(w, t), tag);
    *m_out = m;
  }
}

// One element of Adam's step_fn; T selects the rounding after each op.
template <typename T>
__device__ __forceinline__ void adam_one(float w, float g, float m, float v,
                                         float lr, float wd,
                                         const AdamHyper& h, float* w_out,
                                         float* m_out, float* v_out) {
  const T* tag = nullptr;
  float gg = rnd(__fmul_rn(g, h.rescale), tag);
  if (h.has_clip) {
    gg = (gg < -h.clip) ? -h.clip : gg;   // max(g, -clip), NaN kept
    gg = (gg > h.clip) ? h.clip : gg;     // then min(., clip)
  }
  gg = rnd(__fadd_rn(gg, rnd(__fmul_rn(wd, w), tag)), tag);
  const float m2 = rnd(__fadd_rn(rnd(__fmul_rn(h.b1, m), tag),
                                 rnd(__fmul_rn(h.omb1, gg), tag)), tag);
  const float gv = rnd(__fmul_rn(rnd(__fmul_rn(h.omb2, gg), tag), gg), tag);
  const float v2 = rnd(__fadd_rn(rnd(__fmul_rn(h.b2, v), tag), gv), tag);
  const float den = rnd(__fadd_rn(rnd(__fsqrt_rn(v2), tag), h.eps), tag);
  const float step = rnd(__fdiv_rn(rnd(__fmul_rn(lr, m2), tag), den), tag);
  *w_out = rnd(__fsub_rn(w, step), tag);
  *m_out = m2;
  *v_out = v2;
}

// The segment of vector v: the last whose first vector is <= v (empty
// segments share their successor's first vector and are skipped by taking
// the last).
__device__ __forceinline__ int segment_of(const long long* vs, int nseg,
                                          long long v) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(vs + mid) <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The segment table, int64 entries: [w ptrs | g ptrs | state 0 ptrs |
// state 1 ptrs | sizes | first vectors], nseg each (a state pointer the
// optimizer does not use is 0); lrwd: [lr | wd], nseg floats each.
template <typename T>
__global__ void __launch_bounds__(256)
sgd_apply_kernel(const long long* __restrict__ tab,
                 const float* __restrict__ lrwd, int nseg,
                 long long total_vecs, Hyper h) {
  constexpr int VEC = 16 / sizeof(T);
  const long long* wp = tab;
  const long long* gp = tab + nseg;
  const long long* mp = tab + 2 * nseg;
  const long long* sz = tab + 4 * nseg;
  const long long* vs = tab + 5 * nseg;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < total_vecs; v += stride) {
    const int lo = segment_of(vs, nseg, v);
    const long long e0 = (v - __ldg(vs + lo)) * VEC;
    const long long n = __ldg(sz + lo);
    T* w = reinterpret_cast<T*>(__ldg(wp + lo));
    const T* g = reinterpret_cast<const T*>(__ldg(gp + lo));
    T* m = reinterpret_cast<T*>(__ldg(mp + lo));
    const float lr = __ldg(lrwd + lo);
    const float wd = __ldg(lrwd + nseg + lo);
    const long long left = n - e0;
    const int cnt = left < VEC ? static_cast<int>(left) : VEC;
    const uintptr_t align = reinterpret_cast<uintptr_t>(w) |
                            reinterpret_cast<uintptr_t>(g) |
                            (h.has_mom ? reinterpret_cast<uintptr_t>(m) : 0);
    if (cnt == VEC && (align & 15) == 0) {
      __align__(16) T wv[VEC];
      __align__(16) T gv[VEC];
      __align__(16) T mv[VEC];
      *reinterpret_cast<uint4*>(wv) =
          *reinterpret_cast<const uint4*>(w + e0);
      *reinterpret_cast<uint4*>(gv) =
          __ldg(reinterpret_cast<const uint4*>(g + e0));
      if (h.has_mom)
        *reinterpret_cast<uint4*>(mv) =
            *reinterpret_cast<const uint4*>(m + e0);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float nw, nm;
        sgd_one<T>(to_f(wv[k]), to_f(gv[k]), h.has_mom ? to_f(mv[k]) : 0.f,
                   lr, wd, h, &nw, &nm);
        from_f(nw, wv + k);
        from_f(nm, mv + k);
      }
      *reinterpret_cast<uint4*>(w + e0) = *reinterpret_cast<uint4*>(wv);
      if (h.has_mom)
        *reinterpret_cast<uint4*>(m + e0) = *reinterpret_cast<uint4*>(mv);
    } else {
      for (int k = 0; k < cnt; ++k) {
        float nw, nm;
        sgd_one<T>(to_f(w[e0 + k]), to_f(g[e0 + k]),
                   h.has_mom ? to_f(m[e0 + k]) : 0.f, lr, wd, h, &nw, &nm);
        from_f(nw, w + e0 + k);
        if (h.has_mom) from_f(nm, m + e0 + k);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
adam_apply_kernel(const long long* __restrict__ tab,
                  const float* __restrict__ lrwd, int nseg,
                  long long total_vecs, AdamHyper h) {
  constexpr int VEC = 16 / sizeof(T);
  const long long* wp = tab;
  const long long* gp = tab + nseg;
  const long long* mp = tab + 2 * nseg;
  const long long* vp = tab + 3 * nseg;
  const long long* sz = tab + 4 * nseg;
  const long long* vs = tab + 5 * nseg;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long vi = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       vi < total_vecs; vi += stride) {
    const int lo = segment_of(vs, nseg, vi);
    const long long e0 = (vi - __ldg(vs + lo)) * VEC;
    const long long n = __ldg(sz + lo);
    T* w = reinterpret_cast<T*>(__ldg(wp + lo));
    const T* g = reinterpret_cast<const T*>(__ldg(gp + lo));
    T* m = reinterpret_cast<T*>(__ldg(mp + lo));
    T* v = reinterpret_cast<T*>(__ldg(vp + lo));
    const float lr = __ldg(lrwd + lo);
    const float wd = __ldg(lrwd + nseg + lo);
    const long long left = n - e0;
    const int cnt = left < VEC ? static_cast<int>(left) : VEC;
    const uintptr_t align =
        reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
    if (cnt == VEC && (align & 15) == 0) {
      __align__(16) T wv[VEC];
      __align__(16) T gv[VEC];
      __align__(16) T mv[VEC];
      __align__(16) T vv[VEC];
      *reinterpret_cast<uint4*>(wv) =
          *reinterpret_cast<const uint4*>(w + e0);
      *reinterpret_cast<uint4*>(gv) =
          __ldg(reinterpret_cast<const uint4*>(g + e0));
      *reinterpret_cast<uint4*>(mv) =
          *reinterpret_cast<const uint4*>(m + e0);
      *reinterpret_cast<uint4*>(vv) =
          *reinterpret_cast<const uint4*>(v + e0);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float nw, nm, nv;
        adam_one<T>(to_f(wv[k]), to_f(gv[k]), to_f(mv[k]), to_f(vv[k]), lr,
                    wd, h, &nw, &nm, &nv);
        from_f(nw, wv + k);
        from_f(nm, mv + k);
        from_f(nv, vv + k);
      }
      *reinterpret_cast<uint4*>(w + e0) = *reinterpret_cast<uint4*>(wv);
      *reinterpret_cast<uint4*>(m + e0) = *reinterpret_cast<uint4*>(mv);
      *reinterpret_cast<uint4*>(v + e0) = *reinterpret_cast<uint4*>(vv);
    } else {
      for (int k = 0; k < cnt; ++k) {
        float nw, nm, nv;
        adam_one<T>(to_f(w[e0 + k]), to_f(g[e0 + k]), to_f(m[e0 + k]),
                    to_f(v[e0 + k]), lr, wd, h, &nw, &nm, &nv);
        from_f(nw, w + e0 + k);
        from_f(nm, m + e0 + k);
        from_f(nv, v + e0 + k);
      }
    }
  }
}

int grid(long long total_vecs) {
  long long blocks = (total_vecs + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<int>(blocks);
}

template <typename T>
int launch(const void* tab, const void* lrwd, int nseg, long long total_vecs,
           float rescale, float mom, float clip, int has_mom, int has_clip,
           void* stream) {
  if (nseg <= 0 || total_vecs <= 0) return 0;
  Hyper h{rescale, mom, clip, has_mom, has_clip};
  sgd_apply_kernel<T><<<grid(total_vecs), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tab), static_cast<const float*>(lrwd),
      nseg, total_vecs, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_adam(const void* tab, const void* lrwd, int nseg,
                long long total_vecs, float rescale, float b1, float omb1,
                float b2, float omb2, float eps, float clip, int has_clip,
                void* stream) {
  if (nseg <= 0 || total_vecs <= 0) return 0;
  AdamHyper h{rescale, b1, omb1, b2, omb2, eps, clip, has_clip};
  adam_apply_kernel<T><<<grid(total_vecs), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tab), static_cast<const float*>(lrwd),
      nseg, total_vecs, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch. tab and lrwd are device
// pointers to the segment table (see sgd_apply_kernel); total_vecs is the
// bucket's length in 16-byte vectors. Runs on `stream`, not waited for.

int sgd_apply_bf16(const void* tab, const void* lrwd, int nseg,
                   long long total_vecs, float rescale, float mom, float clip,
                   int has_mom, int has_clip, void* stream) {
  return launch<__nv_bfloat16>(tab, lrwd, nseg, total_vecs, rescale, mom,
                               clip, has_mom, has_clip, stream);
}

int sgd_apply_f32(const void* tab, const void* lrwd, int nseg,
                  long long total_vecs, float rescale, float mom, float clip,
                  int has_mom, int has_clip, void* stream) {
  return launch<float>(tab, lrwd, nseg, total_vecs, rescale, mom, clip,
                       has_mom, has_clip, stream);
}

// Adam: b1, b2, eps and omb1 = 1 - beta1, omb2 = 1 - beta2 (computed in
// double on the host) arrive rounded to the weight's dtype.

int adam_apply_bf16(const void* tab, const void* lrwd, int nseg,
                    long long total_vecs, float rescale, float b1, float omb1,
                    float b2, float omb2, float eps, float clip, int has_clip,
                    void* stream) {
  return launch_adam<__nv_bfloat16>(tab, lrwd, nseg, total_vecs, rescale, b1,
                                    omb1, b2, omb2, eps, clip, has_clip,
                                    stream);
}

int adam_apply_f32(const void* tab, const void* lrwd, int nseg,
                   long long total_vecs, float rescale, float b1, float omb1,
                   float b2, float omb2, float eps, float clip, int has_clip,
                   void* stream) {
  return launch_adam<float>(tab, lrwd, nseg, total_vecs, rescale, b1, omb1,
                            b2, omb2, eps, clip, has_clip, stream);
}

}  // extern "C"
