// Greedy non-maximum suppression for Hopper (sm_90a): the keep mask of
// box_nms, MultiBoxDetection, Proposal and MultiProposal.
//
// Replaces no Pallas kernel. The JAX package runs the greedy pass as a
// lax.scan over every box (mxnet_tpu/ops/extended.py:418) or a fori_loop
// (mxnet_tpu/ops/detection.py:350): one step per box, each step a row of
// the IoU matrix. Written as a loop of PyTorch ops, that is thousands of
// tiny launches per image at SSD300's 8,732 anchors. Here it is two
// launches for the whole batch:
//
//   nms_mask_kernel: for each image b, each row i of the sorted valid
//     prefix and each 64-wide column block c >= i's own block within the
//     prefix, the 64-bit word of "box j suppresses-if-i-is-kept": j > i,
//     j in the prefix, iou(i, j) > thresh and, with ids, the same class.
//     One 64-thread block per (column block, row block, image), a thread
//     per row; pairs that do not intersect skip the division.
//   nms_walk_kernel: one block per image walks the prefix in score order,
//     a 64-box word at a time, with a bitmask of removed boxes in shared
//     memory: box i is kept when its bit is clear, and then its row is
//     ORed into the mask. A word's decisions are register work on its
//     diagonal entries; the kept boxes' rows, the bulk of the reads, are
//     spread over the block's warps with many loads in flight. The walk
//     reads only words the mask kernel wrote.
//
// Bound: the data moved is small (boxes in, keep out); the IoU tests are
// the work, and the walk is serial by definition, so latency sets its
// time: per word, the decisions and one round of the kept rows' loads.
// A first version walked box by box with one warp and ORed each kept
// row in turn: 3.1 ms of mask and 7.2 ms of walk at SSD300 b32, a memory
// round trip per kept box (PERF.md, PR 22).
//
// The boxes arrive sorted by score (descending, stable) with the valid
// ones first: nvalid[b] is the prefix length, read on the card, so the
// host never waits. Boxes after the prefix are never kept, as in the scan,
// where they start suppressed and suppress nothing.
//
// Numerics: the keep set must be the JAX package's exactly, ties and IoUs
// at the threshold included, so the IoU is the same float32 expression
// with every product, sum and quotient a separate correctly rounded
// intrinsic (no FMA contraction):
//   corner (box_nms):  inter = max(min(x2) - max(x1), 0) * max(min(y2) -
//     max(y1), 0); area = max(x2 - x1, 0) * max(y2 - y1, 0); union =
//     (area_i + area_j) - inter; iou = union > 0 ? inter / union : 0
//   plus_one (Proposal): w = max(0, (min(x2) - max(x1)) + 1), likewise h,
//     inter = w * h; area = ((x2 - x1) + 1) * ((y2 - y1) + 1);
//     iou = inter / ((area_i + area_j) - inter)
//
// Memory: the mask is B * n * ceil(n / 64) words (306 MB at b32 x 8,732);
// the walk keeps ceil(n / 64) words in shared memory (up to 227 KB:
// n <= 1,859,584).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWord = 64;

__device__ __forceinline__ float iou_corner(const float* a, const float* b) {
  const float iw = fmaxf(__fsub_rn(fminf(a[2], b[2]), fmaxf(a[0], b[0])), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a[3], b[3]), fmaxf(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a[2], a[0]), 0.f),
                                 fmaxf(__fsub_rn(a[3], a[1]), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.f),
                                 fmaxf(__fsub_rn(b[3], b[1]), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__device__ __forceinline__ float iou_plus_one(const float* a, const float* b) {
  const float iw = fmaxf(0.f, __fadd_rn(__fsub_rn(fminf(a[2], b[2]),
                                                  fmaxf(a[0], b[0])), 1.f));
  const float ih = fmaxf(0.f, __fadd_rn(__fsub_rn(fminf(a[3], b[3]),
                                                  fmaxf(a[1], b[1])), 1.f));
  const float inter = __fmul_rn(iw, ih);
  const float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a[2], a[0]), 1.f),
                                 __fadd_rn(__fsub_rn(a[3], a[1]), 1.f));
  const float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.f),
                                 __fadd_rn(__fsub_rn(b[3], b[1]), 1.f));
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// The IoU test of box a (kept first) against box b: iou > thresh, with
// the exact expression of iou_corner / iou_plus_one. Most pairs do not
// intersect; their IoU is 0 (or, Proposal form, 0 / (area_a + area_b)),
// decided without the division.
__device__ __forceinline__ bool over(const float* a, const float* b,
                                     float thresh, int plus_one) {
  const float one = plus_one ? 1.f : 0.f;
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a[2], b[2]),
                                             fmaxf(a[0], b[0])), one), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a[3], b[3]),
                                             fmaxf(a[1], b[1])), one), 0.f);
  if (__fmul_rn(iw, ih) == 0.f && !(0.f > thresh)) return false;
  return (plus_one ? iou_plus_one(a, b) : iou_corner(a, b)) > thresh;
}

// One 64-thread block per (column block, row block, image) on or above
// the diagonal of the valid prefix: the column block's boxes in shared
// memory, a thread per row.
__global__ void __launch_bounds__(kWord)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ ids,
                const int* __restrict__ nvalid, int n, int words,
                float thresh, int plus_one,
                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  const int nv = nvalid[b];
  const int r0 = rb * kWord, c0 = cb * kWord;
  if (r0 >= nv || c0 >= nv) return;
  __shared__ float cbox[kWord][4];
  __shared__ float cid[kWord];
  const int t = threadIdx.x;
  const float* bb = boxes + (size_t)b * n * 4;
  const float* ib = ids ? ids + (size_t)b * n : nullptr;
  if (c0 + t < nv) {
#pragma unroll
    for (int k = 0; k < 4; ++k) cbox[t][k] = bb[(size_t)(c0 + t) * 4 + k];
    cid[t] = ib ? ib[c0 + t] : 0.f;
  }
  __syncthreads();
  const int i = r0 + t;
  if (i >= nv) return;
  float me[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) me[k] = bb[(size_t)i * 4 + k];
  const float my_id = ib ? ib[i] : 0.f;
  const int cend = min(kWord, nv - c0);
  unsigned long long bits = 0ull;
  for (int k = (cb == rb) ? t + 1 : 0; k < cend; ++k) {
    if (ib && cid[k] != my_id) continue;
    if (over(me, cbox[k], thresh, plus_one)) bits |= 1ull << k;
  }
  mask[((size_t)b * n + i) * words + cb] = bits;
}

constexpr int kWalkWarps = 8;
constexpr int kKeptPerWarp = kWord / kWalkWarps;

// One block of kWalkWarps warps per image walks the valid prefix a word
// (64 boxes) at a time. Warp 0 takes the word's 64 diagonal entries (box
// j against the later boxes of the word) into registers, two a lane, and
// makes the 64 decisions in order from them by shuffles: register work.
// Then every warp ORs a share of the kept boxes' rows into the removed
// mask from the next word on, a lane a word, each lane's loads all in
// flight before its ORs: the rows of the kept boxes, not the decisions,
// are most of the walk's reads (at SSD300 about 70% of the boxes
// survive).
__global__ void __launch_bounds__(kWalkWarps * 32)
nms_walk_kernel(const unsigned long long* __restrict__ mask,
                const int* __restrict__ nvalid, int n, int words,
                unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long kept_word;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nv = nvalid[b];
  const int nvw = (nv + kWord - 1) / kWord;
  unsigned char* kb = keep + (size_t)b * n;
  for (int k = tid; k < nvw; k += blockDim.x) removed[k] = 0ull;
  for (int k = tid; k < n; k += blockDim.x) kb[k] = 0;
  __syncthreads();
  const unsigned long long* mb = mask + (size_t)b * n * words;
  for (int w = 0; w < nvw; ++w) {
    const int i0 = w * kWord;
    if (warp == 0) {
      const int cnt = min(kWord, nv - i0);
      const unsigned long long d0 =
          lane < cnt ? mb[(size_t)(i0 + lane) * words + w] : 0ull;
      const unsigned long long d1 =
          lane + 32 < cnt ? mb[(size_t)(i0 + lane + 32) * words + w] : 0ull;
      unsigned long long cur = removed[w];
      unsigned long long kept = 0ull;
      for (int j = 0; j < cnt; ++j) {
        const unsigned long long dj =
            __shfl_sync(0xffffffffu, j < 32 ? d0 : d1, j & 31);
        if (!((cur >> j) & 1ull)) {
          kept |= 1ull << j;
          cur |= dj;
        }
      }
      if ((kept >> lane) & 1ull) kb[i0 + lane] = 1;
      if ((kept >> (lane + 32)) & 1ull) kb[i0 + lane + 32] = 1;
      if (lane == 0) kept_word = kept;
    }
    __syncthreads();
    // this warp's kept boxes: set bits warp, warp + kWalkWarps, ... of
    // the word (-1 past the last)
    int js[kKeptPerWarp];
    unsigned long long rest = kept_word;
    for (int d = 0; d < warp && rest; ++d) rest &= rest - 1;
#pragma unroll
    for (int q = 0; q < kKeptPerWarp; ++q) {
      js[q] = rest ? __ffsll((long long)rest) - 1 : -1;
#pragma unroll
      for (int d = 0; d < kWalkWarps; ++d) rest &= rest - 1;
    }
    for (int k = w + 1 + lane; k < nvw; k += 32) {
      unsigned long long v[kKeptPerWarp];
#pragma unroll
      for (int q = 0; q < kKeptPerWarp; ++q)
        v[q] = js[q] >= 0 ? mb[(size_t)(i0 + js[q]) * words + k] : 0ull;
      unsigned long long acc = 0ull;
#pragma unroll
      for (int q = 0; q < kKeptPerWarp; ++q) acc |= v[q];
      if (acc) atomicOr(&removed[k], acc);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// The keep mask of a sorted batch: boxes [B, n, 4] float32 (corners), ids
// [B, n] float32 or null (class-aware when given), nvalid [B] int32 on the
// card, mask scratch of B * n * ceil(n / 64) words, keep [B, n] uint8.
// Returns 0 or the cudaError_t of the launches; not waited for.
int box_nms_keep(const float* boxes, const float* ids, const int* nvalid,
                 int batch, int n, float thresh, int plus_one,
                 unsigned long long* mask, unsigned char* keep,
                 void* stream) {
  const int words = (n + kWord - 1) / kWord;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words > 0) {
    dim3 grid(words, words, batch);
    nms_mask_kernel<<<grid, kWord, 0, s>>>(boxes, ids, nvalid, n, words,
                                           thresh, plus_one, mask);
  }
  const size_t smem = (size_t)(words > 0 ? words : 1) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_walk_kernel<<<batch, kWalkWarps * 32, smem, s>>>(mask, nvalid, n,
                                                      words, keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
