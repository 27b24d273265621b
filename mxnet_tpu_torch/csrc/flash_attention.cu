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
// and loops over the other axis itself, keeping the state in registers.
// dQ and dK/dV stay two launches, as on the TPU: neither needs float atomics,
// so two launches on the same inputs give the same bits.
//
// What bounds them on an H100: at the transformer LM's shapes (S = 2048,
// D = 128) each launch does O(S^2 D) tensor-core operations against O(S D)
// bytes, so they are bound by operations (989 TFLOP/s bf16). Every kernel
// keeps the S x S score matrix out of device memory.
//
// The bf16 forward is built for Hopper. A block of 256 threads -- two
// consumer warpgroups and no producer, so that ptxas may give each thread up
// to 255 registers -- owns 128 query rows of one (batch, head); warpgroup w
// owns rows 64w .. 64w+63. A head's query tiles run together (so its K and
// V are read from device memory about once, then from L2), heavy (late,
// causal) tiles first. Loads are TMA in the 128-byte swizzle through 4-D
// tensor maps (d, s, h, b) built from the tensors' strides, so [B, S, H, D]
// buffers seen transposed are read in place; a box is 64 columns x 128 rows
// (two per tile at D = 128), and rows past S read as zeros. Q is loaded
// once; K and V come in tiles of 128 keys through a 2-stage ring, each tile
// on its own mbarrier, and the last of the 8 warps done with a K (or V)
// tile loads the stage's next one. Shared memory: Q 32 KB + 2 x (32 + 32)
// KB at D = 128, half that at D = 64: one block per SM. Per k tile each
// warpgroup runs
//   S  = Q K^T   wgmma m64n128k16, both operands K-major in shared memory;
//   the online softmax in registers, in the accumulator's layout (a row's
//                128 columns lie in a quad of lanes: two shuffles a
//                reduction); only the diagonal tile and a ragged last tile
//                are masked, and tiles wholly above the diagonal are skipped;
//   O += P V     wgmma m64nDk16 with A from registers -- S's fragment,
//                packed to bf16 pairs, is the A fragment of the k16 steps --
//                and V N-major in shared memory.
// S of tile j + 1 and P V of tile j go out together, and the softmax of
// tile j + 1 runs while P V does. The two warpgroups take turns at issuing
// (pingpong, two named barriers), so that one's softmax runs while the
// other's products do. S (64 f32), O (D/2 f32) and P (32 pairs) live in
// registers. The epilogue divides O by l, writes bf16 into the warpgroup's
// own rows of the Q tile in the boxes' swizzle, and stores them with TMA,
// which drops rows past Sq.
//
// What bounds it (PERF.md): the softmax's issue. With the accurate expf
// (seven instructions and an ex2) a score costs about 13 instructions, and
// a warp alone on its scheduler issues them well below one a cycle, so a
// warpgroup's softmax outlasts the other's two products and the tensor
// cores idle for much of the loop. Each block also pays for its start, its
// epilogue and the hand-over to the next block on its SM.

// The bf16 dK/dV kernel is built for Hopper as the forward is. A block of
// 256 threads (two consumer warpgroups, no producer) owns 128 keys of one
// (batch, head); warpgroup w owns keys 64w .. 64w+63. A head's key blocks
// run together (Q and dO come from L2 after the first), heavy (early,
// causal) blocks first. K and V are loaded once by TMA (boxes of 64 columns
// x 128 rows, the 128-byte swizzle, the forward's 4-D maps); Q and dO come
// in q tiles of 64 rows through a 2-stage ring, with the tile's lse and
// delta (cp.async, 4 bytes a lane: a row of [B*H, Sq] need not be 16-byte
// aligned) on the same mbarrier; the last of the 8 warps done with a stage
// refills it. Shared memory: K + V 64 KB + 2 x (32 KB + 512 B) at D = 128,
// half the tiles at D = 64: one block per SM. Per q tile each warpgroup runs
//   S^T  = K Q^T, dP^T = V dO^T   wgmma m64n64k16, both operands K-major in
//                                 shared memory, two groups: P^T = exp(S^T
//                                 * scale - lse) runs while dP^T does;
//   dS^T = P^T (dP^T - delta) * scale, in the accumulator's layout; only
//                                 the tile on the warpgroup's diagonal and
//                                 a ragged last tile are masked;
//   dV += P^T dO, dK += dS^T Q    wgmma m64nDk16 with A from registers (the
//                                 score fragments packed to bf16 pairs) and
//                                 dO, Q N-major in shared memory.
// Causal: q tiles before k0 are skipped; the first tile (queries k0 ..
// k0+63) lies wholly before warpgroup 1's keys, which passes it with no
// products. The two warpgroups take turns at issuing (pingpong, two turns a
// q tile), so that one's exp and dS run while the other's products do.
// dK, dV (D/2 f32 each), S^T and dP^T (32 f32 each) live in registers. The
// epilogue writes bf16 into the warpgroup's own rows of the K and V tiles
// and stores them with TMA, which drops rows past Sk.
//
// What bounds it (PERF.md, chip_flash_probe.py): the series inside a
// warpgroup. It runs at about half the tensor rate; the score products,
// the exp/dS pass and the dV/dK products of a q tile run one after the
// other, and the other warpgroup hides only part of each (the turns
// themselves change little). The score products also read all of an SM's
// 128 B/clock of shared memory at the full tensor rate (an m64n64k16 from
// shared memory reads 4 KB for 131k operations). Issuing the next tile's
// score products with this tile's dV/dK needs more than 255 registers at
// D = 128 (it spills).
//
// The bf16 dQ kernel is built for Hopper as the other two are. A block of
// 256 threads (two consumer warpgroups, no producer) owns 128 query rows of
// one (batch, head); warpgroup w owns rows 64w .. 64w+63. The grid runs as
// the forward's: a head's query blocks together, heavy (late, causal)
// blocks first. Q and dO are loaded once by TMA (the forward's maps and
// boxes); K and V come in k tiles of 128 keys through a 2-stage ring, both
// on the stage's mbarrier, and the last of the 8 warps done with a stage
// refills it. lse and delta of the thread's two rows are read once into
// registers. Shared memory: Q + dO 64 KB + 2 x (32 + 32) KB at D = 128,
// half that at D = 64: one block per SM. Per k tile each warpgroup runs
//   S = Q K^T, dP = dO V^T   wgmma m64n128k16, both operands K-major in
//                            shared memory, two groups: P = exp(S * scale
//                            - lse) runs while dP does;
//   dS = P (dP - delta) * scale, in the accumulator's layout; only the
//                            tile on the warpgroup's diagonal and a ragged
//                            last tile are masked;
//   dQ += dS K               wgmma m64nDk16 with A from registers (dS
//                            packed to bf16 pairs) and K N-major: the same
//                            shared tile read under a second descriptor.
// Causal: the block loads k tiles up to its diagonal; both warpgroups need
// each of them (the diagonal tile is masked for both). The two warpgroups
// take turns at issuing (pingpong, two turns a k tile). dQ (D/2 f32), S and
// dP (64 f32 each) live in registers: 254 of them at D = 128. The epilogue
// writes bf16 into the warpgroup's own rows of the Q tile and stores them
// with TMA, which drops rows past Sq.
//
// What bounds it (PERF.md, chip_flash_probe.py --kernel dq): as in dK/dV,
// the series inside a warpgroup. Leaving out the score products takes 28%
// off a launch, leaving out the exp 16%; without the turns it is 2%
// slower. 64-key tiles (m64n64k16 scores) are 22% slower: twice the waits
// and turns per score, and twice the shared-memory bytes per operation of
// B. Holding Q and dO in registers as the score products' A fragments
// (64-key tiles: 128-key ones do not fit) is 15% slower than this form.
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
// as zeros, masked out of every sum (p = 0), and never stored (the bf16
// dK/dV kernel leaves padded keys unmasked: each feeds only its own row of
// dK and dV, which is dropped). Every row's
// first k tile holds its column 0, so the running max is finite after it and
// no exp(-inf - -inf) forms.
//
// f32 inputs run on the CUDA cores in full f32 (no TF32): one warp per
// query row (forward, dQ) or per key (dK/dV), one lane per key (or query) of
// a 32-wide tile, with the same tile-by-tile update as the TPU kernel.
//
// Layout: each tensor is [B, H, S, D] given by three element strides (batch,
// head, sequence) with the last dim contiguous; the wrapper checks that rows
// are 16-byte aligned (and copies a bf16 input of the forward or the
// backward that has stride 0 along a dimension longer than 1: a tensor map
// cannot say so). lse and delta are contiguous f32 [B*H, Sq].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a wgmma accumulator's K x 16 columns packed to bf16
// pairs: k-step kk holds columns 16kk .. 16kk+15.
template <int K>
__device__ __forceinline__ void pack_frag(uint32_t (&f)[K][4],
                                          const float (&s)[2 * K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    f[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    f[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    f[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    f[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward (TMA, wgmma)
// ---------------------------------------------------------------------------

constexpr int FT = 128;                // query rows per block, keys per k tile
constexpr int FWD_THREADS = 256;       // two consumer warpgroups of 64 rows
constexpr int FWD_STAGES = 2;          // the K/V ring
constexpr int BOX = FT * 128;          // a box: 128 rows x 64 bf16, 16384 B

// Bytes of a 128-row tile of D columns: D / 64 boxes.
template <int D>
__host__ __device__ constexpr int tile_bytes() { return D / 64 * BOX; }

// Q, the ring of K and V tiles, and slack to align them to the 1024-byte
// swizzle atom.
template <int D>
constexpr int fwd_smem() {
  return (1 + 2 * FWD_STAGES) * tile_bytes<D>() + 1024;
}

struct FwdArgs {
  float* lse;                  // [B*H, Sq]
  int H, Sq, Sk, causal;
  float scale;
};

// The online-softmax step of one k tile on a warpgroup's S fragment (the
// thread's rows row0 and row0 + 8, columns col0 + 8n and + 1, col0 = the
// tile's first key + 2t): scale; mask where `edge` (the tile crosses the
// diagonal or Sk); the running max m, corr = exp(m_old - m), p = exp(s - m)
// in place of s, and l = corr * l + rowsum(p). The mask is a pass of its
// own, so that the loop holds one copy of the rest. The row max and sum run
// as four independent chains per row (n % 4) folded at the end; a sum's
// order is the kernel's own.
__device__ __forceinline__ void softmax_tile(float (&s)[16][4], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const FwdArgs& a, bool edge,
                                             int col0, int row0) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], a.scale);
  if (edge) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + n * 8 + (e & 1);
        if (col >= a.Sk || (a.causal && col > row0 + (e >> 1) * 8))
          s[n][e] = -INFINITY;
      }
  }
  float mx[4][2];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx[c][0] = m[0], mx[c][1] = m[1];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[n & 3][e >> 1] = fmaxf(mx[n & 3][e >> 1], s[n][e]);
  float rs[4][2] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[0][r], mx[1][r]), fmaxf(mx[2][r], mx[3][r]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    corr[r] = expf(__fsub_rn(m[r], v));
    m[r] = v;
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(__fsub_rn(s[n][e], m[e >> 1]));
      s[n][e] = p;
      rs[n & 3][e >> 1] = __fadd_rn(rs[n & 3][e >> 1], p);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = __fadd_rn(__fadd_rn(rs[0][r], rs[1][r]),
                        __fadd_rn(rs[2][r], rs[3][r]));
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
    l[r] = __fadd_rn(__fmul_rn(corr[r], l[r]), v);
  }
}

// One thread loads the K (v = 0) or V (v = 1) tile of k tile j of head
// (hi, bi) into stage j % FWD_STAGES of the ring, on that stage's barrier.
template <int D>
__device__ __forceinline__ void fwd_load(unsigned char* ring, uint64_t* full,
                                         const CUtensorMap* tm, int j, int v,
                                         int hi, int bi) {
  constexpr int TB = tile_bytes<D>();
  const int st = j % FWD_STAGES;
  unsigned char* dst = ring + (2 * st + v) * TB;
  mbar_expect_tx(&full[st], TB);
#pragma unroll
  for (int nb = 0; nb < D / 64; ++nb)
    tma_load4(dst + nb * BOX, tm, nb * 64, j * FT, hi, bi, &full[st]);
}

// S = Q K^T for a warpgroup's 64 rows (qw: its rows of the Q tile) against
// a K tile, one wgmma group: k-step kk reads 16 columns, 32 bytes into box
// kk / 4 of both operands.
template <int D>
__device__ __forceinline__ void fwd_scores(float (&s)[16][4],
                                           const unsigned char* qw,
                                           const unsigned char* kt) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk / 4 * BOX + kk % 4 * 32;
    const uint64_t da = sw128_desc_at(qw + off, 16, 1024);
    const uint64_t db = sw128_desc_at(kt + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_kk_first(s, da, db);
    else
      wgmma_ss_kk(s, da, db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// O += P V, one wgmma group: P's k-step kk is pa[kk], V's 16 rows of 128
// bytes, 2048 bytes on; at D = 128 the leading offset steps to V's second
// box.
template <int D>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 8][4],
                                       const uint32_t (&pa)[8][4],
                                       const unsigned char* vt) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs(o, pa[kk], sw128_desc_at(vt + kk * 2048, BOX, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Pingpong: the two warpgroups take turns to issue their products, so that
// one's softmax runs while the other's products do. Named barrier 3 + w is
// warpgroup w's turn (256 threads: w syncs on it, the other arrives).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __grid_constant__ CUtensorMap tmo, FwdArgs a) {
  constexpr int NB = D / 64;             // boxes per tile
  constexpr int TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qfull, kfull[FWD_STAGES],
      vfull[FWD_STAGES];
  __shared__ int kdone[FWD_STAGES], vdone[FWD_STAGES];
  // the swizzle works on shared-memory address bits: align the tiles there
  unsigned char* qs =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = qs + TB;         // stage s: K at 2s TB, V at (2s+1) TB

  // the grid runs x fastest: a head's query tiles run together, so its K
  // and V are read from device memory about once and then from L2; heavy
  // (late, causal) tiles first
  const int bh = blockIdx.y;
  const int bi = bh / a.H, hi = bh - bi * a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FT;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int nk = (a.Sk + FT - 1) / FT;
  if (a.causal) nk = min(nk, (min(q0 + FT, a.Sq) - 1) / FT + 1);

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmq) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmk) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmv) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmo) : "memory");
    mbar_init(&qfull, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      kdone[s] = vdone[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&qfull, TB);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_load4(qs + nb * BOX, &tmq, nb * 64, q0, hi, bi, &qfull);
    for (int j = 0; j < FWD_STAGES && j < nk; ++j) {
      fwd_load<D>(ring, kfull, &tmk, j, 0, hi, bi);
      fwd_load<D>(ring, vfull, &tmv, j, 1, hi, bi);
    }
  }

  // this warpgroup's 64 rows of Q (8 KB into each box); the thread's rows
  const unsigned char* qw = qs + wg * 64 * 128;
  const int row0 = q0 + wg * 64 + warp * 16 + g;   // and row0 + 8
  float o[D / 8][4], s[16][4];
  uint32_t pa[8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  // The softmax of k tile j on s, masked only where the tile crosses this
  // warpgroup's diagonal or Sk. A warp done with a K or V tile counts
  // itself out; the last of the 8 loads the stage's next tile.
  auto softmax = [&](int j) {
    softmax_tile(s, m, l, corr, a,
                 (j + 1) * FT > a.Sk ||
                     (a.causal && j * FT + FT - 1 > q0 + wg * 64),
                 j * FT + 2 * t, row0);
  };
  auto release = [&](int* done, uint64_t* full, const CUtensorMap* tm,
                     int j, int v) {
    if (count_last(&done[j % FWD_STAGES], 8, lane) && lane == 0 &&
        j + FWD_STAGES < nk)
      fwd_load<D>(ring, full, tm, j + FWD_STAGES, v, hi, bi);
  };

  mbar_wait(&qfull, 0);
  if (wg == 1) turn_pass(wg);      // warpgroup 0 goes first
  turn_wait(wg);
  mbar_wait(&kfull[0], 0);
  fwd_scores<D>(s, qw, ring);
  turn_pass(wg);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  reg_fence_all(s);
  release(kdone, kfull, &tmk, 0, 0);
  softmax(0);
  pack_frag(pa, s);
  reg_fence_all(pa);

  // Each turn issues S of tile j + 1, then O += P V of tile j; the softmax
  // of tile j + 1 runs while the second product does, and O is rescaled
  // (by tile j + 1's corr) once it is done. The last turn is O += P V of
  // the last tile alone. (Every turn of the loop issues both products: with
  // S issued on only some paths, ptxas cannot tell that the first of the two
  // groups is complete and serialises the products.)
  for (int j = 0; j + 1 < nk; ++j) {
    turn_wait(wg);
    mbar_wait(&kfull[(j + 1) % FWD_STAGES], ((j + 1) / FWD_STAGES) & 1);
    fwd_scores<D>(s, qw, ring + 2 * ((j + 1) % FWD_STAGES) * TB);
    mbar_wait(&vfull[j % FWD_STAGES], (j / FWD_STAGES) & 1);
    fwd_pv<D>(o, pa, ring + (2 * (j % FWD_STAGES) + 1) * TB);
    turn_pass(wg);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    reg_fence_all(s);
    release(kdone, kfull, &tmk, j + 1, 0);
    softmax(j + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence_all(o);
    reg_fence_all(pa);
    release(vdone, vfull, &tmv, j, 1);
    // (a row whose max did not move has corr 1: o * 1 is o)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][0] = __fmul_rn(o[i][0], corr[0]);
        o[i][1] = __fmul_rn(o[i][1], corr[0]);
        o[i][2] = __fmul_rn(o[i][2], corr[1]);
        o[i][3] = __fmul_rn(o[i][3], corr[1]);
      }
    }
    pack_frag(pa, s);
    // both done before the next turn issues anything
    reg_fence_all(o);
    reg_fence_all(pa);
  }
  turn_wait(wg);
  mbar_wait(&vfull[(nk - 1) % FWD_STAGES], ((nk - 1) / FWD_STAGES) & 1);
  fwd_pv<D>(o, pa, ring + (2 * ((nk - 1) % FWD_STAGES) + 1) * TB);
  // warpgroup 1's last turn passes to no one: the turns balance
  if (wg == 0) turn_pass(wg);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  reg_fence_all(o);

  // o / l in bf16 into this warpgroup's rows of the Q tile (no other warp
  // reads them), in the boxes' swizzle: 16-byte chunk c of row r at chunk
  // c ^ (r % 8); then one thread stores them with TMA.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = wg * 64 + warp * 16 + g + r * 8;   // row in the tile
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      __nv_bfloat162 v = __floats2bfloat162_rn(
          __fdiv_rn(o[i][2 * r], l[r]), __fdiv_rn(o[i][2 * r + 1], l[r]));
      *reinterpret_cast<__nv_bfloat162*>(
          qs + i / 8 * BOX + rl * 128 + (((i % 8) ^ g) << 4) + 4 * t) = v;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if ((threadIdx.x & 127) == 0 && q0 + wg * 64 < a.Sq) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_store4(&tmo, qw + nb * BOX, nb * 64, q0 + wg * 64, hi, bi);
    tma_store_commit();
    tma_store_wait_read();
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + r * 8 < a.Sq)
        a.lse[static_cast<long long>(bh) * a.Sq + row0 + r * 8] =
            __fadd_rn(m[r], logf(l[r]));
  }
}

// ---------------------------------------------------------------------------
// bf16 dK / dV (TMA, wgmma)
// ---------------------------------------------------------------------------

constexpr int KT = 128;                // keys per block
constexpr int QT = 64;                 // query rows per q tile
constexpr int DKV_STAGES = 2;          // the Q/dO ring
constexpr int QBOX = QT * 128;         // a q-tile box: 64 rows x 64 bf16, 8192 B

// K and V, the ring of Q and dO tiles, and slack to align them to the
// 1024-byte swizzle atom.
template <int D>
constexpr int dkv_smem() {
  return 2 * tile_bytes<D>() + DKV_STAGES * 2 * (D / 64) * QBOX + 1024;
}

struct BwdArgs {
  const float* lse;            // [B*H, Sq]
  const float* delta;          // [B*H, Sq]
  int H, Sq, Sk, causal;
  float scale;
};

// The thread's cp.async copies issued so far arrive on `bar` when they
// complete; the barrier's count includes that arrival.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// S^T = K Q^T (or dP^T = V dO^T) for a warpgroup's 64 keys (kw: its rows of
// the K or V tile) against a q tile, one wgmma group: k-step kk reads 16
// columns, 32 bytes into box kk / 4 of both operands.
template <int D>
__device__ __forceinline__ void dkv_scores(float (&s)[8][4],
                                           const unsigned char* kw,
                                           const unsigned char* qt) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sw128_desc_at(kw + kk / 4 * BOX + kk % 4 * 32, 16,
                                      1024);
    const uint64_t db = sw128_desc_at(qt + kk / 4 * QBOX + kk % 4 * 32, 16,
                                      1024);
    if (kk == 0)
      wgmma_ss_kk_first(s, da, db);
    else
      wgmma_ss_kk(s, da, db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// dV += P^T dO and dK += dS^T Q, one wgmma group: the A fragments of k-step
// kk (16 query rows) are pa[kk] and da[kk]; dO's and Q's 16 rows of 128
// bytes lie 2048 bytes on, and at D = 128 the leading offset steps to the
// tile's second box.
template <int D>
__device__ __forceinline__ void dkv_acc(float (&dv)[D / 8][4],
                                        float (&dk)[D / 8][4],
                                        const uint32_t (&pa)[4][4],
                                        const uint32_t (&da)[4][4],
                                        const unsigned char* qt,
                                        const unsigned char* dot) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(dv, pa[kk], sw128_desc_at(dot + kk * 2048, QBOX, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(dk, da[kk], sw128_desc_at(qt + kk * 2048, QBOX, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __grid_constant__ CUtensorMap tmdo,
                      const __grid_constant__ CUtensorMap tmdk,
                      const __grid_constant__ CUtensorMap tmdv, BwdArgs a) {
  constexpr int NB = D / 64;             // boxes per tile
  constexpr int TB = tile_bytes<D>();    // a K or V tile
  constexpr int SB = NB * QBOX;          // a Q or dO tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kvfull, full[DKV_STAGES];
  __shared__ int done[DKV_STAGES];
  __shared__ __align__(16) float rowv[DKV_STAGES][2][QT];   // lse, delta
  // the swizzle works on shared-memory address bits: align the tiles there
  unsigned char* ks =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* vs = ks + TB;
  unsigned char* ring = vs + TB;         // stage s: Q at 2s SB, dO at (2s+1) SB

  // the grid runs x fastest: a head's key blocks run together, so its Q
  // and dO are read from device memory about once and then from L2; heavy
  // (early, causal) blocks first
  const int bh = blockIdx.y;
  const int bi = bh / a.H, hi = bh - bi * a.H;
  const int k0 = blockIdx.x * KT;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // causal: query rows before k0 see none of the block's keys
  const int t0 = a.causal ? k0 / QT : 0;
  const int n = (a.Sq + QT - 1) / QT - t0;   // q tiles the block visits
  const float* lseh = a.lse + static_cast<long long>(bh) * a.Sq;
  const float* deltah = a.delta + static_cast<long long>(bh) * a.Sq;
  const CUtensorMap* mq = &tmq;
  const CUtensorMap* mdo = &tmdo;

  // A whole warp loads q tile t0 + i into stage i % DKV_STAGES: lse and
  // delta of its 64 rows by cp.async, two each a lane (zero past Sq; a row
  // of [B*H, Sq] f32 need not be 16-byte aligned), Q and dO by TMA (rows
  // past Sq read as zeros); all on the stage's barrier.
  auto load = [&](int i) {
    const int st = i % DKV_STAGES, q0 = (t0 + i) * QT;
#pragma unroll
    for (int h = 0; h < QT / 32; ++h) {
      const int r = lane + 32 * h;
      const bool ok = q0 + r < a.Sq;
      cp_async4(&rowv[st][0][r], lseh + (ok ? q0 + r : 0), ok ? 4 : 0);
      cp_async4(&rowv[st][1][r], deltah + (ok ? q0 + r : 0), ok ? 4 : 0);
    }
    cp_async_arrive(&full[st]);
    if (lane == 0) {
      unsigned char* qt = ring + 2 * st * SB;
      mbar_expect_tx(&full[st], 2 * SB);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load4(qt + nb * QBOX, mq, nb * 64, q0, hi, bi, &full[st]);
        tma_load4(qt + SB + nb * QBOX, mdo, nb * 64, q0, hi, bi, &full[st]);
      }
    }
  };

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmq) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmk) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmv) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmdo) : "memory");
    mbar_init(&kvfull, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);       // the TMA bytes' arrival + 32 lanes
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (lane == 0) {
      mbar_expect_tx(&kvfull, 2 * TB);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        tma_load4(ks + nb * BOX, &tmk, nb * 64, k0, hi, bi, &kvfull);
        tma_load4(vs + nb * BOX, &tmv, nb * 64, k0, hi, bi, &kvfull);
      }
    }
    for (int i = 0; i < DKV_STAGES && i < n; ++i) load(i);
  }

  // this warpgroup's 64 keys of K and V (8 KB into each box); the thread's
  const unsigned char* kw = ks + wg * 64 * 128;
  const unsigned char* vw = vs + wg * 64 * 128;
  const int key0 = k0 + wg * 64 + warp * 16 + g;   // and key0 + 8
  float dk[D / 8][4], dv[D / 8][4], s[8][4], dp[8][4];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  // A warp done with q tile i counts itself out of its stage; the last of
  // the 8 loads the stage's next tile.
  auto release = [&](int i) {
    if (count_last(&done[i % DKV_STAGES], 8, lane) && i + DKV_STAGES < n)
      load(i + DKV_STAGES);
  };
  // Pingpong turns, two a q tile (the S^T and dP^T products, then the dV
  // and dK products); warpgroup 1's last turn passes to no one.
  auto pass = [&](bool last) {
    if (wg == 0 || !last) turn_pass(wg);
  };

  mbar_wait(&kvfull, 0);
  if (wg == 1) turn_pass(wg);            // warpgroup 0 goes first
  int i = 0;
  if (a.causal && wg == 1) {
    // q tile t0 (queries k0 .. k0+63) lies wholly before this warpgroup's
    // keys: its two turns pass with no products. It still waits for the
    // tile's load before counting out: every warp waits every phase of a
    // stage's barrier, so that a parity wait never meets a phase that has
    // not begun (a wait for parity 1 before phase 0 completes returns at
    // once).
    turn_wait(wg);
    turn_pass(wg);
    turn_wait(wg);
    pass(n == 1);
    mbar_wait(&full[0], 0);
    release(0);
    i = 1;
  }
  for (; i < n; ++i) {
    const int st = i % DKV_STAGES;
    const int q0 = (t0 + i) * QT;
    const unsigned char* qt = ring + 2 * st * SB;
    const unsigned char* dot = qt + SB;
    const float* lrow = rowv[st][0];
    const float* drow = rowv[st][1];
    turn_wait(wg);
    mbar_wait(&full[st], (i / DKV_STAGES) & 1);
    dkv_scores<D>(s, kw, qt);
    dkv_scores<D>(dp, vw, dot);
    turn_pass(wg);
    // P^T = exp(S^T * scale - lse) while dP^T runs; masked (to 0) only
    // where the tile crosses this warpgroup's diagonal or Sq
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    reg_fence_all(s);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nn][e] = __fmul_rn(s[nn][e], a.scale);
    if (q0 + QT > a.Sq || (a.causal && q0 < k0 + wg * 64 + 64)) {
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + nn * 8 + 2 * t + (e & 1);
          if (q >= a.Sq || (a.causal && key0 + (e >> 1) * 8 > q))
            s[nn][e] = -INFINITY;
        }
    }
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 l = *reinterpret_cast<const float2*>(lrow + nn * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nn][e] = expf(__fsub_rn(s[nn][e], (e & 1) ? l.y : l.x));
    }
    // dS^T = P^T (dP^T - delta) * scale
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence_all(dp);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 d = *reinterpret_cast<const float2*>(drow + nn * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nn][e] = __fmul_rn(
            __fmul_rn(s[nn][e], __fsub_rn(dp[nn][e], (e & 1) ? d.y : d.x)),
            a.scale);
    }
    pack_frag(pa, s);
    pack_frag(da, dp);
    reg_fence_all(pa);
    reg_fence_all(da);
    turn_wait(wg);
    dkv_acc<D>(dv, dk, pa, da, qt, dot);
    pass(i + 1 == n);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence_all(dv);
    reg_fence_all(dk);
    reg_fence_all(pa);
    reg_fence_all(da);
    release(i);
  }

  // dK and dV in bf16 into this warpgroup's rows of the K and V tiles (no
  // other warp reads them), in the boxes' swizzle: 16-byte chunk c of row r
  // at chunk c ^ (r % 8); then one thread stores them with TMA, which drops
  // rows past Sk.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = wg * 64 + warp * 16 + g + r * 8;   // row in the tile
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int off = c / 8 * BOX + rl * 128 + (((c % 8) ^ g) << 4) + 4 * t;
      *reinterpret_cast<__nv_bfloat162*>(ks + off) =
          __floats2bfloat162_rn(dk[c][2 * r], dk[c][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vs + off) =
          __floats2bfloat162_rn(dv[c][2 * r], dv[c][2 * r + 1]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if ((threadIdx.x & 127) == 0 && k0 + wg * 64 < a.Sk) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_store4(&tmdk, kw + nb * BOX, nb * 64, k0 + wg * 64, hi, bi);
      tma_store4(&tmdv, vw + nb * BOX, nb * 64, k0 + wg * 64, hi, bi);
    }
    tma_store_commit();
    tma_store_wait_read();
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ (TMA, wgmma)
// ---------------------------------------------------------------------------

constexpr int DQ_BN = 128;             // keys per k tile
constexpr int DQ_STAGES = 2;           // the K/V ring
constexpr int KBOX = DQ_BN * 128;      // a k-tile box: DQ_BN rows x 64 bf16

// Q, dO, the ring of K and V tiles, and slack to align them to the
// 1024-byte swizzle atom.
template <int D>
constexpr int dq_smem() {
  return 2 * tile_bytes<D>() + DQ_STAGES * 2 * (D / 64) * KBOX + 1024;
}

// S = Q K^T (or dP = dO V^T) for a warpgroup's 64 rows (aw: its rows of
// the Q or dO tile) against a k tile, one wgmma group: k-step kk reads 16
// columns, 32 bytes into box kk / 4 of both operands.
template <int D, int N>
__device__ __forceinline__ void dq_scores(float (&s)[N][4],
                                          const unsigned char* aw,
                                          const unsigned char* kt) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sw128_desc_at(aw + kk / 4 * BOX + kk % 4 * 32, 16,
                                      1024);
    const uint64_t db = sw128_desc_at(kt + kk / 4 * KBOX + kk % 4 * 32, 16,
                                      1024);
    if (kk == 0)
      wgmma_ss_kk_first(s, da, db);
    else
      wgmma_ss_kk(s, da, db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// dQ += dS K, one wgmma group: dS's k-step kk (16 keys) is da[kk]; K, read
// N-major, has its 16 rows of 128 bytes 2048 bytes on, and at D = 128 the
// leading offset steps to the tile's second box.
template <int D>
__device__ __forceinline__ void dq_acc(float (&dq)[D / 8][4],
                                       const uint32_t (&da)[DQ_BN / 16][4],
                                       const unsigned char* kt) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < DQ_BN / 16; ++kk)
    wgmma_rs(dq, da[kk], sw128_desc_at(kt + kk * 2048, KBOX, 1024));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmdo,
                     const __grid_constant__ CUtensorMap tmdq, BwdArgs a) {
  constexpr int NB = D / 64;             // boxes per tile
  constexpr int TB = tile_bytes<D>();    // a Q or dO tile
  constexpr int KB = NB * KBOX;          // a K or V tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t qfull, full[DQ_STAGES];
  __shared__ int done[DQ_STAGES];
  // the swizzle works on shared-memory address bits: align the tiles there
  unsigned char* qs =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* dos = qs + TB;
  unsigned char* ring = dos + TB;        // stage s: K at 2s KB, V at (2s+1) KB

  // the grid runs x fastest: a head's query blocks run together, so its K
  // and V are read from device memory about once and then from L2; heavy
  // (late, causal) blocks first
  const int bh = blockIdx.y;
  const int bi = bh / a.H, hi = bh - bi * a.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FT;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * 64;           // the warpgroup's first row
  const int row0 = r0 + warp * 16 + g;   // the thread's rows: and row0 + 8
  // k tiles the block visits: causal, up to its diagonal tile. A tile is
  // as wide as the block, so both warpgroups need every one.
  int nk = (a.Sk + DQ_BN - 1) / DQ_BN;
  if (a.causal) nk = min(nk, (min(q0 + FT, a.Sq) - 1) / DQ_BN + 1);
  const CUtensorMap* mk = &tmk;
  const CUtensorMap* mv = &tmv;

  // One thread loads k tile j (K and V) into stage j % DQ_STAGES, on the
  // stage's barrier; keys past Sk read as zeros.
  auto load = [&](int j) {
    const int st = j % DQ_STAGES;
    unsigned char* kt = ring + 2 * st * KB;
    mbar_expect_tx(&full[st], 2 * KB);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load4(kt + nb * KBOX, mk, nb * 64, j * DQ_BN, hi, bi, &full[st]);
      tma_load4(kt + KB + nb * KBOX, mv, nb * 64, j * DQ_BN, hi, bi,
                &full[st]);
    }
  };

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmq) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmk) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmv) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmdo) : "memory");
    mbar_init(&qfull, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&qfull, 2 * TB);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tma_load4(qs + nb * BOX, &tmq, nb * 64, q0, hi, bi, &qfull);
      tma_load4(dos + nb * BOX, &tmdo, nb * 64, q0, hi, bi, &qfull);
    }
    for (int j = 0; j < DQ_STAGES && j < nk; ++j) load(j);
  }

  // lse and delta of the thread's rows (zero past Sq, where Q and dO read
  // as zeros too, so that dS is 0 there)
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const long long at = static_cast<long long>(bh) * a.Sq + row;
    lse[r] = row < a.Sq ? a.lse[at] : 0.f;
    delta[r] = row < a.Sq ? a.delta[at] : 0.f;
  }
  // this warpgroup's 64 rows of Q and dO (8 KB into each box)
  unsigned char* qw = qs + wg * 64 * 128;
  const unsigned char* dow = dos + wg * 64 * 128;
  float dq[D / 8][4], s[DQ_BN / 8][4], dp[DQ_BN / 8][4];
  uint32_t da[DQ_BN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  // A warp done with k tile j counts itself out of its stage; the last of
  // the 8 loads the stage's next tile.
  auto release = [&](int j) {
    if (count_last(&done[j % DQ_STAGES], 8, lane) && lane == 0 &&
        j + DQ_STAGES < nk)
      load(j + DQ_STAGES);
  };
  // Pingpong turns, two a k tile (the S and dP products, then the dQ
  // product); warpgroup 1's last turn passes to no one.
  auto pass = [&](bool last) {
    if (wg == 0 || !last) turn_pass(wg);
  };

  mbar_wait(&qfull, 0);
  if (wg == 1) turn_pass(wg);            // warpgroup 0 goes first
  for (int j = 0; j < nk; ++j) {
    const int st = j % DQ_STAGES;
    const unsigned char* kt = ring + 2 * st * KB;
    const unsigned char* vt = kt + KB;
    turn_wait(wg);
    mbar_wait(&full[st], (j / DQ_STAGES) & 1);
    dq_scores<D>(s, qw, kt);
    dq_scores<D>(dp, dow, vt);
    turn_pass(wg);
    // P = exp(S * scale - lse) while dP runs; masked (to 0) only where the
    // tile crosses this warpgroup's diagonal or Sk
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    reg_fence_all(s);
#pragma unroll
    for (int n = 0; n < DQ_BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], a.scale);
    if ((j + 1) * DQ_BN > a.Sk || (a.causal && j * DQ_BN + DQ_BN - 1 > r0)) {
#pragma unroll
      for (int n = 0; n < DQ_BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * DQ_BN + n * 8 + 2 * t + (e & 1);
          if (col >= a.Sk || (a.causal && col > row0 + (e >> 1) * 8))
            s[n][e] = -INFINITY;
        }
    }
#pragma unroll
    for (int n = 0; n < DQ_BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = expf(__fsub_rn(s[n][e], lse[e >> 1]));
    // dS = P (dP - delta) * scale
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence_all(dp);
#pragma unroll
    for (int n = 0; n < DQ_BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = __fmul_rn(
            __fmul_rn(s[n][e], __fsub_rn(dp[n][e], delta[e >> 1])), a.scale);
    pack_frag(da, dp);
    reg_fence_all(da);
    turn_wait(wg);
    dq_acc<D>(dq, da, kt);
    pass(j + 1 == nk);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence_all(dq);
    reg_fence_all(da);
    release(j);
  }

  // dQ in bf16 into this warpgroup's rows of the Q tile (no other warp
  // reads them), in the boxes' swizzle: 16-byte chunk c of row r at chunk
  // c ^ (r % 8); then one thread stores them with TMA, which drops rows
  // past Sq.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = wg * 64 + warp * 16 + g + r * 8;   // row in the tile
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(
          qs + c / 8 * BOX + rl * 128 + (((c % 8) ^ g) << 4) + 4 * t) =
          __floats2bfloat162_rn(dq[c][2 * r], dq[c][2 * r + 1]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if ((threadIdx.x & 127) == 0 && r0 < a.Sq) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_store4(&tmdq, qw + nb * BOX, nb * 64, r0, hi, bi);
    tma_store_commit();
    tma_store_wait_read();
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

// The map of a bf16 [B, H, S, D] tensor as (d, s, h, b) from its element
// strides, in boxes of 64 columns x `rows` rows. A dimension of extent 1
// takes a packed stride (it is never stepped); every other stride must be a
// nonzero multiple of 16 bytes.
int encode_bhsd(CUtensorMap* map, const void* base, const View& v, int B,
                int H, int S, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long st[3] = {v.ss, v.sh, v.sb};
  cuuint64_t strides[3];
  cuuint64_t packed = 2ull * D;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) {
      strides[i] = packed;
    } else {
      if (st[i] <= 0 || (st[i] * 2) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      strides[i] = static_cast<cuuint64_t>(st[i]) * 2;
    }
    packed *= dims[i + 1];
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return encode_tiled(map, base, 4, dims, box, strides);
}

template <int D>
int launch_fwd_bf16(const Params& p, int BH, void* stream) {
  const int B = BH / p.H;
  const int n_qt = (p.Sq + FT - 1) / FT;
  if (BH > 65535 || B * p.H != BH)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // The runtime call comes before the first encode: the driver's
  // encoder fails with no current context, as in a fresh thread.
  constexpr int smem = fwd_smem<D>();
  auto kernel = flash_fwd_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tmq, tmk, tmv, tmo;
  int err = encode_bhsd(&tmq, p.q, p.vq, B, p.H, p.Sq, D, FT);
  if (err == 0) err = encode_bhsd(&tmk, p.k, p.vk, B, p.H, p.Sk, D, FT);
  if (err == 0) err = encode_bhsd(&tmv, p.v, p.vv, B, p.H, p.Sk, D, FT);
  if (err == 0) err = encode_bhsd(&tmo, p.out, p.vout, B, p.H, p.Sq, D, 64);
  if (err != 0) return err;
  const FwdArgs a = {p.lse, p.H, p.Sq, p.Sk, p.causal, p.scale};
  kernel<<<dim3(n_qt, BH), FWD_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(tmq, tmk, tmv, tmo, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const Params& p, int BH, void* stream) {
  const int B = BH / p.H;
  const int n_kt = (p.Sk + KT - 1) / KT;
  if (BH > 65535 || B * p.H != BH)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int smem = dkv_smem<D>();
  auto kernel = flash_dkv_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tmq, tmk, tmv, tmdo, tmdk, tmdv;
  int err = encode_bhsd(&tmq, p.q, p.vq, B, p.H, p.Sq, D, QT);
  if (err == 0) err = encode_bhsd(&tmk, p.k, p.vk, B, p.H, p.Sk, D, KT);
  if (err == 0) err = encode_bhsd(&tmv, p.v, p.vv, B, p.H, p.Sk, D, KT);
  if (err == 0) err = encode_bhsd(&tmdo, p.dout, p.vdo, B, p.H, p.Sq, D, QT);
  if (err == 0) err = encode_bhsd(&tmdk, p.dk, p.vdk, B, p.H, p.Sk, D, 64);
  if (err == 0) err = encode_bhsd(&tmdv, p.dv, p.vdv, B, p.H, p.Sk, D, 64);
  if (err != 0) return err;
  const BwdArgs a = {p.lse, p.delta, p.H, p.Sq, p.Sk, p.causal, p.scale};
  kernel<<<dim3(n_kt, BH), FWD_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(tmq, tmk, tmv, tmdo, tmdk,
                                                tmdv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_bf16(const Params& p, int BH, void* stream) {
  const int B = BH / p.H;
  const int n_qt = (p.Sq + FT - 1) / FT;
  if (BH > 65535 || B * p.H != BH)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int smem = dq_smem<D>();
  auto kernel = flash_dq_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tmq, tmk, tmv, tmdo, tmdq;
  int err = encode_bhsd(&tmq, p.q, p.vq, B, p.H, p.Sq, D, FT);
  if (err == 0) err = encode_bhsd(&tmk, p.k, p.vk, B, p.H, p.Sk, D, DQ_BN);
  if (err == 0) err = encode_bhsd(&tmv, p.v, p.vv, B, p.H, p.Sk, D, DQ_BN);
  if (err == 0) err = encode_bhsd(&tmdo, p.dout, p.vdo, B, p.H, p.Sq, D, FT);
  if (err == 0) err = encode_bhsd(&tmdq, p.out, p.vout, B, p.H, p.Sq, D, 64);
  if (err != 0) return err;
  const BwdArgs a = {p.lse, p.delta, p.H, p.Sq, p.Sk, p.causal, p.scale};
  kernel<<<dim3(n_qt, BH), FWD_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(tmq, tmk, tmv, tmdo, tmdq, a);
  return static_cast<int>(cudaGetLastError());
}

enum Which { FWD = 0, DQ = 1, DKV = 2 };

int run(Which which, int f32, int D, const Params& p, int BH, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (f32) {
    const int rows = which == DKV ? p.Sk : p.Sq;
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
  if (which == FWD)
    return D == 64 ? launch_fwd_bf16<64>(p, BH, stream)
                   : launch_fwd_bf16<128>(p, BH, stream);
  if (which == DQ)
    return D == 64 ? launch_dq_bf16<64>(p, BH, stream)
                   : launch_dq_bf16<128>(p, BH, stream);
  return D == 64 ? launch_dkv_bf16<64>(p, BH, stream)
                 : launch_dkv_bf16<128>(p, BH, stream);
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
