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
// the two bounds are about equal at ResNet-50's shapes. Every kernel reads
// its input tile plus a one-pixel halo once per channel chunk, and all nine
// taps then read it from shared memory. The three bf16 kernels are built
// for Hopper: persistent blocks with rings of TMA-filled stages feeding
// wgmma (below). The f32 kernels are the simple form, on the CUDA cores: no
// TMA, no pipelining of the loads against the math.
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
// dx = dpre*s, and folds dpre*x and dpre into per-channel f32 partials: in
// bf16 one row per consumer warpgroup of each persistent block, summed over
// its work items in order; in f32 one row per block. The TPU summed those
// across its sequential grid; here a second launch (finalize) folds the
// rows in a fixed order into ds, db. In bf16 a block's producer warpgroup
// loads dy halo rows and weight boxes with TMA into two rings, and two
// consumer warpgroups, each on its own pixel tile, run wgmma on them; what
// bounds it is in PERF.md.
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
// FMA contraction: "the bf16 rule"); for f32 the product and sum are
// separate f32 ops.
// Accumulation is f32. The f32 kernels run on the CUDA cores with FMA (no
// TF32), so their results differ from a float32 reference only by
// summation order.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

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

__device__ __forceinline__ float act32(float x, float s, float b, int relu) {
  float v = __fadd_rn(__fmul_rn(x, s), b);
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---------------------------------------------------------------------------
// Shared-memory fills (any block size)
// ---------------------------------------------------------------------------

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
// threads activate each tile's halo in place (the bf16 rule's roundings,
// padding left at zero) while the tile before it runs on
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

// The bf16 activation (the header's rule) on a pair of bf16 (low half
// first): x*s and +b each rounded to bf16 (bf16 operands: the rule's f32
// product and sum are exact before that rounding, so the bits are the
// rule's), then the ReLU. max.NaN keeps a NaN as the rule does; it maps -0
// to +0, which adds nothing to any sum.
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
// d-input, bf16: persistent, warp-specialised, TMA + wgmma
// ---------------------------------------------------------------------------

// Replaces _bwd_dx_kernel (mxnet_tpu/pallas_kernels/conv_fused.py). The
// GEMM: rows are the 128 output pixels of a 16 x 8 tile of the virtual
// image, columns a block of 64*NB input channels (the ci block), and the
// reduction runs over (64-channel chunk of dy, tap, 16 channels). A work
// item is (tile pair, ci block), numbered ci-block-major (item = cb *
// n_pairs + pair) so that the blocks in flight read the same weights from
// L2; block i takes items i, i + gridDim.x, ... (dx_plan in
// kernels/conv_fused.py), and consumer warpgroup cg (0, 1) takes tile 2 *
// pair + cg of each. The block is just the two consumers: with 8 warps,
// ptxas may give each thread the registers that NB = 2 needs (a producer
// warp would cap them at 168).
//
// Loads are TMA, issued by the consumers themselves. A consumer's dy halo
// for a chunk -- 18 rows of 16 pixels x 64 channels at (channel, column,
// row, image), one box where the rows lie in one image, else a box per row
// -- lands in one of its two stages; dy is not activated, so the zero fill
// outside the tensor is exactly the padding, the separator rows and the
// channels past Co. The weight ring holds pieces (chunk, tap): one box of
// 64 dy channels x 64*NB input channels of the flipped, transposed W, whose
// zero fill covers co past Co. Where every item needs the same nine pieces
// (one ci block of 64, Co <= 64) they are loaded once ("resident").
// Otherwise the last of the 8 warps done with a piece refills its slot;
// a stage is refilled by the last of its consumer's 4 warps. Arrival is an
// mbarrier per stage and slot (the boxes' bytes).
//
// Each consumer holds an m128 x n(64*NB) f32 accumulator (two m64 halves)
// and runs wgmma m64n(64*NB)k16 with both operands in shared memory: A, the
// tap's window of the halo -- 8 groups of 8 pixel rows, one halo row apart,
// starting at slot kx; wgmma, like TMA, swizzles by address bits, so the
// window needs no copy per kx -- and B, the piece. A tap's eight k-steps
// are one wgmma group; what the group of two taps back read is freed while
// the current one runs.
//
// Epilogue, in the consumer's last halo stage of the item: x of the lane's
// pixels is loaded (16 bytes at a time) while the taps run; each warp
// stages 16 pixels x 32 channels of its accumulator, and each lane reads
// back 8 channels of a pixel, recomputes pre with the bf16 rule's
// roundings, masks, scales and stores 8 bf16 of dx with one 16-byte store.
// ds and db are folded in a fixed order -- per lane, over the 8 lanes that
// share its channels, over the 4 warps -- and summed over the block's items
// of a ci block in item order into the consumer's own row of part (2, 2 *
// gridDim.x, Ci); the finalize folds the rows in order. No float atomics:
// every launch gives the same bits. What bounds it on an H100 is in
// PERF.md.
constexpr int DXB_CH = 64;                          // channels of a box
constexpr int DXB_HROW = DWB_HROW * DXB_CH * 2;     // a halo row: 16 slots
constexpr int DXB_HALO = (TH + 2) * DXB_HROW;       // one halo stage, 36864
constexpr int DXB_HALO_W = DWB_HROW;                // pixels per halo row box
constexpr int DXB_H_STAGES = 4;                     // two per consumer
constexpr int DXB_BOX = DXB_CH * DXB_CH * 2;        // 64 x 64 weights, 8192
constexpr int DXB_MAX_W_STAGES = 10;
// two consumer warpgroups and no producer: with 8 warps, 2 per SM
// sub-partition, ptxas may give each thread up to 255 registers
constexpr int DXB_THREADS = 256;
constexpr int SMEM_OPTIN = 232448;    // shared memory a block can opt into
constexpr int DXB_STATIC = 512;       // barriers and counters, with room
// epilogue scratch in a halo stage: per warp 16 pixels x 32 f32 channels
// (rows 36 floats apart), then the warps' ds and db sums
constexpr int DXB_STG_LD = 36;
constexpr int DXB_STG = 16 * DXB_STG_LD * 4;
static_assert(4 * DXB_STG + (8 + 3) * 2 * DXB_CH * 4 <= DXB_HALO,
              "epilogue scratch");

struct DxbWalk {
  int kc;         // 64-channel chunks of dy: ceil(Co / 64)
  int n_pairs;    // tile pairs: ceil(tiles / 2)
  int n_items;    // n_pairs * ci blocks
  int resident;   // the nine weight pieces are loaded once
  int w_stages;   // pieces in the weight ring (9 when resident)
};

// Shared-memory descriptor of the A operand: 64 pixel rows x 16 channels,
// K-major in the 128-byte swizzle, from a halo window -- 8 groups of 8
// pixel rows 128 bytes apart, the groups one halo row (DXB_HROW) apart.
// The window starts at slot kx of a swizzle atom; wgmma, like TMA, takes
// the swizzle from the address bits, so the base-offset field stays 0.
__device__ __forceinline__ uint64_t dxb_adesc(const void* p) {
  return sw128_desc_at(p, 16, DXB_HROW);
}

// The B operand of NB 64-channel boxes 8192 bytes apart (N-major, 128-byte
// swizzle): the leading offset steps from one box to the next.
__device__ __forceinline__ uint64_t dxb_bdesc(const void* p) {
  return sw128_desc_at(p, DXB_BOX, 1024);
}

// Pixel (tile row tr, column tc) of tile `tile` -> its index in the N*H*W
// pixels of x and dx, or -1 where nothing is stored.
__device__ __forceinline__ int dxb_pixel(const Geom& g, int tile, int tr,
                                         int tc) {
  const int rt = tile / g.col_tiles;
  const int vr = rt * TH + tr;
  const int c = (tile - rt * g.col_tiles) * TW + tc;
  if (vr >= g.V || c >= g.W) return -1;
  const int n = vr / (g.H + 1);
  const int h = vr - n * (g.H + 1);
  if (h >= g.H) return -1;
  return (n * g.H + h) * g.W + c;
}

// dx of channels cl .. cl + 7 of one pixel from dz and the pixel's x (8
// bf16). tab: the item's s (f32), then `stride` floats on, its bf16 s and
// then bf16 b as pairs. pre = x*s + b with the bf16 rule's roundings, as
// bf16 pair operations (act_pair); dpre = dz * (pre > 0), dx = dpre * s
// rounded to bf16, and dpre*x and dpre added to ps, pb -- no contraction.
__device__ __forceinline__ uint4 dxb_finish(const float (&dz)[8], uint4 xr,
                                            const float* tab, int cl,
                                            int stride, int relu,
                                            float (&ps)[8], float (&pb)[8]) {
  const uint32_t xw[4] = {xr.x, xr.y, xr.z, xr.w};
  const uint32_t* sb =
      reinterpret_cast<const uint32_t*>(tab + stride) + cl / 2;
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t pre = act_pair(xw[k], sb[k], sb[stride / 2 + k], 0);
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * k + e;
      const float xv = __uint_as_float(e ? xw[k] & 0xffff0000u : xw[k] << 16);
      float dpre = dz[j];
      if (relu) {
        // pre > 0: sign clear, not +0, not NaN
        const uint32_t pb16 = e ? pre >> 16 : pre & 0xffffu;
        dpre = __fmul_rn(dz[j], pb16 - 1u < 0x7f80u ? 1.f : 0.f);
      }
      d[e] = __fmul_rn(dpre, tab[cl + j]);
      ps[j] = __fadd_rn(ps[j], __fmul_rn(dpre, xv));
      pb[j] = __fadd_rn(pb[j], dpre);
    }
    const __nv_bfloat162 pr = __floats2bfloat162_rn(d[0], d[1]);
    o[k] = *reinterpret_cast<const uint32_t*>(&pr);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// A block's rings. Consumer cg owns halo stages 2cg and 2cg + 1: its h-th
// halo of the walk -- item h / kc of the block, dy chunk h % kc -- lands in
// stage 2cg + h % 2. The weight slots are shared by both consumers. A
// stage or slot is free once every warp that reads it has seen its last
// wgmma group complete: hdone and wdone count those warps, and the last
// one refills it.
struct DxbRing {
  uint64_t* hfull;
  uint64_t* wfull;
  int* hdone;
  int* wdone;
  unsigned char* hring;
  unsigned char* wring;
  const CUtensorMap* tmrow;     // dy: boxes of one halo row
  const CUtensorMap* tmhalo;    // dy: boxes of a whole halo
  const CUtensorMap* tmw;
};

// A warp of consumer cg issues its halo h: 18 rows of 16 pixels (columns
// c0 - 1 .. c0 + 14; the last six only fill the stage's row) x 64 dy
// channels. Where the 18 virtual rows are rows h0 .. h0 + 17 of one image
// -- counting its row -1 and its row H, the separators, which lie outside
// the tensor and read as zeros -- one box brings them all; otherwise lane
// k < 18 issues the box of row k. Nothing past the block's last item.
__device__ __forceinline__ void dxb_issue_halo(const DxbRing& rg,
                                               const Geom& g,
                                               const DxbWalk& walk,
                                               float inv_h1, int cg, int h,
                                               int lane) {
  const int item = blockIdx.x + (h / walk.kc) * gridDim.x;
  if (item >= walk.n_items) return;
  const int stg = 2 * cg + (h & 1);
  const int tile = 2 * (item % walk.n_pairs) + cg;
  const int rt = tile / g.col_tiles;
  const int c = (h % walk.kc) * DXB_CH;
  const int w0 = (tile - rt * g.col_tiles) * TW - 1;
  unsigned char* dst = rg.hring + stg * DXB_HALO;
  int n, hh;
  dwb_box_rows(rt * TH - 1, g, inv_h1, n, hh);
  if (lane == 0) mbar_expect_tx(&rg.hfull[stg], DXB_HALO);
  if (hh + TH + 1 <= g.H || n >= g.N) {
    if (lane == 0) tma_load4(dst, rg.tmhalo, c, w0, hh, n, &rg.hfull[stg]);
  } else if (lane < TH + 2) {
    dwb_box_rows(rt * TH - 1 + lane, g, inv_h1, n, hh);
    tma_load4(dst + lane * DXB_HROW, rg.tmrow, c, w0, hh, n, &rg.hfull[stg]);
  }
}

// One thread issues piece p of the block's walk -- item p / (9 kc) of the
// block, dy chunk, tap -- into slot p % w_stages: one box of 64 dy
// channels x NB blocks of 64 input channels. Nothing past the block's last
// item.
template <int NB>
__device__ __forceinline__ void dxb_issue_piece(const DxbRing& rg,
                                                const DxbWalk& walk, int p) {
  const int per = walk.kc * 9;
  const int item = blockIdx.x + (p / per) * gridDim.x;
  if (item >= walk.n_items) return;
  const int rem = p - (p / per) * per;
  const int stg = p % walk.w_stages;
  mbar_expect_tx(&rg.wfull[stg], NB * DXB_BOX);
  tma_load4(rg.wring + stg * NB * DXB_BOX, rg.tmw, 0, rem / 9 * DXB_CH,
            item / walk.n_pairs * NB, rem % 9, &rg.wfull[stg]);
}

// A warp is done with piece p (its last wgmma group that read it has
// completed): the last of the 8 consumer warps refills the slot with piece
// p + w_stages.
template <int NB>
__device__ __forceinline__ void dxb_piece_done(const DxbRing& rg,
                                               const DxbWalk& walk, int p,
                                               int lane) {
  if (count_last(&rg.wdone[p % walk.w_stages], 8, lane) && lane == 0)
    dxb_issue_piece<NB>(rg, walk, p + walk.w_stages);
}

// Tap step tau = chunk * 9 + tap of an item: wait for its weight piece
// (and, on a new chunk, the chunk's halo h), issue the tap's wgmma group --
// both m64 halves, four k-steps each -- and, while it runs, free what the
// group of tap tau - 2 read (done since the last tap's wait): its piece, and
// after a chunk's last tap the chunk's stage, which then takes halo h + 1.
// Then wait until this group is the only one pending. p0: the pieces of the
// block's earlier items.
template <int NB>
__device__ __forceinline__ void dxb_tap(float (&acc)[2][NB][8][4],
                                        const DxbRing& rg, const Geom& g,
                                        const DxbWalk& walk, float inv_h1,
                                        int tau, int p0, int& h, int cg,
                                        int lane) {
  const int pi = p0 + tau;
  const int ws = walk.resident ? tau : pi % walk.w_stages;
  const int tap = tau % 9;
  if (tap == 0 && tau > 0) {
    ++h;
    mbar_wait(&rg.hfull[2 * cg + (h & 1)], (h >> 1) & 1);
  }
  mbar_wait(&rg.wfull[ws], walk.resident ? 0 : (pi / walk.w_stages) & 1);
  const unsigned char* wp = rg.wring + ws * NB * DXB_BOX;
  const int ky = tap / 3;
  const unsigned char* win = rg.hring + (2 * cg + (h & 1)) * DXB_HALO +
                             ky * DXB_HROW + (tap - ky * 3) * 128;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(acc[i][nb][j][e]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(reinterpret_cast<float(&)[NB * 8][4]>(acc[i]),
               dxb_adesc(win + 8 * i * DXB_HROW + kk * 32),
               dxb_bdesc(wp + kk * 16 * DXB_CH * 2));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  if (tau >= 2) {
    if (!walk.resident) dxb_piece_done<NB>(rg, walk, pi - 2, lane);
    if ((tau - 2) % 9 == 8 && count_last(&rg.hdone[2 * cg + ((h + 1) & 1)], 4,
                                       lane))
      dxb_issue_halo(rg, g, walk, inv_h1, cg, h + 1, lane);
  }
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

template <int NB>
__global__ void __launch_bounds__(DXB_THREADS, 1)
conv_bwd_dx_bf16_kernel(const __grid_constant__ CUtensorMap tmrow,
                        const __grid_constant__ CUtensorMap tmhalo,
                        const __grid_constant__ CUtensorMap tmw,
                        const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ s,
                        const float* __restrict__ b,
                        __nv_bfloat16* __restrict__ dx,
                        float* __restrict__ part, Geom g, DxbWalk walk) {
  constexpr int CB = NB * DXB_CH;               // input channels per item
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t hfull[DXB_H_STAGES];
  __shared__ __align__(8) uint64_t wfull[DXB_MAX_W_STAGES];
  __shared__ int hdone[DXB_H_STAGES], wdone[DXB_MAX_W_STAGES];
  // the swizzle works on shared-memory address bits: align the rings there
  unsigned char* hring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) &
                                     1023u);
  unsigned char* wring = hring + DXB_H_STAGES * DXB_HALO;
  const long long T = 2LL * gridDim.x;          // rows of part
  const int cg = threadIdx.x >> 7;              // consumer: tile 2*pair + cg
  const int ct = threadIdx.x & 127;
  const int warp = ct >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;    // accumulator: row gq (and gq + 8) of the
  const int t = lane & 3;      // warp's 16, columns 8j + 2t and +1
  const DxbRing rg = {hfull, wfull, hdone, wdone, hring,
                      wring, &tmrow, &tmhalo, &tmw};
  const float inv_h1 = 1.f / static_cast<float>(g.H + 1);

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmrow) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmhalo) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmw) : "memory");
    for (int i = 0; i < DXB_H_STAGES; ++i) {
      mbar_init(&hfull[i], 1);
      hdone[i] = 0;
    }
    for (int i = 0; i < walk.w_stages; ++i) {
      mbar_init(&wfull[i], 1);
      wdone[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* prow = part + (2LL * blockIdx.x + cg) * g.Ci;   // this consumer's
  // row of part starts at zero: channels that none of its items reach
  // stay so
  for (int c = ct; c < g.Ci; c += 128) {
    prow[c] = 0.f;
    prow[T * g.Ci + c] = 0.f;
  }
  __syncthreads();
  // the first two halos of each consumer and the first pieces
  if (warp == 0) {
    dxb_issue_halo(rg, g, walk, inv_h1, cg, 0, lane);
    dxb_issue_halo(rg, g, walk, inv_h1, cg, 1, lane);
  }
  if (threadIdx.x == 0)
    for (int p = 0; p < walk.w_stages; ++p) dxb_issue_piece<NB>(rg, walk, p);

  const int total = walk.kc * 9;
  const int v = lane >> 3;     // epilogue: the lane's 8 channels of each 32
  const int rl = lane & 7;     // and its staged rows, rl and rl + 8
  float acc[2][NB][8][4];
  int h = 0;                   // this consumer's halo in use
  int p0 = 0;
  // thread ct < CB: channel run_cb + ct's ds and db over the block's items
  // of ci block run_cb (items ascend, so a ci block is one run)
  int run_cb = -1;
  float run_s = 0.f, run_b = 0.f;
  for (int item = blockIdx.x; item < walk.n_items; item += gridDim.x) {
    const int pair = item % walk.n_pairs;
    const int cb0 = item / walk.n_pairs * CB;
    const int tile = 2 * pair + cg;
    // for the epilogue, loaded while the taps run: this thread's channel
    // of s and b, and x of the lane's pixels -- tile row 8i + 2*warp + rr,
    // column rl -- and channels
    const bool my_ch = ct < CB && cb0 + ct < g.Ci;
    const float my_s = my_ch ? __ldg(s + cb0 + ct) : 0.f;
    const float my_b = my_ch ? __ldg(b + cb0 + ct) : 0.f;
    int px[2][2];
    uint4 xr[NB][2][2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        px[i][rr] = dxb_pixel(g, tile, 8 * i + 2 * warp + rr, rl);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ch = cb0 + nb * DXB_CH + hf * 32 + v * 8;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            xr[nb][hf][i][rr] =
                px[i][rr] >= 0 && ch < g.Ci
                    ? __ldg(reinterpret_cast<const uint4*>(
                          x + static_cast<long long>(px[i][rr]) * g.Ci + ch))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nb][j][e] = 0.f;
    mbar_wait(&hfull[2 * cg + (h & 1)], (h >> 1) & 1);
    for (int tau = 0; tau < total; ++tau)
      dxb_tap<NB>(acc, rg, g, walk, inv_h1, tau, p0, h, cg, lane);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) reg_fence(acc[i][nb][j][e]);
    if (!walk.resident)
      for (int k = total > 2 ? total - 2 : 0; k < total; ++k)
        dxb_piece_done<NB>(rg, walk, p0 + k, lane);
    p0 += total;

    // ---- epilogue, in this consumer's stage of halo h once every warp's
    // last group that read it has completed. Scratch: per warp its staged
    // accumulator rows, then the warps' ds and db sums, then the item's s
    // and, as bf16 pairs, its s and b.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cg) : "memory");
    unsigned char* scr = hring + (2 * cg + (h & 1)) * DXB_HALO;
    float* stg = reinterpret_cast<float*>(scr + warp * DXB_STG);
    float* red = reinterpret_cast<float*>(scr + 4 * DXB_STG);
    float* tab = red + 8 * CB;
    if (ct < CB) {
      tab[ct] = my_s;
      __nv_bfloat16* t16 = reinterpret_cast<__nv_bfloat16*>(tab + CB);
      t16[ct] = __float2bfloat16_rn(my_s);
      t16[CB + ct] = __float2bfloat16_rn(my_b);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cg) : "memory");
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int cl = nb * DXB_CH + hf * 32 + v * 8;
        const bool chok = cb0 + cl < g.Ci;      // Ci is a multiple of 8
        float ps[8], pb[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) ps[e] = pb[e] = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float* a = acc[i][nb][hf * 4 + jj];
            *reinterpret_cast<float2*>(stg + gq * DXB_STG_LD + 8 * jj +
                                       2 * t) = make_float2(a[0], a[1]);
            *reinterpret_cast<float2*>(stg + (gq + 8) * DXB_STG_LD + 8 * jj +
                                       2 * t) = make_float2(a[2], a[3]);
          }
          __syncwarp();
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if (px[i][rr] < 0 || !chok) continue;
            const float* src = stg + (rl + 8 * rr) * DXB_STG_LD + 8 * v;
            const float4 lo = *reinterpret_cast<const float4*>(src);
            const float4 hi = *reinterpret_cast<const float4*>(src + 4);
            const float dz[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
            *reinterpret_cast<uint4*>(
                dx + static_cast<long long>(px[i][rr]) * g.Ci + cb0 + cl) =
                dxb_finish(dz, xr[nb][hf][i][rr], tab, cl, CB, g.relu, ps,
                           pb);
          }
          __syncwarp();
        }
        // fold the 8 lanes that hold the same channels (lane bits 0..2)
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int d = 1; d < 8; d <<= 1) {
            ps[e] = __fadd_rn(ps[e], __shfl_xor_sync(FULL, ps[e], d));
            pb[e] = __fadd_rn(pb[e], __shfl_xor_sync(FULL, pb[e], d));
          }
        if (rl == 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            red[(warp * 2) * CB + cl + e] = ps[e];
            red[(warp * 2 + 1) * CB + cl + e] = pb[e];
          }
        }
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cg) : "memory");
    if (ct < CB) {
      if (cb0 != run_cb) {
        if (run_cb >= 0 && run_cb + ct < g.Ci) {
          prow[run_cb + ct] = run_s;
          prow[T * g.Ci + run_cb + ct] = run_b;
        }
        run_cb = cb0;
        run_s = run_b = 0.f;
      }
      float vs = 0.f, vb = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        vs = __fadd_rn(vs, red[(k * 2) * CB + ct]);
        vb = __fadd_rn(vb, red[(k * 2 + 1) * CB + ct]);
      }
      run_s = __fadd_rn(run_s, vs);
      run_b = __fadd_rn(run_b, vb);
    }
    // the scratch's generic-proxy accesses come before the next boxes'
    // async-proxy writes into the stage
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cg) : "memory");
    if (warp == 0) dxb_issue_halo(rg, g, walk, inv_h1, cg, h + 2, lane);
    ++h;
  }
  if (ct < CB && run_cb >= 0 && run_cb + ct < g.Ci) {
    prow[run_cb + ct] = run_s;
    prow[T * g.Ci + run_cb + ct] = run_b;
  }
}

// ---------------------------------------------------------------------------
// Forward, bf16: persistent, warp-specialised, TMA + wgmma, the activation
// in place
// ---------------------------------------------------------------------------

// Replaces _fwd_kernel (mxnet_tpu/pallas_kernels/conv_fused.py). The
// d-input kernel's implicit GEMM with x in place of dy and W, laid out (9,
// Ci, co64), in place of its flipped transpose: rows are the 128 output
// pixels of a tile, columns a block of 64*NB output channels (the co
// block), and the reduction runs over (64-channel chunk of x, tap, 16
// channels). A work item is (tile pair, co block), numbered co-block-major
// (item = cb * n_pairs + pair), so that the blocks in flight read the same
// weights from L2; block i takes items i, i + gridDim.x, ... (fwd_plan in
// kernels/conv_fused.py), and consumer warpgroup cg (0, 1) takes tile 2 *
// pair + cg of each. The halos, the weight pieces and the wgmma operands
// are the d-input kernel's (DxbWalk, DXB_*, dxb_adesc, dxb_bdesc): a
// block's walk is a sequence of chunk steps q (its items in order, each
// item's chunks in order), and step q needs each consumer's halo of the
// chunk -- 18 rows of 16 pixel slots x 64 channels, in the consumer's stage
// 2cg + q % 2 -- and the chunk's nine pieces (chunk, tap), 64 input x
// 64*NB output channels each, in a ring of slots shared by both consumers
// (loaded once where every item reads the same nine: Ci and Co <= 64).
//
// The block is three warpgroups with one role each, so that the consumers'
// loop holds nothing but waits and tensor-core work:
// - warp 8, the producer: walks the chunk steps and issues the TMA boxes
//   of each halo (a box per row from 18 lanes where the rows span images)
//   and piece as soon as its stage or slot is empty;
// - warps 9-11, the activators: once a halo lands, they rewrite it in
//   place as relu(x*s + b) by the bf16 rule (act_pair), 16 bytes at a time
//   in the boxes' swizzle, touching only the 10 pixel slots a tap window
//   reads and only pixels inside an image -- the boxes' zero fill is the
//   padding, which lives in activated space (the fill is not an activated
//   zero: relu(0*s + b) is relu(b)), and channels past Ci activate to 0*0 +
//   0 -- then fence the writes for the async proxy and mark the halo ready;
// - warpgroups 0 and 1, the consumers: each holds an m128 x n(64*NB) f32
//   accumulator and runs a tap's wgmma m64n(64*NB)k16 (both m64 halves,
//   four k-steps) as one group, both operands read from shared memory,
//   with FWB_DEPTH groups in flight. Once a group has completed, its piece
//   is freed and, after a chunk's last tap, its stage.
// Handshakes are mbarriers: full (the boxes' bytes), ready (the 96
// activator threads), empty (a lane of each warp that read it); setmaxnreg
// moves registers from the producer warpgroup to the consumers.
//
// Epilogue, in the consumer's stage of the item's last chunk once its
// groups have completed: the accumulator, rounded to bf16, is written in
// the 128-byte swizzle as 16*NB boxes of one tile row x 64 channels, and
// lane k of the consumer's first warp stores box k with TMA; then the
// stage is freed. Rows on a separator or past the last image are not
// stored, and columns past W and channels past Co fall outside the tensor
// and are not written. No float atomics: every launch gives the same bits.
// At ResNet-50's shapes the bound is the operations (bytes at 56x56); what
// holds the kernel above it, measured with chip_conv_probe.py, is in
// PERF.md.
constexpr int FWB_THREADS = 384;
constexpr int FWB_ACTIVATORS = 96;                    // warps 9-11
// tap groups a consumer keeps in flight: a group's piece (and stage) is
// freed once the group FWB_DEPTH later has been issued
constexpr int FWB_DEPTH = 1;
constexpr int FWB_ACT_J = HALO_P * 8 / FWB_ACTIVATORS;   // 15 passes
constexpr int FWB_ACT_BATCH = 3;          // passes whose loads fly together
static_assert(HALO_P * 8 % FWB_ACTIVATORS == 0, "activation passes");
static_assert(FWB_ACT_J % FWB_ACT_BATCH == 0, "activation batches");
static_assert(2 * TH * 1024 <= DXB_HALO, "epilogue staging");
static_assert(FWB_DEPTH >= 1 && FWB_DEPTH < 9, "groups in flight");
// registers per thread after setmaxnreg: the consumers hold up to two
// m64n128 f32 accumulators (128), an activator a batch of 16-byte chunks.
// Leave some of the file free: with every register given out, the
// consumers' setmaxnreg.inc waited for ever.
constexpr int FWB_PRODUCER_REGS = 56;
constexpr int FWB_CONSUMER_REGS = 224;
static_assert(FWB_PRODUCER_REGS * 128 + FWB_CONSUMER_REGS * 256 < 65536,
              "register file");

// The mbarriers of a block: per halo stage full, ready and empty; per
// weight slot full and empty.
struct FwbBars {
  uint64_t* hfull;
  uint64_t* hready;
  uint64_t* hempty;
  uint64_t* wfull;
  uint64_t* wempty;
};

// The producer warp's issue of one halo: tile `tile`'s 18 rows of 16
// pixels (columns c0 - 1 .. c0 + 14) x channels c .. c + 63 of x. Where the
// rows lie in one image (counting its row -1 and its row H, which lie
// outside the tensor and read as zeros) lane 0 issues one box for them
// all; otherwise lane k < 18 issues row k's.
__device__ __forceinline__ void fwb_issue_halo(
    unsigned char* dst, uint64_t* bar, const CUtensorMap* tmrow,
    const CUtensorMap* tmhalo, const Geom& g, float inv_h1, int tile, int c,
    int lane) {
  const int rt = tile / g.col_tiles;
  const int w0 = (tile - rt * g.col_tiles) * TW - 1;
  int n, hh;
  dwb_box_rows(rt * TH - 1, g, inv_h1, n, hh);
  if (lane == 0) mbar_expect_tx(bar, DXB_HALO);
  if (hh + TH + 1 <= g.H || n >= g.N) {
    if (lane == 0) tma_load4(dst, tmhalo, c, w0, hh, n, bar);
  } else if (lane < TH + 2) {
    dwb_box_rows(rt * TH - 1 + lane, g, inv_h1, n, hh);
    tma_load4(dst + lane * DXB_HROW, tmrow, c, w0, hh, n, bar);
  }
}

// The producer warp: for each chunk step q of the block's walk, the two
// consumers' halos, each once its stage is empty, then (unless resident)
// the step's nine pieces into the next slots of the ring, each once both
// consumers have freed the slot. Every lane waits; lane 0 issues the
// pieces.
template <int NB>
__device__ void fwb_produce(const FwbBars& bb, unsigned char* hring,
                            unsigned char* wring, const CUtensorMap* tmrow,
                            const CUtensorMap* tmhalo,
                            const CUtensorMap* tmw, const Geom& g,
                            const DxbWalk& walk, float inv_h1, int lane) {
  if (walk.resident && lane == 0)
    for (int tap = 0; tap < 9; ++tap) {
      mbar_expect_tx(&bb.wfull[tap], NB * DXB_BOX);
      tma_load4(wring + tap * NB * DXB_BOX, tmw, 0, 0, 0, tap,
                &bb.wfull[tap]);
    }
  int slot = 0, phase = 0, p = 0, q = 0;
  for (int item = blockIdx.x; item < walk.n_items; item += gridDim.x) {
    const int pair = item % walk.n_pairs;
    const int cb = item / walk.n_pairs;
    for (int c = 0; c < walk.kc; ++c, ++q) {
      for (int cg = 0; cg < 2; ++cg) {
        const int stg = 2 * cg + (q & 1);
        if (q >= 2) mbar_wait(&bb.hempty[stg], ((q - 2) >> 1) & 1);
        fwb_issue_halo(hring + stg * DXB_HALO, &bb.hfull[stg], tmrow,
                       tmhalo, g, inv_h1, 2 * pair + cg, c * DXB_CH, lane);
      }
      if (walk.resident) continue;
      for (int tap = 0; tap < 9; ++tap, ++p) {
        if (p >= walk.w_stages) mbar_wait(&bb.wempty[slot], phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&bb.wfull[slot], NB * DXB_BOX);
          tma_load4(wring + slot * NB * DXB_BOX, tmw, 0, c * DXB_CH,
                    cb * NB, tap, &bb.wfull[slot]);
        }
        if (++slot == walk.w_stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// Activator thread at (0 .. 95): for each chunk step q and consumer cg, in
// the producer's order, once the halo lands it activates 16-byte chunk at %
// 8 (channels 8 (at % 8) ..) of halo pixels p = at / 8 + 12j (row p / 10,
// slot p % 10), j < 15, where the pixel lies in an image, fences its writes
// for the async proxy and arrives on the stage's ready barrier. s and b are
// rounded to bf16 pairs, zero past Ci. The passes go in batches whose
// loads are all issued before the first store.
__device__ void fwb_activate(const FwbBars& bb, unsigned char* hring,
                             const float* s, const float* b, const Geom& g,
                             const DxbWalk& walk, float inv_h1, int at) {
  const int v = at & 7;
  const int lane = at & 31;
  int q = 0;
  for (int item = blockIdx.x; item < walk.n_items; item += gridDim.x) {
    const int pair = item % walk.n_pairs;
    for (int c = 0; c < walk.kc; ++c, ++q) {
      uint32_t s2[4], b2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float sv[2], bv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = c * DXB_CH + 8 * v + 2 * k + e;
          sv[e] = ci < g.Ci ? __ldg(s + ci) : 0.f;
          bv[e] = ci < g.Ci ? __ldg(b + ci) : 0.f;
        }
        const __nv_bfloat162 sp = __floats2bfloat162_rn(sv[0], sv[1]);
        const __nv_bfloat162 bp = __floats2bfloat162_rn(bv[0], bv[1]);
        s2[k] = *reinterpret_cast<const uint32_t*>(&sp);
        b2[k] = *reinterpret_cast<const uint32_t*>(&bp);
      }
      for (int cg = 0; cg < 2; ++cg) {
        const int tile = 2 * pair + cg;
        const int rt = tile / g.col_tiles;
        const int c0 = (tile - rt * g.col_tiles) * TW;
        // lane k < 18 asks whether halo row k lies in an image
        const int vr = rt * TH - 1 + lane;
        bool in = false;
        if (lane < TH + 2 && vr >= 0 && vr < g.V) {
          int hrow;
          dwb_image(vr, g.H + 1, inv_h1, hrow);
          in = hrow < g.H;
        }
        const uint32_t rows = __ballot_sync(FULL, in);
        const int stg = 2 * cg + (q & 1);
        const uint32_t halo = smem_addr(hring + stg * DXB_HALO);
        mbar_wait(&bb.hfull[stg], (q >> 1) & 1);
#pragma unroll 1
        for (int j0 = 0; j0 < FWB_ACT_J; j0 += FWB_ACT_BATCH) {
          uint32_t addr[FWB_ACT_BATCH];
          uint4 x[FWB_ACT_BATCH];
#pragma unroll
          for (int k = 0; k < FWB_ACT_BATCH; ++k) {
            const int p = (at >> 3) + 12 * (j0 + k);
            const int hr = p / HALO_W;
            const int hc = p - hr * HALO_W;
            addr[k] = ((rows >> hr) & 1u) &&
                              static_cast<unsigned>(c0 - 1 + hc) <
                                  static_cast<unsigned>(g.W)
                          ? halo + hr * DXB_HROW + hc * DXB_CH * 2 +
                                ((v ^ (hc & 7)) << 4)
                          : 0u;
            if (addr[k]) x[k] = lds128(addr[k]);
          }
#pragma unroll
          for (int k = 0; k < FWB_ACT_BATCH; ++k)
            if (addr[k])
              sts128(addr[k],
                     make_uint4(act_pair(x[k].x, s2[0], b2[0], g.relu),
                                act_pair(x[k].y, s2[1], b2[1], g.relu),
                                act_pair(x[k].z, s2[2], b2[2], g.relu),
                                act_pair(x[k].w, s2[3], b2[3], g.relu)));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&bb.hready[stg]);
      }
    }
  }
}

// Issues the wgmma group of tap `tap` (0 .. 8) on the halo whose A
// descriptor is da and the piece whose B descriptor is db: both m64 halves
// of the accumulator, four k-steps each. The window of tap (ky, kx) starts
// ky halo rows and kx pixel slots into the halo; the offsets are added to
// the descriptors' address field (16-byte units, no carry: shared memory
// lies below 2^18 bytes).
template <int NB>
__device__ __forceinline__ void fwb_group(float (&acc)[2][NB][8][4],
                                          uint64_t da, uint64_t db,
                                          int tap) {
  const int ky = tap / 3;
  const int kx = tap - ky * 3;
  reg_fence_all(reinterpret_cast<float(&)[2 * NB * 8][4]>(acc));
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(reinterpret_cast<float(&)[NB * 8][4]>(acc[i]),
               da + ((ky * DXB_HROW + kx * 128 + 8 * i * DXB_HROW +
                      kk * 32) >> 4),
               db + ((kk * 16 * DXB_CH * 2) >> 4));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int NB>
__global__ void __launch_bounds__(FWB_THREADS, 1)
conv_fused_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tmrow,
                           const __grid_constant__ CUtensorMap tmhalo,
                           const __grid_constant__ CUtensorMap tmw,
                           const __grid_constant__ CUtensorMap tmout,
                           const float* __restrict__ s,
                           const float* __restrict__ b, Geom g,
                           DxbWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t hfull[DXB_H_STAGES];
  __shared__ __align__(8) uint64_t hready[DXB_H_STAGES];
  __shared__ __align__(8) uint64_t hempty[DXB_H_STAGES];
  __shared__ __align__(8) uint64_t wfull[DXB_MAX_W_STAGES];
  __shared__ __align__(8) uint64_t wempty[DXB_MAX_W_STAGES];
  // the swizzle works on shared-memory address bits: align the rings there
  unsigned char* hring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) &
                                     1023u);
  unsigned char* wring = hring + DXB_H_STAGES * DXB_HALO;
  const FwbBars bb = {hfull, hready, hempty, wfull, wempty};
  const float inv_h1 = 1.f / static_cast<float>(g.H + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < DXB_H_STAGES; ++i) {
      mbar_init(&hfull[i], 1);
      mbar_init(&hready[i], FWB_ACTIVATORS);
      mbar_init(&hempty[i], 4);
    }
    for (int i = 0; i < walk.w_stages; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- the producer warpgroup: warp 8 issues the loads, warps 9-11
    // activate
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        FWB_PRODUCER_REGS));
    if (threadIdx.x >= 288) {
      fwb_activate(bb, hring, s, b, g, walk, inv_h1, threadIdx.x - 288);
      return;
    }
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmrow) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmhalo) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmw) : "memory");
    }
    fwb_produce<NB>(bb, hring, wring, &tmrow, &tmhalo, &tmw, g, walk,
                    inv_h1, threadIdx.x & 31);
    return;
  }

  // ---- consumer warpgroup cg: tile 2 * pair + cg of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      FWB_CONSUMER_REGS));
  const int cg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;    // accumulator: row gq (and gq + 8) of the
  const int t = lane & 3;      // warp's 16, columns 8j + 2t and +1
  if (threadIdx.x == 0)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tmout) : "memory");
  float acc[2][NB][8][4];
  int slot = 0, phase = 0;     // the next piece's slot and pass (ring)
  int q = 0;                   // chunk step
  for (int item = blockIdx.x; item < walk.n_items; item += gridDim.x) {
    const int co0 = item / walk.n_pairs * NB * DXB_CH;
    const int tile = 2 * (item % walk.n_pairs) + cg;
    const int rt = tile / g.col_tiles;
    const int c0 = (tile - rt * g.col_tiles) * TW;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nb][j][e] = 0.f;
    for (int c = 0; c < walk.kc; ++c, ++q) {
      const int stg = 2 * cg + (q & 1);
      mbar_wait(&hready[stg], (q >> 1) & 1);
      const uint64_t da = dxb_adesc(hring + stg * DXB_HALO);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ws = walk.resident ? tap : slot;
        mbar_wait(&wfull[ws], walk.resident ? 0 : phase);
        fwb_group<NB>(acc, da, dxb_bdesc(wring + ws * NB * DXB_BOX), tap);
        asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(FWB_DEPTH)
                     : "memory");
        // the item's group FWB_DEPTH back has completed: free its piece
        // and, after a chunk's last tap, its stage (the epilogue frees an
        // item's last)
        if (lane == 0 && (c > 0 || tap >= FWB_DEPTH)) {
          if (!walk.resident)
            mbar_arrive(&wempty[ws >= FWB_DEPTH
                                    ? ws - FWB_DEPTH
                                    : ws + walk.w_stages - FWB_DEPTH]);
          if (tap == FWB_DEPTH - 1)
            mbar_arrive(&hempty[2 * cg + ((q - 1) & 1)]);
        }
        if (!walk.resident && ++slot == walk.w_stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence_all(reinterpret_cast<float(&)[2 * NB * 8][4]>(acc));
    if (lane == 0 && !walk.resident)
      for (int k = 1; k <= FWB_DEPTH; ++k)
        mbar_arrive(&wempty[slot >= k ? slot - k : slot + walk.w_stages - k]);

    // ---- epilogue, in the stage of the item's last chunk once every
    // warp's groups that read it have completed: box (nb, tile row tr) at
    // (nb * TH + tr) * 1024, pixel tc's 128 bytes at tc * 128, 16-byte
    // chunk c at c ^ tc. Warp w holds tile rows 8i + 2w (accumulator rows
    // gq) and 8i + 2w + 1 (gq + 8), column gq.
    const int stg = 2 * cg + ((q - 1) & 1);
    unsigned char* scr = hring + stg * DXB_HALO;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cg) : "memory");
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          unsigned char* row =
              scr + (nb * TH + 8 * i + 2 * warp + r) * 1024 + gq * 128 + 4 * t;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[i][nb][j][2 * r], acc[i][nb][j][2 * r + 1]);
            *reinterpret_cast<__nv_bfloat162*>(row + ((j ^ gq) << 4)) = v;
          }
        }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cg) : "memory");
    if (warp == 0) {
      if (lane < NB * TH) {
        const int tr = lane % TH;
        const int nb = lane / TH;
        const int vr = rt * TH + tr;
        int hrow = g.H, n = 0;
        if (vr < g.V) n = dwb_image(vr, g.H + 1, inv_h1, hrow);
        if (hrow < g.H)
          tma_store4(&tmout, scr + (nb * TH + tr) * 1024,
                     co0 + nb * DXB_CH, c0, hrow, n);
      }
      tma_store_commit();
      // the stores have read the stage before it is freed
      tma_store_wait_read();
      __syncwarp();
    }
    if (lane == 0) mbar_arrive(&hempty[stg]);
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

// d-input, f32. Geometry of the GEMM: the tile operand is dy (g.Ci = the
// convolution's Co), w is the flipped, transposed (9*Co, Ci) weight, and
// the result has g.Co = the convolution's Ci channels, like x and dx.
// part holds 2 x gridDim.x x g.Co floats: the block partials of ds, then
// of db.
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

int launch_fwd_f32(const void* x, const float* s, const float* b,
                   const void* w, void* out, int N, int H, int W, int Ci,
                   int Co, int relu, void* stream) {
  Geom g = make_geom(N, H, W, Ci, Co, relu, 1, x, w, 4);
  int err = set_smem(conv_fused_f32_kernel, SMEM32);
  if (err != 0) return err;
  const long long blocks = tiles_of(g);
  const int co_tiles = (Co + BN - 1) / BN;
  if (blocks > 0x7fffffffLL || co_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks), co_tiles);
  conv_fused_f32_kernel<<<grid, THREADS, SMEM32,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), s, b, static_cast<const float*>(w),
      static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

int launch_dx_f32(const void* dy, const void* wt, const void* x,
                  const float* s, const float* b, void* dx, float* part,
                  int N, int H, int W, int Ci, int Co, int relu,
                  void* stream) {
  // the GEMM reads dy (Co channels) and produces Ci channels
  Geom g = make_geom(N, H, W, Co, Ci, relu, 0, dy, wt, 4);
  int err = set_smem(conv_bwd_dx_f32_kernel, SMEM32);
  if (err != 0) return err;
  const long long blocks = tiles_of(g);
  const int c_tiles = (Ci + BN - 1) / BN;
  if (blocks > 0x7fffffffLL || c_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(static_cast<unsigned>(blocks), c_tiles);
  conv_bwd_dx_f32_kernel<<<grid, THREADS, SMEM32,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(wt),
      static_cast<const float*>(x), s, b, static_cast<float*>(dx), part, g);
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

// The map of a contiguous bf16 NHWC tensor as (channel, column, row,
// image), with boxes of 64 channels x box_w columns x box_h rows.
int encode_nhwc(CUtensorMap* map, const void* base, int N, int H, int W,
                int C, int box_w, int box_h) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(DWB_CK),
                             static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  return encode_tiled(map, base, 4, dims, box);
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
  if (items > 0x7fffffffLL || g.V >= (1 << 24) ||
      static_cast<long long>(N) * H * W > 0x7fffffffLL)
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

// The walk of a persistent bf16 kernel (d-input or forward) over the items
// (tile pair, block of 64*nb result channels) of a plan, for a halo
// operand of k_ch channels (chunks of 64) and a result of n_ch channels:
// checks the plan and sizes the weight ring; smem is the dynamic shared
// memory the kernel asks for.
int plan_walk(const Geom& g, int k_ch, int n_ch, int nb, int grid,
              int resident, DxbWalk& walk, int& smem) {
  const long long n_tiles = tiles_of(g);
  const long long n_pairs = (n_tiles + 1) / 2;
  const int n_cb = (n_ch + nb * DXB_CH - 1) / (nb * DXB_CH);
  const long long items = n_pairs * n_cb;
  walk.kc = (k_ch + DXB_CH - 1) / DXB_CH;
  // dwb_image's float estimate is exact below 2^24 virtual rows
  if (items > 0x7fffffffLL || g.V >= (1 << 24) ||
      static_cast<long long>(g.N) * g.H * g.W > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  walk.n_pairs = static_cast<int>(n_pairs);
  walk.n_items = static_cast<int>(items);
  walk.resident = resident;
  // resident: one result block of 64 channels and one halo chunk, so that
  // every item reads the same nine pieces
  if (grid <= 0 || grid > items ||
      (resident && (n_cb != 1 || walk.kc != 1 || nb != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rings = 1024 + DXB_H_STAGES * DXB_HALO;
  walk.w_stages = resident ? 9
                           : (SMEM_OPTIN - DXB_STATIC - rings) /
                                 (nb * DXB_BOX);
  if (walk.w_stages > DXB_MAX_W_STAGES) walk.w_stages = DXB_MAX_W_STAGES;
  smem = rings + walk.w_stages * nb * DXB_BOX;
  return 0;
}

// The weight pieces of a (9, k_ch, n64) bf16 matrix, n64 = n_ch rounded
// up to 64, as (n % 64, k, n / 64, tap): a box is a piece, nb blocks of 64
// k rows x 64 result channels.
int encode_pieces(CUtensorMap* map, const void* base, int k_ch, int n_ch,
                  int nb) {
  const long long n64 = (n_ch + DXB_CH - 1) / DXB_CH * DXB_CH;
  const cuuint64_t dims[4] = {DXB_CH, static_cast<cuuint64_t>(k_ch),
                              static_cast<cuuint64_t>(n64 / DXB_CH), 9};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(n64) * 2,
                                 DXB_CH * 2,
                                 static_cast<cuuint64_t>(k_ch * n64) * 2};
  const cuuint32_t box[4] = {DXB_CH, DXB_CH, static_cast<cuuint32_t>(nb),
                             1};
  return encode_tiled(map, base, 4, dims, box, strides);
}

// The bf16 d-input kernel over the items of a dx_plan: `grid` blocks, ci
// blocks of 64*nb channels, the weight pieces loaded once if `resident`.
int launch_dx_bf16(const void* dy, const void* wt, const void* x,
                   const float* s, const float* b, void* dx, float* part,
                   int N, int H, int W, int Ci, int Co, int relu, int nb,
                   int grid, int resident, void* stream) {
  // the boxes' rows and the epilogue's 16-byte accesses: channel counts a
  // multiple of 8, 16-byte aligned bases
  if (Ci % 8 != 0 || Co % 8 != 0 || (nb != 1 && nb != 2) ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g = make_geom(N, H, W, Ci, Co, relu, 0, x, dy, 8);
  DxbWalk walk;
  int smem;
  int err = plan_walk(g, Co, Ci, nb, grid, resident, walk, smem);
  if (err != 0) return err;
  auto kernel =
      nb == 1 ? conv_bwd_dx_bf16_kernel<1> : conv_bwd_dx_bf16_kernel<2>;
  err = set_smem(kernel, smem);
  if (err != 0) return err;
  CUtensorMap tmrow, tmhalo, tmw;
  err = encode_nhwc(&tmrow, dy, N, H, W, Co, DXB_HALO_W, 1);
  if (err != 0) return err;
  err = encode_nhwc(&tmhalo, dy, N, H, W, Co, DXB_HALO_W, TH + 2);
  if (err != 0) return err;
  err = encode_pieces(&tmw, wt, Co, Ci, nb);
  if (err != 0) return err;
  kernel<<<grid, DXB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tmrow, tmhalo, tmw, static_cast<const __nv_bfloat16*>(x), s, b,
      static_cast<__nv_bfloat16*>(dx), part, g, walk);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward kernel over the items of a fwd_plan: `grid` blocks, co
// blocks of 64*nb channels, the weight pieces loaded once if `resident`.
int launch_fwd_bf16(const void* x, const float* s, const float* b,
                    const void* w, void* out, int N, int H, int W, int Ci,
                    int Co, int relu, int nb, int grid, int resident,
                    void* stream) {
  // the boxes' rows: channel counts a multiple of 8, 16-byte aligned bases
  if (Ci % 8 != 0 || Co % 8 != 0 || (nb != 1 && nb != 2) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g = make_geom(N, H, W, Ci, Co, relu, 1, x, w, 8);
  DxbWalk walk;
  int smem;
  int err = plan_walk(g, Ci, Co, nb, grid, resident, walk, smem);
  if (err != 0) return err;
  auto kernel = nb == 1 ? conv_fused_fwd_bf16_kernel<1>
                        : conv_fused_fwd_bf16_kernel<2>;
  err = set_smem(kernel, smem);
  if (err != 0) return err;
  CUtensorMap tmrow, tmhalo, tmw, tmout;
  err = encode_nhwc(&tmrow, x, N, H, W, Ci, DXB_HALO_W, 1);
  if (err != 0) return err;
  err = encode_nhwc(&tmhalo, x, N, H, W, Ci, DXB_HALO_W, TH + 2);
  if (err != 0) return err;
  err = encode_pieces(&tmw, w, Ci, Co, nb);
  if (err != 0) return err;
  err = encode_nhwc(&tmout, out, N, H, W, Co, TW, 1);
  if (err != 0) return err;
  kernel<<<grid, FWB_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tmrow, tmhalo, tmw, tmout, s, b, g, walk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch. Pointers are device
// pointers to contiguous tensors; every kernel runs on `stream` and is not
// waited for. N, H, W, Ci, Co are the convolution's: x (N,H,W,Ci), s and b
// (Ci,) float32, dy and out (N,H,W,Co).

// Forward, bf16: w (9, Ci, co64), W's rows padded with zeros to a multiple
// of 64 output channels; Ci and Co multiples of 8; x, w and out 16-byte
// aligned; `grid` persistent blocks (at most one per SM) walk the
// ceil(T/2) x ceil(Co / (64*nb)) items of a fwd_plan.
int conv_fused_fwd_bf16(const void* x, const float* s, const float* b,
                        const void* w, void* out, int N, int H, int W, int Ci,
                        int Co, int relu, int nb, int grid, int resident,
                        void* stream) {
  return launch_fwd_bf16(x, s, b, w, out, N, H, W, Ci, Co, relu, nb, grid,
                         resident, stream);
}

// Forward, f32: w (9*Ci, Co) tap-major.
int conv_fused_fwd_f32(const void* x, const float* s, const float* b,
                       const void* w, void* out, int N, int H, int W, int Ci,
                       int Co, int relu, void* stream) {
  return launch_fwd_f32(x, s, b, w, out, N, H, W, Ci, Co, relu, stream);
}

// d-input: wt (9*Co, Ci) is W flipped in space and transposed; dx like x.
// bf16: Ci and Co multiples of 8, wt's rows padded with zeros to a multiple
// of 64 channels, (9*Co, ceil(Ci/64)*64); dy, wt, x and dx 16-byte aligned;
// `grid`
// persistent blocks (at most one per SM) walk the ceil(T/2) x ceil(Ci /
// (64*nb)) items of a dx_plan; part (2, 2*grid, Ci) float32.
int conv_fused_bwd_dx_bf16(const void* dy, const void* wt, const void* x,
                           const float* s, const float* b, void* dx,
                           float* part, int N, int H, int W, int Ci, int Co,
                           int relu, int nb, int grid, int resident,
                           void* stream) {
  return launch_dx_bf16(dy, wt, x, s, b, dx, part, N, H, W, Ci, Co, relu, nb,
                        grid, resident, stream);
}

// f32: part (2, T, Ci) with T = ceil((N*(H+1)-1)/16) * ceil(W/8).
int conv_fused_bwd_dx_f32(const void* dy, const void* wt, const void* x,
                          const float* s, const float* b, void* dx,
                          float* part, int N, int H, int W, int Ci, int Co,
                          int relu, void* stream) {
  return launch_dx_f32(dy, wt, x, s, b, dx, part, N, H, W, Ci, Co, relu,
                       stream);
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
