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
// from one K step to the next in VMEM scratch. Here a block loops over K
// itself with the sum in registers, and two routes serve every shape:
//
// The wgmma route (qmm_s32, qmm_scaled): shapes whose operands a TMA
// tensor map can describe -- row strides and base addresses of x and w
// 16-byte aligned, which every caller on the int8 path gives (im2col pads
// K to a multiple of 16). One persistent block per SM walks the output
// tiles of a host-side plan (kernels/quantized_matmul.py, qmm_plan): tiles
// of 128 rows x BN columns (BN 64 where N <= 64, else 128), numbered with
// N fastest so that the blocks in flight share x's rows in L2 (w, at most
// 2.4 MB at batch 32, stays in the 50 MB L2 whatever the order). Where the
// tiles are too few to fill the SMs and K is deep, the plan splits K: an
// item is (tile, range of 128-byte K blocks). The block is three
// warpgroups. In warpgroup 2, the producer, one thread issues TMA boxes of
// x (128 rows x 128 bytes of K) and w (BN rows x 128 bytes) into a
// STAGES-deep ring in the 128-byte swizzle; rows past M or N and bytes past
// K read as zeros, which add nothing to an integer sum. Warpgroups 0 and 1,
// the consumers, own rows 0-63 and 64-127 of the tile: each 128-byte stage
// is four wgmma m64nBNk32 s32.s8.s8 products, both operands K-major from
// shared memory, the sum in registers. The epilogue converts (scaled form:
// __int2float_rn then one __fmul_rn by the column's scale, loaded once per
// tile), writes the warpgroup's 64 x BN tile into its own staging buffer in
// the swizzle of the store boxes, and one thread stores it with TMA (boxes
// of 64 rows x 32 values; the tensor map clips the M and N edges). The
// store runs while the consumers take the next tile, whose operands the
// producer has already been loading. Where a row of the output is not a
// multiple of 16 bytes (N % 4 != 0), guarded stores from registers take
// over that last step. A split tile: each item writes its int32 partial
// into the workspace (fragment order, 16-byte coalesced stores) and counts
// itself in; the warpgroup that counts last adds the other partials to its
// registers and runs the epilogue on the full sum.
//
// The byte route (qmm_s32_bytes, qmm_scaled_bytes): every other shape (a
// misaligned view, K = 147 unpadded, K of 1). One block per 128 x 64 tile,
// 4 warps of mma.sync m16n8k32 (s8 x s8 -> s32), operand tiles of 64 bytes
// of K loaded byte by byte with guards (zeros past every edge) into shared
// rows padded to 80 bytes, so that ldmatrix reads eight rows without bank
// conflicts. The wrapper picks the route from the shape and alignment
// before the launch; each route has its own entry points and counters.
//
// What bounds it on an H100: at int8 ResNet-50's shapes the bytes moved
// (M*K + K*N read, 4*M*N written) take longer at 3.35 TB/s than the
// operations at 1979 TOPS, and the int32 or f32 output is most of the
// bytes. The wgmma route writes each output once, in full 128-byte lines
// by TMA, with one 64-row store per consumer in flight behind its products.
// At large M (25088 and up: the most bytes) nothing but the stream of
// output and x bounds it. At M = 1568 and 6272 the tiles are few and K deep
// (up to 4608): there the operand reads from L2 and the tensor work of each
// tile bound it, and split K spreads them over more SMs.
//
// Numerics: the int32 sum is exact, and integer addition is associative,
// so neither the order of the k steps nor the split changes a bit: the
// partials stay int32 and are converted only after the full sum. Integer
// products without .satfinite wrap on overflow as XLA's int32 dot does; at
// ResNet-50 K <= 4608, so |acc| <= 4608 * 128^2 ~ 7.5e7, far from 2^31. The
// scaled epilogue converts with round-to-nearest (__int2float_rn: |acc| can
// exceed 2^24) and multiplies once (__fmul_rn), as the plain version's
// acc.to(float32) * scales does, so both outputs equal the plain version
// bit for bit. The bias is not fused: the callers add it after the
// product, as the JAX package does, and a fused add could be contracted
// into one FMA.

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// The wgmma route
// ---------------------------------------------------------------------------

constexpr int QT = 384;            // threads: consumers 0-255, producer 256-
constexpr int QBM = 128;           // output rows per tile
constexpr int QBK = 128;           // bytes of K per stage (one swizzle row)
constexpr int QSTAGES = 4;
constexpr int QA_BYTES = QBM * QBK;
constexpr int QBOX_COLS = 32;      // output values per store box (128 bytes)
constexpr int QBOX_BYTES = 64 * QBOX_COLS * 4;

template <int BN>
struct QCfg {
  static constexpr int STAGE = QA_BYTES + BN * QBK;
  // per consumer warpgroup: its 64 x BN output tile as BN/32 store boxes
  static constexpr int STAGING = BN / QBOX_COLS * QBOX_BYTES;
  // the ring and both staging buffers, plus slack for 1024-byte alignment
  static constexpr int SMEM = QSTAGES * STAGE + 2 * STAGING + 1024;
};

// d (+)= A (64 x 32 bytes, shared memory, K-major) * B (32 bytes x 64 or
// 128, shared memory, K-major), s8 x s8 -> s32; `accumulate` 0 ignores d's
// old value (the first k-step of an item).
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

struct QArgs {
  const float* scales;       // scaled form only
  void* out;                 // [M, N] contiguous: int32 or f32
  int* ws;                   // split K: int32 partials, 64 x BN per item
  int* cnt;                  // split K: 2 counters per tile, zero between
  int M, N, K;
  int tiles_n, tiles;        // tiles = tiles_m * tiles_n
  int kb;                    // 128-byte K blocks
  int kps, nsplit, items;    // K blocks per split; items = tiles * nsplit
};

// Item i of the plan: split i / tiles of tile i % tiles, whose columns are
// tile % tiles_n (N fastest) and rows tile / tiles_n; K blocks [kb0, kb1).
// Block b takes items b, b + gridDim.x, ...
struct QItem {
  int split, tile, m0, n0, kb0, kb1;
};

template <int BN>
__device__ __forceinline__ QItem q_item(const QArgs& a, int i) {
  QItem it;
  it.split = i / a.tiles;
  it.tile = i - it.split * a.tiles;
  const int tm = it.tile / a.tiles_n;
  it.m0 = tm * QBM;
  it.n0 = (it.tile - tm * a.tiles_n) * BN;
  it.kb0 = it.split * a.kps;
  it.kb1 = min(a.kb, it.kb0 + a.kps);
  return it;
}

__device__ __forceinline__ void q_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int BN, bool SCALED, bool TMA_OUT>
__global__ void __launch_bounds__(QT, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmw,
                 const __grid_constant__ CUtensorMap tmo, const QArgs a) {
  using C = QCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[QSTAGES], empty[QSTAGES];
  __shared__ int last[2];
  // the swizzle works on shared-memory address bits: align the ring there
  unsigned char* ring = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) &
                                    1023u);

  if (threadIdx.x == 0) {
    for (int i = 0; i < QSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x != 256) return;
    int n = 0;
    for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
      const QItem it = q_item<BN>(a, i);
      for (int kb = it.kb0; kb < it.kb1; ++kb, ++n) {
        const int s = n % QSTAGES;
        mbar_wait(&empty[s], ((n / QSTAGES) & 1) ^ 1);
        unsigned char* st = ring + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load4(st, &tmx, kb * QBK, it.m0, 0, 0, &full[s]);
        tma_load4(st + QA_BYTES, &tmw, kb * QBK, it.n0, 0, 0, &full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows wg*64 .. wg*64+63 of each tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned char* staging = ring + QSTAGES * C::STAGE + wg * C::STAGING;
  uint32_t acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0u;

  int n = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x) {
    const QItem it = q_item<BN>(a, i);
    int prev = -1;
    for (int kb = it.kb0; kb < it.kb1; ++kb, ++n) {
      const int s = n % QSTAGES;
      mbar_wait(&full[s], (n / QSTAGES) & 1);
      const unsigned char* st = ring + s * C::STAGE;
      reg_fence_all(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < QBK / 32; ++k)
        wgmma_s8(acc, sw128_desc_at(st + wg * 64 * QBK + k * 32, 16, 1024),
                 sw128_desc_at(st + QA_BYTES + k * 32, 16, 1024),
                 kb != it.kb0 || k != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (prev >= 0) {
        // the previous stage's products are done: hand it back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence_all(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    if (a.nsplit > 1) {
      // this split's partial, in fragment order: 16-byte vector j of thread
      // tid at (j * 128 + tid)
      int4* part = reinterpret_cast<int4*>(a.ws) +
                   (static_cast<long long>(i) * 2 + wg) * (BN / 8) * 128;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        part[j * 128 + tid] =
            make_int4(static_cast<int>(acc[j][0]), static_cast<int>(acc[j][1]),
                      static_cast<int>(acc[j][2]), static_cast<int>(acc[j][3]));
      __threadfence();
      q_bar(wg);
      if (tid == 0) {
        int* c = a.cnt + it.tile * 2 + wg;
        const bool is_last = atomicAdd(c, 1) == a.nsplit - 1;
        if (is_last) *c = 0;       // zero again for the next launch
        last[wg] = is_last;
      }
      q_bar(wg);
      if (!last[wg]) continue;
      __threadfence();
      for (int sp = 0; sp < a.nsplit; ++sp) {
        if (sp == it.split) continue;
        const int4* q = reinterpret_cast<const int4*>(a.ws) +
                        ((static_cast<long long>(sp) * a.tiles + it.tile) * 2 +
                         wg) * (BN / 8) * 128;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int4 v = __ldcg(q + j * 128 + tid);
          acc[j][0] += static_cast<uint32_t>(v.x);
          acc[j][1] += static_cast<uint32_t>(v.y);
          acc[j][2] += static_cast<uint32_t>(v.z);
          acc[j][3] += static_cast<uint32_t>(v.w);
        }
      }
    }

    // ---- epilogue: accumulator [j][e] is row wg*64 + warp*16 + g (+8 for
    // e >= 2), column 8j + 2t (+1 for odd e) of the tile
    const int row0 = it.m0 + wg * 64;
    uint32_t v[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (SCALED) {
        const int c = it.n0 + 8 * j + 2 * t;
        const float s0 = c < a.N ? __ldg(a.scales + c) : 0.f;
        const float s1 = c + 1 < a.N ? __ldg(a.scales + c + 1) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[j][e] = __float_as_uint(__fmul_rn(
              __int2float_rn(static_cast<int>(acc[j][e])), e & 1 ? s1 : s0));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][e] = acc[j][e];
      }
    }
    if (TMA_OUT) {
      // the warpgroup's previous store has read its staging buffer
      if (tid == 0) tma_store_wait_read();
      q_bar(wg);
      // box b = columns 32b .. 32b+31: row r at r * 128 bytes, 16-byte
      // chunk c of it at chunk c ^ (r % 8)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        unsigned char* box = staging + (j / 4) * QBOX_BYTES;
        const int chunk = (j % 4) * 2 + (t >> 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + h * 8;
          *reinterpret_cast<uint2*>(box + r * 128 + ((chunk ^ (r & 7)) << 4) +
                                    (t & 1) * 8) =
              make_uint2(v[j][2 * h], v[j][2 * h + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      q_bar(wg);
      if (tid == 0) {
        if (row0 < a.M) {
#pragma unroll
          for (int b = 0; b < BN / QBOX_COLS; ++b)
            if (it.n0 + b * QBOX_COLS < a.N)
              tma_store4(&tmo, staging + b * QBOX_BYTES,
                         it.n0 + b * QBOX_COLS, row0, 0, 0);
        }
        tma_store_commit();            // one group per tile, maybe empty
      }
    } else {
      uint32_t* out = static_cast<uint32_t*>(a.out);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + warp * 16 + g + h * 8;
        if (m >= a.M) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = it.n0 + 8 * j + 2 * t + e;
            if (c < a.N)
              out[static_cast<long long>(m) * a.N + c] = v[j][2 * h + e];
          }
      }
    }
  }
  if (TMA_OUT && tid == 0) tma_store_wait_read();
}

// The map of a row-major matrix of `rows` rows of `cols` elements, rows
// `ld_bytes` apart, as (column, row, 1, 1) in boxes of box_cols x box_rows.
int encode_matrix(CUtensorMap* map, const void* base, long long rows,
                  long long cols, long long ld_bytes, int box_cols,
                  int box_rows, CUtensorMapDataType dtype) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows), 1, 1};
  const cuuint64_t packed = static_cast<cuuint64_t>(ld_bytes * rows);
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ld_bytes), packed,
                                 packed};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  return encode_tiled(map, base, 4, dims, box, strides, dtype);
}

template <typename K>
int q_set_smem(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// Sets the kernel's shared memory, encodes the maps and launches. The
// runtime call comes before the first encode: the driver's encoder fails
// with no current context, as in a thread that has made no CUDA call yet.
template <int BN, bool SCALED, bool TMA_OUT>
int launch_wgmma(const int8_t* x, const int8_t* w, void* out,
                 long long lda, long long ldb, const QArgs& a, int grid,
                 cudaStream_t s) {
  auto kernel = qmm_wgmma_kernel<BN, SCALED, TMA_OUT>;
  int err = q_set_smem(kernel, QCfg<BN>::SMEM);
  if (err != 0) return err;
  CUtensorMap tmx, tmw, tmo;
  err = encode_matrix(&tmx, x, a.M, a.K, lda, QBK, QBM,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0)
    err = encode_matrix(&tmw, w, a.N, a.K, ldb, QBK, BN,
                        CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0 && TMA_OUT)
    err = encode_matrix(&tmo, out, a.M, a.N, 4LL * a.N, QBOX_COLS, 64,
                        SCALED ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_INT32);
  if (err != 0) return err;
  if (!TMA_OUT) tmo = tmx;             // not read
  kernel<<<grid, QT, QCfg<BN>::SMEM, s>>>(tmx, tmw, tmo, a);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma route: checks the plan (bn, nsplit, kps, grid from qmm_plan)
// against the shape and the operands against TMA's rules, and launches.
template <bool SCALED>
int run_wgmma(const int8_t* x, const int8_t* w, const float* scales,
              void* out, int* ws, int* cnt, int M, int N, int K,
              long long lda, long long ldb, int bn, int nsplit, int kps,
              int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || lda <= 0 || ldb <= 0 || lda % 16 != 0 ||
      ldb % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_n = (N + bn - 1) / bn;
  const long long tiles = (M + QBM - 1) / QBM * tiles_n;
  const int kb = (K + QBK - 1) / QBK;
  // every split non-empty, together exactly the K blocks
  if (nsplit < 1 || kps < 1 || static_cast<long long>(nsplit) * kps < kb ||
      static_cast<long long>(nsplit - 1) * kps >= kb ||
      (nsplit > 1 && (ws == nullptr || cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = tiles * nsplit;
  if (items > 0x7fffffffLL || grid < 1 || grid > items)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  QArgs a;
  a.scales = scales;
  a.out = out;
  a.ws = ws;
  a.cnt = cnt;
  a.M = M;
  a.N = N;
  a.K = K;
  a.tiles_n = static_cast<int>(tiles_n);
  a.tiles = static_cast<int>(tiles);
  a.kb = kb;
  a.kps = kps;
  a.nsplit = nsplit;
  a.items = static_cast<int>(items);
  const bool tma_out = N % 4 == 0;     // output rows a multiple of 16 bytes
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return tma_out
               ? launch_wgmma<64, SCALED, true>(x, w, out, lda, ldb, a, grid, s)
               : launch_wgmma<64, SCALED, false>(x, w, out, lda, ldb, a, grid,
                                                 s);
  return tma_out
             ? launch_wgmma<128, SCALED, true>(x, w, out, lda, ldb, a, grid, s)
             : launch_wgmma<128, SCALED, false>(x, w, out, lda, ldb, a, grid,
                                                s);
}

// ---------------------------------------------------------------------------
// The byte route
// ---------------------------------------------------------------------------

namespace bytes_route {

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

// One (rows x BK) tile of a K-contiguous operand into shared memory, byte
// by byte: row r of the tile is operand row row0 + r (x's m, or w's n),
// bytes k0 .. k0 + BK of it, zeros past every edge.
template <int ROWS>
__device__ __forceinline__ void load_tile(int8_t (*tile)[PITCH],
                                          const int8_t* base, long long ld,
                                          int row0, int nrows, int k0, int K) {
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

template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
qmm_bytes_kernel(const Params p) {
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

  load_tile<BM>(As[0], p.x, p.lda, m0, p.M, 0, p.K);
  load_tile<BN>(Bs[0], p.w, p.ldb, n0, p.N, 0, p.K);

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile<BM>(As[s ^ 1], p.x, p.lda, m0, p.M, (kt + 1) * BK, p.K);
      load_tile<BN>(Bs[s ^ 1], p.w, p.ldb, n0, p.N, (kt + 1) * BK, p.K);
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
int run_bytes(const int8_t* x, const int8_t* w, const float* scales,
              void* out, int M, int N, int K, long long lda, long long ldb,
              void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
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
  qmm_bytes_kernel<SCALED>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bytes_route

}  // namespace

extern "C" {

// Each returns 0 or the cudaError_t of the launch, runs on `stream` and is
// not waited for. x[m, k] is at x[m * lda + k], w[k, n] at w[k + n * ldb];
// out is a contiguous [M, N] int32 (s32) or f32 (scaled) tensor; scales
// holds N f32 values.
//
// The wgmma route: bn, nsplit, kps and grid are qmm_plan's; with nsplit >
// 1, ws holds nsplit * tiles * 128 * bn int32 (any contents) and cnt 2 *
// tiles int32 counters that are zero (and are zero again after the
// kernel). lda, ldb, x, w and out must be 16-byte aligned.

int qmm_s32(const int8_t* x, const int8_t* w, int* out, int M, int N, int K,
            long long lda, long long ldb, int* ws, int* cnt, int bn,
            int nsplit, int kps, int grid, void* stream) {
  return run_wgmma<false>(x, w, nullptr, out, ws, cnt, M, N, K, lda, ldb, bn,
                          nsplit, kps, grid, stream);
}

int qmm_scaled(const int8_t* x, const int8_t* w, const float* scales,
               float* out, int M, int N, int K, long long lda, long long ldb,
               int* ws, int* cnt, int bn, int nsplit, int kps, int grid,
               void* stream) {
  return run_wgmma<true>(x, w, scales, out, ws, cnt, M, N, K, lda, ldb, bn,
                         nsplit, kps, grid, stream);
}

// The byte route: any shape and strides.

int qmm_s32_bytes(const int8_t* x, const int8_t* w, int* out, int M, int N,
                  int K, long long lda, long long ldb, void* stream) {
  return bytes_route::run_bytes<false>(x, w, nullptr, out, M, N, K, lda, ldb,
                                       stream);
}

int qmm_scaled_bytes(const int8_t* x, const int8_t* w, const float* scales,
                     float* out, int M, int N, int K, long long lda,
                     long long ldb, void* stream) {
  return bytes_route::run_bytes<true>(x, w, scales, out, M, N, K, lda, ldb,
                                      stream);
}

}  // extern "C"
