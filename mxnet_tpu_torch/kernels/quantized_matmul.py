"""int8 x int8 -> int32 matrix product with an optional per-output-channel
f32 dequantize: the Hopper kernels and their plain PyTorch version
(counterpart of mxnet_tpu/pallas_kernels/quantized_matmul.py).

    quantized_matmul(x, w)          -> x @ w, exact int32        (M, N)
    quantized_matmul(x, w, scales)  -> float32(x @ w) * scales   (M, N) f32

x is (M, K) int8, w (K, N) int8, scales (N,) float32. Both outputs come from
one CUDA source (``csrc/quantized_matmul.cu``): the int32 form replaces the
TPU kernel ``_mm_kernel`` and the scaled form ``_mm_scaled_kernel``. The
kernels' design note is in their source.

Two hand-written routes serve every shape, and ``route`` picks one from the
shape and alignment before the launch. The wgmma route (TMA, wgmma,
persistent blocks over ``qmm_plan``'s items, split K where tiles are few)
takes every operand pair that a TMA tensor map can describe: 16-byte
aligned row strides and base addresses, which every product of the int8
path has (im2col pads K to a multiple of 16). The byte route (mma.sync,
guarded byte loads) takes the rest, such as K = 147 unpadded or a
misaligned view. Each route and form has its own launch counter:
``LAUNCHES_MM`` and ``LAUNCHES_MM_SCALED`` (wgmma), ``LAUNCHES_MM_BYTES``
and ``LAUNCHES_MM_SCALED_BYTES`` (bytes).

A CPU tensor runs ``quantized_matmul_reference``. A CUDA tensor launches
a kernel or raises: a dtype other than int8 operands and float32 scales,
operands on two devices, an x whose K axis is not contiguous, or a failed
launch. There is no fits-guard: the JAX module's K % 128 and N % 128 tiling
rules belong to the TPU, and the kernels take every shape. Nor is there a
``MXTPU_QUANT_MATMUL`` switch: its "0" and "interpret" values chose XLA's
dot or the Pallas interpreter, and the port has neither.

Layouts: the kernels read both operands K-contiguous. x may have any row
stride (a row-sliced view goes in without a copy) but its K axis must be
contiguous. A w with ``stride(0) == 1`` (``weight.T`` of an (N, K) weight,
as every caller on the int8 path holds it) is read in place; any other w,
for example a contiguous (K, N) tensor, is copied once into that layout
first. That copy is a layout step, counted in ``COPIES``, not a fallback:
the product still runs on a kernel.

Bitwise contract: integer sums are exact and integer addition associative,
so the int32 output equals the plain version bit for bit whatever the
order of the k steps or the split; the scaled output converts the full sum
to f32 with round-to-nearest and multiplies once, as the plain version
does, so it is equal bit for bit too.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..base import MXNetError
from . import _cost

__all__ = ["cost", "quantized_matmul", "quantized_matmul_reference", "engaged",
           "route", "qmm_plan", "qmm_blocks", "QmmPlan", "LAUNCHES_MM",
           "LAUNCHES_MM_SCALED", "LAUNCHES_MM_BYTES",
           "LAUNCHES_MM_SCALED_BYTES", "COPIES"]

# Kernel launches in this process, by route and form: LAUNCHES_MM counts
# int32 products (the TPU's _mm_kernel) and LAUNCHES_MM_SCALED dequantized
# ones (_mm_scaled_kernel) on the wgmma route; LAUNCHES_MM_BYTES and
# LAUNCHES_MM_SCALED_BYTES the same on the byte route. COPIES counts w
# operands copied into the kernels' K-contiguous layout first.
LAUNCHES_MM = 0
LAUNCHES_MM_SCALED = 0
LAUNCHES_MM_BYTES = 0
LAUNCHES_MM_SCALED_BYTES = 0
COPIES = 0

# The wgmma route's tiles (csrc/quantized_matmul.cu): 128 output rows, 64 or
# 128 columns, K in blocks of 128 bytes.
_BM = 128
_BK = 128
_MAX_SPLIT = 16
# The planner's cost model, estimates that only weigh one choice against
# another: device us for one 128-byte K block of a 128 x 128 tile (operand
# reads from L2 and the tensor work), for a tile's epilogue, and for each
# split of a split tile (its int32 partial written, read back and added).
# Fitted to the M = 1568 and fc products on an H100 SXM, split and not
# (chip_qmm_probe.py, plans no_split and split_more): 0.35 us a K block
# and 4.5 us more for a launch that splits in two.
_KB_US = 0.35
_TILE_US = 1.0
_PART_US = 2.25

QmmPlan = collections.namedtuple(
    "QmmPlan", "M K N bn tiles_m tiles_n kb nsplit kps items grid")


def quantized_matmul_reference(x, w, scales=None):
    """Plain PyTorch semantics of the kernel: x (M, K) int8 @ w (K, N) int8
    -> the (M, N) int32 sum, or float32 ``acc * scales`` with (N,) f32
    scales. PyTorch has no integer matrix product on CUDA, so the sum is
    taken in float64 and cast: every product and partial sum is an integer
    below K * 128^2 < 2^53, so it is exact (and within int32 for K below
    2^17)."""
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64)) \
        .to(torch.int32)
    if scales is None:
        return acc
    return acc.to(torch.float32) * scales


def engaged(x, w):
    """Whether ``ops/quantized.py`` routes this product through
    ``quantized_matmul``: 2-D int8 operands of matching K. (Kept for API
    parity with the JAX module, whose answer also depended on the device
    and on the TPU tiling.)"""
    return (x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0]
            and x.dtype == torch.int8 and w.dtype == torch.int8)


def _check(x, w, scales):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("quantized_matmul: need (M, K) x and (K, N) w, "
                         "got %s / %s" % (tuple(x.shape), tuple(w.shape)))
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("quantized_matmul: int8 operands required, got %s / "
                        "%s" % (x.dtype, w.dtype))
    if w.device != x.device:
        raise ValueError("quantized_matmul: operands on %s and %s"
                         % (x.device, w.device))
    if scales is not None:
        if scales.dtype != torch.float32:
            raise TypeError("quantized_matmul: float32 scales required, got "
                            "%s" % scales.dtype)
        if tuple(scales.shape) != (w.shape[1],):
            raise ValueError("quantized_matmul: scales must be (%d,), got %s"
                             % (w.shape[1], tuple(scales.shape)))
        if scales.device != x.device:
            raise ValueError("quantized_matmul: scales on %s, operands on %s"
                             % (scales.device, x.device))


def quantized_matmul(x, w, scales=None):
    """x (M, K) int8 @ w (K, N) int8 with an exact int32 sum. Returns the
    (M, N) int32 sum, or with (N,) float32 ``scales`` the dequantized
    float32 product ``acc * scales`` from the kernel's epilogue.

    A CPU tensor runs ``quantized_matmul_reference``; a CUDA tensor
    launches the kernel on the current stream or raises (see the module
    docstring for what it takes)."""
    _check(x, w, scales)
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError("quantized_matmul: no kernel for device %s"
                         % x.device)
    with _cost.launch("quantized_matmul", cost, x.shape[0], x.shape[1],
                      w.shape[1], scales is not None):
        if x.device.type == "cpu":
            return quantized_matmul_reference(x, w, scales)
        return _launch(x, w, scales)


def cost(M, K, N, scaled):
    """``(int8 operations, bytes)`` of one product: 2*M*N*K; x (M*K) and w
    (K*N) int8 read once and the (M, N) int32 or f32 output written once,
    the (N,) f32 scales read too."""
    return (2.0 * M * N * K,
            M * K + K * N + 4.0 * M * N + (4.0 * N if scaled else 0.0))


def route(M, K, N, lda, ldb, x_ptr, w_ptr):
    """Which hand-written route takes an (M, K) x (K, N) product whose
    operands start at byte addresses ``x_ptr`` and ``w_ptr`` with rows
    ``lda`` and ``ldb`` bytes apart (the K-contiguous layout): "wgmma"
    where a TMA tensor map can describe both (non-empty, row strides and
    base addresses multiples of 16 bytes), else "bytes"."""
    if M < 1 or N < 1 or K < 1 or lda < 1 or ldb < 1:
        return "bytes"
    if lda % 16 or ldb % 16 or x_ptr % 16 or w_ptr % 16:
        return "bytes"
    return "wgmma"


@functools.lru_cache(maxsize=512)
def qmm_plan(M, K, N, n_sm):
    """The wgmma route's work partition of an (M, K) x (K, N) product on a
    card of ``n_sm`` SMs: a ``QmmPlan``.

    Output tiles are 128 rows x ``bn`` columns (64 where N <= 64, else
    128), ``tiles_m * tiles_n`` of them, numbered with N fastest (tile t
    holds row tile t // tiles_n and column tile t % tiles_n), so that the
    blocks in flight read the same rows of x. K is read in ``kb`` blocks
    of 128 bytes and cut into ``nsplit`` splits of ``kps`` blocks (every
    split non-empty; the last may be shorter). An item is
    (split, tile), numbered ``split * tiles + tile``; ``grid`` persistent
    blocks, at most one per SM, take items ``b, b + grid, ...``
    (``qmm_blocks``). ``nsplit`` minimises the cost model's time: the
    rounds of items a block walks, each its K blocks and an epilogue, plus
    the partials of a split tile written and read back by the last split."""
    bn = 64 if N <= 64 else 128
    tiles_m, tiles_n = -(-M // _BM), -(-N // bn)
    tiles = tiles_m * tiles_n
    kb = -(-K // _BK)
    work = bn / 128.0
    best = None
    for ns in range(1, min(kb, _MAX_SPLIT) + 1):
        kps = -(-kb // ns)
        nsplit = -(-kb // kps)
        items = tiles * nsplit
        grid = min(items, n_sm)
        rounds = -(-items // grid)
        cost = rounds * (kps * _KB_US * work + _TILE_US) \
            + (nsplit > 1) * nsplit * _PART_US * work
        if best is None or cost < best[0]:
            best = (cost, QmmPlan(M, K, N, bn, tiles_m, tiles_n, kb, nsplit,
                                  kps, items, grid))
    return best[1]


def qmm_blocks(plan):
    """Each block's items of ``plan`` in the order the kernel walks them:
    a list (one per block) of ``(m0, m1, n0, n1, k0, k1)``, the output
    rows, columns and K bytes of the item, clipped to the matrix."""
    tiles = plan.tiles_m * plan.tiles_n
    blocks = []
    for b in range(plan.grid):
        items = []
        for i in range(b, plan.items, plan.grid):
            split, tile = divmod(i, tiles)
            tm, tn = divmod(tile, plan.tiles_n)
            kb0 = split * plan.kps
            kb1 = min(plan.kb, kb0 + plan.kps)
            items.append((tm * _BM, min(plan.M, (tm + 1) * _BM),
                          tn * plan.bn, min(plan.N, (tn + 1) * plan.bn),
                          kb0 * _BK, min(plan.K, kb1 * _BK)))
        blocks.append(items)
    return blocks


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGS = {"qmm_s32": [_P, _P, _P, _I, _I, _I, _L, _L, _P, _P, _I, _I, _I, _I,
                     _P],
         "qmm_scaled": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _P, _P, _I, _I,
                        _I, _I, _P],
         "qmm_s32_bytes": [_P, _P, _P, _I, _I, _I, _L, _L, _P],
         "qmm_scaled_bytes": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _P]}


def _fn(name):
    from . import _build
    fn = getattr(_build.load("quantized_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = _I
    return fn


@functools.lru_cache(maxsize=16)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


# Split-K tile counters, by (device, stream): zeros that the kernel leaves
# zero after each launch, so that launches on one stream share them.
_COUNTERS = {}


def _counters(dev, stream, n):
    buf = _COUNTERS.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[(dev, stream)] = buf
    return buf


def _launch(x, w, scales):
    global LAUNCHES_MM, LAUNCHES_MM_SCALED, COPIES
    global LAUNCHES_MM_BYTES, LAUNCHES_MM_SCALED_BYTES
    M, K = x.shape
    N = w.shape[1]
    if K > 1 and M > 0 and x.stride(1) != 1:
        raise ValueError("quantized_matmul: x must have a contiguous K axis "
                         "(stride(1) == 1), got strides %s; pass "
                         "x.contiguous()" % (tuple(x.stride()),))
    if K > 1 and N > 0 and w.stride(0) != 1:
        w = w.t().contiguous().t()
        COPIES += 1
    lda = x.stride(0) if M > 1 else K
    ldb = w.stride(1) if N > 1 else K
    dev = x.device
    out = torch.empty((M, N), dtype=torch.int32 if scales is None
                      else torch.float32, device=dev)
    if out.numel() == 0:
        return out
    which = route(M, K, N, lda, ldb, x.data_ptr(), w.data_ptr())
    s = None if scales is None else scales.contiguous()
    ptrs = [x.data_ptr(), w.data_ptr()] \
        + ([] if s is None else [s.data_ptr()]) + [out.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == "wgmma":
            plan = qmm_plan(M, K, N, _sm_count(dev))
            ws = cnt = None
            if plan.nsplit > 1:
                ws = torch.empty(plan.items * _BM * plan.bn,
                                 dtype=torch.int32, device=dev)
                cnt = _counters(dev, stream, 2 * plan.tiles_m * plan.tiles_n)
            err = _fn("qmm_s32" if s is None else "qmm_scaled")(
                *ptrs, M, N, K, lda, ldb, 0 if ws is None else ws.data_ptr(),
                0 if cnt is None else cnt.data_ptr(), plan.bn, plan.nsplit,
                plan.kps, plan.grid, stream)
        else:
            err = _fn("qmm_s32_bytes" if s is None else "qmm_scaled_bytes")(
                *ptrs, M, N, K, lda, ldb, stream)
    if err != 0:
        raise MXNetError("quantized_matmul launch failed: cudaError %d "
                         "(M, K, N = %d, %d, %d; %s route)"
                         % (err, M, K, N, which))
    if which == "wgmma":
        if s is None:
            LAUNCHES_MM += 1
        else:
            LAUNCHES_MM_SCALED += 1
    elif s is None:
        LAUNCHES_MM_BYTES += 1
    else:
        LAUNCHES_MM_SCALED_BYTES += 1
    return out
