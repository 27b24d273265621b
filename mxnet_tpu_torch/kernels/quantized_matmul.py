"""int8 x int8 -> int32 matrix product with an optional per-output-channel
f32 dequantize: the Hopper kernel and its plain PyTorch version
(counterpart of mxnet_tpu/pallas_kernels/quantized_matmul.py).

    quantized_matmul(x, w)          -> x @ w, exact int32        (M, N)
    quantized_matmul(x, w, scales)  -> float32(x @ w) * scales   (M, N) f32

x is (M, K) int8, w (K, N) int8, scales (N,) float32. Both outputs come from
one CUDA source (``csrc/quantized_matmul.cu``): ``qmm_s32`` replaces the TPU
kernel ``_mm_kernel`` and ``qmm_scaled`` replaces ``_mm_scaled_kernel``; each
has its own launch counter (``LAUNCHES_MM``, ``LAUNCHES_MM_SCALED``). The
kernel's design note is in its source.

A CPU tensor runs ``quantized_matmul_reference``. A CUDA tensor launches
the kernel or raises: a dtype other than int8 operands and float32 scales,
operands on two devices, an x whose K axis is not contiguous, or a failed
launch. There is no fits-guard: the JAX module's K % 128 and N % 128 tiling
rules belong to the TPU, and the kernel takes every shape. Nor is there a
``MXTPU_QUANT_MATMUL`` switch: its "0" and "interpret" values chose XLA's
dot or the Pallas interpreter, and the port has neither.

Layouts: the kernel reads both operands K-contiguous. x may have any row
stride (a row-sliced view goes in without a copy) but its K axis must be
contiguous. A w with ``stride(0) == 1`` (``weight.T`` of an (N, K) weight,
as every caller on the int8 path holds it) is read in place; any other w,
for example a contiguous (K, N) tensor, is copied once into that layout
first. That copy is a layout step, counted in ``COPIES``, not a fallback:
the product still runs on the kernel.

Bitwise contract: integer sums are exact, so the int32 output equals the
plain version bit for bit; the scaled output converts the sum to f32 with
round-to-nearest and multiplies once, as the plain version does, so it is
equal bit for bit too.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError

__all__ = ["quantized_matmul", "quantized_matmul_reference", "engaged",
           "LAUNCHES_MM", "LAUNCHES_MM_SCALED", "COPIES"]

# Kernel launches in this process: LAUNCHES_MM counts int32 products (the
# TPU's _mm_kernel), LAUNCHES_MM_SCALED the dequantized ones
# (_mm_scaled_kernel). COPIES counts w operands copied into the kernel's
# K-contiguous layout first.
LAUNCHES_MM = 0
LAUNCHES_MM_SCALED = 0
COPIES = 0


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
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w, scales)
    if x.device.type != "cuda":
        raise MXNetError("quantized_matmul: no kernel for device %s"
                         % x.device)
    return _launch(x, w, scales)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGS = {"qmm_s32": [_P, _P, _P, _I, _I, _I, _L, _L, _P],
         "qmm_scaled": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _P]}


def _fn(name):
    from . import _build
    fn = getattr(_build.load("quantized_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = _I
    return fn


def _launch(x, w, scales):
    global LAUNCHES_MM, LAUNCHES_MM_SCALED, COPIES
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
    out = torch.empty((M, N), dtype=torch.int32 if scales is None
                      else torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if scales is None:
            err = _fn("qmm_s32")(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 M, N, K, lda, ldb, stream)
        else:
            s = scales.contiguous()
            err = _fn("qmm_scaled")(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), M, N, K, lda, ldb, stream)
    if err != 0:
        raise MXNetError("quantized_matmul launch failed: cudaError %d "
                         "(M, K, N = %d, %d, %d)" % (err, M, K, N))
    if scales is None:
        LAUNCHES_MM += 1
    else:
        LAUNCHES_MM_SCALED += 1
    return out
