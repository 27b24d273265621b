"""2-bit gradient compression with error feedback: the Hopper kernels and
their plain PyTorch versions (counterpart of
mxnet_tpu/pallas_kernels/compression.py; ref:
src/kvstore/gradient_compression-inl.h quantize_2bit).

    words, new_residual = quantize_2bit(grad, residual, threshold)
    values = dequantize_2bit(words, n, threshold)

Each value of ``r = residual + grad`` becomes 2 bits: ``11`` where ``r >=
threshold`` (decodes to +threshold), ``10`` where ``r <= -threshold``
(decodes to -threshold), else ``00`` (decodes to 0); the new residual
keeps what the code did not carry. 16 values pack into one int32 word,
value ``i`` of a group at bit-pair ``15 - i``, so a word whose value 0
fires +threshold is negative; there are ``ceil(n / 16)`` words and the
tail pads with zero codes. This is the JAX package's wire format, so words
made by either package decode in the other.

Types follow ``quantize_2bit_jnp``: ``r`` and the new residual are in the
gradient's dtype (bf16 or float32), the threshold a weak scalar rounded to
it (``base.weak_scalar``), and the new residual is ``(r - pos * thr) + neg
* thr`` op by op, zero terms included (for code 0 and ``r = -0.0`` that is
+0.0). The JAX package's Pallas form declares a float32 residual and
rejects a bf16 gradient; its jnp form, which runs off the TPU, takes bf16
and is what the port follows. ``dequantize_2bit`` returns float32, as both
JAX forms do; the caller casts.

One CUDA source (``csrc/compression.cu``) holds both kernels:
``quantize_2bit_{bf16,f32}`` replaces the TPU kernel ``_quant_kernel`` and
``dequantize_2bit_f32`` replaces ``_dequant_kernel``; each has its own
launch counter (``LAUNCHES_QUANTIZE``, ``LAUNCHES_DEQUANTIZE``). A CPU
tensor runs the plain version; a CUDA tensor launches the kernel or raises
(a dtype other than bf16/f32 gradients and int32 words, operands on two
devices, a non-contiguous or non-1-D operand, a failed launch). The
kernels' design note is in the source.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, weak_scalar

__all__ = ["quantize_2bit", "dequantize_2bit", "quantize_2bit_reference",
           "dequantize_2bit_reference", "num_words", "LAUNCHES_QUANTIZE",
           "LAUNCHES_DEQUANTIZE"]

# Kernel launches in this process: one per quantize_2bit / dequantize_2bit
# call on a CUDA tensor.
LAUNCHES_QUANTIZE = 0
LAUNCHES_DEQUANTIZE = 0

_GROUP = 16   # values per 32-bit word


def num_words(n):
    """Words that carry ``n`` values: ``ceil(n / 16)``."""
    return -(-int(n) // _GROUP)


def _shifts(device):
    return 2 * (15 - torch.arange(_GROUP, dtype=torch.int64, device=device))


def quantize_2bit_reference(grad, residual, threshold=0.5):
    """Plain PyTorch ``quantize_2bit_jnp``: ``(words, new_residual)``, int32
    ``[ceil(n/16)]`` and ``[n]`` in the gradient's dtype. The packing shifts
    and sums in int64 and wraps to int32 (the JAX form sums int32 with
    wraparound; the bit-pairs are disjoint, so the sum is their or)."""
    n = grad.shape[0]
    r = residual + grad
    thr = weak_scalar(float(threshold), r.dtype)
    pos = r >= thr
    neg = r <= -thr
    codes = torch.where(pos, 3, torch.where(neg, 2, 0)).to(torch.int64)
    new_residual = r - pos.to(r.dtype) * thr + neg.to(r.dtype) * thr
    pad = num_words(n) * _GROUP - n
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    words = (codes.reshape(-1, _GROUP) << _shifts(r.device)).sum(dim=1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), new_residual


def dequantize_2bit_reference(words, n, threshold=0.5):
    """Plain PyTorch ``dequantize_2bit_jnp``: int32 words -> float32
    ``[n]``."""
    codes = (words.to(torch.int64)[:, None] >> _shifts(words.device)) & 3
    thr = torch.tensor(float(threshold), dtype=torch.float32,
                       device=words.device)
    zero = torch.zeros((), dtype=torch.float32, device=words.device)
    vals = torch.where(codes == 3, thr, torch.where(codes == 2, -thr, zero))
    return vals.reshape(-1)[:n]


def _check_flat(name, *ts):
    for t in ts:
        if t.dim() != 1:
            raise ValueError("%s: 1-D operands, got shape %s"
                             % (name, tuple(t.shape)))
        if t.device != ts[0].device:
            raise ValueError("%s: operands on %s and %s"
                             % (name, ts[0].device, t.device))


def quantize_2bit(grad, residual, threshold=0.5):
    """2-bit quantize with error feedback: ``(words, new_residual)`` for
    ``[n]`` ``grad`` and ``residual`` of one dtype. A CPU tensor runs
    ``quantize_2bit_reference``; a CUDA tensor launches the kernel on the
    current stream (bf16 or float32, contiguous) or raises."""
    _check_flat("quantize_2bit", grad, residual)
    if grad.shape != residual.shape or grad.dtype != residual.dtype:
        raise ValueError("quantize_2bit: grad %s %s and residual %s %s"
                         % (tuple(grad.shape), grad.dtype,
                            tuple(residual.shape), residual.dtype))
    if grad.device.type == "cpu":
        return quantize_2bit_reference(grad, residual, threshold)
    if grad.device.type != "cuda":
        raise MXNetError("quantize_2bit: no kernel for device %s"
                         % grad.device)
    return _launch_quantize(grad, residual, threshold)


def dequantize_2bit(words, n, threshold=0.5):
    """Inverse of ``quantize_2bit``: ``[ceil(n/16)]`` int32 words -> float32
    ``[n]``. A CPU tensor runs ``dequantize_2bit_reference``; a CUDA tensor
    launches the kernel on the current stream or raises."""
    _check_flat("dequantize_2bit", words)
    if words.dtype != torch.int32 or words.shape[0] != num_words(n):
        raise ValueError("dequantize_2bit: need %d int32 words for %d "
                         "values, got %s %s" % (num_words(n), n,
                                                tuple(words.shape),
                                                words.dtype))
    if words.device.type == "cpu":
        return dequantize_2bit_reference(words, n, threshold)
    if words.device.type != "cuda":
        raise MXNetError("dequantize_2bit: no kernel for device %s"
                         % words.device)
    return _launch_dequantize(words, n, threshold)


_P = ctypes.c_void_p
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGS = {"quantize_2bit_bf16": [_P, _P, _P, _P, _L, _F, _P],
         "quantize_2bit_f32": [_P, _P, _P, _P, _L, _F, _P],
         "dequantize_2bit_f32": [_P, _P, _L, _F, _P]}
_KERNEL_DTYPES = {torch.bfloat16: "quantize_2bit_bf16",
                  torch.float32: "quantize_2bit_f32"}


def _fn(name):
    from . import _build
    fn = getattr(_build.load("compression"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
    return fn


def _launch_quantize(grad, residual, threshold):
    global LAUNCHES_QUANTIZE
    name = _KERNEL_DTYPES.get(grad.dtype)
    if name is None:
        raise TypeError("quantize_2bit: the kernel takes bf16 or float32 "
                        "gradients, got %s" % grad.dtype)
    if not (grad.is_contiguous() and residual.is_contiguous()):
        raise ValueError("quantize_2bit: grad and residual must be "
                         "contiguous")
    n = grad.shape[0]
    words = torch.empty(num_words(n), dtype=torch.int32, device=grad.device)
    new_res = torch.empty_like(residual)
    if n == 0:
        return words, new_res
    with torch.cuda.device(grad.device):
        err = _fn(name)(grad.data_ptr(), residual.data_ptr(),
                        new_res.data_ptr(), words.data_ptr(), n,
                        weak_scalar(float(threshold), grad.dtype),
                        torch.cuda.current_stream(grad.device).cuda_stream)
    if err != 0:
        raise MXNetError("quantize_2bit launch failed: cudaError %d (n %d, "
                         "%s)" % (err, n, grad.dtype))
    LAUNCHES_QUANTIZE += 1
    return words, new_res


def _launch_dequantize(words, n, threshold):
    global LAUNCHES_DEQUANTIZE
    if not words.is_contiguous():
        raise ValueError("dequantize_2bit: words must be contiguous")
    out = torch.empty(int(n), dtype=torch.float32, device=words.device)
    if n == 0:
        return out
    with torch.cuda.device(words.device):
        err = _fn("dequantize_2bit_f32")(
            words.data_ptr(), out.data_ptr(), int(n), float(threshold),
            torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise MXNetError("dequantize_2bit launch failed: cudaError %d (n %d)"
                         % (err, n))
    LAUNCHES_DEQUANTIZE += 1
    return out
