"""Fused scale-bias-ReLU + 3x3 convolution: the Hopper kernel and its plain
PyTorch version (counterpart of mxnet_tpu/pallas_kernels/conv_fused.py).

    y = conv3x3(relu(x * s + b), W)        # stride 1, SAME padding, NHWC

``fused_scale_relu_conv3x3`` launches the hand-written CUDA kernel in
``csrc/conv_fused.cu`` for a CUDA tensor and runs ``fused_conv_reference``
for a CPU tensor; there is no other route. The kernel's design note is in
its source.

Layouts are the JAX package's: x (N, H, W, Ci) NHWC, s and b (Ci,) float32
(the folded BatchNorm scale and bias), w (3, 3, Ci, Co) HWIO.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as tF

from ..base import MXNetError

__all__ = ["fused_scale_relu_conv3x3", "fused_conv_reference",
           "compute_dtype", "LAUNCHES"]

# Kernel launches made by fused_scale_relu_conv3x3 in this process.
LAUNCHES = 0


def compute_dtype(dtype):
    """The dtype the convolution runs in: bf16 and f32 as they are, other
    half types as bf16, wider floats as f32 (``_compute_dtype`` of the JAX
    module)."""
    if dtype in (torch.bfloat16, torch.float32):
        return dtype
    if not dtype.is_floating_point:
        raise TypeError("fused_scale_relu_conv3x3: floating input "
                        "required, got %s" % dtype)
    return torch.bfloat16 if dtype.itemsize <= 2 else torch.float32


def fused_conv_reference(x, s, b, w, relu=True):
    """Plain PyTorch semantics of the fused op: the activation in the
    compute dtype, the convolution in float32 on the upcast operands, the
    result cast to ``x.dtype``. On a CUDA tensor the caller decides TF32
    (``torch.backends.cudnn.allow_tf32``)."""
    cdt = compute_dtype(x.dtype)
    pre = x.to(cdt) * s.to(cdt) + b.to(cdt)
    z = torch.clamp_min(pre, 0) if relu else pre
    out = tF.conv2d(z.float().permute(0, 3, 1, 2),
                    w.to(cdt).float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _check(x, s, b, w):
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[-1]:
        raise ValueError("fused_scale_relu_conv3x3: need NHWC x and "
                         "(3,3,Ci,Co) w, got %s / %s"
                         % (tuple(x.shape), tuple(w.shape)))
    ci = x.shape[-1]
    if tuple(s.shape) != (ci,) or tuple(b.shape) != (ci,):
        raise ValueError("fused_scale_relu_conv3x3: s and b must be (%d,), "
                         "got %s / %s" % (ci, tuple(s.shape),
                                          tuple(b.shape)))
    for t in (s, b, w):
        if t.device != x.device:
            raise ValueError("fused_scale_relu_conv3x3: operands on %s and "
                             "%s" % (x.device, t.device))
        if not t.dtype.is_floating_point:
            raise TypeError("fused_scale_relu_conv3x3: floating operands "
                            "required, got %s" % t.dtype)
    compute_dtype(x.dtype)


def fused_scale_relu_conv3x3(x, s, b, w, relu=True):
    """conv3x3(relu(x*s + b), w) with the normalize/ReLU chain applied on
    the kernel's operand load. ``relu=False`` gives conv3x3(x*s + b, w).

    A CPU tensor runs ``fused_conv_reference``. A CUDA tensor launches the
    kernel on the current stream, or raises: non-contiguous ``x``, an
    unsupported dtype, mismatched shapes or a failed launch are errors.

    The op has no backward yet, on either device: with grad mode on and an
    operand that requires grad it raises, rather than return a result
    that silently drops every gradient upstream of it.
    """
    _check(x, s, b, w)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, s, b, w)):
        raise MXNetError("fused_scale_relu_conv3x3 has no backward yet: "
                         "run it under torch.no_grad() or outside "
                         "autograd.record(), or build the network with "
                         "fuse=False to train")
    if x.device.type == "cpu":
        return fused_conv_reference(x, s, b, w, relu)
    if x.device.type != "cuda":
        raise MXNetError("fused_scale_relu_conv3x3: no kernel for device %s"
                         % x.device)
    if not x.is_contiguous():
        raise ValueError("fused_scale_relu_conv3x3: x must be contiguous "
                         "NHWC")
    return _launch(x, s, b, w, bool(relu))


def _launch(x, s, b, w, relu):
    global LAUNCHES
    from . import _build

    N, H, W_, Ci = x.shape
    Co = w.shape[-1]
    cdt = compute_dtype(x.dtype)
    xc = x if x.dtype == cdt else x.to(cdt)
    w2 = w.reshape(9 * Ci, Co).to(cdt).contiguous()
    s2 = s.to(torch.float32).contiguous()
    b2 = b.to(torch.float32).contiguous()
    out = torch.empty((N, H, W_, Co), dtype=cdt, device=x.device)
    if out.numel() == 0:
        return out.to(x.dtype)
    if Ci == 0:
        return out.zero_().to(x.dtype)
    lib = _build.load("conv_fused")
    fn = lib.conv_fused_fwd_bf16 if cdt == torch.bfloat16 \
        else lib.conv_fused_fwd_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xc.data_ptr(), s2.data_ptr(), b2.data_ptr(), w2.data_ptr(),
                 out.data_ptr(), N, H, W_, Ci, Co, int(relu), stream)
    if err != 0:
        raise MXNetError("conv_fused kernel launch failed: cudaError %d "
                         "(N=%d H=%d W=%d Ci=%d Co=%d %s)"
                         % (err, N, H, W_, Ci, Co, cdt))
    LAUNCHES += 1
    return out if out.dtype == x.dtype else out.to(x.dtype)
