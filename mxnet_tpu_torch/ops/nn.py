"""Neural-network ops on torch tensors (counterpart of mxnet_tpu/ops/nn.py):
FullyConnected, Convolution, Pooling, Activation, softmax, log_softmax and
BatchNorm (batch statistics in training, running statistics otherwise).

Layouts follow the JAX package: NCHW by default, the channels-last layouts
(NWC/NHWC/NDHWC) where ``layout=`` says so, and OIHW weights in every
layout. Convolutions and pooling outside the fused BN->ReLU->conv3x3 link
run through ``torch.nn.functional``; the JAX package leaves them to XLA.

The values a ``remat_policy`` may keep are tagged where they are made, as
the JAX package tags them: convolution outputs "conv_out", max-pool
outputs "pool_out" and training BatchNorm statistics "bn_stat"
(``remat.checkpoint_name``; outside a policy a tag does nothing).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..base import canonical_dtype
from ..kernels import batchnorm_fused as _bnf
from ..kernels.batchnorm_fused import exact_mul, exact_sq, tree_fold_rows
from ..remat import checkpoint_name
from .registry import register

__all__ = ["fully_connected", "convolution", "pooling", "activation",
           "softmax", "log_softmax", "batch_moments", "batch_norm"]


def _pair(v, n=2):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v if len(v) == n else v * n


def _channels_last(layout):
    return layout is not None and layout.endswith("C")


def _to_cf(x):
    """Channels-last (N, *spatial, C) -> channels-first view."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_cl(x):
    """Channels-first (N, C, *spatial) -> channels-last view."""
    return x.permute(0, *range(2, x.dim()), 1)


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    x2 = x.reshape(x.shape[0], -1) if flatten else x
    out = torch.matmul(x2, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}


@register("Convolution", aliases=("convolution",))
def convolution(x, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout="NCHW", cudnn_tune=None, cudnn_off=False,
                workspace=1024):
    """N-D convolution (1D/2D/3D by kernel length); OIHW weights."""
    nd = len(kernel) if kernel is not None else x.dim() - 2
    if kernel is not None and tuple(weight.shape[2:]) != tuple(kernel):
        raise ValueError(
            "Convolution kernel param %s does not match weight spatial "
            "shape %s" % (tuple(kernel), tuple(weight.shape[2:])))
    stride = _pair(stride, nd)
    dilate = _pair(dilate, nd)
    pad = _pair(pad if pad is not None else 0, nd)
    use_bias = bias is not None and not no_bias
    channels_last = _channels_last(layout)
    if channels_last and num_group == 1 and nd == 2 \
            and tuple(weight.shape[2:]) == (1, 1) and pad == (0, 0):
        # 1x1 NHWC conv as one matmul over [N*H*W, Cin]; the stride is a
        # slice of the input (the JAX package's form, ops/nn.py)
        xs = x[:, ::stride[0], ::stride[1], :] if stride != (1, 1) else x
        n, h, w_, cin = xs.shape
        a = xs.reshape(n * h * w_, cin)
        b = weight.reshape(weight.shape[0], cin).t()
        with checkpoint_name("conv_out"):
            out = torch.matmul(a, b).reshape(n, h, w_, weight.shape[0])
            return out + bias if use_bias else out
    xin = _to_cf(x) if channels_last else x
    with checkpoint_name("conv_out"):
        out = _CONV[nd](xin, weight, bias if use_bias else None, stride,
                        pad, dilate, num_group)
    return _to_cl(out) if channels_last else out


@register("Pooling", aliases=("pooling",))
def pooling(x, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid", cudnn_off=False,
            layout=None):
    """Global max/avg pooling, or windowed max pooling with padding
    ("valid" or "full" output rounding), channels-first or -last."""
    nd = x.dim() - 2
    channels_last = _channels_last(layout)
    if global_pool and pool_type in ("max", "avg"):
        s0 = 1 if channels_last else 2
        axes = tuple(range(s0, s0 + nd))
        red = torch.amax if pool_type == "max" else torch.mean
        return red(x, dim=axes, keepdim=True)
    if global_pool or pool_type != "max":
        raise NotImplementedError("%s pooling (global_pool=%s) is not "
                                  "ported yet" % (pool_type, global_pool))
    kernel = _pair(kernel, nd)
    stride = _pair(stride, nd)
    pad = _pair(pad if pad is not None else 0, nd)
    xin = _to_cf(x) if channels_last else x
    # explicit -inf padding, (left, right) per spatial dim, last dim
    # first; "full" adds the right padding its ceil-rounded size needs
    flat = []
    for i in reversed(range(nd)):
        extra = 0
        if pooling_convention == "full":
            in_sz = xin.shape[2 + i] + 2 * pad[i]
            out_sz = -(-(in_sz - kernel[i]) // stride[i]) + 1
            extra = max((out_sz - 1) * stride[i] + kernel[i] - in_sz, 0)
        flat += [pad[i], pad[i] + extra]
    xp = tF.pad(xin, flat, value=float("-inf")) if any(flat) else xin
    with checkpoint_name("pool_out"):
        out = (tF.max_pool1d, tF.max_pool2d, tF.max_pool3d)[nd - 1](
            xp, kernel, stride)
    return _to_cl(out) if channels_last else out


@register("Activation", aliases=("activation",))
def activation(x, act_type="relu"):
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return tF.softplus(x)
    if act_type == "softsign":
        return x / (1 + torch.abs(x))
    raise ValueError("unknown act_type %r" % (act_type,))


@register("softmax")
def softmax(x, axis=-1, temperature=None, dtype=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    out = torch.softmax(x, dim=axis)
    return out.to(canonical_dtype(dtype)) if dtype else out


@register("log_softmax")
def log_softmax(x, axis=-1, temperature=None, dtype=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    out = torch.log_softmax(x, dim=axis)
    return out.to(canonical_dtype(dtype)) if dtype else out


def bn_inv_std(var32, eps):
    """``1/sqrt(var + eps)`` in f32 as two IEEE ops (sqrt, then divide):
    the same bits on the CPU and the card. XLA:CPU rewrites the JAX
    package's ``1.0 / jnp.sqrt`` into its own ``rsqrt``, which can differ
    by an ulp."""
    return _bnf.inv_std(var32, eps)


def bn_apply(x, mean32, inv32, g, beta, cax):
    """The BN normalize chain over f32 statistics: ``exact_mul`` then one
    add of rounded values, so every op is correctly rounded (the JAX
    package's ``_bn_apply_core`` after its inverse standard deviation)."""
    shape = [1] * x.dim()
    shape[cax] = x.shape[cax]
    out = exact_mul(x.to(torch.float32) - mean32.reshape(shape),
                    (inv32 * g.to(torch.float32)).reshape(shape)) \
        + beta.to(torch.float32).reshape(shape)
    return out.to(x.dtype)


def batch_moments(x, axes, axis=None, fp32_out=False):
    """Batch mean and variance over ``axes`` (all but the channel axis):
    the framework's one definition of BatchNorm statistics. Both
    accumulate in f32 through the deterministic tree (``tree_fold_rows``,
    squares by ``exact_sq``). Half-precision inputs take the single-pass
    E[x^2] - E[x]^2 (clamped at 0; its cancellation is far below the
    input's rounding), f32 inputs the two-pass E[(x - mean)^2]. Returns
    the statistics in x.dtype, or in f32 with ``fp32_out=True``."""
    keep = (axis % x.dim()) if axis is not None else [
        i for i in range(x.dim()) if i not in axes][0]
    c = x.shape[keep]
    x2 = torch.movedim(x.float(), keep, -1).reshape(-1, c)
    n = x2.shape[0]
    mean32 = _bnf.div_count(tree_fold_rows(x2)[0], n)
    if x.dtype.itemsize <= 2:
        var32 = _bnf.max0(_bnf.div_count(tree_fold_rows(exact_sq(x2))[0], n)
                           - exact_sq(mean32))
    else:
        var32 = _bnf.div_count(tree_fold_rows(exact_sq(x2 - mean32))[0], n)
    if fp32_out:
        return mean32, var32
    with checkpoint_name("bn_stat"):
        return mean32.to(x.dtype), var32.to(x.dtype)


@register("BatchNorm", aliases=("batch_norm",))
def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               min_calib_range=None, max_calib_range=None, _training=True):
    """Returns (out, mean, var). In training mode (and not
    ``use_global_stats``) it normalizes with the batch statistics and
    returns them in x.dtype; the running-statistic update belongs to the
    caller (the gluon layer). A channels-last input (channel axis last)
    goes through ``kernels.batchnorm_fused.fused_batch_norm`` on every
    device, as the JAX package routes it to its kernel; channels-first
    takes ``batch_moments`` and the normalize chain in plain torch.
    Otherwise it normalizes with the running statistics."""
    cax = axis % x.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _training and not use_global_stats:
        if x.dim() >= 2 and cax == x.dim() - 1:
            out, mean32, var32 = _bnf.fused_batch_norm(x, g, beta, eps=eps)
        else:
            axes = tuple(i for i in range(x.dim()) if i != cax)
            mean32, var32 = batch_moments(x, axes, axis, fp32_out=True)
            out = bn_apply(x, mean32, bn_inv_std(var32, eps), g, beta, cax)
        with checkpoint_name("bn_stat"):
            return out, mean32.to(x.dtype), var32.to(x.dtype)
    mean32 = moving_mean.to(torch.float32)
    var32 = moving_var.to(torch.float32)
    return (bn_apply(x, mean32, bn_inv_std(var32, eps), g, beta, cax),
            moving_mean, moving_var)
