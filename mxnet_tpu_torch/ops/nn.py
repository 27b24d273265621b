"""Neural-network ops on torch tensors (counterpart of mxnet_tpu/ops/nn.py):
FullyConnected, Convolution, Deconvolution, Pooling (max, avg, sum, lp),
Activation, LeakyReLU, softmax, log_softmax, softmin,
softmax_cross_entropy, the loss heads (SoftmaxOutput and the three
regression outputs, each a ``torch.autograd.Function`` with the
reference's gradient), BatchNorm (batch statistics in training, running
statistics otherwise), LayerNorm, InstanceNorm, GroupNorm,
L2Normalization, LRN, Dropout, UpSampling, BilinearSampler,
GridGenerator and the fused ``RNN`` (layers of RNN, LSTM or GRU cells in
one or both directions over a packed parameter vector).

Layouts follow the JAX package: NCHW by default, the channels-last layouts
(NWC/NHWC/NDHWC) where ``layout=`` says so, and OIHW weights in every
layout. Convolutions and pooling outside the fused BN->ReLU->conv3x3 link
run through ``torch.nn.functional``; the JAX package leaves them to XLA.
``precision`` of Convolution, Deconvolution and FullyConnected runs the
product under the port's ``precision.matmul_precision`` (None defers to
the global policy). Dropout draws its mask from the port's generator of
the input's device (``random.generator``).

``RNN`` keeps the JAX package's structure: per layer and direction, one
product of all steps' inputs with the input weights, then a Python loop
over time of the recurrent product and the gate math, under autograd (the
JAX package's ``lax.scan``). ``rnn_packed_param_size`` and
``rnn_packed_input_size`` hold the packing arithmetic that
``initializer.FusedRNN`` and ``symbol/infer.py`` read.

The values a ``remat_policy`` may keep are tagged where they are made, as
the JAX package tags them: convolution outputs "conv_out", max-pool
outputs "pool_out" and training BatchNorm statistics "bn_stat"
(``remat.checkpoint_name``; outside a policy a tag does nothing).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .. import random as _random
from ..base import canonical_dtype, weak_scalar
from ..kernels import batchnorm_fused as _bnf
from ..kernels.batchnorm_fused import exact_mul, exact_sq, tree_fold_rows
from ..precision import matmul_precision
from ..remat import checkpoint_name
from . import global_batch as _gb
from .registry import register

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "activation", "leaky_relu", "softmax", "log_softmax", "softmin",
           "softmax_cross_entropy", "softmax_output",
           "linear_regression_output", "mae_regression_output",
           "logistic_regression_output", "batch_moments", "batch_norm",
           "layer_norm", "instance_norm", "group_norm", "l2_normalization",
           "lrn", "dropout", "upsampling", "bilinear_sampler",
           "grid_generator", "rnn_packed_param_size",
           "rnn_packed_input_size", "rnn_fused"]


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
                    flatten=True, precision=None):
    x2 = x.reshape(x.shape[0], -1) if flatten else x
    with matmul_precision(precision):
        out = torch.matmul(x2, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}


@register("Convolution", aliases=("convolution",))
def convolution(x, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout="NCHW", cudnn_tune=None, cudnn_off=False,
                workspace=1024, precision=None):
    """N-D convolution (1D/2D/3D by kernel length); OIHW weights."""
    with matmul_precision(precision):
        return _convolution(x, weight, bias, kernel, stride, dilate, pad,
                            num_group, no_bias, layout)


def _convolution(x, weight, bias, kernel, stride, dilate, pad, num_group,
                 no_bias, layout):
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


_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(x, weight, bias=None, kernel=None, stride=None, dilate=None,
                  pad=None, adj=None, target_shape=None, num_filter=None,
                  num_group=1, no_bias=True, layout="NCHW", cudnn_tune=None,
                  cudnn_off=False, workspace=512, precision=None):
    """Transposed convolution; weights (in_channels, out_channels / groups,
    *kernel). The output of each spatial dim is (in - 1) * stride - 2 * pad
    + dilate * (kernel - 1) + 1 + adj, as the JAX package's
    fractionally-strided convolution gives it. An ``adj`` below the stride
    or the dilation is torch's ``output_padding``; a larger one runs that
    convolution itself: the input dilated by the stride, padded, and
    convolved with the flipped kernel."""
    nd = len(kernel)
    if tuple(weight.shape[2:]) != tuple(kernel):
        raise ValueError(
            "Deconvolution kernel param %s does not match weight spatial "
            "shape %s" % (tuple(kernel), tuple(weight.shape[2:])))
    stride = _pair(stride, nd)
    dilate = _pair(dilate, nd)
    pad = _pair(pad if pad is not None else 0, nd)
    adj = _pair(adj if adj is not None else 0, nd)
    channels_last = _channels_last(layout)
    xin = _to_cf(x) if channels_last else x
    b = bias if bias is not None and not no_bias else None
    with matmul_precision(precision):
        if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
            out = _CONV_T[nd](xin, weight, b, stride, pad, adj, num_group,
                              dilate)
        else:
            out = _fractional_conv(xin, weight, b, stride, dilate, pad, adj,
                                   num_group)
    return _to_cl(out) if channels_last else out


def _fractional_conv(x, weight, bias, stride, dilate, pad, adj, groups):
    """The JAX package's form of a transposed convolution, channels-first:
    x dilated by ``stride``, padded (k_eff - 1 - pad, k_eff - 1 - pad +
    adj) per dim, convolved with the kernel flipped and its in/out axes
    swapped per group."""
    nd = x.dim() - 2
    n, c = x.shape[:2]
    size = [(x.shape[2 + i] - 1) * stride[i] + 1 for i in range(nd)]
    xd = x.new_zeros((n, c) + tuple(size))
    xd[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                          for s in stride)] = x
    flat = []
    for i in reversed(range(nd)):
        k_eff = dilate[i] * (weight.shape[2 + i] - 1) + 1
        flat += [k_eff - 1 - pad[i], k_eff - 1 - pad[i] + adj[i]]
    xd = tF.pad(xd, flat)           # a negative entry crops
    w = torch.flip(weight, dims=tuple(range(2, 2 + nd)))
    cin, cog = w.shape[0], w.shape[1]
    w = w.reshape((groups, cin // groups, cog) + tuple(w.shape[2:]))
    w = w.transpose(1, 2).reshape((groups * cog, cin // groups)
                                  + tuple(w.shape[3:]))
    return _CONV[nd](xd, w, bias, 1, 0, dilate, groups)


def _pool_pads(xin, kernel, stride, pad, convention):
    """(left, right) padding per spatial dim, last dim first (``tF.pad``'s
    order): ``pad`` each side, and for "full" the extra right padding its
    ceil-rounded output size needs."""
    nd = len(kernel)
    flat = []
    for i in reversed(range(nd)):
        extra = 0
        if convention == "full":
            in_sz = xin.shape[2 + i] + 2 * pad[i]
            out_sz = -(-(in_sz - kernel[i]) // stride[i]) + 1
            extra = max((out_sz - 1) * stride[i] + kernel[i] - in_sz, 0)
        flat += [pad[i], pad[i] + extra]
    return flat


_MAX_POOL = (tF.max_pool1d, tF.max_pool2d, tF.max_pool3d)
_AVG_POOL = (tF.avg_pool1d, tF.avg_pool2d, tF.avg_pool3d)


def _window_sum(xp, kernel, stride):
    """Sum over each window of the already padded ``xp`` (a window mean
    times the window's size)."""
    nd = len(kernel)
    return _AVG_POOL[nd - 1](xp, kernel, stride) * float(math.prod(kernel))


@register("Pooling", aliases=("pooling",))
def pooling(x, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid", cudnn_off=False,
            p_value=2, count_include_pad=True, layout=None):
    """Max, avg, sum or lp pooling, global or windowed with padding
    ("valid" or "full" output rounding), channels-first or -last. As in the
    JAX package, avg with ``count_include_pad`` divides every window by
    the kernel's size, also the windows "full" rounding adds; without it,
    by the count of input elements the window covers."""
    nd = x.dim() - 2
    channels_last = _channels_last(layout)
    if global_pool:
        s0 = 1 if channels_last else 2
        axes = tuple(range(s0, s0 + nd))
        if pool_type == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        if pool_type == "avg":
            return torch.mean(x, dim=axes, keepdim=True)
        if pool_type == "sum":
            return torch.sum(x, dim=axes, keepdim=True)
        if pool_type == "lp":
            return torch.pow(torch.sum(torch.pow(torch.abs(x), p_value),
                                       dim=axes, keepdim=True),
                             1.0 / p_value)
        raise ValueError("unknown pool_type %r" % (pool_type,))
    kernel = _pair(kernel, nd)
    stride = _pair(stride, nd)
    pad = _pair(pad if pad is not None else 0, nd)
    xin = _to_cf(x) if channels_last else x
    flat = _pool_pads(xin, kernel, stride, pad, pooling_convention)
    if pool_type == "max":
        # explicit -inf padding, so "full" windows see no fake maximum
        xp = tF.pad(xin, flat, value=float("-inf")) if any(flat) else xin
        with checkpoint_name("pool_out"):
            out = _MAX_POOL[nd - 1](xp, kernel, stride)
    elif pool_type in ("avg", "sum"):
        if xin.device.type == "cpu" and xin.dtype.itemsize <= 2:
            # torch's CPU average pooling has no bf16 3-D form: sum in
            # float32 there, rounding once at the end
            return pooling(x.float(), kernel, pool_type, stride, pad,
                           global_pool, pooling_convention, cudnn_off,
                           p_value, count_include_pad, layout).to(x.dtype)
        xp = tF.pad(xin, flat) if any(flat) else xin
        if pool_type == "avg" and count_include_pad:
            out = _AVG_POOL[nd - 1](xp, kernel, stride)
        else:
            out = _window_sum(xp, kernel, stride)
            if pool_type == "avg":
                ones = torch.ones((1, 1) + tuple(xin.shape[2:]),
                                  dtype=torch.float32, device=x.device)
                ones = tF.pad(ones, flat) if any(flat) else ones
                cnt = torch.round(_window_sum(ones, kernel, stride))
                out = out / cnt.to(out.dtype)
    elif pool_type == "lp":
        xp = torch.pow(torch.abs(xin), p_value)
        xp = tF.pad(xp, flat) if any(flat) else xp
        out = torch.pow(_window_sum(xp, kernel, stride), 1.0 / p_value)
    else:
        raise ValueError("unknown pool_type %r" % (pool_type,))
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


@register("LeakyReLU", aliases=("leaky_relu",))
def leaky_relu(x, gamma=None, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    """leaky, prelu (``gamma`` per channel, axis 1), elu, selu, gelu (the
    erf form) and rrelu (its evaluation slope, the bounds' mean)."""
    def scaled(a, t):
        return weak_scalar(a, x.dtype) * t
    if act_type == "leaky":
        return torch.where(x > 0, x, scaled(slope, x))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(x > 0, x, g * x)
    if act_type == "elu":
        return torch.where(x > 0, x, scaled(slope, torch.expm1(x)))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scaled(scale, torch.where(x > 0, x,
                                         scaled(alpha, torch.expm1(x))))
    if act_type == "gelu":
        return tF.gelu(x)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(x > 0, x, scaled(mid, x))
    raise ValueError("unknown act_type %r" % (act_type,))


@register("softmax")
def softmax(x, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None):
    """Softmax over ``axis``; with ``use_length`` only the first
    ``length`` entries along it (per leading index) take part, the rest
    are 0."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if use_length and length is not None:
        ax = axis % x.dim()
        shp = [1] * x.dim()
        shp[ax] = x.shape[ax]
        pos = torch.arange(x.shape[ax], device=x.device).reshape(shp)
        lens = length.reshape(tuple(length.shape)
                              + (1,) * (x.dim() - length.dim()))
        mask = pos < lens
        out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=axis)
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    out = torch.softmax(x, dim=axis)
    return out.to(canonical_dtype(dtype)) if dtype else out


@register("log_softmax")
def log_softmax(x, axis=-1, temperature=None, dtype=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    out = torch.log_softmax(x, dim=axis)
    return out.to(canonical_dtype(dtype)) if dtype else out


@register("softmin")
def softmin(x, axis=-1):
    return torch.softmax(-x, dim=axis)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed negative log-likelihood of ``label`` under
    softmax(data)."""
    logp = torch.log_softmax(data, dim=-1)
    idx = label.to(torch.int64).reshape(-1, 1)
    return -torch.sum(torch.gather(logp, -1, idx))


def _onehot(label, num_classes, axis, dtype):
    """One-hot of integer-valued ``label`` inserted at ``axis``; an index
    outside [0, num_classes) gives a row of zeros (jax.nn.one_hot's)."""
    lbl = label.to(torch.int64).unsqueeze(axis)
    shp = [1] * lbl.dim()
    shp[axis] = num_classes
    cls = torch.arange(num_classes, device=label.device).reshape(shp)
    return (lbl == cls).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; backward the reference's (softmax - onehot(label))
    * grad_scale (SoftmaxOutputGrad), which ignores the incoming gradient
    unless ``out_grad``."""

    @staticmethod
    def forward(ctx, data, label, axis, opts):
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.axis, ctx.opts = axis, opts
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        axis = ctx.axis
        (grad_scale, ignore_label, use_ignore, normalization, out_grad,
         smooth_alpha) = ctx.opts
        ax = axis % out.dim()
        num_classes = out.shape[ax]
        onehot = _onehot(label, num_classes, ax, out.dtype)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) \
                + smooth_alpha / (num_classes - 1) * (1.0 - onehot)
        grad = out - onehot
        valid = None
        if use_ignore:
            keep = label != ignore_label
            grad = grad * keep.unsqueeze(ax).to(grad.dtype)
            valid = keep.sum()
        if normalization == "batch":
            grad = grad / out.shape[0]
        elif normalization == "valid":
            n = valid if valid is not None else torch.tensor(label.numel())
            grad = grad / torch.clamp(n, min=1).to(grad.dtype)
        grad = grad * grad_scale
        if out_grad:
            grad = grad * g
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, dlabel, None, None


@register("SoftmaxOutput", aliases=("softmax_output",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax with the reference's loss-head gradient (``_SoftmaxOutput``):
    a bare ``backward()`` on it trains the net."""
    axis = 1 if multi_output else -1
    return _SoftmaxOutput.apply(data, label, axis, (
        grad_scale, ignore_label, use_ignore, normalization, out_grad,
        smooth_alpha))


class _RegressionHead(torch.autograd.Function):
    """Forward the prediction; backward a fixed (pred, label) rule scaled
    by grad_scale / outputs per example, ignoring the incoming gradient
    (the reference's RegressionBackward)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        pred = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(pred, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return pred

    @staticmethod
    def backward(ctx, g):
        pred, label = ctx.saved_tensors
        lbl = label.reshape(pred.shape)
        batch = pred.shape[0] if pred.dim() else 1
        num_output = max(pred.numel() // max(batch, 1), 1)
        diff = pred - lbl
        rule = torch.sign(diff) if ctx.kind == "mae" else diff
        grad = (rule * (ctx.grad_scale / num_output)).to(pred.dtype)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, dlabel, None, None


@register("LinearRegressionOutput", aliases=("linear_regression_output",))
def linear_regression_output(data, label, grad_scale=1.0):
    return _RegressionHead.apply(data, label, "linear", grad_scale)


@register("MAERegressionOutput", aliases=("mae_regression_output",))
def mae_regression_output(data, label, grad_scale=1.0):
    return _RegressionHead.apply(data, label, "mae", grad_scale)


@register("LogisticRegressionOutput",
          aliases=("logistic_regression_output",))
def logistic_regression_output(data, label, grad_scale=1.0):
    return _RegressionHead.apply(data, label, "logistic", grad_scale)


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
    takes ``batch_moments`` and the normalize chain in plain torch. Inside
    a data-parallel step across processes (``ops.global_batch``) both
    layouts take the fused op with the global batch's statistics
    (its ``across`` hook). Otherwise it normalizes with the running
    statistics."""
    cax = axis % x.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _training and not use_global_stats:
        across = _gb.mean_fn()
        if x.dim() >= 2 and cax == x.dim() - 1:
            out, mean32, var32 = _bnf.fused_batch_norm(x, g, beta, eps=eps,
                                                       across=across)
        elif x.dim() >= 2 and across is not None:
            out, mean32, var32 = _bnf.fused_batch_norm(
                torch.movedim(x, cax, -1), g, beta, eps=eps, across=across)
            out = torch.movedim(out, -1, cax)
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


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(x, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    var, mean = torch.var_mean(x, dim=axis, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + eps)
    shape = [1] * x.dim()
    shape[axis % x.dim()] = x.shape[axis % x.dim()]
    out = (x - mean) * inv * gamma.reshape(shape) + beta.reshape(shape)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


@register("InstanceNorm", aliases=("instance_norm",))
def instance_norm(x, gamma, beta, eps=1e-3):
    """Normalization over the spatial axes of each sample and channel."""
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, unbiased=False, keepdim=True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("GroupNorm", aliases=("group_norm",))
def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    var, mean = torch.var_mean(xg, dim=axes, unbiased=False, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("L2Normalization", aliases=("l2_normalization",))
def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, x.dim()))
    else:
        raise ValueError(mode)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                      + eps)
    return x / norm


@register("LRN", aliases=("lrn",))
def lrn(x, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Cross-channel local response normalization."""
    half = nsize // 2
    sq = torch.square(x)
    padded = tF.pad(sq, (0, 0) * (x.dim() - 2) + (half, half))
    acc = torch.zeros_like(x)
    for i in range(nsize):
        acc = acc + padded.narrow(1, i, x.shape[1])
    return x / torch.pow(knorm + alpha * acc / nsize, beta)


@register("Dropout", aliases=("dropout",))
def dropout(x, key=None, p=0.5, mode="training", axes=(), _training=True,
            cudnn_off=False):
    """In training (or ``mode="always"``) each entry, or each slice along
    ``axes``, is kept with probability 1 - p and scaled by 1 / (1 - p), else
    zeroed. The mask is drawn from ``key`` (a ``torch.Generator``) or from
    the port's generator of x's device, never from torch's global RNG."""
    if not _training and mode != "always":
        return x
    if p <= 0.0:
        return x
    shape = tuple(1 if i in axes else s for i, s in enumerate(x.shape)) \
        if axes else tuple(x.shape)
    keep = 1.0 - p
    gen = key if key is not None else _random.generator(x.device)
    mask = _gb.dropout_rows(
        shape, lambda s: torch.rand(s, generator=gen, device=x.device),
        shared=0 in axes) < keep
    return torch.where(mask, x / weak_scalar(keep, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


@register("UpSampling", aliases=("upsampling",))
def upsampling(*data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest-neighbour upsampling of NCHW inputs; several inputs are
    brought to the first's size and concatenated on channels."""
    x = data[0]
    out = x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    if len(data) > 1 and multi_input_mode == "concat":
        outs = [out]
        for d in data[1:]:
            s = x.shape[2] * scale // d.shape[2]
            outs.append(d.repeat_interleave(s, 2).repeat_interleave(s, 3))
        return torch.cat(outs, dim=1)
    return out


@register("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, cudnn_off=False):
    """Bilinear samples of NCHW ``data`` at ``grid`` (N, 2, Ho, Wo): x then
    y in [-1, 1] over the corner pixels; points outside the image read 0."""
    n, c, h, w = data.shape
    ho, wo = grid.shape[2], grid.shape[3]
    gx = (grid[:, 0] + 1) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1) * (h - 1) / 2.0
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    flat = data.reshape(n, c, h * w)

    def sample(yi, xi):
        yc = yi.clamp(0, h - 1)
        xc = xi.clamp(0, w - 1)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yc * w + xc).reshape(n, 1, ho * wo).expand(n, c, ho * wo)
        vals = torch.gather(flat, 2, idx).reshape(n, c, ho, wo)
        return vals * valid.unsqueeze(1).to(data.dtype)

    return (sample(y0, x0) * (wy0 * wx0).unsqueeze(1)
            + sample(y0, x1) * (wy0 * wx1).unsqueeze(1)
            + sample(y1, x0) * (wy1 * wx0).unsqueeze(1)
            + sample(y1, x1) * (wy1 * wx1).unsqueeze(1))


@register("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid (N, 2, H, W): "affine" from (N, 6) transforms over
    the target shape, "warp" from an (N, 2, H, W) flow field."""
    if transform_type == "affine":
        h, w = target_shape
        n = data.shape[0]
        # the float32 grid promotes a half-precision transform, as in JAX
        dt = torch.promote_types(data.dtype, torch.float32)
        theta = data.reshape(n, 2, 3).to(dt)
        ys = torch.linspace(-1, 1, h, device=data.device, dtype=dt)
        xs = torch.linspace(-1, 1, w, device=data.device, dtype=dt)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx).reshape(-1)], dim=0)
        return torch.einsum("nij,jk->nik", theta, coords).reshape(n, 2, h, w)
    if transform_type == "warp":
        n, _, hh, ww = data.shape
        ys = torch.arange(hh, dtype=data.dtype, device=data.device)
        xs = torch.arange(ww, dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        fx = (data[:, 0] + gx) * 2 / max(ww - 1, 1) - 1
        fy = (data[:, 1] + gy) * 2 / max(hh - 1, 1) - 1
        return torch.stack([fx, fy], dim=1)
    raise ValueError(transform_type)


# -- fused RNN -----------------------------------------------------------------

_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def rnn_packed_param_size(mode, input_size, state_size, num_layers, ndir):
    """Length of the packed ``RNN`` parameter vector."""
    g = _RNN_GATES[mode]
    h = state_size
    return ndir * g * h * (input_size + h + 2) \
        + (num_layers - 1) * ndir * g * h * (h * ndir + h + 2)


def rnn_packed_input_size(total, mode, state_size, num_layers, ndir):
    """The layer-0 input size of a packed vector of ``total`` values (the
    inverse of ``rnn_packed_param_size``)."""
    g = _RNN_GATES[mode]
    h = state_size
    return total // ndir // g // h - (num_layers - 1) * (h + ndir * h + 2) \
        - h - 2


def _rnn_unpack_params(parameters, mode, input_size, state_size, num_layers,
                       ndir):
    """Views of the packed vector per (layer, direction): (w_i2h, w_h2h,
    b_i2h, b_h2h). cuDNN's order: all weights layer-major with the
    direction inner, then all biases."""
    g = _RNN_GATES[mode]
    h = state_size
    shapes_w, shapes_b = [], []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else h * ndir
        for _ in range(ndir):
            shapes_w += [(g * h, isz), (g * h, h)]
            shapes_b += [(g * h,), (g * h,)]
    out, off = [], 0
    for shp in shapes_w + shapes_b:
        n = math.prod(shp)
        out.append(parameters[off:off + n].reshape(shp))
        off += n
    nw = len(shapes_w)
    return [(out[i], out[i + 1], out[nw + i], out[nw + i + 1])
            for i in range(0, nw, 2)]   # index: layer * ndir + direction


def _rnn_cell_step(mode, h_prev, c_prev, i2h, h2h, clip=None):
    """One step's gate math from its two projections. LSTM gates [i, f, g,
    o]; GRU [r, z, n] with n = tanh(i2h_n + r * h2h_n). ``clip`` = (min,
    max, nan) clips the LSTM cell state at every step as cuDNN's
    CUDNN_RNN_CLIP does (NaN to the clipped 0 where ``nan``)."""
    if mode in ("rnn_relu", "rnn_tanh"):
        pre = i2h + h2h
        return (torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre),
                c_prev)
    if mode == "gru":
        ir, iz, inn = i2h.chunk(3, -1)
        hr, hz, hn = h2h.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        return (1.0 - z) * n + z * h_prev, c_prev
    if mode == "lstm":
        gi, gf, gg, go = (i2h + h2h).chunk(4, -1)
        c = torch.sigmoid(gf) * c_prev + torch.sigmoid(gi) * torch.tanh(gg)
        if clip is not None:
            cmin, cmax, cnan = clip
            c = torch.clamp(c, cmin, cmax)
            if cnan:
                c = torch.where(torch.isnan(c),
                                torch.clamp(torch.zeros_like(c), cmin, cmax),
                                c)
        return torch.sigmoid(go) * torch.tanh(c), c
    raise ValueError("unknown RNN mode %r" % (mode,))


def _sequence_reverse(x, lengths):
    """Reverse (T, N, C) within each sample's valid prefix; the padding
    stays in place."""
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    lens = lengths.to(torch.int64)[None, :]
    idx = torch.where(t < lens, lens - 1 - t, t)
    return torch.gather(x, 0, idx[..., None].expand(x.shape))


def _rnn_layer_scan(mode, x, h0, c0, w_i2h, w_h2h, b_i2h, b_h2h, reverse,
                    lengths=None, clip=None):
    """One direction of one layer over the sequence: the input projection
    of every step in one (T*N, I) x (I, G*H) product, then per step the
    (N, H) x (H, G*H) recurrent product and the gate math. With
    ``lengths`` (N,), steps past a sample's length keep its state and
    emit zeros, and the reverse direction reverses within the valid
    prefix, so each final state is taken at its sample's own end."""
    if reverse:
        x = _sequence_reverse(x, lengths) if lengths is not None \
            else torch.flip(x, (0,))
    i2h_all = torch.matmul(x, w_i2h.t()) + b_i2h
    lens = lengths.to(torch.int64) if lengths is not None else None
    h, c = h0, c0
    outs = []
    for t in range(x.shape[0]):
        h2h = torch.matmul(h, w_h2h.t()) + b_h2h
        h_new, c_new = _rnn_cell_step(mode, h, c, i2h_all[t], h2h, clip=clip)
        if lens is None:
            h, c = h_new, c_new
            outs.append(h)
            continue
        valid = (t < lens)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs.append(torch.where(valid, h, 0.0))
    hs = torch.stack(outs, 0)
    if reverse:
        hs = _sequence_reverse(hs, lengths) if lengths is not None \
            else torch.flip(hs, (0,))
    return hs, h, c


@register("RNN", aliases=("rnn",))
def rnn_fused(data, parameters, state, state_cell=None, sequence_length=None,
              key=None, *, mode="lstm", state_size=None, num_layers=1,
              bidirectional=False, p=0.0, state_outputs=False,
              projection_size=None, lstm_state_clip_min=None,
              lstm_state_clip_max=None, lstm_state_clip_nan=False,
              use_sequence_length=False, _training=True):
    """Fused multi-layer RNN in one or both directions. Layout TNC: data
    (T, N, I); state (L*D, N, H); a packed 1-D ``parameters``. Dropout
    ``p`` applies to the inputs of layers after the first in training,
    its mask drawn from ``key`` (a ``torch.Generator``) or the port's
    generator of the data's device. With ``use_sequence_length`` the
    input after the states is the per-sample valid length (N,); for
    modes without a cell state it arrives in the ``state_cell`` slot, as
    the op's inputs are positional."""
    if projection_size:
        raise NotImplementedError("LSTMP projection is not supported")
    if state_size is None:
        raise ValueError("state_size required")
    if use_sequence_length:
        if mode != "lstm" and sequence_length is None:
            state_cell, sequence_length = None, state_cell
        if sequence_length is None:
            raise ValueError("use_sequence_length=True requires a "
                             "sequence_length input")
    else:
        sequence_length = None
    clip = None
    if mode == "lstm" and lstm_state_clip_min is not None:
        clip = (lstm_state_clip_min, lstm_state_clip_max,
                lstm_state_clip_nan)
    ndir = 2 if bidirectional else 1
    per = _rnn_unpack_params(parameters, mode, data.shape[-1], state_size,
                             num_layers, ndir)
    x = data
    h_lasts, c_lasts = [], []
    for layer in range(num_layers):
        if layer > 0 and p > 0.0 and _training and not x.is_meta:
            x = dropout(x, key=key, p=p)
        outs = []
        for d in range(ndir):
            idx = layer * ndir + d
            h0 = state[idx]
            c0 = state_cell[idx] if state_cell is not None \
                else torch.zeros_like(h0)
            hs, h_last, c_last = _rnn_layer_scan(
                mode, x, h0, c0, *per[idx], reverse=(d == 1),
                lengths=sequence_length, clip=clip)
            outs.append(hs)
            h_lasts.append(h_last)
            c_lasts.append(c_last)
        x = outs[0] if ndir == 1 else torch.cat(outs, dim=-1)
    out_h = torch.stack(h_lasts, 0)
    if mode == "lstm":
        return (x, out_h, torch.stack(c_lasts, 0)) if state_outputs else x
    return (x, out_h) if state_outputs else x
