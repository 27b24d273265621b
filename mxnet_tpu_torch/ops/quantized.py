"""The int8 quantized operator family under the JAX package's registry names
(counterpart of mxnet_tpu/ops/quantized.py; ref: src/operator/quantization/).

Scheme: symmetric int8 (scale = max_abs / 127, zero point 0). Each op takes
int8 payloads with their float min/max ranges and returns (payload,
out_min, out_max), the reference's three-output convention. Ranges are
float32 0-d tensors on the payload's device (Python floats are rounded to
float32 first, as JAX's weak typing does).

Products: ``quantized_fully_connected`` and ``quantized_conv`` accumulate
int8 x int8 in int32 through ``_int8_dot``, which is the hand-written
kernel (``kernels/quantized_matmul.py``) on a CUDA tensor and its plain
version on a CPU tensor. Every convolution goes through an int8 im2col
first (``im2col``); for a 1x1 stride-1 convolution that is the flattened
pixels, one product as in the JAX package. For the others the JAX package
used XLA's int32 convolution: PyTorch has no integer convolution on CUDA,
and the integer sum is exact either way. On the card no code path computes an
int8 product without the kernel; payloads of another integer type raise
there (the CPU sums them in int64 and wraps to int32, as XLA's int32 dot
does).

Divisions by a scale divide by a tensor on the payload's device: PyTorch's
CUDA division by a Python or CPU scalar multiplies by its reciprocal, which
can move a value across a rounding boundary (``_div``).

The graph pass that swaps float layers for int8 ones lives in
``contrib/quantization.py`` (``quantize_net``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError, weak_scalar
from ..kernels import quantized_matmul as _qmm
from .registry import register

__all__ = ["im2col", "weight_matrix", "quantize_codes", "ALIGN"]

_I32_MIN = -2 ** 31
# K is padded to a multiple of this in im2col, so that the kernel's rows
# load as 16-byte chunks (csrc/quantized_matmul.cu).
ALIGN = 16


def _f32(v, device):
    """``v`` (a tensor, numpy value or Python number) as a float32 tensor on
    ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)


def _operand(v, device):
    """A range or scale operand as JAX types it: ``(tensor, weak)``. A
    tensor keeps its dtype and a numpy value its own (float64 becomes
    float32, JAX's default), both strong; a Python number is a weak
    float32."""
    if isinstance(v, torch.Tensor):
        return v.to(device), False
    if isinstance(v, (int, float)):
        return _f32(v, device), True
    t = torch.as_tensor(np.asarray(v), device=device)
    return (t.to(torch.float32) if t.dtype == torch.float64 else t), False


def _promote(*ops):
    """JAX's type promotion of ``(tensor, weak)`` operands: the strong types
    promote together and the weak ones take the result; with none strong
    the result stays weak float32. Returns ``([tensors], weak)``."""
    strong = [t.dtype for t, weak in ops if not weak]
    if not strong:
        return [t for t, _ in ops], True
    dt = functools.reduce(torch.promote_types, strong)
    return [t.to(dt) for t, _ in ops], False


def _div(a, b):
    """a / b as a true IEEE division on every device, in JAX's type: a
    Python number ``b`` is weak and rounds to ``a``'s float type first
    (``base.weak_scalar``); a tensor ``b`` promotes with ``a`` (a bf16
    tensor over a float32 one divides in float32). ``b`` becomes a tensor
    on ``a``'s device: PyTorch's CUDA division by a Python or CPU scalar
    multiplies by its reciprocal."""
    if isinstance(b, torch.Tensor):
        dt = torch.promote_types(a.dtype, b.dtype)
        return a.to(dt) / b.to(device=a.device, dtype=dt)
    return a / torch.tensor(weak_scalar(float(b), a.dtype), dtype=a.dtype,
                            device=a.device)


def quantize_codes(f, s, weak=False):
    """int8 codes ``clip(round(f / s), -127, 127)``: true division in JAX's
    type, round half to even, clip before the cast (the JAX package's
    expression). ``s`` is a Python number (weak), or a tensor that is
    strong (an f32 scale takes bf16 data to f32, with no bf16 rounding
    before ``round``) or, with ``weak``, computed from Python numbers only
    (it rounds to ``f``'s type first, as a Python scale would)."""
    if weak and isinstance(s, torch.Tensor):
        s = s.to(f.dtype)
    return torch.clamp(torch.round(_div(f, s)), -127, 127).to(torch.int8)


def _int8_dot(x2, wt):
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through
    ``quantized_matmul``: the kernel on a CUDA tensor, the plain version on
    a CPU tensor. Integer accumulation is exact, so the two agree bit for
    bit."""
    return _qmm.quantized_matmul(x2, wt)


def _int_dot(x2, wt):
    """(M, K) @ (K, N) integer product in int32: ``_int8_dot`` for int8
    operands; on the CPU, other integer types sum in int64 and wrap to
    int32 (XLA's int32 dot); on the card they raise."""
    if _qmm.engaged(x2, wt):
        return _int8_dot(x2, wt)
    if x2.device.type != "cpu":
        raise MXNetError("int8 product on %s: the kernel takes int8 payloads "
                         "and weights, got %s / %s"
                         % (x2.device, x2.dtype, wt.dtype))
    return torch.matmul(x2.to(torch.int64), wt.to(torch.int64)) \
        .to(torch.int32)


def _scale(mn, mx, device=None):
    """``max(|mn|, |mx|, 1e-12) / 127`` in JAX's type, on ``device``
    (default: the range's own, else the CPU): ``(scale, weak)``, weak when
    both ends are Python numbers (``_promote``)."""
    if device is None:
        device = next((v.device for v in (mn, mx)
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    (a, b), weak = _promote(_operand(mn, device), _operand(mx, device))
    m = torch.clamp_min(torch.maximum(a.abs(), b.abs()),
                        weak_scalar(1e-12, a.dtype))
    return _div(m, 127.0), weak


def _calib_range(lo, hi, device):
    """A calibrated range as JAX holds it (``jnp.asarray(float(lo))``: weak
    float32 scalars): ``(lo, hi, _scale(lo, hi))``."""
    lo, hi = float(lo), float(hi)
    return _f32(lo, device), _f32(hi, device), _scale(lo, hi, device)


def _out_scale(data_range, weight_range, device):
    """The int32 product's scale ``_scale(data) * _scale(weight)``, in
    JAX's promoted type."""
    (sd, sw), _ = _promote(_scale(*data_range, device),
                           _scale(*weight_range, device))
    return sd * sw


def _deq(q, mn, mx):
    return q.to(torch.float32) * _scale(mn, mx, q.device)[0].to(
        torch.float32)


def _int32_range(sc):
    m = sc * (2.0 ** 31)
    return -m, m


@register("_contrib_quantize", aliases=("quantize_v1",))
def quantize_v1(data, min_range, max_range, out_type="int8"):
    """Three-in, three-out quantize with explicit range inputs
    (ref: quantization/quantize.cc)."""
    dev = data.device
    return (quantize_codes(data, *_scale(min_range, max_range, dev)),
            torch.min(_operand(min_range, dev)[0]),
            torch.max(_operand(max_range, dev)[0]))


@register("_contrib_quantize_v2", aliases=("quantize_v2",))
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """Quantize float -> int8; the range from calibration parameters or
    from the data (ref: quantization/quantize_v2.cc)."""
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx, s = _calib_range(min_calib_range, max_calib_range,
                                 data.device)
    else:
        mn, mx = torch.min(data), torch.max(data)
        s = _scale(mn, mx, data.device)
    return quantize_codes(data, *s), mn, mx


@register("_contrib_requantize", aliases=("requantize",))
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 -> int8 rescale (ref: quantization/requantize.cc). The int32
    payload carries scale in_range / 2^31; the output is int8 at the
    calibrated (or max-abs) range."""
    dev = data.device
    (a, b), _ = _promote(_operand(min_range, dev), _operand(max_range, dev))
    a = torch.clamp_min(torch.maximum(a.abs(), b.abs()),
                        weak_scalar(1e-12, a.dtype))
    f = data.to(torch.float32) * _div(a, 2.0 ** 31).to(torch.float32)
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx, s = _calib_range(min_calib_range, max_calib_range, dev)
    else:
        mn, mx = torch.min(f), torch.max(f)
        s = _scale(mn, mx, dev)
    return quantize_codes(f, *s), mn, mx


@register("_contrib_calibrate_entropy", aliases=("calibrate_entropy",))
def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence-optimal calibration threshold from an activation
    histogram (ref: quantization/calibrate.cc). Runs in numpy on the host,
    as the reference does; returns float32 (min, max) = (-thr, thr)."""
    from ..contrib.quantization import _get_optimal_threshold
    dev = hist.device if isinstance(hist, torch.Tensor) \
        else torch.device("cpu")
    h, e = (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in (hist, hist_edges))
    thr = _get_optimal_threshold(h, e, int(num_quantized_bins))
    return _f32(-thr, dev), _f32(thr, dev)


@register("_contrib_quantized_act", aliases=("quantized_act",))
def quantized_act(data, min_data, max_data, act_type="relu"):
    """int8 activation (ref: quantized_activation.cc); relu keeps the range,
    as the reference passes min/max through."""
    if act_type != "relu":
        raise NotImplementedError("quantized_act supports relu (the "
                                  "reference's only int8 activation)")
    return torch.clamp_min(data, 0).to(torch.int8), min_data, max_data


@register("_contrib_quantized_flatten", aliases=("quantized_flatten",))
def quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data


def _windows(x, kh, kw, sh, sw):
    """(N, C, Ho, Wo, kh, kw) strided view of the windows of a contiguous
    (N, C, H, W) tensor (no padding)."""
    n, c, h, w = x.shape
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    st = x.stride()
    return x.as_strided((n, c, ho, wo, kh, kw),
                        (st[0], st[1], sh * st[2], sw * st[3], st[2], st[3]))


@register("_contrib_quantized_pooling", aliases=("quantized_pooling",))
def quantized_pooling(data, min_data, max_data, kernel=(2, 2),
                      pool_type="max", stride=(1, 1), pad=(0, 0),
                      global_pool=False):
    """int8 max or average pooling on NCHW (ref: quantized_pooling.cc).
    Padding never wins a max; the average sums in int32 with the padding
    counted and floor-divides by the window size."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    ph, pw = int(pad[0]), int(pad[1])
    if global_pool:
        kh, kw = data.shape[2], data.shape[3]
        sh = sw = 1
        ph = pw = 0
    fill = _I32_MIN if pool_type == "max" else 0
    x = torch.nn.functional.pad(data.to(torch.int32), (pw, pw, ph, ph),
                                value=fill).contiguous()
    win = _windows(x, kh, kw, sh, sw)
    if pool_type == "max":
        out = torch.amax(win, dim=(4, 5))
    else:
        out = torch.div(win.sum(dim=(4, 5), dtype=torch.int32), kh * kw,
                        rounding_mode="floor")
    return out.to(torch.int8), min_data, max_data


@register("_contrib_quantized_elemwise_add",
          aliases=("quantized_elemwise_add",))
def quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """int8 + int8 -> int32 at a shared scale
    (ref: quantized_elemwise_add.cc)."""
    dev = lhs.device
    f = _deq(lhs, lhs_min, lhs_max) + _deq(rhs, rhs_min, rhs_max)
    amax = torch.maximum(
        torch.maximum(_f32(lhs_min, dev).abs(), _f32(lhs_max, dev).abs()),
        torch.maximum(_f32(rhs_min, dev).abs(), _f32(rhs_max, dev).abs()))
    mx = amax * 2
    s = _div(mx, 2.0 ** 31)
    # the JAX bounds +-(2^31 - 1) round to +-2^31 in float32; the cast then
    # saturates, as XLA's float -> int32 conversion does
    v = torch.clamp(torch.round(_div(f, torch.clamp_min(s, 1e-38))),
                    -2.0 ** 31, 2.0 ** 31)
    out = torch.where(v >= 2.0 ** 31,
                      torch.full_like(v, 2 ** 31 - 1, dtype=torch.int32),
                      v.to(torch.int32))
    return out, -mx, mx


def _bias_int32(bias, min_bias, max_bias, out_scale):
    sb = _scale(min_bias, max_bias, bias.device)[0]
    return torch.round(_div(bias.to(torch.float32) * sb,
                            out_scale)).to(torch.int32)


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",))
def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias, max_bias,
                              num_hidden=1, no_bias=False, flatten=True):
    """int8 FC -> int32 (ref: quantized_fully_connected.cc): one launch of
    the int8 kernel on the card (``weight.T`` is read in place)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    lead = x.shape[:-1]
    acc = _int_dot(x.reshape(-1, x.shape[-1]), weight.t()) \
        .reshape(*lead, weight.shape[0])
    out_scale = _out_scale((min_data, max_data), (min_weight, max_weight),
                           acc.device)
    if bias is not None and not no_bias:
        acc = acc + _bias_int32(bias, min_bias, max_bias, out_scale)
    mn, mx = _int32_range(out_scale)
    return acc, mn, mx


def im2col(x, kernel, stride=(1, 1), pad=(0, 0), dilate=(1, 1), align=1):
    """Columns of a 2-D convolution over an NCHW tensor, for one product
    with the weight: returns ``(cols, (n, ho, wo))`` where cols is
    (n*ho*wo, Kp) in x's dtype, row (b, i, j) holding the window of output
    pixel (i, j) of image b tap by tap, channels innermost: column
    ``(di * kw + dj) * C + c`` is x[b, c, i*sh - ph + di*dh,
    j*sw - pw + dj*dw], zero outside the image. Kp is kh*kw*C rounded up to
    a multiple of ``align``; the extra columns are zero (they add nothing
    to a product). The matching weight is ``weight_matrix(w, align)``. A
    1x1 stride-1 unpadded convolution of a tensor already laid out NHWC in
    memory gives a view, with no copy."""
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    ph, pw = int(pad[0]), int(pad[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    n, c, h, w = x.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    k = kh * kw * c
    kp = -(-k // align) * align
    xh = x.permute(0, 2, 3, 1)                        # NHWC view
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0) and kp == k:
        return xh.reshape(n * h * w, c), (n, ho, wo)
    if ph or pw or not xh.is_contiguous():
        xp = x.new_zeros((n, h + 2 * ph, w + 2 * pw, c))
        xp[:, ph:ph + h, pw:pw + w] = xh
    else:
        xp = xh
    st = xp.stride()
    patches = xp.as_strided((n, ho, wo, kh, kw, c),
                            (st[0], sh * st[1], sw * st[2], dh * st[1],
                             dw * st[2], st[3]))
    cols = x.new_empty((n * ho * wo, kp))
    if kp != k:
        cols[:, k:].zero_()
    cols[:, :k].view(n, ho, wo, kh, kw, c).copy_(patches)
    return cols, (n, ho, wo)


def weight_matrix(w, align=1):
    """The (Kp, O) product operand of an OIHW weight for ``im2col``'s
    columns: row ``(di * kw + dj) * C + c`` holds w[:, c, di, dj], zero rows
    pad K to Kp. Laid out K-contiguous (a transposed (O, Kp) tensor), as
    the int8 kernel reads it; a view of a contiguous 1x1 weight needing
    no padding."""
    o, c, kh, kw = w.shape
    k = kh * kw * c
    kp = -(-k // align) * align
    m = w.permute(0, 2, 3, 1).reshape(o, k)
    if kp != k:
        m = torch.cat([m, m.new_zeros((o, kp - k))], dim=1)
    return m.t()


@register("_contrib_quantized_conv", aliases=("quantized_conv",))
def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias, max_bias, kernel=(1, 1),
                   stride=(1, 1), pad=(0, 0), dilate=(1, 1), num_filter=1,
                   num_group=1, no_bias=False, layout="NCHW"):
    """int8 conv -> int32, NCHW (ref: quantized_conv.cc): ``im2col`` and
    one product per group, one launch of the int8 kernel each on the card.
    A 1x1 stride-1 convolution's columns are the flattened pixels (JAX's
    form)."""
    ci, o = data.shape[1], weight.shape[0]
    groups = int(num_group)
    cg, og = ci // groups, o // groups
    parts = []
    for g in range(groups):
        cols, (n, ho, wo) = im2col(
            data[:, g * cg:(g + 1) * cg], weight.shape[2:], stride, pad,
            dilate, ALIGN)
        parts.append(_int_dot(cols, weight_matrix(
            weight[g * og:(g + 1) * og], ALIGN)).reshape(n, ho, wo, og))
    acc = parts[0] if groups == 1 else torch.cat(parts, dim=3)
    acc = acc.permute(0, 3, 1, 2).contiguous()
    out_scale = _out_scale((min_data, max_data), (min_weight, max_weight),
                           acc.device)
    if bias is not None and not no_bias:
        acc = acc + _bias_int32(bias, min_bias, max_bias, out_scale) \
            .reshape(1, -1, 1, 1)
    mn, mx = _int32_range(out_scale)
    return acc, mn, mx


@register("_contrib_quantized_concat", aliases=("quantized_concat",))
def quantized_concat(*args, dim=1, num_args=None):
    """Concatenate int8 payloads after rescaling each to the widest input
    range (ref: quantized_concat.cc). Inputs: d0..dk-1, min0, max0, ..."""
    k = len(args) // 3
    datas = args[:k]
    mins = args[k::2][:k]
    maxs = args[k + 1::2][:k]
    dev = datas[0].device
    mx = torch.stack([torch.maximum(_f32(a, dev).abs(), _f32(b, dev).abs())
                      for a, b in zip(mins, maxs)]).max()
    s_out = _div(mx, 127.0)
    parts = [quantize_codes(_deq(d, mn_i, mx_i), s_out)
             for d, mn_i, mx_i in zip(datas, mins, maxs)]
    return torch.cat(parts, dim=int(dim)), -mx, mx


@register("_contrib_quantized_batch_norm", aliases=("quantized_batch_norm",))
def quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                         min_data, max_data, eps=1e-3,
                         min_calib_range=None, max_calib_range=None):
    """int8 BatchNorm with the folded scale and shift, re-quantized to the
    calibrated (or the output's own) range (ref: quantized_batch_norm.cc).
    """
    f = _deq(data, min_data, max_data)
    inv = _div(_f32(1.0, f.device), torch.sqrt(moving_var + eps))
    f = (f - moving_mean.reshape(1, -1, 1, 1)) \
        * (gamma * inv).reshape(1, -1, 1, 1) + beta.reshape(1, -1, 1, 1)
    if min_calib_range is not None:
        mn, mx, s = _calib_range(min_calib_range, max_calib_range,
                                 data.device)
    else:
        mn, mx = torch.min(f), torch.max(f)
        s = _scale(mn, mx)
    return quantize_codes(f, *s), mn, mx
