"""int8 quantization (counterpart of mxnet_tpu/contrib/quantization.py;
ref: python/mxnet/contrib/quantization.py).

``quantize_net`` is a Gluon-level pass: it calibrates the inputs of a
network's Dense and NCHW Conv2D layers ('naive': min/max over the
calibration batches; 'entropy': KL-optimal thresholds), then replaces each
with an int8 twin. The twin stores its weight as int8 with per-output-
channel symmetric scales, quantizes its input with the calibrated
threshold, and computes the product with the int8 kernel's dequantizing
form (``kernels/quantized_matmul.py``, ``scales = act_scale * w_scale``):
one launch per layer on the card, the plain version on the CPU. A
convolution goes through an int8 im2col first (``ops/quantized.py``),
where the JAX package used XLA's int32 convolution; the integer sums are
exact either way, so the two packages compute the same values. The bias
is added after the product, as in the JAX package.

BatchNorm, activations, pooling and residual adds stay float32 PyTorch
between the int8 layers, as in the JAX package's quantized network. A
convolution's output is an NCHW view of NHWC memory (the product's own
layout): no transpose is made, and the next layer's im2col reads it in
place.

The histogram helpers are numpy, copied from the JAX module (the port
imports no file of the JAX package).
"""
from __future__ import annotations

import logging

import numpy as _np
import torch

from ..context import current_context
from ..gluon import nn as _nn
from ..gluon.block import HybridBlock
from ..kernels import quantized_matmul as QM
from ..base import weak_scalar
from ..ndarray.ndarray import nd_io
from ..ops.quantized import (ALIGN, _div, _f32, _operand, _promote, im2col,
                             quantize_codes, weight_matrix)

__all__ = ["quantize_net", "calib_graph", "CalibrationCollector",
           "quantize", "dequantize", "requantize", "quantized_layers",
           "_get_optimal_threshold"]


def _tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        _np.asarray(v))


# -- primitive ops (ref: src/operator/quantization/quantize.cc etc.) --------

@nd_io
def quantize(data, min_range, max_range, out_type="int8"):
    """Symmetric int8 quantization of float data at a given range
    (ref: quantize.cc): ``clip(round(x * (127 / max(amax, 1e-8))))``, with
    the range and the scale in ``x``'s dtype, as the JAX package computes
    them. Returns (q, -amax, amax)."""
    x = _tensor(data)
    dt = x.dtype
    amax = torch.maximum(_f32(min_range, x.device).to(dt).abs(),
                         _f32(max_range, x.device).to(dt).abs())
    scale = _div(_f32(127.0, x.device).to(dt),
                 torch.clamp_min(amax, weak_scalar(1e-8, dt)))
    q = torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)
    return q, -amax, amax


@nd_io
def dequantize(data, min_range, max_range, out_type="float32"):
    """ref: dequantize.cc: ``q * (amax / 127)``, ``amax / 127`` in the
    range's type."""
    q = _tensor(data)
    (lo, hi), _ = _promote(_operand(min_range, q.device),
                           _operand(max_range, q.device))
    amax = torch.maximum(lo.abs(), hi.abs())
    return q.to(torch.float32) * _div(amax, 127.0).to(torch.float32)


def requantize(data, min_range, max_range, out_min, out_max):
    """int32 accumulator -> int8 at a new range (ref: requantize.cc)."""
    return quantize(dequantize(data, min_range, max_range), out_min, out_max)


# -- calibration (ref: quantization.py _LayerOutputCollector /
#    _LayerOutputMinMaxCollector / _get_optimal_thresholds) ----------------

def _smooth_distribution(p, eps=1e-4):
    """Replace zeros with eps, taking the mass off non-zero entries
    (ref: src/operator/quantization/calibrate.cc SmoothDistribution)."""
    is_zero = p == 0
    n_zeros = int(is_zero.sum())
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        return None
    eps1 = eps * n_zeros / n_nonzeros
    if eps1 >= 1.0:
        return None
    return p + eps * is_zero - eps1 * (~is_zero)


def _get_optimal_threshold(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence-optimal clip threshold from a symmetric histogram, the
    TensorRT-style sweep of the reference (calibrate.cc
    CalibrateComputeCPU): for each candidate window, ``p`` folds the
    clipped outlier mass into its edge bins while ``q`` (the int8
    reconstruction) has none there, so KL(p||q) grows with the clipped
    mass and the sweep balances clipping against resolution."""
    hist = _np.asarray(hist, dtype=_np.float64)
    hist_edges = _np.asarray(hist_edges, dtype=_np.float64)
    num_bins = hist.size
    zero_bin = num_bins // 2
    half_q = num_quantized_bins // 2
    thresholds = []
    divergences = []
    for i in range(half_q, zero_bin + 1):
        start, stop = zero_bin - i, zero_bin + i + 1
        sliced = hist[start + 1:stop - 1]
        p = _np.zeros(stop - start)
        p[0] = hist[:start + 1].sum()
        p[-1] = hist[stop - 1:].sum()
        p[1:-1] = sliced
        # q: quantize the window WITHOUT the folded outliers
        sliced_full = _np.zeros_like(p)
        sliced_full[1:-1] = sliced
        nmerged = p.size // num_quantized_bins
        q = _np.zeros_like(p)
        for j in range(num_quantized_bins):
            s = j * nmerged
            t = p.size if j == num_quantized_bins - 1 else (j + 1) * nmerged
            chunk = sliced_full[s:t]
            nz = int((chunk != 0).sum())
            if nz:
                q[s:t] = _np.where((p[s:t] != 0), chunk.sum() / nz, 0.0)
        ps = _smooth_distribution(p)
        qs = _smooth_distribution(q)
        thresholds.append(float(hist_edges[min(stop, num_bins)]))
        if ps is None or qs is None:
            divergences.append(_np.inf)
            continue
        pn, qn = ps / ps.sum(), qs / qs.sum()
        divergences.append(float((pn * _np.log(pn / qn)).sum()))
    if not thresholds:
        return float(abs(hist_edges[-1]))
    return thresholds[int(_np.argmin(divergences))]


class CalibrationCollector:
    """Accumulates per-layer input statistics during calibration forwards
    (ref: quantization.py _LayerOutputMinMaxCollector). In 'naive' mode a
    tensor's min and max are taken where it lies (on the card, two scalars
    cross to the host); 'entropy' mode histograms it in numpy on the
    host."""

    def __init__(self, mode="naive", num_bins=8001):
        assert mode in ("naive", "entropy")
        self.mode = mode
        self.num_bins = num_bins
        self.min_max = {}     # name -> (min, max)
        self.hists = {}       # name -> (hist, edges)

    def collect(self, name, arr):
        a = None
        if isinstance(arr, torch.Tensor) and self.mode == "naive":
            lo, hi = torch.aminmax(arr.detach())
            mn, mx = float(lo.item()), float(hi.item())
        else:
            a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) \
                else _np.asarray(arr)
            mn, mx = float(a.min()), float(a.max())
        if name in self.min_max:
            pmn, pmx = self.min_max[name]
            mn, mx = min(mn, pmn), max(mx, pmx)
        self.min_max[name] = (mn, mx)
        if self.mode == "entropy":
            amax = max(abs(mn), abs(mx), 1e-8)
            prev = self.hists.get(name)
            if prev is not None and prev[1][-1] >= amax:
                # new batch fits the existing range: accumulate in place
                self.hists[name] = (prev[0] + _np.histogram(
                    a, bins=self.num_bins,
                    range=(prev[1][0], prev[1][-1]))[0], prev[1])
            else:
                hist, edges = _np.histogram(a, bins=self.num_bins,
                                            range=(-amax, amax))
                if prev is not None:
                    # range grew: fold the old histogram into the new,
                    # wider bins via its bin centers (approximate re-bin,
                    # keeps every batch's statistics, not just the last)
                    old_hist, old_edges = prev
                    centers = (old_edges[:-1] + old_edges[1:]) / 2.0
                    hist += _np.histogram(centers, bins=self.num_bins,
                                          range=(-amax, amax),
                                          weights=old_hist)[0]
                self.hists[name] = (hist, edges)

    def threshold(self, name):
        if self.mode == "entropy" and name in self.hists:
            hist, edges = self.hists[name]
            return _get_optimal_threshold(hist, edges)
        mn, mx = self.min_max.get(name, (0.0, 1.0))
        return max(abs(mn), abs(mx), 1e-8)


# -- quantized layers -------------------------------------------------------

def _quantize_weight(w):
    """Per-output-channel symmetric int8: ``w_scale = max(max |w| over the
    channel, 1e-8) / 127`` in ``w``'s dtype, codes ``clip(round(w /
    w_scale), -127, 127)`` (round half to even). Returns (wq, w_scale)."""
    amax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
    w_scale = _div(torch.clamp_min(amax, weak_scalar(1e-8, w.dtype)), 127.0)
    return quantize_codes(w, w_scale.reshape((-1,) + (1,) * (w.dim() - 1))), \
        w_scale


class _QuantizedLayer(HybridBlock):
    """State and stages shared by the int8 Dense and Conv2D: ``_wq`` (int8,
    the float weight's layout), ``_w_scale`` (f32 per output channel),
    ``_act_scale`` (threshold / 127, a Python float), ``_bias``; and derived
    from them ``_act_scale_t`` (float32 on the weight's device), ``_scales``
    (the f32 product ``act_scale * w_scale``, the kernel's epilogue) and
    ``_wmat`` (the K-contiguous product operand)."""

    def __init__(self, layer, act_threshold):
        super().__init__(prefix=layer.prefix)
        # the int8 state keeps no autograd history back to the float weight
        with torch.no_grad():
            wq, w_scale = _quantize_weight(layer.weight._tensor())
            bias = layer.bias._tensor() if "bias" in layer._reg_params \
                else None
            self._set_state(wq, w_scale, float(act_threshold) / 127.0, bias)
        self.act = getattr(layer, "act", None)

    def _set_state(self, wq, w_scale, act_scale, bias):
        self._wq = wq
        self._w_scale = w_scale
        self._act_scale = float(act_scale)
        # a plain tensor (the float layer's bias is a torch Parameter, which
        # torch would register on this block)
        self._bias = None if bias is None else bias.detach()
        self._act_scale_t = _f32(self._act_scale, wq.device)
        # JAX's act_scale * w_scale: the Python scale is weak, so the
        # product is in w_scale's dtype
        self._scales = (weak_scalar(self._act_scale, w_scale.dtype)
                        * w_scale).to(torch.float32)
        self._wmat = self._weight_matrix(wq)

    def quantize_input(self, x):
        """The int8 codes of the layer's input: ``clip(round(x /
        act_scale), -127, 127)``, the Python scale weak (a bf16 input
        divides by the scale rounded to bf16, in bf16)."""
        return quantize_codes(x, self._act_scale_t, weak=True)

    def product(self, cols):
        """The dequantized product of (M, K) int8 columns with the weight:
        one launch of the int8 kernel's scaled form on the card."""
        return QM.quantized_matmul(cols, self._wmat, self._scales)

    def _finish(self, out, bias_shape):
        if self._bias is not None:
            out = out + self._bias.reshape(bias_shape)
        if self.act is not None:
            out = self.act(out)
        return out


class _QuantizedDense(_QuantizedLayer):
    """int8 Dense: weight int8 with per-output-channel scales, input
    quantized with the calibrated threshold, the int8 product dequantized
    in the kernel's epilogue (ref: quantized_fully_connected.cc)."""

    def __init__(self, dense, act_threshold):
        super().__init__(dense, act_threshold)
        self._units = dense._units
        self._flatten = dense._flatten

    @staticmethod
    def _weight_matrix(wq):
        return wq.t()                                   # (in, out)

    def columns(self, xq):
        """(M, K) int8 rows of the product, and the output's leading
        shape."""
        return xq.reshape(-1, xq.shape[-1]), tuple(xq.shape[:-1])

    def forward(self, x, *args):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        cols, lead = self.columns(self.quantize_input(x))
        out = self.product(cols).reshape(lead + (self._units,))
        return self._finish(out, (-1,))


class _QuantizedConv2D(_QuantizedLayer):
    """int8 Conv2D (NCHW) with per-output-channel weight scales
    (ref: quantized_conv.cc): int8 im2col, then the kernel's dequantizing
    product; the output is an NCHW view of the product's NHWC memory."""

    def __init__(self, conv, act_threshold):
        super().__init__(conv, act_threshold)
        self._kernel = tuple(int(k) for k in conv._kwargs["kernel"])
        self._strides = conv._kwargs.get("stride", (1, 1))
        self._padding = conv._kwargs.get("pad", (0, 0))
        self._dilation = conv._kwargs.get("dilate", (1, 1))

    @staticmethod
    def _weight_matrix(wq):
        return weight_matrix(wq, ALIGN)

    def columns(self, xq):
        """im2col of the int8 input (K padded to a multiple of 16), and
        (n, ho, wo)."""
        return im2col(xq, self._kernel, self._strides, self._padding,
                      self._dilation, ALIGN)

    def forward(self, x, *args):
        cols, (n, ho, wo) = self.columns(self.quantize_input(x))
        out = self.product(cols)
        del cols
        out = out.reshape(n, ho, wo, -1).permute(0, 3, 1, 2)
        return self._finish(out, (1, -1, 1, 1))


# -- the network pass -------------------------------------------------------

def _walk_children(block, prefix=""):
    """Yield (parent, local_name, path, child) with dot-separated paths, so
    nested blocks with the same local name ('0' in two branches) stay
    distinct in calibration stats and exclude matching."""
    for name, child in list(block.named_children()):
        path = name if not prefix else prefix + "." + name
        yield block, name, path, child
        yield from _walk_children(child, path)


def quantized_layers(network):
    """{path: int8 layer} of a network ``quantize_net`` has converted."""
    return {path: child for _, _, path, child in _walk_children(network)
            if isinstance(child, _QuantizedLayer)}


def _device_of(network):
    for p in network._collect_params_with_prefix().values():
        if p._data is not None:
            return p._tensor().device
    return current_context().device


def quantize_net(network, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 num_calib_examples=None, logger=None):
    """Quantize a Gluon network's Dense and NCHW Conv2D layers to int8, in
    place (ref: quantization.py:quantize_net). ``calib_data`` is an
    iterable of input batches (tensors, numpy arrays, or tuples whose first
    item is one; moved to the network's device); with
    ``calib_mode='none'`` (or no data) each layer's threshold is 1.0.
    Layers named in ``exclude_layers`` (by local name, path or class
    name), grouped convolutions and channels-last convolutions stay
    float. Returns ``network``."""
    assert quantized_dtype in ("int8", "auto"), \
        "only int8 quantization is supported"
    exclude = set(exclude_layers or [])
    collector = CalibrationCollector(
        mode=calib_mode if calib_mode != "none" else "naive")

    targets = [(parent, name, path, child)
               for parent, name, path, child in _walk_children(network)
               if isinstance(child, (_nn.Dense, _nn.Conv2D))
               and name not in exclude and path not in exclude
               and child.__class__.__name__ not in exclude
               and getattr(child, "_groups", 1) == 1
               and (isinstance(child, _nn.Dense)
                    or child._kwargs.get("layout") == "NCHW")]

    if calib_data is not None and calib_mode != "none":
        # capture each target layer's input by hooking its forward (the
        # port's blocks always run eagerly: hybridize() is a flag)
        dev = _device_of(network)
        hooks = []
        for _, _, path, child in targets:
            orig = child.forward

            def hooked(x, *a, _name=path, _orig=orig, **kw):
                collector.collect(_name, x)
                return _orig(x, *a, **kw)
            child.forward = hooked
            hooks.append(child)
        seen = 0
        try:
            for batch in calib_data:
                data = batch[0] if isinstance(batch, (tuple, list)) \
                    else batch
                if isinstance(data, torch.Tensor):
                    data = data.to(dev)
                else:
                    data = torch.as_tensor(_np.asarray(data, "float32"),
                                           device=dev)
                network(data)
                seen += data.shape[0]
                if num_calib_examples is not None and \
                        seen >= num_calib_examples:
                    break
        finally:
            for child in hooks:
                del child.forward
        (logger or logging).info(
            "Calibrated %d layers on %d examples (%s mode)",
            len(targets), seen, collector.mode)

    for parent, name, path, child in targets:
        thr = collector.threshold(path)
        if isinstance(child, _nn.Dense):
            q = _QuantizedDense(child, thr)
        else:
            q = _QuantizedConv2D(child, thr)
        setattr(parent, name, q)
    return network


def calib_graph(qsym, arg_params, aux_params, collector, calib_mode="naive",
                quantized_dtype="int8", logger=None):
    """Symbolic-path shim kept for API parity (ref: quantization.py
    calib_graph). The Gluon path (quantize_net) is the primary flow."""
    raise NotImplementedError(
        "symbolic calib_graph is not implemented; use quantize_net on a "
        "Gluon network")
