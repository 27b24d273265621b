"""The image operator family, ``mx.nd.image`` (counterpart of
mxnet_tpu/ops/image.py; ref: src/operator/image/image_random.cc, resize.cc
and crop.cc).

The ops run on their input's device. Layouts are the reference's: HWC (or
NHWC batched) images, except ``normalize``, which takes ``to_tensor``'s
CHW (NCHW) float output. ``resize`` is ``jax.image.resize``'s, as in the
JAX package: nearest, or linear with its triangle filter widened when
downsampling (``resize_weights``, also the BilinearResize2D op's).

The random ops draw from the port's generator of their input's device
(``random.generator``), or from the ``torch.Generator`` passed as ``key``;
the JAX package draws through threefry keys, so the streams differ by
design while the laws, shapes and dtypes are its. Each draw stays on the
device: no op reads a random factor back to the host. The colour jitters'
arithmetic is written once, below, for these ops, the host transforms
(``gluon.data.vision.transforms``) and ``image``'s augmenters.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import random as _random
from .registry import register

__all__ = ["resize_weights", "jax_resize", "gray", "blend", "contrast",
           "saturation", "hue_matrix", "lighting_delta"]

# The colour jitters' arithmetic on float32 HWC images, written once: on
# tensors for the random ops below, on numpy arrays for the host transforms
# (``gluon.data.vision.transforms``) and ``image``'s augmenters.
GRAY = (0.299, 0.587, 0.114)       # ITU-R BT.601 luma weights
TYIQ = ((0.299, 0.587, 0.114),
        (0.596, -0.274, -0.321),
        (0.211, -0.523, 0.311))
ITYIQ = ((1.0, 0.956, 0.621),
         (1.0, -0.272, -0.647),
         (1.0, -1.107, 1.705))
EIGVAL = (55.46, 4.794, 1.148)     # AlexNet's PCA of ImageNet RGB
EIGVEC = ((-0.5675, 0.7192, 0.4009),
          (-0.5808, -0.0045, -0.8140),
          (-0.5836, -0.6948, 0.4203))
_GRAY = np.array(GRAY, np.float32)


def gray(img):
    """Per-pixel luma, the channel axis kept."""
    return (img * _GRAY if isinstance(img, np.ndarray) else
            img * img.new_tensor(GRAY)).sum(-1, keepdims=True)


def blend(img, other, alpha):
    return img * alpha + other * (1 - alpha)


def contrast(img, alpha):
    """Blend with the image's mean luma."""
    return blend(img, gray(img).mean(), alpha)


def saturation(img, alpha):
    """Blend with each pixel's luma."""
    return blend(img, gray(img), alpha)


def hue_matrix(u, w):
    """The RGB -> RGB matrix of a hue rotation by the angle whose cosine and
    sine are ``u`` and ``w`` (a rotation of the YIQ chroma), applied as
    ``img @ m.T``."""
    bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], np.float32)
    return np.array(ITYIQ, np.float32) @ bt @ np.array(TYIQ, np.float32)


def lighting_delta(alphastd, eigval=EIGVAL, eigvec=EIGVEC):
    """AlexNet's PCA lighting noise: the RGB offset for one image, drawn
    from numpy's global generator (ImageNet's eigen-decomposition unless
    one is given)."""
    a = np.random.normal(0, alphastd, 3).astype(np.float32)
    return (np.asarray(eigvec, np.float32) * a
            * np.asarray(eigval, np.float32)).sum(-1)


@register("_image_to_tensor", aliases=("image_to_tensor",))
def to_tensor(data):
    """HWC [0, 255] -> CHW float32 [0, 1]; NHWC -> NCHW."""
    x = data.to(torch.float32) / 255.0
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize", aliases=("image_normalize",))
def normalize(data, mean=0.0, std=1.0):
    """(data - mean) / std per channel of a CHW/NCHW float image."""
    mean = torch.as_tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.as_tensor(std, dtype=data.dtype, device=data.device)
    if mean.dim() == 1:
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1) if std.dim() == 1 else std
    elif std.dim() == 1:
        std = std.reshape(-1, 1, 1)
    return (data - mean) / std


@register("_image_flip_left_right", aliases=("image_flip_left_right",))
def flip_left_right(data):
    return torch.flip(data, (data.dim() - 2,))


@register("_image_flip_top_bottom", aliases=("image_flip_top_bottom",))
def flip_top_bottom(data):
    return torch.flip(data, (data.dim() - 3,))


def _cast(x, dtype):
    """``x`` (float) in ``dtype``; an integer type saturates at its range
    and truncates, as XLA's conversion does."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        x = torch.clamp(x, info.min, info.max)
    return x.to(dtype)


def _uniform(key, data, low, high):
    """One float32 draw from U(low, high) on ``data``'s device."""
    gen = key if key is not None else _random.generator(data.device)
    u = torch.rand((), generator=gen, device=data.device)
    return u * (float(high) - float(low)) + float(low)


def _coin(key, data, p):
    return _uniform(key, data, 0.0, 1.0) < p


@register("_image_random_flip_left_right",
          aliases=("image_random_flip_left_right",))
def random_flip_left_right(data, key=None, p=0.5):
    return torch.where(_coin(key, data, p), flip_left_right(data), data)


@register("_image_random_flip_top_bottom",
          aliases=("image_random_flip_top_bottom",))
def random_flip_top_bottom(data, key=None, p=0.5):
    return torch.where(_coin(key, data, p), flip_top_bottom(data), data)


def resize_weights(in_size, out_size, device):
    """``jax.image.resize``'s linear weights, [in_size, out_size] float32:
    a triangle filter at the half-pixel sample points, widened by
    in/out when downsampling, each column normalised, and zero where the
    sample point falls outside the input."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kscale = torch.clamp(inv_scale, min=1.0).to(device)
    inv_scale = inv_scale.to(device)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        in_size, dtype=torch.float32, device=device)[:, None]) / kscale
    w = torch.clamp(1 - torch.abs(x), min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(
        torch.finfo(torch.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def jax_resize(x, shape, method="linear"):
    """``jax.image.resize(x, shape, method)`` for "nearest" and "linear"
    (antialiased), in float (the input's float dtype, else float32)."""
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).to(torch.int64).to(x.device)
            x = torch.index_select(x, d, idx)
            continue
        w = resize_weights(m, n, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w,
                                          dims=([x.dim() - 1], [0])), -1, d)
    return x


@register("_image_resize", aliases=("image_resize",))
def resize(data, size=(0, 0), keep_ratio=False, interp=1):
    """Resize HWC/NHWC to ``size`` = (w, h); interp 0 nearest, else
    linear; ``keep_ratio`` scales the short side to size[0]."""
    if isinstance(size, int):
        size = (size, size)
    ax = data.dim() - 3
    H, W = data.shape[ax], data.shape[ax + 1]
    if keep_ratio:
        s = float(size[0]) / min(H, W)
        new_h, new_w = int(round(H * s)), int(round(W * s))
    else:
        new_w, new_h = int(size[0]), int(size[1]) or int(size[0])
    shape = list(data.shape)
    shape[ax], shape[ax + 1] = new_h, new_w
    out = jax_resize(data.to(torch.float32), shape,
                     "nearest" if int(interp) == 0 else "linear")
    return _cast(out, data.dtype)


@register("_image_crop", aliases=("image_crop",))
def image_crop(data, x=0, y=0, width=1, height=1):
    """The (x, y, width, height) crop of an HWC/NHWC image."""
    ax = data.dim() - 3
    out = data.narrow(ax, int(y), int(height))
    return out.narrow(ax + 1, int(x), int(width))


@register("_image_random_brightness", aliases=("image_random_brightness",))
def random_brightness(data, key=None, min_factor=0.0, max_factor=1.0):
    """Scale by a factor drawn from U(min_factor, max_factor)."""
    a = _uniform(key, data, min_factor, max_factor)
    return _cast(data.to(torch.float32) * a, data.dtype)


@register("_image_random_contrast", aliases=("image_random_contrast",))
def random_contrast(data, key=None, min_factor=0.0, max_factor=1.0):
    """Blend with the image's mean luma (each image's, batched)."""
    a = _uniform(key, data, min_factor, max_factor)
    x = data.to(torch.float32)
    if x.dim() == 3:
        return _cast(contrast(x, a), data.dtype)
    return _cast(blend(x, gray(x).mean((-3, -2, -1), keepdim=True), a),
                 data.dtype)


@register("_image_random_saturation", aliases=("image_random_saturation",))
def random_saturation(data, key=None, min_factor=0.0, max_factor=1.0):
    """Blend with each pixel's luma."""
    a = _uniform(key, data, min_factor, max_factor)
    x = data.to(torch.float32)
    return _cast(blend(x, gray(x), a), data.dtype)


@register("_image_random_hue", aliases=("image_random_hue",))
def random_hue(data, key=None, min_factor=0.0, max_factor=1.0):
    """Rotate the YIQ chroma by U(min_factor, max_factor) turns."""
    alpha = _uniform(key, data, min_factor, max_factor) * (2.0 * math.pi)
    x = data.to(torch.float32)
    u, w = torch.cos(alpha), torch.sin(alpha)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, u, -w]),
                       torch.stack([zero, w, u])])
    m = x.new_tensor(ITYIQ) @ rot @ x.new_tensor(TYIQ)
    return _cast(x @ m.T, data.dtype)


@register("_image_random_color_jitter",
          aliases=("image_random_color_jitter",))
def random_color_jitter(data, key=None, brightness=0.0, contrast=0.0,
                        saturation=0.0, hue=0.0):
    """Brightness, contrast, saturation and hue jitters, those given, in
    that order."""
    x = data
    if brightness > 0:
        x = random_brightness(x, key, 1 - brightness, 1 + brightness)
    if contrast > 0:
        x = random_contrast(x, key, 1 - contrast, 1 + contrast)
    if saturation > 0:
        x = random_saturation(x, key, 1 - saturation, 1 + saturation)
    if hue > 0:
        x = random_hue(x, key, -hue, hue)
    return x


@register("_image_random_lighting", aliases=("image_random_lighting",))
def random_lighting(data, key=None, alpha_std=0.05):
    """AlexNet's PCA lighting noise: + eigvec @ (N(0, alpha_std) *
    eigval)."""
    gen = key if key is not None else _random.generator(data.device)
    alpha = torch.randn(3, generator=gen, device=data.device) * alpha_std
    delta = data.new_tensor(EIGVEC, dtype=torch.float32) @ (
        alpha * data.new_tensor(EIGVAL, dtype=torch.float32))
    return _cast(data.to(torch.float32) + delta, data.dtype)
