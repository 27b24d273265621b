"""Vision transforms (counterpart of
mxnet_tpu/gluon/data/vision/transforms.py; ref:
python/mxnet/gluon/data/vision/transforms.py).

Blocks over HWC images (uint8 or float; NDArrays, tensors or numpy
arrays), computed on the host with numpy and returned as host NDArrays
(``mx.cpu()``): the DataLoader moves whole batches to the card. ``Compose``
chains transforms; ``ToTensor`` turns HWC uint8 into CHW float32 / 255.
Every copy is numpy's, and an output wraps its numpy array without a
further copy (``_nd``): DataLoader worker threads then never enter
torch's CPU thread pool, which several threads at once oversubscribe.

Resizes are OpenCV's ``cv2.resize``, as in the JAX package, through the
port's one lazy import of ``cv2`` (``base.cv2``): every interpolation code
(0 nearest, 1 linear, 2 cubic, 3 area, 4 Lanczos) gives the JAX package's
bytes, uint8 and float alike. A resize without OpenCV raises ImportError.

The random transforms draw from Python's ``random`` and numpy's global
generator, as the JAX package's do, so the same seeds give the same
draws.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np
import torch

from ...block import Block
from ....base import canonical_dtype, cv2 as _cv2
from ....context import Context
from ....ndarray.ndarray import NDArray, array as nd_array, \
    _from_numpy, _np_dtype
from ....ops.image import contrast, saturation, hue_matrix, lighting_delta

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "CropResize",
           "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomLighting", "RandomColorJitter"]

def _to_np(x):
    """The image as numpy, read only: a host tensor (or NDArray) is seen
    in place, anything else copied to the host."""
    t = x._data if isinstance(x, NDArray) else x
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.device.type == "cpu" and t.dtype != torch.bfloat16:
            return t.numpy()
        return x.asnumpy() if isinstance(x, NDArray) else \
            NDArray(t).asnumpy()
    return np.asarray(x)


_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _nd(a, fresh=False):
    """A host NDArray holding ``a``, float64 and int64 narrowed as
    ``nd.array`` does. ``fresh``: ``a`` is a new array that nothing else
    holds, so it is wrapped without a copy; otherwise it is copied."""
    a = np.asarray(a)
    narrow = _NARROW.get(a.dtype)
    if narrow is not None:
        a, fresh = a.astype(narrow), True
    if not (fresh and a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")
    return NDArray(_from_numpy(a), ctx=Context("cpu"))


def _resize(img, size, interpolation=1):
    """``cv2.resize(img, size, interpolation=...)`` for size = (width,
    height). A 2-D image gives a 2-D result, as OpenCV's does."""
    return _cv2().resize(np.ascontiguousarray(img),
                         (int(size[0]), int(size[1])),
                         interpolation=interpolation)


class Compose(Block):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = transforms

    def forward(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        dt = canonical_dtype(self._dtype)
        if dt == torch.bfloat16:
            return nd_array(_to_np(x), ctx=Context("cpu"), dtype=dt)
        return _nd(_to_np(x).astype(_np_dtype(dt)), fresh=True)


class ToTensor(Block):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW for a
    batch)."""

    def forward(self, x):
        img = _to_np(x).astype(np.float32) / 255.0
        if img.ndim == 3:
            img = img.transpose(2, 0, 1)
        elif img.ndim == 4:
            img = img.transpose(0, 3, 1, 2)
        return _nd(img)                 # made contiguous by the copy


class Normalize(Block):
    """(x - mean) / std over the channels of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def forward(self, x):
        img = _to_np(x).astype(np.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return _nd((img - mean) / std, fresh=True)


def _size2(size):
    return size if isinstance(size, (list, tuple)) else (size, size)


def _hwc(out):
    return out[..., None] if out.ndim == 2 else out


class Resize(Block):
    """Resize to ``size`` = (width, height) (or a square); with
    ``keep_ratio`` the image is scaled to fit inside it."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = _size2(size)
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        img = _to_np(x)
        w, h = self._size
        if self._keep:
            ih, iw = img.shape[:2]
            scale = min(w / iw, h / ih)
            w, h = int(iw * scale + 0.5), int(ih * scale + 0.5)
        return _nd(_hwc(_resize(img, (w, h), self._interp)), fresh=True)


class CenterCrop(Block):
    """The central (width, height) crop; an image smaller than the crop is
    first resized up to it."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = _size2(size)
        self._interp = interpolation

    def forward(self, x):
        img = _to_np(x)
        cw, ch = self._size
        h, w = img.shape[:2]
        if h < ch or w < cw:
            img = _resize(img, (max(w, cw), max(h, ch)), self._interp)
            h, w = img.shape[:2]
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        return _nd(_hwc(img[y0:y0 + ch, x0:x0 + cw]))


class RandomResizedCrop(Block):
    """A crop of random area (``scale`` of the image) and aspect ratio
    (``ratio``), resized to ``size``; after 10 misses, ``CenterCrop``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = _size2(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        img = _to_np(x)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = _pyrandom.uniform(*self._scale) * area
            ar = _pyrandom.uniform(*self._ratio)
            cw = int(round((target * ar) ** 0.5))
            ch = int(round((target / ar) ** 0.5))
            if cw <= w and ch <= h:
                x0 = _pyrandom.randint(0, w - cw)
                y0 = _pyrandom.randint(0, h - ch)
                crop = img[y0:y0 + ch, x0:x0 + cw]
                return _nd(_hwc(_resize(crop, self._size, self._interp)),
                           fresh=True)
        return CenterCrop(self._size, self._interp)(_nd(img))


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        img = _to_np(x)
        if _pyrandom.random() < self._p:
            img = img[:, ::-1]
        return _nd(img)


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        img = _to_np(x)
        if _pyrandom.random() < self._p:
            img = img[::-1]
        return _nd(img)


class _RandomJitter(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _alpha(self):
        return 1.0 + _pyrandom.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        return _nd(_to_np(x).astype(np.float32) * self._alpha(), fresh=True)


class RandomContrast(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype(np.float32)
        return _nd(contrast(img, self._alpha()), fresh=True)


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        img = _to_np(x).astype(np.float32)
        return _nd(saturation(img, self._alpha()), fresh=True)


class CropResize(Block):
    """A fixed (x, y, width, height) crop, then a resize to ``size`` if
    given (ref: transforms.py:238 CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x0, self._y0 = int(x), int(y)
        self._w, self._h = int(width), int(height)
        self._size = _size2(size) if size is not None else None
        self._interp = interpolation

    def forward(self, x):
        img = _to_np(x)
        out = img[self._y0:self._y0 + self._h,
                  self._x0:self._x0 + self._w]
        if self._size is not None:
            out = _resize(out, self._size, self._interp)
        return _nd(_hwc(out))


class RandomHue(_RandomJitter):
    """Hue jitter as a rotation of the YIQ chroma (ref: transforms.py:502
    RandomHue, src/operator/image/image_random.cc)."""

    def forward(self, x):
        img = _to_np(x).astype(np.float32)
        alpha = _pyrandom.uniform(-self._amount, self._amount)
        t = hue_matrix(np.cos(alpha * np.pi), np.sin(alpha * np.pi))
        return _nd(np.dot(img, t.T), fresh=True)


class RandomLighting(Block):
    """AlexNet's PCA lighting noise, drawn from numpy's generator."""

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        img = _to_np(x).astype(np.float32)
        return _nd(img + lighting_delta(self._alpha), fresh=True)


class RandomColorJitter(Block):
    """Brightness, contrast, saturation and hue jitters (those given) in a
    random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            x = t(x)
        return x
