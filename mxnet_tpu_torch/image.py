"""``mx.image``: image decoding, resizing, cropping and augmentation, and
``ImageIter`` (counterpart of mxnet_tpu/image.py; ref:
python/mxnet/image/image.py).

The work is host work, as in the JAX package: OpenCV (``base.cv2``,
imported at the first call) decodes and resizes, numpy does the rest, and
every image is a host NDArray (``mx.cpu()``) over a numpy array; a batch is
moved to the card by its consumer or by ``io.DevicePrefetchIter``. The
random augmenters draw from Python's ``random`` and numpy's global
generator in the JAX package's order, so the same seeds give the same
crops, flips and jitters in both packages. The colour jitters share their
arithmetic with ``gluon.data.vision.transforms`` (``ops/image.py``).

The detection names (``ImageDetIter``, ``CreateDetAugmenter`` and the
``Det*`` augmenters) live in ``image_det`` and resolve here lazily, as in
the JAX package.
"""
from __future__ import annotations

import json
import os
import random as _pyrandom

import numpy as np

from .base import cv2 as _cv2
from .gluon.data.vision.transforms import _nd, _to_np
from .ops.image import contrast, saturation, hue_matrix, lighting_delta, \
    EIGVAL, EIGVEC

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "ResizeAug", "ForceResizeAug",
           "CenterCropAug", "RandomCropAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "LightingAug",
           "ColorJitterAug", "CreateAugmenter", "Augmenter", "ImageIter"]

_np_img = _to_np


def _hwc_nd(img, fresh=True):
    return _nd(img[..., None] if img.ndim == 2 else img, fresh=fresh)


def _decoded(img, flag, to_rgb, what):
    if img is None:
        raise IOError("cannot decode %s" % what)
    if flag and to_rgb:
        img = _cv2().cvtColor(img, _cv2().COLOR_BGR2RGB)
    return _hwc_nd(img)


def imread(filename, flag=1, to_rgb=True):
    """The image file ``filename`` as HWC uint8 (RGB, or BGR without
    ``to_rgb``; (H, W, 1) gray with ``flag=0``)."""
    cv2 = _cv2()
    img = cv2.imread(filename, cv2.IMREAD_COLOR if flag else
                     cv2.IMREAD_GRAYSCALE)
    return _decoded(img, flag, to_rgb, "image file %s" % filename)


def imdecode(buf, flag=1, to_rgb=True):
    """An encoded image (bytes, or an NDArray of them) as ``imread``
    gives it."""
    cv2 = _cv2()
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        buf = _np_img(buf).astype(np.uint8)
    img = cv2.imdecode(np.frombuffer(bytes(buf), np.uint8),
                       cv2.IMREAD_COLOR if flag else cv2.IMREAD_GRAYSCALE)
    return _decoded(img, flag, to_rgb, "image buffer")


def imresize(src, w, h, interp=1):
    """``src`` resized to (w, h) with OpenCV's interpolation code
    ``interp``."""
    out = _cv2().resize(np.ascontiguousarray(_np_img(src)), (w, h),
                        interpolation=interp)
    return _hwc_nd(out)


def resize_short(src, size, interp=2):
    """``src`` resized so that its shorter edge is ``size``."""
    img = _np_img(src)
    h, w = img.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(img, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The (x0, y0, w, h) crop of ``src``, resized to ``size`` = (w, h)
    if given and different."""
    img = _np_img(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != tuple(size):
        return imresize(img, size[0], size[1], interp)
    return _nd(img)


def center_crop(src, size, interp=2):
    """(the central ``size`` crop, its (x0, y0, w, h))."""
    img = _np_img(src)
    h, w = img.shape[:2]
    cw, ch = size
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return fixed_crop(img, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def random_crop(src, size, interp=2):
    """(a ``size`` crop at a random place, its (x0, y0, w, h)); the place
    is drawn from Python's ``random``."""
    img = _np_img(src)
    h, w = img.shape[:2]
    cw, ch = size
    x0 = _pyrandom.randint(0, max(0, w - cw))
    y0 = _pyrandom.randint(0, max(0, h - ch))
    return fixed_crop(img, x0, y0, min(cw, w), min(ch, h), size, interp), \
        (x0, y0, cw, ch)


def color_normalize(src, mean, std=None):
    """(src - mean) / std in float32."""
    img = _np_img(src).astype(np.float32)
    img -= np.asarray(mean, np.float32)
    if std is not None:
        img /= np.asarray(std, np.float32)
    return _nd(img, fresh=True)


class Augmenter:
    """An image -> image step; ``dumps()`` names it and its arguments."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _nd(_np_img(src)[:, ::-1])
        return src


class CastAug(Augmenter):
    def __init__(self, dtype="float32"):
        super().__init__(type=dtype)
        self.dtype = dtype

    def __call__(self, src):
        return _nd(_np_img(src).astype(self.dtype), fresh=True)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=list(np.ravel(mean)), std=list(np.ravel(std)))
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return _nd(_np_img(src).astype(np.float32) * alpha, fresh=True)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        img = _np_img(src).astype(np.float32)
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        return _nd(contrast(img, alpha), fresh=True)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        img = _np_img(src).astype(np.float32)
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        return _nd(saturation(img, alpha), fresh=True)


class LightingAug(Augmenter):
    """PCA lighting noise of standard deviation ``alphastd``, drawn from
    numpy's global generator (the eigen-decomposition given)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        rgb = lighting_delta(self.alphastd, self.eigval, self.eigvec)
        return _nd(_np_img(src).astype(np.float32) + rgb, fresh=True)


class RandomGrayAug(Augmenter):
    """Gray with probability ``p`` (ref: image.py RandomGrayAug)."""

    _MAT = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _nd(_np_img(src).astype(np.float32) @ self._MAT,
                       fresh=True)
        return src


class HueJitterAug(Augmenter):
    """A random hue rotation of up to ``hue`` half turns, in YIQ space
    (ref: image.py HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        t = hue_matrix(np.cos(alpha * np.pi), np.sin(alpha * np.pi)).T
        return _nd(_np_img(src).astype(np.float32) @ t, fresh=True)


class ColorJitterAug(Augmenter):
    """The brightness, contrast and saturation jitters given, in a random
    order."""

    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self.augs)
        _pyrandom.shuffle(augs)
        for a in augs:
            src = a(src)
        return src


def _pca_lighting(pca_noise):
    return LightingAug(pca_noise, np.array(EIGVAL), np.array(EIGVEC))


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """The standard classification augmenter list (ref: image.py
    CreateAugmenter): resize, crop to ``data_shape``, flip, cast to
    float32, colour jitter, lighting, normalise."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        auglist.append(_pca_lighting(pca_noise))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and np.asarray(mean).any():
        auglist.append(ColorNormalizeAug(mean, std if std is not None
                                         else np.ones(3)))
    return auglist


class ImageIter:
    """Batches of augmented images from a ``.rec`` file (``path_imgrec``)
    or from a ``.lst`` file (``path_imglist``: index, label, path per
    tab-separated line, the path under ``path_root``), read whole at
    construction. Each image goes through ``aug_list`` (default
    ``CreateAugmenter(data_shape, **kwargs)``) and becomes CHW float32; a
    batch is a host ``DataBatch`` whose last batch is filled from the
    epoch's start (``pad`` counts the filler). ``shuffle`` draws the order
    from Python's ``random`` at each ``reset()``."""

    _AUG_KEYS = ("resize", "rand_crop", "rand_resize", "rand_mirror",
                 "mean", "std", "brightness", "contrast", "saturation",
                 "pca_noise", "inter_method")

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, shuffle=False,
                 aug_list=None, label_width=1, **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self._shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in self._AUG_KEYS})
        self._items = []
        if path_imgrec:
            from .recordio import MXRecordIO
            rec = MXRecordIO(path_imgrec, "r")
            while True:
                raw = rec.read()
                if raw is None:
                    break
                self._items.append(("rec", raw))
            rec.close()
        elif path_imglist:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        continue
                    self._items.append(
                        ("file", (os.path.join(path_root or "", parts[-1]),
                                  float(parts[1]))))
        else:
            raise ValueError("need path_imgrec or path_imglist")
        self.reset()

    @property
    def provide_data(self):
        from .io.io import DataDesc
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        from .io.io import DataDesc
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self._order = list(range(len(self._items)))
        if self._shuffle:
            _pyrandom.shuffle(self._order)
        self._cursor = 0

    def __iter__(self):
        return self

    def _raw_sample(self, item):
        """(decoded image, raw label) of one item."""
        kind, payload = item
        if kind == "rec":
            from .recordio import unpack
            header, buf = unpack(payload)
            return imdecode(buf), header.label
        fn, label = payload
        return imread(fn), label

    def _load(self, item):
        img, label = self._raw_sample(item)
        for aug in self.auglist:
            img = aug(img)
        arr = _np_img(img)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3):
            arr = arr.transpose(2, 0, 1)
        lab = label if np.isscalar(label) or getattr(label, "ndim", 0) == 0 \
            else np.asarray(label).ravel()[0]
        return arr.astype(np.float32), np.float32(lab)

    def next(self):
        from .io.io import DataBatch
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        idxs = [self._order[i % n] for i in range(self._cursor, end)]
        pad = max(0, end - n)
        self._cursor = end
        imgs, labels = zip(*[self._load(self._items[i]) for i in idxs])
        return DataBatch(data=[_nd(np.stack(imgs), fresh=True)],
                         label=[_nd(np.stack(labels), fresh=True)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __next__(self):
        return self.next()


_DET_NAMES = ("DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
              "DetHorizontalFlipAug", "DetRandomCropAug",
              "DetRandomPadAug", "CreateMultiRandCropAugmenter",
              "CreateDetAugmenter", "ImageDetIter")


def __getattr__(name):
    if name in _DET_NAMES:
        from . import image_det
        return getattr(image_det, name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
