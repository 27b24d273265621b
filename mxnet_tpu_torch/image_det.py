"""Detection data pipeline: label-aware augmenters and ``ImageDetIter``
(counterpart of mxnet_tpu/image_det.py; ref: python/mxnet/image/detection.py — DetAugmenter hierarchy (:41),
DetBorrowAug (:67), DetRandomSelectAug (:92), DetHorizontalFlipAug
(:128), DetRandomCropAug (:154), DetRandomPadAug (:325),
CreateMultiRandCropAugmenter (:419), CreateDetAugmenter (:484),
ImageDetIter (:626)). Host work, as in ``image``: images are host
NDArrays, and the random draws are Python's ``random`` and numpy's global
generator in the JAX package's order, so the same seeds give the same crops,
pads, flips and labels in both packages.

Label convention matches the reference: the raw record label is
``[header_width, obj_width, <extra header...>, id, xmin, ymin, xmax,
ymax, <extra...>] * N`` with coordinates normalized to [0, 1]; parsed
labels are float arrays ``[N, obj_width]`` whose row is
``(class_id, xmin, ymin, xmax, ymax, ...)``. Batches pad the object
axis with -1 rows (the SSD target layers treat id < 0 as absent).
"""
from __future__ import annotations

import json
import random as _pyrandom
from math import sqrt

import numpy as np

from .image import (Augmenter, ImageIter, ResizeAug, ForceResizeAug,
                    CastAug, ColorJitterAug, ColorNormalizeAug,
                    RandomGrayAug, HueJitterAug, fixed_crop, _np_img, _nd,
                    _pca_lighting)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Detection base augmenter (ref: detection.py:41) — takes and
    returns (image, label) so geometry changes stay label-consistent."""

    def __init__(self, **kwargs):
        self._kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, np.ndarray):
                v = v.tolist()
            self._kwargs[k] = v

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError("Must override implementation.")


class DetBorrowAug(DetAugmenter):
    """Lift a label-invariant classification augmenter (ref: :67)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("Borrowing from invalid Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def dumps(self):
        return [self.__class__.__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly chosen augmenter, or none (ref: :92)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        if not isinstance(aug_list, (list, tuple)):
            aug_list = [aug_list]
        for aug in aug_list:
            if not isinstance(aug, DetAugmenter):
                raise ValueError("Allow DetAugmenter in list only")
        if not aug_list:
            skip_prob = 1
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [x.dumps() for x in self.aug_list]]

    def __call__(self, src, label):
        if _pyrandom.random() < self.skip_prob:
            return src, label
        _pyrandom.shuffle(self.aug_list)
        return self.aug_list[0](src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Random horizontal flip of image AND boxes (ref: :128)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            src = _nd(_np_img(src)[:, ::-1])
            label = label.copy()
            tmp = 1.0 - label[:, 1]
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Constrained random crop (ref: :154): the crop must cover at
    least `min_object_covered` of some box; boxes with post-crop
    coverage below `min_eject_coverage` are dropped."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.enabled = (area_range[1] > 0
                        and area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0]
                        <= aspect_ratio_range[1])

    def __call__(self, src, label):
        img = _np_img(src)
        crop = self._random_crop_proposal(label, img.shape[0],
                                          img.shape[1])
        if crop:
            x, y, w, h, label = crop
            src = fixed_crop(src, x, y, w, h, None)
        return src, label

    @staticmethod
    def _areas(boxes):
        return (np.maximum(0, boxes[:, 3] - boxes[:, 1])
                * np.maximum(0, boxes[:, 2] - boxes[:, 0]))

    @staticmethod
    def _intersect(boxes, xmin, ymin, xmax, ymax):
        left = np.maximum(boxes[:, 0], xmin)
        right = np.minimum(boxes[:, 2], xmax)
        top = np.maximum(boxes[:, 1], ymin)
        bot = np.minimum(boxes[:, 3], ymax)
        invalid = np.where(np.logical_or(left >= right, top >= bot))[0]
        out = boxes.copy()
        out[:, 0], out[:, 1], out[:, 2], out[:, 3] = left, top, right, bot
        out[invalid, :] = 0
        return out

    def _satisfies(self, label, xmin, ymin, xmax, ymax, width, height):
        if (xmax - xmin) * (ymax - ymin) < 2:
            return False
        x1, y1 = xmin / width, ymin / height
        x2, y2 = xmax / width, ymax / height
        areas = self._areas(label[:, 1:])
        valid = np.where(areas * width * height > 2)[0]
        if valid.size < 1:
            return False
        inter = self._intersect(label[valid, 1:], x1, y1, x2, y2)
        cov = self._areas(inter) / areas[valid]
        cov = cov[np.where(cov > 0)[0]]
        return cov.size > 0 and np.amin(cov) > self.min_object_covered

    def _update_labels(self, label, crop_box, height, width):
        xmin = crop_box[0] / width
        ymin = crop_box[1] / height
        w = crop_box[2] / width
        h = crop_box[3] / height
        out = label.copy()
        out[:, (1, 3)] -= xmin
        out[:, (2, 4)] -= ymin
        out[:, (1, 3)] /= w
        out[:, (2, 4)] /= h
        out[:, 1:5] = np.clip(out[:, 1:5], 0, 1)
        cov = self._areas(out[:, 1:]) * w * h / self._areas(label[:, 1:])
        valid = np.logical_and(out[:, 3] > out[:, 1],
                               out[:, 4] > out[:, 2])
        valid = np.where(np.logical_and(valid,
                                        cov > self.min_eject_coverage))[0]
        if valid.size < 1:
            return None
        return out[valid, :]

    def _random_crop_proposal(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return ()
        min_area = self.area_range[0] * height * width
        max_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            if ratio <= 0:
                continue
            h = int(round(sqrt(min_area / ratio)))
            max_h = int(round(sqrt(max_area / ratio)))
            if round(max_h * ratio) > width:
                max_h = int((width + 0.4999999) / ratio)
            max_h = min(max_h, height)
            h = min(h, max_h)
            if h < max_h:
                h = _pyrandom.randint(h, max_h)
            w = int(round(h * ratio))
            area = w * h
            if area < min_area:
                h += 1
                w = int(round(h * ratio))
                area = w * h
            if area > max_area:
                h -= 1
                w = int(round(h * ratio))
                area = w * h
            if not (min_area <= area <= max_area and 0 <= w <= width
                    and 0 <= h <= height):
                continue
            y = _pyrandom.randint(0, max(0, height - h))
            x = _pyrandom.randint(0, max(0, width - w))
            if self._satisfies(label, x, y, x + w, y + h, width, height):
                new_label = self._update_labels(label, (x, y, w, h),
                                                height, width)
                if new_label is not None:
                    return (x, y, w, h, new_label)
        return ()


class DetRandomPadAug(DetAugmenter):
    """Random expansion padding (ref: :325) — the inverse zoom of
    random crop; boxes shrink into the padded canvas."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(128, 128, 128)):
        if not isinstance(pad_val, (list, tuple)):
            pad_val = (pad_val,)
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = (area_range[1] > 1.0
                        and area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0]
                        <= aspect_ratio_range[1])

    def __call__(self, src, label):
        img = _np_img(src)
        height, width = img.shape[:2]
        pad = self._random_pad_proposal(label, height, width)
        if pad:
            x, y, w, h, label = pad
            canvas = np.empty((h, w, img.shape[2]), img.dtype)
            canvas[...] = np.asarray(self.pad_val, img.dtype)
            canvas[y:y + height, x:x + width] = img
            src = _nd(canvas, fresh=True)
        return src, label

    @staticmethod
    def _update_labels(label, pad_box, height, width):
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] * width + pad_box[0]) / pad_box[2]
        out[:, (2, 4)] = (out[:, (2, 4)] * height + pad_box[1]) / pad_box[3]
        return out

    def _random_pad_proposal(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return ()
        min_area = self.area_range[0] * height * width
        max_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            if ratio <= 0:
                continue
            h = int(round(sqrt(min_area / ratio)))
            max_h = int(round(sqrt(max_area / ratio)))
            if round(h * ratio) < width:
                h = int((width + 0.499999) / ratio)
            h = max(h, height)
            h = min(h, max_h)
            if h < max_h:
                h = _pyrandom.randint(h, max_h)
            w = int(round(h * ratio))
            if (h - height) < 2 or (w - width) < 2:
                continue
            y = _pyrandom.randint(0, max(0, h - height))
            x = _pyrandom.randint(0, max(0, w - width))
            new_label = self._update_labels(label, (x, y, w, h), height,
                                            width)
            return (x, y, w, h, new_label)
        return ()


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """One DetRandomSelectAug over per-constraint croppers (ref: :419).
    Scalar args broadcast; list args must agree in length."""
    def _as_list(v):
        return list(v) if isinstance(v, (list, tuple)) and \
            isinstance(v[0], (list, tuple)) else [v]

    mocs = min_object_covered if isinstance(min_object_covered,
                                            (list, tuple)) \
        else [min_object_covered]
    arrs = _as_list(aspect_ratio_range)
    ars = _as_list(area_range)
    mecs = min_eject_coverage if isinstance(min_eject_coverage,
                                            (list, tuple)) \
        else [min_eject_coverage]
    mas = max_attempts if isinstance(max_attempts, (list, tuple)) \
        else [max_attempts]
    n = max(len(mocs), len(arrs), len(ars), len(mecs), len(mas))
    for name, lst in (("min_object_covered", mocs),
                      ("aspect_ratio_range", arrs), ("area_range", ars),
                      ("min_eject_coverage", mecs), ("max_attempts", mas)):
        if len(lst) not in (1, n):
            raise ValueError(
                "%s has %d entries; list arguments must agree in length "
                "(%d) or be scalar" % (name, len(lst), n))

    def pick(lst, i):
        return lst[i] if len(lst) == n else lst[0]

    crops = [DetRandomCropAug(min_object_covered=pick(mocs, i),
                              aspect_ratio_range=pick(arrs, i),
                              area_range=pick(ars, i),
                              min_eject_coverage=pick(mecs, i),
                              max_attempts=pick(mas, i))
             for i in range(n)]
    return DetRandomSelectAug(crops, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmenter list (ref: detection.py:484):
    resize -> color jitter -> random crop (prob rand_crop) -> random
    pad (prob rand_pad) -> flip -> force-resize to data_shape ->
    cast/normalize."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(_pca_lighting(pca_noise)))
    if hue > 0:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if rand_crop > 0:
        crop_augs = CreateMultiRandCropAugmenter(
            min_object_covered=min_object_covered,
            aspect_ratio_range=aspect_ratio_range,
            area_range=(min(area_range[0], 1.0),
                        min(area_range[1], 1.0)),
            min_eject_coverage=min_eject_coverage,
            max_attempts=max_attempts, skip_prob=(1 - rand_crop))
        auglist.append(crop_augs)
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad_aug = DetRandomPadAug(
            aspect_ratio_range=aspect_ratio_range,
            area_range=(max(area_range[0], 1.0),
                        max(area_range[1], 1.0)),
            max_attempts=max_attempts, pad_val=pad_val)
        auglist.append(DetRandomSelectAug([pad_aug],
                                          skip_prob=(1 - rand_pad)))
    # force resize AFTER geometry augs (labels are normalized, so a
    # resize is label-invariant)
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    has_mean = mean is not None and np.asarray(mean).any()
    has_std = std is not None and (np.asarray(std) != 1.0).any()
    if has_mean or has_std:
        # std-only normalization is valid (ref CreateDetAugmenter
        # appends the normalizer for either)
        auglist.append(DetBorrowAug(ColorNormalizeAug(
            mean if mean is not None else np.zeros(3),
            std if std is not None else np.ones(3))))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator over .rec/.lst sources (ref: detection.py:626).

    Labels batch as [batch, max_objects, obj_width] padded with -1
    rows; `label_shape` is estimated from the dataset on construction.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, aug_list=None, data_name="data",
                 label_name="label", **kwargs):
        aug_keys = ("resize", "rand_crop", "rand_pad", "rand_gray",
                    "rand_mirror", "mean", "std", "brightness", "contrast",
                    "saturation", "pca_noise", "hue", "inter_method",
                    "min_object_covered", "aspect_ratio_range",
                    "area_range", "min_eject_coverage", "max_attempts",
                    "pad_val")
        det_kwargs = {k: v for k, v in kwargs.items() if k in aug_keys}
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=[],
                         **{k: v for k, v in kwargs.items()
                            if k not in aug_keys})
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **det_kwargs)
        self._data_name = data_name
        self._label_name = label_name
        self.label_shape = self._estimate_label_shape()

    @property
    def provide_label(self):
        from .io.io import DataDesc
        return [DataDesc(self._label_name,
                         (self.batch_size,) + self.label_shape)]

    @staticmethod
    def _check_valid_label(label):
        """ref: detection.py _check_valid_label."""
        if len(label.shape) != 2 or label.shape[1] < 5:
            raise RuntimeError("Label with shape (1+, 5+) required, %s "
                               "received." % str(label))
        valid = np.where(np.logical_and(label[:, 0] >= 0,
                                        np.logical_and(
                                            label[:, 3] > label[:, 1],
                                            label[:, 4] > label[:, 2])))[0]
        if valid.size < 1:
            raise RuntimeError("Invalid label occurs.")

    @staticmethod
    def _parse_label(label):
        """Raw header-prefixed flat label -> [N, obj_width]
        (ref: detection.py _parse_label)."""
        raw = np.asarray(label, np.float32).ravel()
        if raw.size < 7:
            raise RuntimeError("Label shape is invalid: %s"
                               % (raw.shape,))
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if (raw.size - header_width) % obj_width != 0:
            raise RuntimeError(
                "Label shape %s inconsistent with annotation width %d."
                % (raw.shape, obj_width))
        out = raw[header_width:].reshape(-1, obj_width)
        valid = np.where(np.logical_and(out[:, 3] > out[:, 1],
                                        out[:, 4] > out[:, 2]))[0]
        if valid.size < 1:
            raise RuntimeError("Encounter sample with no valid label.")
        out = out[valid, :]
        ImageDetIter._check_valid_label(out)
        return out

    def _estimate_label_shape(self):
        """Scan the dataset labels for max object count (ref: :706).
        Reads ONLY the record headers — no image decode."""
        max_count, obj_width = 0, 5
        for item in self._items:
            parsed = self._parse_label(self._raw_label(item))
            max_count = max(max_count, parsed.shape[0])
            obj_width = parsed.shape[1]
        return (max_count, obj_width)

    def _raw_label(self, item):
        kind, payload = item
        if kind == "rec":
            from .recordio import unpack
            return unpack(payload)[0].label
        return payload[1]

    def _load(self, item):
        img, label = self._raw_sample(item)
        label = self._parse_label(label)
        for aug in self.auglist:
            img, label = aug(img, label)
        arr = _np_img(img)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3):
            arr = arr.transpose(2, 0, 1)
        padded = np.full(self.label_shape, -1.0, np.float32)
        n = min(label.shape[0], self.label_shape[0])
        padded[:n, :label.shape[1]] = label[:n]
        return arr.astype(np.float32), padded

    def reshape(self, data_shape=None, label_shape=None):
        """ref: detection.py reshape."""
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.label_shape = tuple(label_shape)

    def sync_label_shape(self, it, verbose=False):
        """Sync label padding with another ImageDetIter (train/val
        pairs must batch identically; ref: detection.py
        sync_label_shape)."""
        assert isinstance(it, ImageDetIter)
        train_shape = self.label_shape
        val_shape = it.label_shape
        shape = (max(train_shape[0], val_shape[0]),
                 max(train_shape[1], val_shape[1]))
        self.reshape(label_shape=shape)
        it.reshape(label_shape=shape)
        return it
