"""Vision datasets (counterpart of mxnet_tpu/gluon/data/vision/datasets.py;
ref: python/mxnet/gluon/data/vision/datasets.py).

Datasets read from a local ``root`` in the standard formats: the idx
files of MNIST and Fashion-MNIST (``train-images-idx3-ubyte``, ...,
gzipped or not) and the pickled batches of CIFAR-10 and CIFAR-100. Nothing
is downloaded. With the files absent and ``MXTPU_SYNTHETIC_DATA=1`` set, a
deterministic synthetic set of the right shapes and classes stands in, as
in the JAX package. An item is (image, label): the image an HWC uint8 host
NDArray, the label an int32 scalar, or ``transform(image, label)``.

``ImageRecordDataset`` reads RecordIO records, raw-pixel
(``recordio.pack_raw_img``) or JPEG/PNG, and ``ImageFolderDataset`` the
image files of ``root/<class>/``: an item is the RGB HWC uint8 image (gray
as (H, W, 1) with ``flag=0``) and its label. Encoded images are decoded by
OpenCV (``base.cv2``, imported at the first call), as in the JAX package.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ..dataset import Dataset
from ....base import getenv as _getenv, cv2 as _cv2
from ....context import Context
from ....ndarray.ndarray import array as nd_array

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _synth_ok():
    return _getenv("MXTPU_SYNTHETIC_DATA", "0") == "1"


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        x = nd_array(self._data[idx], ctx=Context("cpu"))
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)


def _read_idx_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        _, n, h, w = struct.unpack(">IIII", f.read(16))
        return np.frombuffer(f.read(), np.uint8).reshape(n, h, w, 1)


def _read_idx_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        _, n = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), np.uint8).astype(np.int32)


class MNIST(_DownloadedDataset):
    """MNIST from ``root``'s idx files (``train-images-idx3-ubyte`` and
    ``train-labels-idx1-ubyte``, or the ``t10k-`` pair; ``.gz`` or not)."""

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }
    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        img, lab = self._files[self._train]
        for ext in ("", ".gz"):
            ip = os.path.join(self._root, img + ext)
            lp = os.path.join(self._root, lab + ext)
            if os.path.exists(ip) and os.path.exists(lp):
                self._data = _read_idx_images(ip)
                self._label = _read_idx_labels(lp)
                return
        if _synth_ok():
            # a bright row band per class, so that example trainings on
            # the synthetic set converge quickly
            n = 1024 if self._train else 256
            rng = np.random.RandomState(0 if self._train else 1)
            label = rng.randint(0, self._classes, n).astype(np.int32)
            data = (rng.rand(n, *self._shape) * 40.0)
            h = self._shape[0]
            band = max(h // self._classes, 1)
            for i in range(n):
                r0 = int(label[i]) * band % h
                data[i, r0:r0 + band] += 180.0
            self._data = np.clip(data, 0, 255).astype(np.uint8)
            self._label = label
            return
        raise IOError(
            "MNIST files not found under %s (place the idx-ubyte files "
            "there, or set MXTPU_SYNTHETIC_DATA=1)" % self._root)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from ``root/cifar-10-batches-py`` (``data_batch_1`` to
    ``_5``, or ``test_batch``)."""

    _classes = 10
    _shape = (32, 32, 3)

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _batch_files(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        if self._train:
            return [os.path.join(base, "data_batch_%d" % i)
                    for i in range(1, 6)]
        return [os.path.join(base, "test_batch")]

    def _label_key(self):
        return b"labels"

    def _get_data(self):
        files = self._batch_files()
        if all(os.path.exists(f) for f in files):
            datas, labels = [], []
            for fn in files:
                with open(fn, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                datas.append(d[b"data"].reshape(-1, 3, 32, 32)
                             .transpose(0, 2, 3, 1))
                labels.extend(d[self._label_key()])
            self._data = np.concatenate(datas).astype(np.uint8)
            self._label = np.asarray(labels, np.int32)
            return
        if _synth_ok():
            n = 1024 if self._train else 256
            rng = np.random.RandomState(2 if self._train else 3)
            self._data = (rng.rand(n, *self._shape) * 255).astype(np.uint8)
            self._label = rng.randint(0, self._classes, n).astype(np.int32)
            return
        raise IOError("CIFAR files not found under %s (place "
                      "cifar-10-batches-py there, or set "
                      "MXTPU_SYNTHETIC_DATA=1)" % self._root)


class CIFAR100(CIFAR10):
    """CIFAR-100 from ``root/cifar-100-python`` (``train`` or ``test``),
    fine labels or, with ``fine_label=False``, coarse ones."""

    _classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 train=True, fine_label=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batch_files(self):
        base = os.path.join(self._root, "cifar-100-python")
        return [os.path.join(base, "train" if self._train else "test")]

    def _label_key(self):
        return b"fine_labels" if self._fine else b"coarse_labels"


class ImageRecordDataset(Dataset):
    """Images of a RecordIO file: (RGB HWC uint8 host NDArray, label), or
    ``transform(image, label)``. ``flag=0`` gives the gray image as
    (H, W, 1)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        header, img = unpack_img(self._record[idx], self._flag)
        if img is None:
            raise IOError("cannot decode the image of record %d" % idx)
        return _item(img, header.label, self._transform)


def _item(img, label, transform):
    """(RGB HWC uint8 host NDArray, label) of a BGR or gray image."""
    img = img[..., ::-1] if img.ndim == 3 else img[..., None]
    x = nd_array(np.ascontiguousarray(img), ctx=Context("cpu"))
    if transform is not None:
        return transform(x, label)
    return x, label


class ImageFolderDataset(Dataset):
    """The images of ``root/<class>/<file>``, classes numbered in sorted
    folder order (``synsets``), files in sorted order, those ending in one
    of ``exts`` (``items``: (path, label))."""

    def __init__(self, root, flag=1, transform=None,
                 exts=(".jpg", ".jpeg", ".png")):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fn in sorted(os.listdir(path)):
                if fn.lower().endswith(exts):
                    self.items.append((os.path.join(path, fn), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        cv2 = _cv2()
        fn, label = self.items[idx]
        img = cv2.imread(fn, cv2.IMREAD_COLOR if self._flag else
                         cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError("cannot read image %s" % fn)
        return _item(img, label, self._transform)
