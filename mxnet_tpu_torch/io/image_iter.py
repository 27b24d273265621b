"""ImageRecordIter: batches of augmented images from a RecordIO file
(counterpart of mxnet_tpu/io/image_iter.py; ref: src/io/
iter_image_recordio_2.cc and image_iter_common.h).

Raw-pixel records (``recordio.pack_raw_img``) need no decoder; JPEG and
PNG records are decoded by ``cv2.imdecode`` in the pool's threads (OpenCV
releases the interpreter lock while it decodes and resizes). A
``preprocess_threads`` pool decodes, cuts, flips and reorders each image,
the last three with numpy views only (the crop a slice, the mirror ``img[:, ::-1]``, BGR to RGB
``img[..., ::-1]``), and a producer thread assembles the batch ahead of the
consumer with one copy (``np.stack`` of the views, already NCHW) and, for a
float dtype, one vectorised normalise per batch. No torch op runs in these
threads: batches are host NDArrays over the numpy result, moved to a card
by the consumer or by ``DevicePrefetchIter``. ``resize`` and the upscale of
an image smaller than ``data_shape`` are OpenCV's ``INTER_LINEAR``, so
every batch is the JAX package's byte for byte.

The sample order is the JAX package's exactly: epoch ``e`` shuffles with
``random.Random(seed + e)``, and sample ``i`` of the batch starting at
``start`` draws its crop and flip from ``random.Random(seed + e * 1000003
+ start + i)``.
"""
from __future__ import annotations

import concurrent.futures as _fut
import queue as _queue
import random as _pyrandom
import threading

import numpy as np
import torch

from .io import DataIter, DataBatch, DataDesc
from ..base import cv2 as _cv2
from ..context import Context
from ..gluon.data.vision.transforms import _resize
from ..ndarray.ndarray import NDArray
from ..recordio import MXRecordIO, MXIndexedRecordIO, unpack, decode_raw_img

__all__ = ["ImageRecordIter"]


def _augment(raw, data_shape, rand_crop, rand_mirror, resize, rng_seed):
    """Record bytes -> (uint8 CHW RGB view, float32 label)."""
    header, img_bytes = unpack(raw)
    label = header.label
    img = decode_raw_img(img_bytes)
    if img is None:
        cv2 = _cv2()
        img = cv2.imdecode(np.frombuffer(img_bytes, np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise IOError("failed to decode image record")
    rng = _pyrandom.Random(rng_seed)
    if resize:
        h, w = img.shape[:2]
        scale = resize / min(h, w)
        img = _resize(img, (int(w * scale + 0.5), int(h * scale + 0.5)))
    ch, cw = data_shape[1], data_shape[2]
    h, w = img.shape[:2]
    if h < ch or w < cw:
        img = _resize(img, (max(w, cw), max(h, ch)))
        h, w = img.shape[:2]
    if rand_crop:
        y0 = rng.randint(0, h - ch) if h > ch else 0
        x0 = rng.randint(0, w - cw) if w > cw else 0
    else:
        y0, x0 = (h - ch) // 2, (w - cw) // 2
    img = img[y0:y0 + ch, x0:x0 + cw]
    if rand_mirror and rng.random() < 0.5:
        img = img[:, ::-1]
    img = img[..., ::-1].transpose(2, 0, 1)       # BGR HWC -> RGB CHW
    return img, np.float32(
        label if np.isscalar(label) or getattr(label, "ndim", 0) == 0
        else label[0])


class ImageRecordIter(DataIter):
    """Batches of ``data_shape`` (C, H, W) images and their labels from
    ``path_imgrec`` (with ``path_imgidx`` for random access; else one scan
    collects the record offsets). ``dtype="uint8"`` hands over the pixels
    unnormalised (normalise on the card, a quarter of the bytes to move);
    a float dtype subtracts ``mean_*`` and divides by ``std_*``.
    ``round_batch`` fills the last batch from the epoch's start (``pad``
    counts the filler); without it the short batch is dropped.
    ``prefetch_buffer`` batches are assembled ahead on a producer thread
    (0: on the caller's). ``label_width`` is taken, and the label is a
    record's first value, as in the JAX package."""

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 shuffle=False, rand_crop=False, rand_mirror=False, resize=0,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, preprocess_threads=4, label_width=1, seed=0,
                 round_batch=True, prefetch_buffer=2, dtype="float32",
                 **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        if len(self.data_shape) != 3:
            raise ValueError("data_shape must be (C, H, W), got %s"
                             % (self.data_shape,))
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
        std = np.array([std_r, std_g, std_b], np.float32)
        self._mean = mean if mean.any() else None
        self._std = std if (std != 1.0).any() else None
        self._dtype = np.dtype(dtype)
        self._seed = seed
        self._epoch = 0
        self._round_batch = round_batch
        self._pool = _fut.ThreadPoolExecutor(max_workers=preprocess_threads)
        self._nprefetch = max(0, int(prefetch_buffer))
        if path_imgidx:
            self._rec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = MXRecordIO(path_imgrec, "r")
            self._keys = None
            self._offsets = []
            while True:
                pos = self._rec.tell()
                if self._rec.read() is None:
                    break
                self._offsets.append(pos)
        self._prefetcher = None
        # the record file is shared by the consumer and the producer
        # thread: a seek and its read go together
        self._read_lock = threading.Lock()
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape,
                         dtype=self._dtype)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        """Start the next epoch. The old producer is stopped and joined
        first: it must not see the new epoch's order and take its first
        batch."""
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
        self._epoch += 1
        order = list(self._keys if self._keys is not None
                     else range(len(self._offsets)))
        if self._shuffle:
            _pyrandom.Random(self._seed + self._epoch).shuffle(order)
        self._order = order
        self._cursor = 0
        if self._nprefetch > 0:
            self._prefetcher = _Prefetcher(self, self._nprefetch)

    def _read_raw(self, key):
        with self._read_lock:
            if self._keys is not None:
                return self._rec.read_idx(key)
            self._rec.seek_pos(self._offsets[key])
            return self._rec.read()

    def _assemble_next(self):
        """The next batch, made on the calling thread (the producer's, or
        the consumer's without prefetch)."""
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        pad = max(0, end - n)
        if pad and not self._round_batch:
            raise StopIteration
        idxs = [self._order[i % n] for i in range(self._cursor, end)]
        start = self._cursor
        self._cursor = end
        raws = [self._read_raw(k) for k in idxs]
        futs = [self._pool.submit(
            _augment, raw, self.data_shape, self._rand_crop,
            self._rand_mirror, self._resize,
            self._seed + self._epoch * 1000003 + start + i)
            for i, raw in enumerate(raws)]
        imgs, labels = zip(*[f.result() for f in futs])
        data = np.stack(imgs)                   # [N, C, H, W] uint8
        if self._dtype != np.uint8:
            data = data.astype(self._dtype)
            if self._mean is not None:
                data -= self._mean.astype(self._dtype)[:, None, None]
            if self._std is not None:
                data /= self._std.astype(self._dtype)[:, None, None]
        host = Context("cpu")
        return DataBatch(
            data=[NDArray(torch.from_numpy(data), ctx=host)],
            label=[NDArray(torch.from_numpy(np.asarray(labels, np.float32)),
                           ctx=host)],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label)

    def next(self):
        if self._prefetcher is not None:
            return self._prefetcher.next()
        return self._assemble_next()


class _Prefetcher:
    """The producer thread: assembles batches into a queue of ``depth``;
    an exception or the end of the epoch is handed to the consumer."""

    def __init__(self, it, depth):
        self._q = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._terminal = None   # True after StopIteration, or the Exception

        def run():
            while not self._stop.is_set():
                try:
                    item = it._assemble_next()
                except StopIteration:
                    item = None
                except Exception as e:  # handed to the consumer's next()
                    item = e
                # a bounded put that keeps watching the stop flag, so that
                # stop() never waits on a full queue
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except _queue.Full:
                        continue
                if item is None or isinstance(item, Exception):
                    return

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="image-record-prefetch")
        self._thread.start()

    def next(self):
        if self._terminal is not None:
            if isinstance(self._terminal, Exception):
                raise self._terminal
            raise StopIteration
        item = self._q.get()
        if item is None:
            self._terminal = True
            raise StopIteration
        if isinstance(item, Exception):
            self._terminal = item
            raise item
        return item

    def stop(self):
        """Stop the producer and join it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=10)
