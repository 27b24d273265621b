"""Core data iterators (counterpart of mxnet_tpu/io/io.py; ref:
python/mxnet/io/io.py, src/io/iter_csv.cc, iter_libsvm.cc,
iter_mnist.cc).

A batch's arrays are NDArrays on the current context of the thread that
takes the batch (``gpu(0)`` unless it entered another). ``PrefetchingIter``
runs its source iterator on a background thread under ``with mx.cpu():``,
so batches are prepared in host memory there, and moves each batch to the
caller's context in ``next()``, on the caller's thread.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time as _time

import numpy as np

from .. import profiler as _profiler
from .._debug import goodput as _goodput
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, array as nd_array
from . import _stats

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "ResizeIter", "PrefetchingIter", "MNISTIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """Name, shape, type and layout of an input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One mini-batch: lists of data and label arrays, and the count of
    padding samples at its end."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [d.shape for d in self.data] if self.data else []
        lshapes = [l.shape for l in self.label] if self.label else []
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, shapes, lshapes)


class DataIter:
    """Iterator base."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """The input as a list of (name, numpy array) (ref: io/utils.py
    _init_data)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) <= 1:
            data = collections.OrderedDict(
                [(default_name, d) for d in data])
        else:
            data = collections.OrderedDict(
                [("_%d_%s" % (i, default_name), d)
                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    out = collections.OrderedDict()
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out[k] = np.asarray(v)
    return list(out.items())


class NDArrayIter(DataIter):
    """Batches of in-memory arrays (a numpy array, an NDArray, a list or a
    dict of them), shuffled by numpy's global generator at each reset with
    ``shuffle``. ``last_batch_handle`` decides a short last batch: "pad"
    fills it from the start of the data (``pad`` counts the filler),
    "discard" drops it, "roll_over" fills it as "pad" does and starts the
    next epoch where the filler ended."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _slice(self, arrays):
        start = self.cursor
        end = min(start + self.batch_size, self.num_data)
        out = []
        for _, v in arrays:
            part = v[self.idx[start:end]]
            if end - start < self.batch_size:
                if self.last_batch_handle == "discard":
                    return None
                padn = self.batch_size - (end - start)
                part = np.concatenate([part, v[self.idx[:padn]]], axis=0)
            out.append(nd_array(part))
        return out

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self._slice(self.data)
        if data is None:  # discard
            raise StopIteration
        label = self._slice(self.label) if self.label else []
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class _WrappedIter(DataIter):
    """A reader that loads its file into numpy and serves it through an
    ``NDArrayIter`` (``self._iter``)."""

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class CSVIter(_WrappedIter):
    """Rows of a CSV file reshaped to ``data_shape`` (labels from
    ``label_csv``, else zeros); ``round_batch`` pads the last batch, else
    it is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0],) + tuple(label_shape),
                             np.float32)
        self._iter = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")


class LibSVMIter(_WrappedIter):
    """LibSVM's sparse text format (``label index:value ...``) read into
    dense rows of ``data_shape``."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 label_libsvm=None, label_shape=None, **kwargs):
        super().__init__(batch_size)
        feat_dim = int(np.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(feat_dim, np.float32)
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        data = np.stack(rows).reshape((-1,) + tuple(data_shape))
        label = np.asarray(labels, np.float32)
        self._iter = NDArrayIter(data, label, batch_size,
                                 last_batch_handle="pad")


class ResizeIter(DataIter):
    """``size`` batches of ``data_iter`` per epoch, restarting it when it
    runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration


def _batch_to(batch, ctx):
    """The batch with its data and label arrays on ``ctx``."""
    dev = ctx.device

    def move(arrays):
        if arrays is None:
            return None
        return [a if not isinstance(a, NDArray) or a._data.device == dev
                else NDArray(a._data.to(dev), ctx=ctx) for a in arrays]
    batch.data = move(batch.data)
    batch.label = move(batch.label)
    return batch


class PrefetchingIter(DataIter):
    """Up to ``prefetch_depth`` batches of one source iterator prepared
    ahead on a background thread (ref: io.py:347 PrefetchingIter,
    src/io/iter_prefetcher.h); see the module docstring for where they
    are made and moved."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        super().__init__(iters[0].batch_size)
        assert len(iters) == 1, "PrefetchingIter takes one source iterator"
        self.iter = iters[0]
        self._depth = prefetch_depth
        self._queue = _queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._epoch = 0  # a batch of an earlier epoch is dropped
        self._start()

    def _start(self):
        epoch = self._epoch

        def worker():
            with Context("cpu"):
                while not self._stop.is_set():
                    try:
                        batch = self.iter.next()
                    except StopIteration:
                        self._queue.put((epoch, None))
                        return
                    self._queue.put((epoch, batch))
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def reset(self):
        # stop the worker, drain the queue so that a worker blocked in
        # put() sees the stop, and join it before the source is reset: no
        # batch of the old epoch can then reach the new one's queue
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except _queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join()
        while not self._queue.empty():
            self._queue.get_nowait()
        # the gauge re-seeded from the LIVE (drained) queue
        _stats.set_gauge("prefetch_queue_depth", self._queue.qsize())
        self._stop.clear()
        self._epoch += 1
        self.iter.reset()
        self._start()

    def next(self):
        # the consumer's wait: a span, the io.prefetch_wait latency and
        # goodput's input_wait (the JAX package's accounting)
        t0 = _time.perf_counter() \
            if _profiler._LIVE or _goodput.OPEN else None
        batch = self._next_impl()
        _stats.set_gauge("prefetch_queue_depth", self._queue.qsize())
        if t0 is not None:
            wait_us = (_time.perf_counter() - t0) * 1e6
            _profiler.record_op(
                "io.prefetch_next", wait_us, category="io", lane="io",
                args={"queue_depth": self._queue.qsize()})
            _profiler.record_latency("io.prefetch_wait", wait_us)
            _profiler.record_counter("io.prefetch_queue_depth",
                                     self._queue.qsize(), lane="io")
            if _goodput.OPEN:
                _goodput.note_input_wait(wait_us)
        return batch

    def _next_impl(self):
        ctx = current_context()
        while True:
            epoch, batch = self._queue.get()
            if epoch != self._epoch:
                continue
            if batch is None:
                raise StopIteration
            return _batch_to(batch, ctx)

    def __del__(self):
        self._stop.set()


class MNISTIter(_WrappedIter):
    """MNIST's idx files (``image``, ``label``) as float32 images in [0, 1],
    flat (``flat=True``) or (1, 28, 28), and float32 labels; shuffled by
    numpy's global generator with ``shuffle``."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, **kwargs):
        super().__init__(batch_size)
        with open(image, "rb") as f:
            _, n, h, w = np.frombuffer(f.read(16), ">i4")
            data = np.frombuffer(f.read(), np.uint8).reshape(n, h, w)
        with open(label, "rb") as f:
            np.frombuffer(f.read(8), ">i4")
            lab = np.frombuffer(f.read(), np.uint8).astype(np.float32)
        data = data.astype(np.float32) / 255.0
        data = data.reshape(n, h * w) if flat else data.reshape(n, 1, h, w)
        self._iter = NDArrayIter(data, lab, batch_size, shuffle=shuffle,
                                 last_batch_handle="pad")
