"""Batches moved to the card ahead of the step (counterpart of
mxnet_tpu/io/prefetch.py; SURVEY section 7.5, "double-buffered host to
HBM copies").

``DevicePrefetchIter`` walks any iterable of batches on a background thread
and places batch N+1 on the device while the consumer computes on batch N.
The default placement, for a CUDA target:

- copies each host array of the batch (an NDArray, a tensor or a numpy
  array, inside a ``DataBatch``, tuple, list or dict) with numpy into a
  pinned host buffer, from a ring of ``depth`` buffers reused across
  batches (pinned memory is slow to allocate);
- copies that buffer to the card on a side CUDA stream with
  ``non_blocking=True`` and records an event after the copies;
- before reusing a ring slot, waits on the event of that slot's last copy.

The consumer's ``next()`` makes its current stream wait on the batch's
event, and calls ``record_stream`` on each tensor it hands over, so the
caching allocator keeps the memory until the consumer's work on it is
done. For a CPU target the batch's arrays pass through as host arrays.

A ``place_fn`` replaces the default placement, as in the JAX package; it
runs on the background thread.

Telemetry, as in the JAX module: the ``io.prefetch.place`` fault point
fires in the worker before each placement; placed arrays are registered
``io`` in the allocation ledger; while the profiler or the flight recorder
is live, each placement is an ``io.batch_place`` span and each ``next()``
an ``io.batch_fetch`` span (the consumer's wait) with an
``io.prefetch_wait`` latency sample and the queue depth as an
``io.prefetch_queue_depth`` counter; the wait also books as goodput's
``input_wait`` while a goodput run is open. The live queue depth is the
``prefetch_queue_depth`` gauge of ``metrics()['io']``, and worker deaths
are counted there.
"""
from __future__ import annotations

import queue
import threading
import time as _time

import numpy as np
import torch

from .. import profiler as _profiler
from .. import storage as _storage
from .._debug import faultpoint as _faultpoint
from .._debug import goodput as _goodput
from ..context import Context, as_device
from ..ndarray.ndarray import NDArray
from . import _stats
from .io import DataBatch

__all__ = ["DevicePrefetchIter", "DevicePrefetcher"]

_SENTINEL = object()


def _target_device(sharding):
    """The device a batch goes to: the current context's, or that of
    ``sharding`` (a Context, a torch.device, or a NamedSharding on a
    one-device mesh)."""
    if sharding is None:
        return as_device(None)
    mesh = getattr(sharding, "mesh", None)
    if mesh is not None:
        return mesh.devices.flat[0]
    return as_device(sharding)


def _leaves(batch, fn):
    """``batch`` with ``fn`` applied to each array (NDArray, tensor or
    numpy array) in it; other values are kept."""
    if isinstance(batch, DataBatch):
        return DataBatch(
            data=_leaves(batch.data, fn) if batch.data is not None else None,
            label=_leaves(batch.label, fn) if batch.label is not None
            else None, pad=batch.pad, index=batch.index,
            bucket_key=batch.bucket_key, provide_data=batch.provide_data,
            provide_label=batch.provide_label)
    if isinstance(batch, (NDArray, torch.Tensor, np.ndarray)):
        return fn(batch)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_leaves(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _leaves(v, fn) for k, v in batch.items()}
    return batch


def _host_tensor(a):
    if isinstance(a, NDArray):
        return a._data.detach()
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a))
    return a.detach()


class _PinnedPlacer:
    """The default CUDA placement: a ring of ``depth`` slots, each a list
    of pinned buffers (one per array of a batch) and the event of its last
    copy; a side stream for the copies."""

    def __init__(self, device, depth):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.slots = [{"bufs": [], "event": None} for _ in range(depth)]
        self.n = 0

    def _buffer(self, slot, i, t):
        bufs = slot["bufs"]
        if i == len(bufs):
            bufs.append(None)
        b = bufs[i]
        if b is None or b.shape != t.shape or b.dtype != t.dtype:
            b = bufs[i] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
        return b

    def __call__(self, batch):
        slot = self.slots[self.n % len(self.slots)]
        self.n += 1
        if slot["event"] is not None:
            slot["event"].synchronize()     # its last copy has landed
        count = [0]
        placed = []

        def place(a):
            t = _host_tensor(a)
            if t.device.type != "cpu":
                out = t.to(self.device, non_blocking=True)
            else:
                buf = self._buffer(slot, count[0], t)
                count[0] += 1
                if t.dtype == torch.bfloat16:
                    buf.copy_(t)
                else:
                    np.copyto(buf.numpy(), t.numpy())
                out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                out.copy_(buf, non_blocking=True)
            placed.append(out)
            _storage.ledger_register(out, "io", site="io.prefetch")
            return NDArray(out, ctx=Context("gpu", self.device.index)) \
                if isinstance(a, NDArray) else out

        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = _leaves(batch, place)
            event = torch.cuda.Event()
            event.record(self.stream)
        slot["event"] = event
        return out, event, placed


def _place_host(batch):
    """The CPU placement: each array as a host tensor (an NDArray stays an
    NDArray on the CPU)."""
    def place(a):
        if isinstance(a, NDArray):
            return a if a._data.device.type == "cpu" \
                else NDArray(a._data.cpu(), ctx=Context("cpu"))
        return _host_tensor(a).cpu()
    return _leaves(batch, place)


class DevicePrefetchIter:
    """Wrap any iterable of batches; yield them placed on the device.

    Parameters
    ----------
    it : iterable of batches, restarted by ``reset()`` if it has one.
    place_fn : callable(batch) -> placed batch, run on the background
        thread; default: the pinned side-stream copy of the module
        docstring to the target device.
    depth : int, default 2
        Placed batches in flight (2: double buffering) and pinned ring
        slots.
    sharding : the target of the default placement (a Context, a
        torch.device or a NamedSharding on a one-device mesh); default the
        current context.
    """

    def __init__(self, it, place_fn=None, depth=2, sharding=None):
        self._it = it
        self._depth = depth
        self._placer = None
        if place_fn is None:
            device = _target_device(sharding)
            if device.type == "cuda":
                self._placer = _PinnedPlacer(device, depth)
            else:
                place_fn = _place_host
        self._place = place_fn
        self._q = None
        self._thread = None
        self._start()

    def _start(self):
        self._q = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        # a worker's exception reaches the consumer once; the iterator then
        # reads exhausted until reset() starts a new worker
        self._worker_failed = False
        # the gauge comes from the LIVE queue: a restart discards what sat
        # in the old one
        _stats.set_gauge("prefetch_queue_depth", self._q.qsize())
        q, stop = self._q, self._stop

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._it:
                    t0 = _time.perf_counter() if _profiler._LIVE else None
                    if _faultpoint.ACTIVE:
                        _faultpoint.check("io.prefetch.place")
                    if self._placer is not None:
                        placed = self._placer(batch)
                    else:
                        placed = (self._place(batch), None, ())
                    if t0 is not None:
                        _profiler.record_op(
                            "io.batch_place",
                            (_time.perf_counter() - t0) * 1e6,
                            category="io", lane="io",
                            args={"queue_depth": q.qsize()})
                    if stop.is_set() or not put(placed):
                        return
                    _stats.set_gauge("prefetch_queue_depth", q.qsize())
                    if t0 is not None:
                        _profiler.record_counter(
                            "io.prefetch_queue_depth", q.qsize(),
                            lane="io")
            except Exception as e:  # handed to the consumer, raised once
                # a counted event: how often reset() had to recover
                _stats.bump("prefetch_worker_deaths")
                put(e)
                return
            put(_SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def reset(self):
        """Stop the producer and restart the underlying iterator (also
        after a worker's exception). Needs a restartable source: one with
        ``reset()``, or a re-iterable such as a DataLoader."""
        self._stop.set()
        while self._thread.is_alive():
            try:        # unblock a worker waiting on a full queue
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()
        if hasattr(self._it, "reset"):
            self._it.reset()
        self._start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._worker_failed:
            raise StopIteration
        # how long the consumer waited on the producer; goodput.OPEN
        # joins the guard so that input_wait books with the recorder off
        t0 = _time.perf_counter() \
            if _profiler._LIVE or _goodput.OPEN else None
        item = self._q.get()
        _stats.set_gauge("prefetch_queue_depth", self._q.qsize())
        if t0 is not None:
            wait_us = (_time.perf_counter() - t0) * 1e6
            _profiler.record_op(
                "io.batch_fetch", wait_us, category="io", lane="io",
                args={"queue_depth": self._q.qsize()})
            _profiler.record_latency("io.prefetch_wait", wait_us)
            _profiler.record_counter("io.prefetch_queue_depth",
                                     self._q.qsize(), lane="io")
            if _goodput.OPEN:
                _goodput.note_input_wait(wait_us)
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, Exception):
            self._worker_failed = True
            raise item
        batch, event, placed = item
        if event is not None:
            stream = torch.cuda.current_stream(self._placer.device)
            stream.wait_event(event)
            for t in placed:
                t.record_stream(stream)
        return batch

    next = __next__


class DevicePrefetcher(DevicePrefetchIter):
    """A Gluon DataLoader's (data, label) batches placed on the device
    ahead of the step; ``len()`` is the loader's.

        for x, y in DevicePrefetcher(loader):
            ...train on device arrays...
    """

    def __init__(self, loader, depth=2, sharding=None):
        self._loader = loader
        super().__init__(loader, depth=depth, sharding=sharding)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        self.reset()
        return self
