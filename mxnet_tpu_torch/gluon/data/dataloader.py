"""DataLoader with parallel workers (counterpart of
mxnet_tpu/gluon/data/dataloader.py; ref:
python/mxnet/gluon/data/dataloader.py).

``num_workers > 0`` fetches and batchifies batches concurrently, by
default in a thread pool feeding a bounded window of ``prefetch`` batches
(numpy's copies release the GIL), or with ``thread_pool=False`` in a pool
of forked processes that hand batches back through POSIX shared memory
(``_to_shm``/``_from_shm``), for datasets whose Python work would hold the
GIL. The pool forks, as the reference's and the JAX package's do, so that
the children inherit the dataset and its transforms (which need not
pickle); a child makes no CUDA call and runs one intra-op thread.

Where a batch lands. Samples are fetched and batchified on the host: a
worker (a thread, a process, or the caller itself with no workers) runs
under ``with mx.cpu():``, so arrays that a dataset, a transform or a
``batchify_fn`` makes without a context stay in host memory. The batch
moves to the caller's current context (``gpu(0)`` unless the caller
entered another) on the caller's own thread, as each batch is yielded.
No worker thread or process makes a CUDA call but the pinning below, and
a worker process makes none at all.

``pin_memory=True`` with a GPU target pins each host batch before its copy
to the card, which then runs asynchronously on the current stream: in the
worker thread that made the batch (thread pool), else on the caller's
thread (no workers; worker processes, whose batches are rebuilt from
shared memory straight into pinned memory).

The host side copies with numpy (``np.stack``, ``np.copyto``), which
releases the GIL and runs on the calling thread alone: torch's CPU ops
would each enter its intra-op thread pool, and several worker threads
doing so at once oversubscribe the host's cores.
"""
from __future__ import annotations

import concurrent.futures as _fut
import multiprocessing as _mp

import numpy as np
import torch

from ...context import Context, current_context
from ...ndarray.ndarray import NDArray
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn"]


_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _host(a, pin=False):
    """A host NDArray of the new numpy array ``a`` (float64 and int64
    narrowed, as ``nd.array`` does): ``a`` itself, or a pinned copy."""
    narrow = _NARROW.get(a.dtype)
    if narrow is not None:
        a = a.astype(narrow)
    if not pin:
        return NDArray(torch.from_numpy(np.ascontiguousarray(a)),
                       ctx=Context("cpu"))
    out = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                      pin_memory=True)
    np.copyto(out.numpy(), a)
    return NDArray(out, ctx=Context("cpu"))


def _numpy_view(t):
    """A numpy view of host tensor ``t`` (bf16 as int16 bits)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def default_batchify_fn(data):
    """Stack samples into a batch on the host: NDArrays stack into one
    NDArray, tuples element-wise, anything else through ``np.asarray``
    (int64 and float64 narrowed to int32 and float32, as ``nd.array``
    does)."""
    return _batchify(data, False)


def _batchify(data, pin):
    """``default_batchify_fn``, stacking straight into pinned memory with
    ``pin`` (one copy of the batch, not two)."""
    if isinstance(data[0], NDArray):
        ts = [d._data.detach().cpu() for d in data]
        out = torch.empty((len(ts),) + tuple(ts[0].shape),
                          dtype=ts[0].dtype, pin_memory=pin)
        np.stack([_numpy_view(t) for t in ts], out=_numpy_view(out))
        return NDArray(out, ctx=Context("cpu"))
    if isinstance(data[0], (tuple, list)):
        return tuple(_batchify(list(i), pin) for i in zip(*data))
    return _host(np.asarray(data), pin)


def _map_arrays(obj, fn):
    if isinstance(obj, NDArray):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_arrays(o, fn) for o in obj)
    return obj


def _pinned(t):
    """A pinned host copy of host tensor ``t`` (a numpy copy)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    np.copyto(_numpy_view(out), _numpy_view(t))
    return out


def _pin(batch):
    return _map_arrays(batch, lambda a: a if a._data.is_pinned() else
                       NDArray(_pinned(a._data), ctx=Context("cpu")))


def _to_context(batch, ctx):
    """The batch's arrays on ``ctx`` (called on the caller's thread); a
    pinned host array is copied without blocking the host."""
    dev = ctx.device

    def move(a):
        if a._data.device == dev:
            return a
        return NDArray(a._data.to(dev, non_blocking=a._data.is_pinned()),
                       ctx=ctx)
    return _map_arrays(batch, move)


class DataLoader:
    """Batches of a dataset: ``batch_size`` with ``shuffle``, ``sampler``
    and ``last_batch`` ("keep", "discard", "rollover"), or a
    ``batch_sampler``; ``batchify_fn`` (default ``default_batchify_fn``);
    ``num_workers``, ``thread_pool``, ``prefetch`` and ``pin_memory`` as
    in the module docstring."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_size/shuffle/sampler/last_batch are "
                             "mutually exclusive with batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch or 2 * max(num_workers, 1))

    def __len__(self):
        return len(self._batch_sampler)

    def _fetch_batch(self, indices, pin=False):
        """One host batch; run by a worker or, with no workers, by the
        caller."""
        with Context("cpu"):
            samples = [self._dataset[i] for i in indices]
            if self._batchify_fn is default_batchify_fn:
                batch = _batchify(samples, pin)
            else:
                batch = self._batchify_fn(samples)
        return _pin(batch) if pin else batch

    def __iter__(self):
        ctx = current_context()
        pin = self._pin_memory and ctx.device_type == "gpu"
        if self._num_workers == 0:
            batches = (self._fetch_batch(ix, pin)
                       for ix in self._batch_sampler)
        elif self._thread_pool:
            batches = self._iter_threaded(pin)
        else:
            batches = self._iter_multiprocess(pin)
        for batch in batches:
            yield _to_context(batch, ctx)

    def _iter_threaded(self, pin):
        with _fut.ThreadPoolExecutor(self._num_workers) as pool:
            batches = list(self._batch_sampler)
            futs = []
            depth = self._prefetch
            for indices in batches[:depth]:
                futs.append(pool.submit(self._fetch_batch, indices, pin))
            submitted = min(depth, len(batches))
            for i in range(len(batches)):
                yield futs[i].result()
                futs[i] = None
                if submitted < len(batches):
                    futs.append(pool.submit(self._fetch_batch,
                                            batches[submitted], pin))
                    submitted += 1

    def _iter_multiprocess(self, pin):
        pool = self._get_pool()
        batches = list(self._batch_sampler)
        # at most `prefetch` batches in flight, as in the threaded path
        depth = max(self._prefetch, 1)
        pending = []
        submitted = 0
        consumed = 0
        try:
            for indices in batches[:depth]:
                pending.append(pool.apply_async(
                    _mp_fetch_shm, (self._pool_key, indices)))
                submitted += 1
            for i in range(len(batches)):
                desc = pending[i].get()
                consumed = i + 1
                yield _from_shm(desc, pin)
                if submitted < len(batches):
                    pending.append(pool.apply_async(
                        _mp_fetch_shm, (self._pool_key,
                                        batches[submitted])))
                    submitted += 1
        finally:
            # an abandoned iteration: reap the batches in flight and unlink
            # their segments, which would otherwise outlive the process
            for r in pending[consumed:]:
                try:
                    _free_shm(r.get(timeout=5))
                except Exception:
                    pass

    def _get_pool(self):
        """One pool of forked workers for the loader's lifetime, as the
        reference keeps. The children inherit the dataset through a
        module-level registry (no pickling), so a dataset changed after
        the first epoch is not seen by them."""
        if getattr(self, "_pool", None) is None:
            ctx = _mp.get_context("fork")
            self._pool_key = id(self)
            _WORKER_STATES[self._pool_key] = (self._dataset,
                                              self._batchify_fn)
            self._pool = ctx.Pool(self._num_workers,
                                  initializer=_worker_init)
            import atexit
            import weakref
            ref = weakref.ref(self)

            def _atexit_cb():
                self_ = ref()
                if self_ is not None:
                    self_._shutdown_pool()

            self._atexit_cb = _atexit_cb
            atexit.register(_atexit_cb)
        return self._pool

    def _shutdown_pool(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            self._pool = None
            _WORKER_STATES.pop(getattr(self, "_pool_key", None), None)
            cb = getattr(self, "_atexit_cb", None)
            if cb is not None:
                self._atexit_cb = None
                import atexit
                atexit.unregister(cb)
            pool.terminate()
            pool.join()

    def __del__(self):
        self._shutdown_pool()


# {loader key: (dataset, batchify_fn)}, filled in the parent before the
# pool forks, so that the children (and later respawns) inherit it
_WORKER_STATES = {}  # mxlint: disable=MX003 (parent-process registry keyed by id(loader): GIL-atomic writes to distinct keys, snapshotted into children at fork)


def _to_shm(obj):
    """A batch as shared-memory segment descriptors (in a worker)."""
    from multiprocessing import shared_memory
    if isinstance(obj, (tuple, list)):
        return ("tuple", [_to_shm(o) for o in obj])
    if isinstance(obj, NDArray):
        t = obj._data.detach().cpu().contiguous()
        dtype = str(t.dtype)[len("torch."):]
        a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    elif isinstance(obj, np.ndarray):
        a, dtype = np.ascontiguousarray(obj), None
    else:
        return ("obj", obj)
    shm = shared_memory.SharedMemory(create=True, size=max(a.nbytes, 1))
    view = np.ndarray(a.shape, a.dtype, buffer=shm.buf)
    view[...] = a
    name = shm.name
    shm.close()
    # the parent unlinks the segment after the rebuild: drop the worker's
    # resource_tracker registration, which would warn at its exit
    from multiprocessing import resource_tracker
    resource_tracker.unregister("/" + name, "shared_memory")
    return ("shm", name, a.shape, str(a.dtype), dtype)


def _from_shm(desc, pin=False):
    """Rebuild a batch from its descriptors (in the parent) as host
    NDArrays, pinned with ``pin``; each segment is copied out and
    unlinked."""
    from multiprocessing import shared_memory
    tag = desc[0]
    if tag == "tuple":
        return tuple(_from_shm(o, pin) for o in desc[1])
    if tag == "obj":
        return desc[1]
    _, name, shape, np_dtype, dtype = desc
    shm = shared_memory.SharedMemory(name=name)
    try:
        src = np.ndarray(shape, np_dtype, buffer=shm.buf)
        if dtype is None:           # a numpy array: nd.array's narrowing
            return _host(src.copy())
        out = torch.empty(shape, dtype=getattr(torch, dtype),
                          pin_memory=pin)
        np.copyto(_numpy_view(out), src)
        return NDArray(out, ctx=Context("cpu"))
    finally:
        shm.close()
        shm.unlink()


def _free_shm(desc):
    """Unlink the segments of a batch that will not be rebuilt."""
    from multiprocessing import shared_memory
    if desc[0] == "tuple":
        for o in desc[1]:
            _free_shm(o)
    elif desc[0] == "shm":
        try:
            shm = shared_memory.SharedMemory(name=desc[1])
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass


def _worker_init():
    # one intra-op thread per forked worker: an OpenMP pool inherited
    # across fork is not safe to use, and the workers run side by side
    torch.set_num_threads(1)


def _mp_fetch_shm(key, indices):
    dataset, batchify_fn = _WORKER_STATES[key]
    with Context("cpu"):
        batch = batchify_fn([dataset[i] for i in indices])
    return _to_shm(batch)
