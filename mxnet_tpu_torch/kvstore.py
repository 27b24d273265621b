"""KVStore: key-value parameter synchronization in one process (counterpart
of mxnet_tpu/kvstore.py; ref: python/mxnet/kvstore.py:97,
src/kvstore/comm.h).

    kv = mx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    trainer = mx.gluon.Trainer(params, "sgd", kvstore=kv)

The in-process kinds (``local``, ``device``, ``nccl``, ``tpu``) keep one
tensor per key. ``push`` sums the values pushed for a key left to right
(``add_n``), passes the sum through 2-bit compression when compression is
set and the sum has at least ``size_lower_bound`` elements, and then
either stores it or, once ``set_optimizer`` installed an updater, applies
the optimizer to the stored weight (update on kvstore). ``pull`` copies a
key's tensor into each output.

The ``dist_sync``, ``dist_device_sync`` and ``dist`` kinds run one worker
per process, over the default ``torch.distributed`` group (``create``
joins the job ``MXTPU_COORDINATOR`` describes, as ``tools/launch.py``
sets it): ``rank`` and ``num_workers`` are the group's, every worker
holds every key, and a push adds the workers' sums, so every worker pulls
the same values and, updating on the kvstore, applies the same update.
An uncompressed sum is added over the workers on its device
(``parallel.host_allreduce``; one collective per (device, dtype) of a
push's run). A compressed one crosses as its 2-bit words: every worker's
words are gathered, and every worker dequantizes all of them and adds the
values in rank order (the JAX package's ``_compress_reduce``). The
asynchronous server (``dist_async``) belongs to M10b and raises.

Compression (``_compress_run``) is the error-feedback 2-bit codec of
``kernels/compression.py``: a push of a key list encodes every large sum
with one ``quantize_2bit_group`` and decodes them with one
``dequantize_2bit_group`` per dtype, on the card one launch of each Hopper
kernel for up to 64 keys, with a residual per key in the gradient's dtype
and on its device. The pulled value is the dequantized sum cast back to
that dtype, one cast per dtype.

Aliasing: a JAX array is immutable, so the JAX store shares arrays with
its callers. A torch tensor is written in place by backward and by the
optimizer, so here ``init`` stores a copy, a pushed value is copied before
it is stored, and ``pull`` copies into the caller's tensor (under
``no_grad``: with update on kvstore the output is a parameter that
requires grad). Nothing a caller holds aliases the store.

Values and outputs are tensors or NDArrays. A pull into an NDArray
rebinds it to a copy of the key's value (into a Parameter's view: written
in place), as the JAX store's pull writes its NDArray outputs.

``bytes_pushed`` and ``bytes_pulled`` count the bytes each call would move,
and so do the profiler's ``kvstore.bytes_pushed`` and
``kvstore.bytes_pulled`` counters (``profiler.account``: counted with
profiling off too); while the profiler or the flight recorder is live,
``init``, ``push`` and ``pull`` are spans in the ``kvstore`` lane.
``row_sparse_pull`` waits for sparse arrays (Slice I).
"""
from __future__ import annotations

import pickle
import time as _time

import torch

from . import optimizer as opt
from . import profiler as _profiler
from .base import atomic_write, getenv
from .parallel import collectives as _coll
from .kernels.compression import (dequantize_2bit_group,
                                  quantize_2bit_group)
from .ndarray.ndarray import nd_io

__all__ = ["KVStore", "create"]

_LOCAL_KINDS = ("local", "device", "nccl", "tpu")
_DIST_KINDS = ("dist_sync", "dist_device_sync", "dist_async", "dist")


def _ctype_key_value(keys, vals):
    """(key(s), value(s)) as parallel lists, each value a list; keys are
    str or int (ref: python/mxnet/kvstore.py _ctype_key_value)."""
    if isinstance(keys, (str, int)):
        keys, vals = [keys], [vals]
    return list(keys), [list(v) if isinstance(v, (list, tuple)) else [v]
                        for v in vals]


def _nbytes(t):
    return t.numel() * t.element_size()


def _add_n(vals):
    """JAX's ``add_n``: ``out = out + x`` left to right, in the values'
    dtype."""
    out = vals[0]
    for x in vals[1:]:
        out = out + x
    return out


class KVStore:
    """In-process key-value store (ref: python/mxnet/kvstore.py:97)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store = {}            # key -> tensor (the "server" copy)
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._compression_residuals = {}
        self._barrier_before_exit = True
        self.bytes_pushed = 0
        self.bytes_pulled = 0

    # -- identity ----------------------------------------------------------
    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return _coll.host_rank() if self._dist else 0

    @property
    def num_workers(self):
        return _coll.num_hosts() if self._dist else 1

    @property
    def _dist(self):
        return self._kind.startswith("dist")

    def _across(self):
        """Whether pushes cross processes (a dist kind, several workers)."""
        return self._dist and _coll.num_hosts() > 1

    # -- init/push/pull ----------------------------------------------------
    def init(self, key, value):
        """Initialize each key with a copy of its (first) value; a key
        already present keeps its value."""
        t0 = _time.perf_counter() if _profiler._LIVE else None
        keys, vals = _ctype_key_value(key, value)
        nbytes = 0
        for k, vlist in zip(keys, vals):
            if k not in self._store:
                nbytes += _nbytes(vlist[0])
                self._store[k] = vlist[0].detach().clone()
        if t0 is not None:
            _profiler.record_op(
                "kvstore.init", (_time.perf_counter() - t0) * 1e6,
                category="kvstore", lane="kvstore",
                args={"keys": len(keys), "bytes": nbytes,
                      "type": self._kind})

    def push(self, key, value, priority=0):
        """Push values: several for one key are summed (``add_n``), the sum
        is compressed where compression applies, then stored or, with an
        updater, applied to the stored weight (ref: src/kvstore/comm.h:451
        Reduce, kvstore_dist_server.h:346 ApplyUpdates). A list of keys is
        taken in runs in which no key repeats: a run's sums are formed in
        list order, every sum that compression applies to is encoded and
        decoded by one grouped codec call per dtype (``_compress_run``),
        then each key is stored or updated in list order. So a key that
        appears again starts a run that sees the residual the first one
        left, and the result equals pushing the keys one by one. Keys up to
        the first one not initialized are pushed before it raises."""
        t0 = _time.perf_counter() if _profiler._LIVE else None
        b0 = self.bytes_pushed
        keys, vals = _ctype_key_value(key, value)
        bad = next((i for i, k in enumerate(keys) if k not in self._store),
                   len(keys))
        run, seen = [], set()
        for k, vlist in zip(keys[:bad], vals[:bad]):
            if k in seen:
                self._push_run(run)
                run, seen = [], set()
            seen.add(k)
            self.bytes_pushed += sum(_nbytes(v) for v in vlist)
            merged = vlist[0] if len(vlist) == 1 else _add_n(vlist)
            run.append((k, vlist, merged))
        self._push_run(run)
        # accounted with profiling off too (account gates only the trace)
        _profiler.account("kvstore.bytes_pushed", self.bytes_pushed - b0)
        if t0 is not None:
            _profiler.record_op(
                "kvstore.push", (_time.perf_counter() - t0) * 1e6,
                category="kvstore", lane="kvstore",
                args={"keys": len(keys), "bytes": self.bytes_pushed - b0,
                      "type": self._kind})
        if bad < len(keys):
            raise ValueError("key %r has not been initialized"
                             % (keys[bad],))

    def _push_run(self, run):
        """Compress, then store or update, the (key, values, sum) of a run
        of distinct keys."""
        sums = self._compress_run([(k, merged) for k, _, merged in run
                                   if self._compression_active(merged)])
        if self._across():
            sums.update(self._sync_reduce([(k, merged) for k, _, merged in run
                                        if k not in sums]))
        for k, vlist, merged in run:
            merged = sums.get(k, merged)
            if self._updater is not None:
                idx = k if isinstance(k, int) else _str_key_int(k)
                self._updater(idx, merged, self._store[k])
            elif merged is vlist[0]:
                self._store[k] = merged.detach().clone()
            else:
                self._store[k] = merged.detach()

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's value into its output(s)."""
        assert out is not None
        t0 = _time.perf_counter() if _profiler._LIVE else None
        b0 = self.bytes_pulled
        keys, outs = _ctype_key_value(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise ValueError("key %r has not been initialized" % (k,))
            src = self._store[k]
            with torch.no_grad():
                for o in olist:
                    self.bytes_pulled += _nbytes(src)
                    o.copy_(src)
        _profiler.account("kvstore.bytes_pulled", self.bytes_pulled - b0)
        if t0 is not None:
            _profiler.record_op(
                "kvstore.pull", (_time.perf_counter() - t0) * 1e6,
                category="kvstore", lane="kvstore",
                args={"keys": len(keys), "bytes": self.bytes_pulled - b0,
                      "type": self._kind})
        return out

    def pushpull(self, key, value, out=None, priority=0):
        """push, then pull into ``out`` (ref: kvstore.py pushpull)."""
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError(
            "row_sparse_pull needs the port's sparse arrays (Slice I)")

    def broadcast(self, key, value, out=None, priority=0):
        """init, then pull into ``out`` (ref: kvstore.py broadcast)."""
        self.init(key, value)
        if out is not None:
            self.pull(key, out=out, priority=priority)
        return out

    # -- optimizer (update on kvstore) -------------------------------------
    def set_optimizer(self, optimizer):
        """Install a copy of ``optimizer``, round-tripped through pickle as
        the reference sends it to its servers, and its updater."""
        self._optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater = opt.get_updater(self._optimizer)

    def set_updater(self, updater):
        self._updater = updater

    # -- gradient compression ---------------------------------------------
    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression (ref:
        src/kvstore/gradient_compression.h:38): ``type`` "2bit" or "none",
        ``threshold`` (0.5), and ``size_lower_bound``, the fewest elements
        a pushed sum needs to be compressed (``MXNET_KVSTORE_SIZE_LOWER_
        BOUND``, 4096: biases and norms train badly when crushed to
        {0, +-threshold}). Resets the residuals."""
        ctype = compression_params.get("type", "2bit")
        if ctype not in ("none", "2bit"):
            raise ValueError("Unsupported compression type %r" % ctype)
        self._compression_params = dict(compression_params)
        self._compression_params.setdefault("threshold", 0.5)
        self._compression_params.setdefault(
            "size_lower_bound",
            int(getenv("MXNET_KVSTORE_SIZE_LOWER_BOUND", 4096)))
        self._compression_residuals = {}

    def _compression_active(self, merged):
        return (self._compression_params is not None
                and self._compression_params.get("type") != "none"
                and merged.numel()
                >= self._compression_params["size_lower_bound"])

    def _compress_run(self, items):
        """2-bit quantize each (key, sum) with its key's error-feedback
        residual, then dequantize (one process: the words make no trip) and
        cast back to the sum's dtype: one ``quantize_2bit_group`` and one
        ``dequantize_2bit_group`` per (device, dtype), and one cast of the
        decoded values. A residual of another shape, dtype or device starts
        again from zeros. Returns {key: decoded sum}."""
        groups = {}
        for k, merged in items:
            groups.setdefault((merged.device, merged.dtype), []).append(
                (k, merged))
        out = {}
        for (_, dtype), group in groups.items():
            flats, residuals = [], []
            for k, merged in group:
                flat = merged.detach().reshape(-1).contiguous()
                res = self._compression_residuals.get(k)
                if res is None or res.shape != flat.shape or \
                        res.dtype != flat.dtype or res.device != flat.device:
                    res = torch.zeros_like(flat)
                flats.append(flat)
                residuals.append(res)
            thr = self._compression_params["threshold"]
            words, new_res = quantize_2bit_group(flats, residuals, thr)
            ns = [f.numel() for f in flats]
            if self._across():
                deq = self._gathered_sum(words, ns, thr)
            else:
                deq, _ = dequantize_2bit_group(words, ns, thr)
            for (k, merged), res, part in zip(group, new_res,
                                              deq.to(dtype).split(ns)):
                self._compression_residuals[k] = res
                out[k] = part.view(merged.shape)
        return out

    def _gathered_sum(self, words, ns, thr):
        """Every worker's 2-bit words of a group, gathered (one collective),
        dequantized by one grouped call over all of them and added in rank
        order from zero: the sum, flat, in float32."""
        n = self.num_workers
        sizes = [w.numel() for w in words]
        mine = torch.cat(words) if len(words) > 1 else words[0]
        parts = [torch.empty_like(mine) for _ in range(n)]
        _coll._call("kvstore push (2-bit words)", mine, None,
                    lambda: _coll._dist().all_gather(parts, mine))
        every = [w for p in parts for w in p.split(sizes)]
        flat, _ = dequantize_2bit_group(every, ns * n, thr)
        total = flat.new_zeros(sum(ns))
        for r in flat.split(sum(ns)):
            total = total + r
        return total

    def _sync_reduce(self, items):
        """The sum over the workers of each (key, sum): one collective per
        (device, dtype) on the flat concatenation. Returns {key: sum}."""
        groups = {}
        for k, merged in items:
            groups.setdefault((merged.device, merged.dtype), []).append(
                (k, merged))
        out = {}
        for group in groups.values():
            flat = torch.cat([m.detach().reshape(-1) for _, m in group])
            total = _coll.host_allreduce(flat)
            for (k, merged), part in zip(group, total.split(
                    [m.numel() for _, m in group])):
                out[k] = part.view(merged.shape)
        return out

    def _barrier(self):
        """Every worker waits for the others (ref: ps::Postoffice::Barrier,
        src/kvstore/kvstore_dist.h:106)."""
        if self._across():
            _coll.host_barrier()

    def send_command_to_servers(self, head, body):
        """ref: kvstore.py _send_command_to_servers. There are no server
        processes: every worker holds the store, so nothing is sent."""
        del head, body

    # -- optimizer-state checkpointing ------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, "updater is not initialized"
        with atomic_write(fname) as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, "updater is not initialized"
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # the NDArray boundary (the module docstring)
    init = nd_io(init)
    push = nd_io(push)
    pull = nd_io(pull)
    pushpull = nd_io(pushpull)
    broadcast = nd_io(broadcast)

    def set_barrier_before_exit(self, barrier_before_exit):
        """ref: include/mxnet/kvstore.h:334 (recorded, as the JAX package
        records it)."""
        self._barrier_before_exit = barrier_before_exit


_STR_KEY_CACHE = {}


def _str_key_int(k):
    """A stable int index for a string key (the reference hashes string
    keys to server ints, src/kvstore/kvstore_dist.h:263)."""
    if k not in _STR_KEY_CACHE:
        _STR_KEY_CACHE[k] = len(_STR_KEY_CACHE)
    return _STR_KEY_CACHE[k]


def create(name="local"):
    """A KVStore of kind ``name`` (ref: python/mxnet/kvstore.py:716):
    ``local``, ``device``, ``nccl`` or ``tpu``, one in-process store, or
    ``dist_sync``, ``dist_device_sync`` or ``dist``, one per worker
    process over the default process group, which a dist kind joins from
    ``MXTPU_COORDINATOR`` where the process has none yet
    (``parallel.initialize_distributed``). ``dist_async`` belongs to
    M10b."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    kind = name.lower()
    if kind not in _LOCAL_KINDS + _DIST_KINDS:
        raise ValueError("Unknown KVStore type %r (supported: %s)"
                         % (name, ", ".join(_LOCAL_KINDS + _DIST_KINDS)))
    if kind == "dist_async":
        raise NotImplementedError(
            "KVStore 'dist_async': the asynchronous parameter server "
            "belongs to M10b; the port has %s"
            % ", ".join(k for k in _LOCAL_KINDS + _DIST_KINDS
                        if k != "dist_async"))
    if kind.startswith("dist") and getenv("MXTPU_COORDINATOR"):
        _coll.initialize_distributed()
    return KVStore(kind)
