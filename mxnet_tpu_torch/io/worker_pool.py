"""Multi-worker decode pool: the restart-or-die contract of one worker
scaled to N (counterpart of mxnet_tpu/io/worker_pool.py).

``DecodePool`` pulls items from a source iterator, decodes them on N
worker threads, and yields results **in source order** regardless of
worker count or interleaving: every claimed item carries a sequence
number and lands in its numbered result slot; the consumer only ever
takes the next expected sequence. Worker count is a throughput knob,
never a semantics knob.

Failure ladder (each rung counted in ``profiler.metrics()['io']``):

1. **decode raises**: a *worker death* (the thread exits; an abrupt
   ``SystemExit`` takes this path too). The claimed item is requeued so
   no sample is lost, and the pool restarts the worker on a fresh thread.
   Restarts are bounded per worker by ``MXTPU_IO_WORKER_RESTARTS``
   (default ``MXTPU_PS_RETRY_MAX``) counted over *consecutive* deaths: a
   success resets the meter, so a transient chaos rate recovers while a
   persistently broken worker cannot death-loop.
2. **budget exhausted**: the worker is *retired*; the pool degrades to
   fewer workers (``io.pool_workers`` gauge) and keeps serving.
3. **an item keeps failing** (``MXTPU_IO_ITEM_RETRIES`` attempts across
   any workers): the item is poison, its slot carries the exception,
   which the consumer sees EXACTLY once at the item's ordered position;
   afterwards the pool reads exhausted until ``reset()``.
4. **all workers retired**: pool-level death; whatever completed in
   order is still delivered, then the same raise-once surface.

Observability: per-worker deaths/restarts in ``metrics()['io']``, a span
per decode in a **per-worker trace lane** (``io.w<k>``, via
``profiler.ensure_lane``), the ``io.worker.decode`` fault point before
each decode, and a live per-worker state blob in the flight recorder's
dump context (``io_workers:<name>``): a starved-step watchdog dump names
WHICH worker was wedged on WHAT sequence number.

The workers are threads: a decode that releases the GIL (``cv2``'s, numpy
copies) runs in parallel.
"""
from __future__ import annotations

import os
import threading
import time as _time

from .. import _retry
from .. import profiler as _profiler
from .._debug import faultpoint as _faultpoint
from .._debug import flightrec as _flightrec
from .._debug import goodput as _goodput
from .._debug import locktrace as _locktrace
from . import _stats
from ..base import getenv as _getenv

__all__ = ["DecodePool"]

# distinguishes "no slot delivered" from a legitimate None item in the
# consumer's post-lock telemetry hand-off
_NO_RESULT = object()


def _env_int(name, default):
    try:
        return int(_getenv(name, "") or default)
    except ValueError:
        return default


class DecodePool:
    """Order-preserving N-worker decode over ``source``.

    Parameters
    ----------
    source : iterable (restartable via ``reset()`` for pool resets)
    decode_fn : callable(item) -> result, runs on worker threads
    workers : int, default ``MXTPU_IO_DECODE_WORKERS`` (2)
    depth : int, default ``2 * workers``
        Max undelivered sequence numbers in flight (backpressure).
    restarts_per_worker : int, default ``MXTPU_IO_WORKER_RESTARTS``
        (falls back to the ``_retry`` budget, ``MXTPU_PS_RETRY_MAX``).
        Consecutive-death budget per worker before retirement.
    item_retries : int, default ``MXTPU_IO_ITEM_RETRIES`` (4)
        Decode attempts per item before it is declared poison.
    name : str, labels the flight-recorder context blob.
    """

    def __init__(self, source, decode_fn, workers=None, depth=None,
                 restarts_per_worker=None, item_retries=None,
                 name="decode"):
        self._source = source
        self._decode = decode_fn
        self._nworkers = int(workers) if workers is not None \
            else _env_int("MXTPU_IO_DECODE_WORKERS", 2)
        if self._nworkers < 1:
            raise ValueError("DecodePool needs >= 1 worker")
        self._depth = int(depth) if depth is not None \
            else 2 * self._nworkers
        if restarts_per_worker is None:
            restarts_per_worker = _env_int(
                "MXTPU_IO_WORKER_RESTARTS",
                _retry.RetryPolicy().max_retries)
        self._budget = int(restarts_per_worker)
        self._item_retries = int(item_retries) if item_retries \
            is not None else _env_int("MXTPU_IO_ITEM_RETRIES", 4)
        self._name = name
        self._cond = _locktrace.named_condition("io.pool.slots")
        self._start()

    # -- lifecycle ----------------------------------------------------------
    def _start(self):
        with self._cond:
            self._it = iter(self._source)
            self._claim = 0        # next sequence number to hand out
            self._expect = 0       # next sequence the consumer takes
            self._slots = {}       # seq -> ("ok", result) | ("err", exc)
            self._retryq = []      # [(seq, item, attempts)] redo first
            self._decoding = {}    # seq -> worker id, claimed not filled
            self._exhausted = False
            self._last = None      # exclusive end seq once exhausted
            self._failed = None    # pool-terminal exception
            self._dead = False     # terminal raised once; now exhausted
            self._stopping = False
            self._deaths = {}      # worker -> total deaths
            self._consec = {}      # worker -> consecutive deaths
            self._live = set(range(self._nworkers))
            self._threads = []
            # fixed-key per-worker blobs, mutated in place: the flight
            # recorder serializes this at dump time, so a watchdog dump
            # of a starved step names the wedged worker and its seq
            self._ctx = {str(i): {"state": "idle", "seq": -1,
                                  "deaths": 0, "live": True}
                         for i in range(self._nworkers)}
        _flightrec.set_context("io_workers:%s" % self._name, self._ctx)
        _stats.set_gauge("pool_workers", self._nworkers)
        for i in range(self._nworkers):
            self._spawn(i)

    def _spawn(self, wid):
        _profiler.ensure_lane("io.w%d" % wid)
        t = threading.Thread(
            target=self._worker, args=(wid,), daemon=True,
            name="decode-pool-%s-w%d" % (self._name, wid))
        with self._cond:
            if self._stopping:
                return
            self._threads.append(t)
        t.start()

    def close(self):
        """Stop and JOIN every worker without restarting -- the
        abandon-mid-stream path (a consumer breaking out of an epoch
        early must not leave N threads polling the condition for the
        life of the process). Idempotent; the pool reads exhausted
        afterwards until ``reset()`` rebuilds it."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in list(self._threads):
            t.join()

    def __del__(self):
        try:
            self.close()
        except Exception:  # mxlint: disable=MX009 (interpreter teardown -- threading may already be gone)
            pass

    def reset(self):
        """Join every worker, restart the source, and rebuild the pool
        with fresh budgets -- recovery after a poison item or pool
        death, mirroring the single-worker iterators' ``reset()``.
        Requires a restartable source."""
        self.close()
        if hasattr(self._source, "reset"):
            self._source.reset()
        _stats.bump("pool_resets")
        self._start()

    # -- worker side --------------------------------------------------------
    def _claim_one(self, wid):
        """Take the next work unit under the condition: a requeued
        item first (its slot is already owed), else a fresh pull from
        the source (serialized here -- this lock IS the ordering
        point). Returns (seq, item, attempts) or None to exit."""
        with self._cond:
            while True:
                if self._stopping or wid not in self._live:
                    return None
                if self._retryq:
                    claim = self._retryq.pop(0)
                    break
                if self._exhausted:
                    if not self._decoding:
                        # no future work can appear: retire quietly
                        return None
                    self._cond.wait(0.05)
                    continue
                if self._claim - self._expect < self._depth:
                    try:
                        item = next(self._it)
                    except StopIteration:
                        self._exhausted = True
                        self._last = self._claim
                        self._cond.notify_all()
                        continue
                    except Exception as e:  # mxlint: disable=MX009 (not swallowed: the error lands in an ordered result slot and re-raises at the consumer's __next__)
                        # a broken SOURCE is not a decode failure: it
                        # surfaces once, ordered, at the current seq
                        self._slots[self._claim] = ("err", e)
                        self._claim += 1
                        self._exhausted = True
                        self._last = self._claim
                        self._cond.notify_all()
                        continue
                    claim = (self._claim, item, 0)
                    self._claim += 1
                    break
                self._cond.wait(0.05)
            seq = claim[0]
            self._decoding[seq] = wid
            ctx = self._ctx[str(wid)]
            ctx["state"], ctx["seq"] = "decoding", seq
            return claim

    def _on_death(self, wid, seq, item, attempts, exc):
        """The restart-or-die ladder: requeue (or poison) the item,
        then restart or retire the worker."""
        with self._cond:
            self._deaths[wid] = self._deaths.get(wid, 0) + 1
            self._consec[wid] = self._consec.get(wid, 0) + 1
            self._decoding.pop(seq, None)
            ctx = self._ctx[str(wid)]
            ctx["deaths"] = self._deaths[wid]
            if attempts + 1 >= self._item_retries:
                # this was the item's item_retries-th attempt (so
                # MXTPU_IO_ITEM_RETRIES=1 means one attempt, no retry,
                # as the JAX package documents it): poison -- ITS slot
                # carries the error so the consumer sees it exactly
                # once, in order
                self._slots[seq] = ("err", exc)
            else:
                self._retryq.append((seq, item, attempts + 1))
            respawn = self._consec[wid] <= self._budget
            if not respawn:
                self._live.discard(wid)
                ctx["state"], ctx["live"] = "retired", False
                if not self._live and self._failed is None:
                    self._failed = RuntimeError(
                        "DecodePool %r: all %d workers retired "
                        "(consecutive-death budget %d each); last "
                        "error: %r" % (self._name, self._nworkers,
                                       self._budget, exc))
            self._cond.notify_all()
            nlive = len(self._live)
        _stats.bump("worker_deaths.%d" % wid)
        if respawn:
            _stats.bump("worker_restarts.%d" % wid)
            self._spawn(wid)
        else:
            _stats.bump("workers_retired")
            _stats.set_gauge("pool_workers", nlive)

    def _worker(self, wid):
        while True:
            claim = self._claim_one(wid)
            if claim is None:
                return
            seq, item, attempts = claim
            t0 = _time.perf_counter() if _profiler._LIVE else None
            try:
                if _faultpoint.ACTIVE:
                    _faultpoint.check("io.worker.decode")
                result = self._decode(item)
            except BaseException as e:  # mxlint: disable=MX009 (death is counted: _on_death -> _stats.bump -> profiler.account; abrupt SystemExit = the thread-world SIGKILL must take the same requeue path)
                self._on_death(wid, seq, item, attempts, e)
                return  # this incarnation is dead; _spawn made the next
            with self._cond:
                self._slots[seq] = ("ok", result)
                self._decoding.pop(seq, None)
                self._consec[wid] = 0
                ctx = self._ctx[str(wid)]
                ctx["state"], ctx["seq"] = "idle", seq
                self._cond.notify_all()
            if t0 is not None:
                _profiler.record_op(
                    "io.worker.decode",
                    (_time.perf_counter() - t0) * 1e6,
                    category="io", lane="io.w%d" % wid,
                    args={"seq": seq, "worker": wid})

    # -- consumer side ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        # consumer-stall timing (the input-wait half of the goodput
        # ledger + the shared io.prefetch_wait histogram): measured
        # over the whole ordered-slot wait, recorded AFTER the pool
        # condition is released so the telemetry locks never nest
        # under it. goodput.OPEN joins the guard so input_wait
        # attribution survives a flightrec-off deployment
        t0 = _time.perf_counter() \
            if _profiler._LIVE or _goodput.OPEN else None
        err = None
        result = _NO_RESULT
        with self._cond:
            if self._dead:
                # terminal error already surfaced once: the pool reads
                # exhausted until reset() (restart-or-die, N-worker)
                raise StopIteration
            while err is None:
                if self._expect in self._slots:
                    kind, val = self._slots.pop(self._expect)
                    self._expect += 1
                    self._cond.notify_all()
                    if kind == "err":
                        self._dead = True
                        err = val
                        break
                    result = val
                    break
                if self._exhausted and self._last is not None \
                        and self._expect >= self._last:
                    # everything owed was delivered -- a pool that
                    # degraded to zero AFTER finishing still ends
                    # cleanly
                    raise StopIteration
                if self._failed is not None:
                    self._dead = True
                    err = self._failed
                    break
                self._cond.wait(0.05)
        if result is not _NO_RESULT:
            if t0 is not None:
                wait_us = (_time.perf_counter() - t0) * 1e6
                _profiler.record_latency("io.prefetch_wait", wait_us)
                if _goodput.OPEN:
                    _goodput.note_input_wait(wait_us)
            return result
        _stats.bump("pool_failures")
        raise err

    next = __next__

    # -- introspection -------------------------------------------------------
    @property
    def live_workers(self):
        with self._cond:
            return sorted(self._live)

    def deaths(self):
        with self._cond:
            return dict(self._deaths)
