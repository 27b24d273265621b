"""Data-plane accounting: the ``profiler.metrics()['io']`` provider
(counterpart of mxnet_tpu/io/_stats.py).

One module owns every input-pipeline counter and gauge (worker deaths,
corrupt records skipped, the live prefetch queue depth), so the flight
recorder and the ``/metrics`` exporter read the same numbers. Counters
accumulate unconditionally (the ``profiler.account`` contract): a restart
diagnostic must be trustworthy with profiling off.

Gauges are live values, not accumulators: ``prefetch_queue_depth`` is
re-seeded from the actual queue size whenever a prefetch worker restarts,
so a death with items still queued never leaves the gauge stale. It is one
series per process: every prefetcher publishes to it, so its value is the
most recent sample across them.
"""
from __future__ import annotations

from .. import profiler as _profiler
from .._debug import locktrace as _locktrace

__all__ = ["bump", "set_gauge", "get", "snapshot", "reset"]

_lock = _locktrace.named_lock("io.stats")
_counters = {}  # cumulative (worker_deaths.<i>, corrupt_records, ...)
_gauges = {}    # live values (prefetch_queue_depth, pool_workers, ...)


def bump(name, delta=1, args=None):
    """Accumulate a cumulative io counter (unconditionally) and mirror
    it into the profiler's counter ledger so the trace timeline shows
    it when a run is active."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + delta
    _profiler.account("io.%s" % name, delta, lane="io")


def set_gauge(name, value):
    """Publish a live gauge value (replaces, never accumulates)."""
    with _lock:
        _gauges[name] = value


def get(name, default=0):
    with _lock:
        if name in _counters:
            return _counters[name]
        return _gauges.get(name, default)


def snapshot():
    """JSON-safe merged view — the ``io`` section of
    ``profiler.metrics()``."""
    with _lock:
        out = dict(_counters)
        out.update(_gauges)
        return out


def reset():
    with _lock:
        _counters.clear()
        _gauges.clear()


_profiler.register_stats_provider("io", snapshot, reset)
