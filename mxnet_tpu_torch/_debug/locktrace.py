"""Runtime lock-order / race detector (``MXNET_DEBUG_LOCKS=1``)
(counterpart of mxnet_tpu/_debug/locktrace.py).

Every lock of the port's observability layer (profiler, storage ledger,
flight recorder, watchdog, goodput, memwatch, fault points, io stats) is
allocated through ``named_lock`` / ``named_condition``, and when tracing
is enabled the returned lock records

* the **acquisition-order graph**: a directed edge A -> B each time a
  thread acquires B while holding A. An edge pair (A -> B, B -> A) is a
  **lock-order inversion**: two threads interleaving those paths can
  deadlock. Names, not instances, define the order (the lock-hierarchy
  discipline), so two instances of the same subsystem lock share a node.
* **boundary violations**: locks held while crossing a device-sync or
  kernel-build boundary (``boundary()``). Such a boundary can block for
  seconds; a framework lock held across one starves every other thread
  that needs it.

Findings surface in ``profiler.metrics()['locks']`` while tracing is on,
and through ``report()`` directly.

When tracing is disabled (the default), ``named_lock`` still returns the
``_NamedLock`` proxy (enabling at run time with ``enable()`` must
instrument locks created at import time), but its acquire and release
are one module-bool test away from the raw ``threading.Lock``.
"""
from __future__ import annotations

import threading
import traceback
from ..base import getenv as _getenv

__all__ = [
    "named_lock", "named_condition", "enable", "disable", "is_enabled",
    "boundary", "report", "reset", "ENABLED",
]

# Module-level gate, read inline by the proxies and by the framework's
# boundary hooks (`if _locktrace.ENABLED: ...`) so the disabled cost is
# one attribute load + truth test.
ENABLED = _getenv("MXNET_DEBUG_LOCKS", "0") in ("1", "true", "on")

_tls = threading.local()  # .held: list of _NamedLock in acquisition order

# detector state; guarded by the (untraced) bookkeeping lock below
_graph_lock = threading.Lock()
_edges = {}        # (holder_name, acquired_name) -> count
_inversions = []   # {"pair", "first_seen", "stack"} — order-graph cycles
_boundaries = []   # {"boundary", "held", "stack"} — locks held at a sync
_acquisitions = 0  # total traced acquires (detector coverage indicator)
_registry = {}     # name -> number of live locks carrying it
_MAX_FINDINGS = 100  # bound the finding lists; totals keep counting
_inversion_total = 0
_boundary_total = 0


def _held():
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack():
    # skip the locktrace frames themselves; cap depth — findings are
    # for humans, not for unbounded memory growth
    return "".join(traceback.format_stack(limit=12)[:-2])


class _NamedLock:
    """``threading.Lock``/``RLock`` proxy carrying a registry name.

    Disabled fast path: one module-attribute truth test on acquire and
    a thread-local peek on release (needed so a disable() with locks
    held cannot strand bookkeeping)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name, reentrant=False):
        self.name = name
        self._lock = threading.RLock() if reentrant \
            else threading.Lock()

    # -- instrumentation core ------------------------------------------

    def _record_acquire(self):
        global _acquisitions, _inversion_total
        held = _held()
        with _graph_lock:
            _acquisitions += 1
            # one edge from EVERY held lock, not just the innermost —
            # a thread holding A and B while acquiring C can deadlock
            # against a thread doing C then A, so A->C must be in the
            # graph even though B was acquired in between
            for holder in {l.name for l in held}:
                if holder == self.name:
                    continue
                edge = (holder, self.name)
                inverse = (self.name, holder)
                fresh = edge not in _edges
                _edges[edge] = _edges.get(edge, 0) + 1
                if fresh and inverse in _edges:
                    _inversion_total += 1
                    if len(_inversions) < _MAX_FINDINGS:
                        _inversions.append({
                            "pair": [holder, self.name],
                            "held": [l.name for l in held],
                            "stack": _stack(),
                        })
        held.append(self)

    def _record_release(self):
        held = getattr(_tls, "held", None)
        if held:
            # usually LIFO, but Condition.wait releases out of order
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break

    # -- lock protocol --------------------------------------------------

    def acquire(self, blocking=True, timeout=-1):
        got = self._lock.acquire(blocking, timeout)
        if got and ENABLED:
            self._record_acquire()
        return got

    def release(self):
        self._record_release()
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        # RLock grew .locked() only in 3.14; fall back to the probe
        f = getattr(self._lock, "locked", None)
        if f is not None:
            return f()
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _is_owned(self):
        # Condition support: "owned" == this thread recorded the
        # acquire. A lock taken BEFORE a runtime enable() has no
        # record, so never answer a hard False from bookkeeping alone —
        # fall back to the acquire-probe heuristic CPython's Condition
        # uses for plain Locks ("locked at all" == owned).
        held = getattr(_tls, "held", None)
        if held is not None and self in held:
            return True
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __repr__(self):
        return "<_NamedLock %s>" % self.name


def named_lock(name, reentrant=False):
    """Allocate a framework lock under ``name``. All framework locks
    must come from here; the name defines its node in the acquisition-order graph.
    ``reentrant=True`` backs it with an RLock — for critical sections
    that may legitimately re-enter on the same thread (plugin loads
    loading dependency plugins)."""
    with _graph_lock:
        _registry[name] = _registry.get(name, 0) + 1
    return _NamedLock(name, reentrant=reentrant)


def named_condition(name, lock=None):
    """``threading.Condition`` over a named (traced) lock."""
    return threading.Condition(lock if lock is not None
                               else named_lock(name))


def boundary(name):
    """Called at device-sync / kernel-build boundaries. Records every
    traced lock the calling thread holds — blocking device work while
    holding a framework lock is the race/starvation pattern this
    detector exists for. Callers guard with ``if locktrace.ENABLED:``
    so the disabled cost stays off the hot path."""
    global _boundary_total
    if not ENABLED:
        return
    held = getattr(_tls, "held", None)
    if not held:
        return
    with _graph_lock:
        _boundary_total += 1
        if len(_boundaries) < _MAX_FINDINGS:
            _boundaries.append({
                "boundary": name,
                "held": [l.name for l in held],
                "stack": _stack(),
            })


def enable():
    """Turn the detector on at runtime (the env var sets the process
    default). Returns the previous state."""
    global ENABLED
    prev = ENABLED
    ENABLED = True
    return prev


def disable():
    global ENABLED
    prev = ENABLED
    ENABLED = False
    return prev


def is_enabled():
    return ENABLED


def reset():
    """Clear recorded findings (test isolation)."""
    global _acquisitions, _inversion_total, _boundary_total
    with _graph_lock:
        _edges.clear()
        _inversions.clear()
        _boundaries.clear()
        _acquisitions = 0
        _inversion_total = 0
        _boundary_total = 0


def report():
    """JSON-safe snapshot of everything the detector recorded. Embedded
    in ``profiler.metrics()['locks']`` while tracing is enabled."""
    with _graph_lock:
        return {
            "enabled": ENABLED,
            "locks": sorted(_registry),
            "acquisitions": _acquisitions,
            "order_edges": sorted(
                "%s->%s" % e for e in _edges),
            "inversions": [dict(i) for i in _inversions],
            "inversion_total": _inversion_total,
            "boundary_violations": [dict(b) for b in _boundaries],
            "boundary_violation_total": _boundary_total,
        }
