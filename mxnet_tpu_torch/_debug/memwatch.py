"""Memory leak/growth watchdog + OOM post-mortem (counterpart of
mxnet_tpu/_debug/memwatch.py).

The step watchdog (``watchdog.py``) answers "why is nothing happening";
this module answers "why is memory gone". Two halves:

**Leak watchdog.** A daemon thread (lazily started by the first ledger
registration, like the step watchdog's poller) samples the tagged
allocation ledger (``storage.ledger_metrics``) every
``MXTPU_MEMWATCH_POLL_S`` seconds into a rolling window. Past the warm-up
(``MXTPU_MEMWATCH_WARMUP_S``), a full window of monotone non-decreasing
totals whose net growth exceeds ``MXTPU_MEMWATCH_MIN_BYTES`` is a flagged
leak: counted, marked in the trace, and the flight recorder dumps one
post-mortem shard naming the top growing tags and the sampled allocation
sites, once per episode (the latch re-arms only after live bytes fall
back below the level at the trip). The profiler's memory sampler also
feeds the detector while profiling runs.

**OOM post-mortem.** ``torch.cuda.OutOfMemoryError`` is the port's
counterpart of XLA's ``RESOURCE_EXHAUSTED``. Two chains lead into the
same dump: (a) the creation factories' placement (``ndarray._ctx_place``)
calls :func:`oom_report` with the failed request size and re-raises the
error unchanged; (b) unhandled OOMs reach the flight recorder's
``sys.excepthook``, which asks :func:`is_oom` and upgrades the dump
trigger from ``exception`` to ``oom`` (once per exception: a reported
one is not dumped again). Either way the shard bundles the full ledger
(inside ``profiler.metrics()['memory']``), the failed request size and
the top allocation sites, so an OOM names its cause.

Env knobs, the JAX package's: ``MXTPU_MEMWATCH`` (default 1),
``MXTPU_MEMWATCH_POLL_S`` (1.0), ``MXTPU_MEMWATCH_WINDOW`` (16),
``MXTPU_MEMWATCH_WARMUP_S`` (30), ``MXTPU_MEMWATCH_MIN_BYTES`` (64 MiB).
"""
from __future__ import annotations

import collections
import threading
import time

from . import flightrec as _flightrec
from . import locktrace as _locktrace
from .watchdog import _envf
from ..base import getenv as _getenv

__all__ = [
    "ENABLED", "configure", "reset", "observe", "stats", "ensure_thread",
    "is_oom", "oom_report", "check_now",
]


ENABLED = _getenv("MXTPU_MEMWATCH", "1") not in ("0", "false", "off")

_lock = _locktrace.named_lock("memwatch.state")
_cfg = {}


def _defaults():
    return {
        "poll_s": _envf("MXTPU_MEMWATCH_POLL_S", 1.0),
        "window": int(_envf("MXTPU_MEMWATCH_WINDOW", 16)),
        "warmup_s": _envf("MXTPU_MEMWATCH_WARMUP_S", 30.0),
        "min_bytes": int(_envf("MXTPU_MEMWATCH_MIN_BYTES", 64 << 20)),
    }


_cfg.update(_defaults())

_window = collections.deque(maxlen=max(2, _cfg["window"]))
_t0 = None           # first observe() — the warmup clock
_trip_level = None   # total bytes at the last trip; re-arm below it
_stats = {"samples": 0, "trips": 0, "dumps": 0, "oom_reports": 0,
          "last_trip_bytes": 0, "last_slope_bps": 0.0}
_thread = None
_stop = None
_reported_ooms = collections.deque(maxlen=8)  # id(exc) already dumped for


def configure(poll_s=None, window=None, warmup_s=None, min_bytes=None,
              enabled=None):
    """Override the env-derived knobs at runtime (tests, notebooks)."""
    global ENABLED, _window
    with _lock:
        if poll_s is not None:
            _cfg["poll_s"] = float(poll_s)
        if warmup_s is not None:
            _cfg["warmup_s"] = float(warmup_s)
        if min_bytes is not None:
            _cfg["min_bytes"] = int(min_bytes)
        if window is not None:
            _cfg["window"] = int(window)
            _window = collections.deque(_window,
                                        maxlen=max(2, int(window)))
    if enabled is not None:
        ENABLED = bool(enabled)


def reset():
    """Stop the poller and clear all state; knobs re-read from the env
    (test isolation)."""
    global _t0, _trip_level, _thread, _stop, ENABLED, _window
    with _lock:
        stop, thread = _stop, _thread
        _thread = _stop = None
    if stop is not None:
        stop.set()
    if thread is not None and thread.is_alive():
        thread.join(timeout=5)
    with _lock:
        _cfg.clear()
        _cfg.update(_defaults())
        _window = collections.deque(maxlen=max(2, _cfg["window"]))
        _t0 = None
        _trip_level = None
        for k in _stats:
            _stats[k] = 0.0 if k == "last_slope_bps" else 0
    _reported_ooms.clear()
    ENABLED = _getenv("MXTPU_MEMWATCH", "1") not in ("0", "false", "off")


def stats():
    """Flat JSON-safe snapshot — surfaced as
    ``profiler.metrics()['memory']['memwatch']``."""
    with _lock:
        out = dict(_stats)
        out["enabled"] = int(ENABLED)
        out["window"] = len(_window)
        out["armed"] = int(_armed_locked(time.monotonic()))
    return out


def _armed_locked(now):
    return (_t0 is not None and now - _t0 >= _cfg["warmup_s"]
            and len(_window) == _window.maxlen
            and _trip_level is None)


def observe(snapshot=None, now=None):
    """Feed one ledger sample into the detector and trip it when the
    rolling window shows monotone post-warmup growth. Called by the
    daemon poll, by the profiler memory sampler while profiling runs,
    and synchronously by tests (``check_now``). Returns True on trip."""
    global _t0, _trip_level
    if not ENABLED:
        return False
    if snapshot is None:
        from .. import storage
        snapshot = storage.ledger_metrics()
    now = time.monotonic() if now is None else now
    total = int(snapshot.get("total_bytes", 0))
    with _lock:
        if _t0 is None:
            _t0 = now
        _stats["samples"] += 1
        if _trip_level is not None and \
                total < _trip_level - _cfg["min_bytes"] // 2:
            _trip_level = None  # episode over: growth receded, re-arm
        _window.append((now, total, dict(snapshot.get("by_tag", ()))))
        if not _armed_locked(now):
            return False
        pts = list(_window)
        grown = pts[-1][1] - pts[0][1]
        span = pts[-1][0] - pts[0][0]
        if grown < _cfg["min_bytes"] or span <= 0:
            return False
        if any(b[1] < a[1] for a, b in zip(pts, pts[1:])):
            return False  # not monotone: churn, not a leak
        slope = grown / span
        _trip_level = total
        _stats["trips"] += 1
        _stats["last_trip_bytes"] = total
        _stats["last_slope_bps"] = round(slope, 1)
        tag_growth = {
            t: pts[-1][2].get(t, 0) - pts[0][2].get(t, 0)
            for t in set(pts[0][2]) | set(pts[-1][2])}
        top_tags = sorted(((t, g) for t, g in tag_growth.items() if g > 0),
                          key=lambda kv: -kv[1])[:4]
    from .. import profiler as _profiler
    _profiler.marker(
        "memwatch:leak",
        args={"grown_bytes": grown, "window_s": round(span, 1),
              "slope_bps": round(slope, 1),
              "top_tags": dict(top_tags)},
        lane="memory", category="memwatch")
    path = _flightrec.dump(
        "memleak",
        extra={"grown_bytes": grown, "window_s": round(span, 1),
               "slope_bytes_per_s": round(slope, 1),
               "total_bytes": total,
               "top_tags": [{"tag": t, "grown_bytes": g}
                            for t, g in top_tags],
               "top_sites": snapshot.get("top_sites", [])},
        swallow=True)
    if path is not None:
        with _lock:
            _stats["dumps"] += 1
    return True


def check_now():
    """Force one detector pass synchronously (tests / debugger)."""
    return observe()


def _loop(stop):
    while not stop.wait(_cfg["poll_s"]):
        try:
            observe()
        except Exception:
            pass  # the watchdog must never take the process down


def ensure_thread():
    """Lazily start the daemon poller (idempotent) — called by the first
    ledger drain request so pure-eager processes get leak detection
    without any wiring."""
    global _thread, _stop
    if not ENABLED:
        return
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        _stop = threading.Event()
        _thread = threading.Thread(target=_loop, args=(_stop,),
                                   daemon=True, name="mxtpu-memwatch")
        _thread.start()


# ---------------------------------------------------------------------------
# OOM post-mortem
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("OutOfMemoryError", "RESOURCE_EXHAUSTED", "Out of memory",
                "out of memory", "OOM ")


def is_oom(exc):
    """Does this exception look like a device-memory exhaustion? The
    caching allocator raises ``torch.cuda.OutOfMemoryError`` ("CUDA out
    of memory"); the match is textual, as in the JAX package, so that the
    fault-point path's plain exceptions match too."""
    if exc is None:
        return False
    text = "%s: %s" % (type(exc).__name__, exc)
    return any(m in text for m in _OOM_MARKERS)


def oom_report(exc, requested_bytes=None, where=None):
    """Write the OOM post-mortem shard for an allocation failure seen at
    a placement seam (``ndarray._ctx_place``): the failed request size and
    site in ``trigger_info``, the full ledger in the bundled
    ``metrics()``. Unhandled OOMs take the excepthook chain instead
    (``flightrec`` asks :func:`is_oom` there); ``_reported_ooms`` keeps
    the two from double-dumping one exception. Returns the shard path
    (None if capped or already reported)."""
    key = id(exc)
    if key in _reported_ooms:
        return None
    _reported_ooms.append(key)
    with _lock:
        _stats["oom_reports"] += 1
    from .. import storage
    try:
        ledger = storage.ledger_metrics()
    except Exception:
        ledger = {}
    return _flightrec.dump(
        "oom",
        extra={"error": ("%s: %s" % (type(exc).__name__, exc))[:800],
               "requested_bytes": requested_bytes,
               "where": where,
               "ledger_total_bytes": ledger.get("total_bytes"),
               "ledger_by_tag": ledger.get("by_tag", {}),
               "top_sites": ledger.get("top_sites", [])},
        swallow=True)


def was_reported(exc):
    """Has ``oom_report`` already dumped for this exception object? (The
    excepthook consults this so a handled-then-reraised OOM yields ONE
    shard.)"""
    return id(exc) in _reported_ooms


# surfaces inside metrics()['memory'] via storage.memory_metrics();
# registered lazily there — no profiler import needed at module load
