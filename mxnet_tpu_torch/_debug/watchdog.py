"""Step watchdog: hang and straggler detection for training loops
(counterpart of mxnet_tpu/_debug/watchdog.py).

One wedged step sets a job's pace, and a job nobody is watching silently
runs slow or not at all. This module is a progress beacon and a daemon
thread:

- The fused train step (``gluon/fused_step.py``) brackets every step
  with ``step_begin()`` / ``step_end()`` (re-entrant: nested loops count
  the outermost step only); a user loop may add its own outer beacon.
- Completed non-warm-up step durations feed rolling-median windows keyed
  by the step's signature tag (``None`` for untagged beacons), so two
  interleaved cadences (train and eval) each keep an honest median. Once
  any signature has ``MXTPU_WATCHDOG_MIN_SAMPLES`` completed steps, the
  watchdog is *armed* with threshold ``max(MXTPU_WATCHDOG_FACTOR *
  slowest_signature_median, MXTPU_WATCHDOG_MIN_S)`` (the in-flight
  step's signature is unknown, so the envelope tracks the slowest
  cadence); a completed step is judged a straggler against its own
  signature's median.
- A daemon thread polls the in-flight step; one that exceeds the
  threshold is a **stall**: counted (``metrics()['watchdog']``), marked
  in the trace, and the flight recorder dumps one post-mortem shard,
  exactly once per stall.
- Completed steps beyond the threshold count as ``slow_steps``.

Warm-up discipline: the first steps of a run are slow by construction
(in the port, the first-use kernel builds and cuDNN's plans). They are
excluded from the median (the beacon flags them ``warmup=True``) and the
watchdog is not armed until enough representative steps completed.

Each completed step feeds ``goodput.note_step``. The JAX module also
feeds the roofline join (``perfmodel.note_step``, ``fold_pending``),
which arrives with that module.

Env knobs, the JAX package's: ``MXTPU_WATCHDOG`` (default 1),
``MXTPU_WATCHDOG_FACTOR`` (default 8), ``MXTPU_WATCHDOG_MIN_S``
(default 5), ``MXTPU_WATCHDOG_POLL_S`` (default min_s/5, clamped to
[0.02, 1]), ``MXTPU_WATCHDOG_WINDOW`` (default 32),
``MXTPU_WATCHDOG_MIN_SAMPLES`` (default 3).
"""
from __future__ import annotations

import collections
import statistics
import threading
import time

from . import flightrec as _flightrec
from . import goodput as _goodput
from . import locktrace as _locktrace
from ..base import getenv as _getenv

__all__ = [
    "ENABLED", "configure", "reset", "reset_window", "step_begin",
    "step_end", "last_step", "threshold_s", "stats", "check_now",
]


def _envf(name, default):
    try:
        return float(_getenv(name, "") or default)
    except ValueError:
        return default


ENABLED = _getenv("MXTPU_WATCHDOG", "1") not in ("0", "false",
                                                        "off")

_lock = _locktrace.named_lock("watchdog.state")
_cfg = {}        # factor/min_s/poll_s/window/min_samples (see _defaults)
_seq = 0         # beacon sequence: id of the newest step_begin
_depth = 0       # re-entrancy: nested loops track the OUTER step
_inflight = None  # (seq, monotonic start) of the running outer step
_inflight_warmup = False  # a nested warmup end taints the outer step
_inflight_mode = None     # nested step's execution mode (fused_step)
_inflight_sig = None      # nested step's compile-signature tag
_last = None     # (seq, dur_s) of the newest COMPLETED step
_tripped = None  # seq already dumped for — exactly one dump per stall
_stats = {"steps": 0, "warmup_steps": 0, "stalls": 0, "dumps": 0,
          "slow_steps": 0, "armed": 0, "median_s": 0.0,
          "threshold_s": 0.0, "last_stall_step": -1,
          "last_stall_elapsed_s": 0.0, "window_resets": 0,
          "sig_windows": 0}
_thread = None
_stop = None

# a run that churns through signatures must not leak windows; past the
# cap everything clears (the _CACHE_CAP one-shot idiom) and the
# watchdog re-arms from fresh samples
_MAX_SIG_WINDOWS = 64


def _defaults():
    return {
        "factor": _envf("MXTPU_WATCHDOG_FACTOR", 8.0),
        "min_s": _envf("MXTPU_WATCHDOG_MIN_S", 5.0),
        "poll_s": _envf("MXTPU_WATCHDOG_POLL_S", 0.0),  # 0 = derive
        "window": int(_envf("MXTPU_WATCHDOG_WINDOW", 32)),
        "min_samples": int(_envf("MXTPU_WATCHDOG_MIN_SAMPLES", 3)),
    }


_cfg.update(_defaults())

# completed non-warmup durations, keyed by the step's signature tag
# (None = untagged beacons). A single mixed window would let a second hot
# signature (eval vs train) skew the stall envelope; per-signature
# windows keep each cadence's own median honest. The stall envelope is
# the SLOWEST armed cadence (interleaving can never false-trip), and a
# completed step is judged against its OWN window.
_durs = {}


def _win_locked(sig):
    w = _durs.get(sig)
    if w is None:
        if len(_durs) >= _MAX_SIG_WINDOWS:
            _durs.clear()
        w = _durs[sig] = collections.deque(
            maxlen=max(1, _cfg["window"]))
    return w


def _armed_medians_locked():
    return [statistics.median(w) for w in _durs.values()
            if len(w) >= _cfg["min_samples"]]


def configure(factor=None, min_s=None, poll_s=None, window=None,
              min_samples=None, enabled=None):
    """Override the env-derived knobs at runtime (tests, notebooks)."""
    global ENABLED
    with _lock:
        if factor is not None:
            _cfg["factor"] = float(factor)
        if min_s is not None:
            _cfg["min_s"] = float(min_s)
        if poll_s is not None:
            _cfg["poll_s"] = float(poll_s)
        if min_samples is not None:
            _cfg["min_samples"] = int(min_samples)
        if window is not None:
            _cfg["window"] = int(window)
            for sig in list(_durs):
                _durs[sig] = collections.deque(
                    _durs[sig], maxlen=max(1, int(window)))
    if enabled is not None:
        ENABLED = bool(enabled)


def reset():
    """Stop the poller and clear all state; knobs re-read from the env
    (test isolation)."""
    global _seq, _depth, _inflight, _last, _tripped, _thread, _stop
    global ENABLED, _inflight_warmup, _inflight_mode, _inflight_sig
    with _lock:
        stop, thread = _stop, _thread
        _thread = _stop = None
    if stop is not None:
        stop.set()
    if thread is not None and thread.is_alive():
        thread.join(timeout=5)
    with _lock:
        _seq = _depth = 0
        _inflight = _last = _tripped = None
        _inflight_warmup = False
        _inflight_mode = None
        _inflight_sig = None
        _cfg.clear()
        _cfg.update(_defaults())
        _durs.clear()
        for k in _stats:
            _stats[k] = -1 if k == "last_stall_step" else 0
        _stats["median_s"] = _stats["threshold_s"] = 0.0
        _stats["last_stall_elapsed_s"] = 0.0
    ENABLED = _getenv("MXTPU_WATCHDOG", "1") not in (
        "0", "false", "off")


def reset_window():
    """Drop the rolling step-time median window — nothing else: the
    poller, cumulative stats and the in-flight beacon survive.

    Called by ``elastic_train_loop`` on every reshard/restore: step
    durations measured at the OLD world size pollute the median after a
    resize — a shrunk world's slower cadence against a fast stale
    median trips false stalls, and a grown world's fast cadence against
    a slow stale median masks real ones. Clearing the window disarms
    the watchdog until ``min_samples`` fresh steps at the NEW cadence
    complete (the same warm-up discipline the compile step gets).
    Clears EVERY signature's window — a reshard changes them all."""
    with _lock:
        _durs.clear()
        _stats["window_resets"] += 1


def _poll_interval():
    p = _cfg["poll_s"]
    if p > 0:
        return p
    return min(1.0, max(0.02, _cfg["min_s"] / 5.0))


def _median_locked():
    """The stall-envelope baseline: the SLOWEST armed signature's
    median. An in-flight step carries no signature (it is not known
    until dispatch returns), so the envelope must accommodate the
    slowest legitimate cadence — a fast eval window can never shrink
    it under the train cadence (the cross-contamination bug this
    keys-by-signature split fixes)."""
    meds = _armed_medians_locked()
    return max(meds) if meds else 0.0


def threshold_s():
    """Current stall threshold in seconds, or ``None`` while unarmed
    (no signature has enough representative completed steps yet)."""
    with _lock:
        meds = _armed_medians_locked()
        if not meds:
            return None
        return max(_cfg["factor"] * max(meds), _cfg["min_s"])


def last_step():
    """(seq, duration_s) of the newest completed step, or None — the
    per-rank gauge the kvstore heartbeat carries to the PS server."""
    return _last


def stats():
    """Flat JSON-safe snapshot — ``profiler.metrics()['watchdog']``."""
    with _lock:
        out = dict(_stats)
        meds = _armed_medians_locked()
        out["median_s"] = round(max(meds), 6) if meds else 0.0
        thr = (max(_cfg["factor"] * max(meds), _cfg["min_s"])
               if meds else 0.0)
        out["threshold_s"] = round(thr, 6)
        out["armed"] = int(bool(meds))
        out["sig_windows"] = len(_durs)
        out["enabled"] = int(ENABLED)
    return out


def step_begin():
    """Mark the start of a training step (re-entrant). Starts the
    poller thread lazily on first use when the watchdog is enabled."""
    global _seq, _depth, _inflight, _inflight_warmup, _inflight_mode
    global _inflight_sig
    if not ENABLED:
        return
    with _lock:
        _depth += 1
        if _depth > 1:
            return  # nested loop: the outer step owns the beacon
        _seq += 1
        _inflight = (_seq, time.monotonic())
        _inflight_warmup = False
        _inflight_mode = None
        _inflight_sig = None
    _ensure_thread()


def step_end(warmup=False, mode=None, sig=None):
    """Mark the end of the innermost-begun step. ``warmup=True`` steps
    (the first-use kernel builds, fallbacks) complete the beacon but do
    not feed the median: they are not representative of steady state.
    A nested warmup end taints the whole outer step (the outer duration
    contains it). ``mode`` carries the fused step's execution mode
    (``fused`` / ``fallback:*``) so that the goodput run ledger can
    attribute the step's wall time to compute, compile or host overhead;
    a nested mode taints the outer completion the same way. ``sig`` is
    the step's input-signature tag: it keys the rolling window this
    completion feeds and rides the goodput feed, with no new clock reads.

    The completed step feeds ``goodput.note_step`` AFTER this module's
    lock is released: one lock-free GIL-atomic append riding the
    beacon's own clock reads."""
    global _depth, _inflight, _last, _inflight_warmup, _inflight_mode
    global _inflight_sig
    if not ENABLED:
        return
    done = None
    with _lock:
        if _depth == 0:
            return
        _depth -= 1
        if warmup:
            _inflight_warmup = True
        if mode is not None:
            _inflight_mode = mode
        if sig is not None:
            _inflight_sig = sig
        if _depth > 0 or _inflight is None:
            return
        seq, t0 = _inflight
        _inflight = None
        warmup = warmup or _inflight_warmup
        mode = mode if mode is not None else _inflight_mode
        sig = sig if sig is not None else _inflight_sig
        _inflight_warmup = False
        _inflight_mode = None
        _inflight_sig = None
        dur = time.monotonic() - t0
        _last = (seq, dur)
        done = (t0, dur, warmup, mode, sig)
        if warmup:
            _stats["warmup_steps"] += 1
        else:
            _stats["steps"] += 1
            # the straggler verdict compares this completion against
            # its OWN signature's window (threshold BEFORE appending,
            # so a step can't vote itself normal)
            w = _win_locked(sig)
            thr = (max(_cfg["factor"] * statistics.median(w),
                       _cfg["min_s"])
                   if len(w) >= _cfg["min_samples"] else None)
            w.append(dur)
            if thr is not None and dur > thr and seq != _tripped:
                # finished, but way beyond the envelope: a straggler
                # (the in-flight poller may already have dumped for it)
                _stats["slow_steps"] += 1
    if _goodput.OPEN:
        # the goodput feed rides the beacon's OWN clock reads (t0/dur
        # above): the run ledger costs this one call per STEP, nothing
        # per op
        _goodput.note_step(done[0], done[1], warmup=done[2],
                           mode=done[3], sig=done[4])


def check_now():
    """Force one poll pass synchronously (tests; also useful from a
    debugger). Returns True when it tripped."""
    return _check(time.monotonic())


def _check(now):
    global _tripped
    with _lock:
        if _inflight is None or not _armed_medians_locked():
            return False
        seq, t0 = _inflight
        if seq == _tripped:
            return False
        thr = max(_cfg["factor"] * _median_locked(), _cfg["min_s"])
        elapsed = now - t0
        if elapsed <= thr:
            return False
        _tripped = seq
        _stats["stalls"] += 1
        _stats["last_stall_step"] = seq
        _stats["last_stall_elapsed_s"] = round(elapsed, 3)
        median = _median_locked()
    from .. import profiler as _profiler
    _profiler.marker("watchdog:stall",
                     args={"step": seq, "elapsed_s": round(elapsed, 3),
                           "threshold_s": round(thr, 3)},
                     category="watchdog")
    path = _flightrec.dump(
        "watchdog",
        extra={"step": seq, "elapsed_s": round(elapsed, 3),
               "threshold_s": round(thr, 3),
               "median_step_s": round(median, 6)},
        swallow=True)
    if path is not None:
        with _lock:
            _stats["dumps"] += 1
    return True


def _loop(stop):
    while not stop.wait(_poll_interval()):
        try:
            _check(time.monotonic())
            # drain the goodput hot-path mailboxes off the training
            # thread (drain on whoever asks)
            _goodput.fold_pending()
        except Exception:
            pass  # the watchdog must never take the training loop down


def _ensure_thread():
    global _thread, _stop
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        _stop = threading.Event()
        _thread = threading.Thread(target=_loop, args=(_stop,),
                                   daemon=True, name="mxtpu-watchdog")
        # start() UNDER the lock: it does not wait for the thread body
        # (which takes the lock itself), and a concurrent step_begin
        # must never observe a created-but-unstarted (is_alive()
        # False) thread and orphan it with a second poller
        _thread.start()


# surfaces as metrics()['watchdog'] and a dumps() provider line;
# registered here, after the profiler module is fully loaded (it imports
# this module at its bottom)
from .. import profiler as _profiler  # noqa: E402

_profiler.register_stats_provider("watchdog", stats)
