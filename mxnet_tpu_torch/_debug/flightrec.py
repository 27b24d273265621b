"""Always-on flight recorder: the black box under the telemetry plane
(counterpart of mxnet_tpu/_debug/flightrec.py).

The profiler is opt-in, and every diagnostic dies with the process. This
module keeps a fixed-size, lock-light ring of the most recent spans,
counters and markers that is **always on** (independent of
``profiler.set_state``) and dumps it, atomically (temp + rename), as a
chrome-trace shard the moment something goes wrong:

========================  ===================================================
unhandled exception       ``sys.excepthook`` chain (and
                          ``threading.excepthook`` for worker threads)
fatal signal              ``faulthandler`` is enabled into
                          ``flightrec_r<rank>_fatal.txt`` next to the shards
                          (SIGSEGV/SIGABRT cannot run Python: the native
                          stack file is the post-mortem for those)
on demand                 ``SIGUSR2`` (``kill -USR2 <pid>``): loss- and
                          bitwise-neutral; the run continues
watchdog trip             a stalled step (``_debug.watchdog``)
out of memory             ``torch.cuda.OutOfMemoryError`` (``_debug.memwatch``)
========================  ===================================================

Each dump bundles the ring (rendered as chrome-trace events on the
profiler's lanes and timebase, so ``profiler.merge_traces`` merges a
flight-record shard with live profiler shards into one timeline), all-
thread Python stacks, ``profiler.metrics()``, the fault-point trigger
counters, the goodput block and any registered context (``set_context``).

Hot-path contract (the reason this can be always on): the instrumented
sites share the profiler's one inlined guard, ``_HOOKS and
_profiler._LIVE`` where ``_LIVE = _ACTIVE or flightrec.ENABLED``, so
there is no second branch on the dispatch path, and the record itself is
one append into a ``collections.deque(maxlen=N)`` (a C ring buffer;
append is GIL-atomic, no lock). On the per-op dispatch path
(``ndarray/register.py`` ``invoke``) the append is a bare op name with no
clock read, and dump-time rendering anchors each bare-name breadcrumb to
the nearest timestamped neighbour (step spans, markers and counters carry
real timestamps).

Env knobs, the JAX package's:

- ``MXTPU_FLIGHTREC`` (default 1): master switch.
- ``MXTPU_FLIGHTREC_HOOKS`` (default 1): install the dump triggers at
  import.
- ``MXTPU_FLIGHTREC_EVENTS`` (default 4096): ring capacity.
- ``MXTPU_FLIGHTREC_DIR`` (default ``./flightrec/``, created lazily at
  the first write): where shards land.
- ``MXTPU_FLIGHTREC_MAX_DUMPS`` (default 32): per-process dump cap, so
  a crash loop or a thread-death storm cannot fill the disk.

Ring entry wire format (internal): the per-op dispatch site appends a
bare ``str`` (the op name — timestamp interpolated at dump time); the
helper recorders and ``profiler.record_op`` append
``(ph, name, category, tid, ts_s, value, args)`` with ``ph`` one of
``"X"`` (span, value = dur_us, ts_s = span END in perf_counter
seconds), ``"C"`` (counter, value = number or series dict), ``"i"``
(marker). perf_counter seconds convert onto the profiler trace clock
only at dump time.
"""
from __future__ import annotations

import collections
import os
import signal
import sys
import threading
import time
import traceback
from ..base import getenv as _getenv

__all__ = [
    "ENABLED", "RING", "enable", "disable", "configure", "reset_ring",
    "record_span", "record_counter", "record_marker", "snapshot",
    "stats", "dump", "dump_dir", "set_context", "install", "uninstall",
    "last_dumps",
]


def _env_on(name, default="1"):
    return _getenv(name, default) not in ("0", "false", "off")


# Master switch, read inline (one attribute load) by profiler._LIVE and
# the shared-guard record sites. enable()/disable() keep the profiler's
# _LIVE mirror in sync.
ENABLED = _env_on("MXTPU_FLIGHTREC")

_CAP = max(16, int(_getenv("MXTPU_FLIGHTREC_EVENTS", "4096") or 4096))
_MAX_DUMPS = int(_getenv("MXTPU_FLIGHTREC_MAX_DUMPS", "32") or 32)

# The ring. deque(maxlen=) is a C ring buffer: append is O(1) and
# GIL-atomic, old entries fall off the far end — lock-light by
# construction. Hot sites append raw tuples directly (see module
# docstring for the entry format).
RING = collections.deque(maxlen=_CAP)

_STATS = {
    "recorded": 0,     # entries appended through the helper recorders
    "dumps": 0,        # shards written
    "dump_failures": 0,
}
_DUMP_PATHS = collections.deque(maxlen=16)  # newest shard paths
_SEQ = [0]

_context = {}                   # set_context() payloads, bundled per dump
_context_lock = threading.Lock()

_prev_sys_hook = None
_prev_threading_hook = None
_prev_sigusr2 = None
_fatal_file = None
_installed = False


def _sync_profiler_live():
    """Refresh profiler._LIVE (the shared hot-path guard) after an
    ENABLED flip. Lazy import: profiler imports this module at load."""
    try:
        from .. import profiler
        profiler._update_live()
    except Exception:
        pass


def enable():
    """Turn the recorder on at runtime. Returns the previous state."""
    global ENABLED
    prev = ENABLED
    ENABLED = True
    _sync_profiler_live()
    return prev


def disable():
    global ENABLED
    prev = ENABLED
    ENABLED = False
    _sync_profiler_live()
    return prev


def configure(capacity=None, enabled=None):
    """Resize the ring (drops buffered entries) and/or flip the master
    switch — test/tooling surface; production uses the env knobs."""
    global RING, _CAP
    if capacity is not None:
        _CAP = max(16, int(capacity))
        RING = collections.deque(RING, maxlen=_CAP)
    if enabled is not None:
        (enable if enabled else disable)()


def reset_ring():
    """Drop every buffered entry and zero the counters (test isolation)."""
    RING.clear()
    for k in _STATS:
        _STATS[k] = 0
    _DUMP_PATHS.clear()


def dump_dir():
    """Where shards (and the faulthandler fatal file) land:
    ``MXTPU_FLIGHTREC_DIR`` or ``./flightrec`` — created lazily by
    :func:`_ensure_dump_dir` at the first actual write, so importing the
    framework never litters the CWD."""
    return _getenv("MXTPU_FLIGHTREC_DIR", "") or \
        os.path.join(os.getcwd(), "flightrec")


def _ensure_dump_dir():
    d = dump_dir()
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        pass  # read-only CWD: the write itself will surface the error
    return d


def set_context(key, value):
    """Attach a JSON-safe blob to every future dump under
    ``metadata.context[key]`` — e.g. the elastic controller publishes
    its committed world/dead-rank view here so a post-mortem names the
    job topology at the instant of death."""
    with _context_lock:
        _context[key] = value


# -- recording ---------------------------------------------------------------
# Helper recorders for everything OFF the per-op dispatch path (the
# profiler primitives route through these). The per-op dispatch site in
# ndarray/register.py appends a bare op name inline instead: the
# helper-call overhead (or even one clock read) alone would breach the
# <0.5%-of-dispatch budget.

def record_span(name, dur_us, category="operator", tid=0, args=None):
    RING.append(("X", name, category, tid, time.perf_counter(), dur_us,
                 args))
    _STATS["recorded"] += 1


def record_counter(name, value, tid=0, args=None):
    RING.append(("C", name, "counter", tid, time.perf_counter(), value,
                 args))
    _STATS["recorded"] += 1


def record_marker(name, category="instant", tid=0, args=None):
    RING.append(("i", name, category, tid, time.perf_counter(), 0, args))
    _STATS["recorded"] += 1


def snapshot():
    """Atomic copy of the ring, oldest first (list(deque) runs as one C
    call under the GIL — no torn reads, no lock)."""
    return list(RING)


def stats():
    """Flat JSON-safe counters — ``profiler.metrics()['flightrec']``
    (registered as a stats provider by the profiler). ``recorded``
    counts helper-recorded entries only; the raw per-op appends are
    deliberately uncounted (the budget forbids a counter bump there),
    so ``buffered`` is the ground truth for ring occupancy."""
    return {
        "enabled": bool(ENABLED),
        "capacity": _CAP,
        "buffered": len(RING),
        "recorded": _STATS["recorded"],
        "dumps": _STATS["dumps"],
        "dump_failures": _STATS["dump_failures"],
    }


def last_dumps():
    """Paths of the most recent shards this process wrote."""
    return list(_DUMP_PATHS)


# -- dumping -----------------------------------------------------------------

def _thread_stacks():
    """{thread name (id): [frame lines]} for every live thread — the
    'where was everyone' half of a post-mortem."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = "%s (%d)" % (names.get(tid, "?"), tid)
        out[label] = [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
    return out


def _render_events(entries, profiler):
    """Ring entries -> chrome-trace events on the profiler's trace clock
    and pid/lanes, so a flight-record shard merges with live profiler
    shards into one aligned timeline.

    Bare-name breadcrumbs (the clock-free per-op dispatch records) have
    no timestamp of their own: each renders as an instant event at the
    most recent timestamped entry's time (leading ones backfill from
    the first anchor; a ring with no anchors at all falls back to dump
    time), flagged ``args.ts_approx`` — the *order* is exact, the time
    is bounded by the neighboring anchors."""
    t0 = profiler._t0
    pid = profiler.PID
    events = []
    pending = []     # leading bare-name entries awaiting the 1st anchor
    last_ts = None   # newest anchor, trace-clock us

    def _bare(name, ts):
        return {"name": name, "cat": "operator", "ph": "i", "s": "t",
                "ts": ts, "pid": pid, "tid": 1,  # imperative lane
                "args": {"ts_approx": True}}

    for e in entries:
        if isinstance(e, str):  # bare-name dispatch breadcrumb
            if last_ts is None:
                pending.append(e)
            else:
                events.append(_bare(e, last_ts))
            continue
        ph, name, cat, tid, ts_s, value, args = e
        ev = {"name": name, "cat": cat, "ph": ph,
              "ts": (ts_s - t0) * 1e6, "pid": pid, "tid": tid}
        if ph == "X":
            ev["ts"] -= value  # helper records at span END
            ev["dur"] = value
        elif ph == "C":
            ev["args"] = (dict(value) if isinstance(value, dict)
                          else {"value": value})
        elif ph == "i":
            ev["s"] = "p"
        if args:
            a = dict(ev.get("args", ()))
            a.update(args)
            ev["args"] = a
        last_ts = (ts_s - t0) * 1e6
        if pending:
            events.extend(_bare(n, ev["ts"]) for n in pending)
            del pending[:]
        events.append(ev)
    if pending:  # no timestamped entry in the whole ring
        now = (time.perf_counter() - t0) * 1e6
        events.extend(_bare(n, now) for n in pending)
    return events


def dump(trigger, extra=None, path=None, swallow=False):
    """Write one flight-recorder shard (chrome-trace JSON, atomic
    temp+rename via ``base.atomic_write``) and return its path.

    ``trigger`` names why (``exception`` / ``thread-exception`` /
    ``sigusr2`` / ``watchdog`` / ``manual``); ``extra`` lands under
    ``metadata.trigger_info``. With ``swallow=True`` (the hook paths —
    a failing dump must never mask the original crash) failures are
    counted and ``None`` is returned instead of raising."""
    try:
        return _dump(trigger, extra, path)
    except Exception:
        _STATS["dump_failures"] += 1
        if swallow:
            return None
        raise


def _dump(trigger, extra, path):
    if _STATS["dumps"] >= _MAX_DUMPS and path is None:
        return None  # dump-storm cap: a crash loop must not fill the disk
    import json

    from .. import base, profiler
    from . import faultpoint

    entries = snapshot()
    events = profiler._lane_metadata() + _render_events(entries, profiler)
    events.append({"name": "flightrec:%s" % trigger, "cat": "flightrec",
                   "ph": "i", "s": "g", "ts": profiler._now_us(),
                   "pid": profiler.PID,
                   "tid": profiler.LANES["user"]})
    try:
        metrics = profiler.metrics()
    except Exception as e:  # the crashing process may be half-torn-down
        metrics = {"error": "%s: %s" % (type(e).__name__, e)}
    with _context_lock:
        context = dict(_context)
    # the run-level goodput partition: a post-mortem names not just the
    # instant of death but what the whole run's wall clock had bought up
    # to it. Lazy import: goodput bottom-imports the profiler, which
    # imports this module at load.
    try:
        from . import goodput
        goodput_block = goodput.snapshot()
    except Exception:
        goodput_block = None
    # the roofline join: a post-mortem names which signature was binding
    # on what when the run died (same lazy-import discipline)
    try:
        from . import perfmodel
        perf_block = perfmodel.snapshot()
    except Exception:
        perf_block = None
    data = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "rank": profiler.PID,
            "flightrec": True,
            "trigger": trigger,
            "trigger_info": extra or {},
            "clock_sync": profiler.clock_sync(),
            "python_stacks": _thread_stacks(),
            "metrics": metrics,
            "faults": faultpoint.metrics(),
            "goodput": goodput_block,
            "perf": perf_block,
            "context": context,
            "ring": {"buffered": len(entries), "capacity": _CAP},
        },
    }
    if path is None:
        _SEQ[0] += 1
        path = os.path.join(
            _ensure_dump_dir(), "flightrec_r%d_%s_%03d.json"
            % (profiler.PID, trigger, _SEQ[0]))
    with base.atomic_write(path, "w") as f:
        json.dump(data, f, default=str)
    _STATS["dumps"] += 1
    _DUMP_PATHS.append(path)
    return path


# -- crash hooks -------------------------------------------------------------

def _sys_excepthook(exc_type, exc, tb):
    # an unhandled torch.cuda.OutOfMemoryError is the OOM post-mortem
    # seam: upgrade the trigger so the shard names its cause and carries
    # the allocation ledger's view of what was resident
    trigger = "exception"
    extra = {"exception": "%s: %s" % (exc_type.__name__, exc)}
    try:
        from . import memwatch
        if memwatch.is_oom(exc):
            if memwatch.was_reported(exc):
                trigger = None  # a handled-then-reraised OOM: one shard
            else:
                trigger = "oom"
                from .. import storage
                ledger = storage.ledger_metrics()
                extra["ledger_total_bytes"] = ledger.get("total_bytes")
                extra["ledger_by_tag"] = ledger.get("by_tag", {})
                extra["top_sites"] = ledger.get("top_sites", [])
    except Exception:
        pass
    if trigger is not None:
        dump(trigger, extra=extra, swallow=True)
    if _prev_sys_hook is not None:
        _prev_sys_hook(exc_type, exc, tb)


def _threading_excepthook(args):
    if args.exc_type is SystemExit:
        pass  # thread called sys.exit: not a crash
    else:
        dump("thread-exception",
             extra={"thread": getattr(args.thread, "name", "?"),
                    "exception": "%s: %s" % (args.exc_type.__name__,
                                             args.exc_value)},
             swallow=True)
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


_sigusr2_inflight = threading.Lock()


def _sigusr2_dump_thread():
    try:
        # reads state only — a mid-training dump is loss- and bitwise-
        # neutral (tests/test_flightrec.py pins that)
        dump("sigusr2", swallow=True)
    finally:
        _sigusr2_inflight.release()


def _sigusr2_handler(signum, frame):
    # NEVER dump inline: the handler preempts the main thread between
    # bytecodes, and dump() takes profiler/watchdog/context locks — all
    # non-reentrant. If the signal lands inside one of their ``with
    # _lock:`` regions (e.g. account() on a kvstore byte ledger), an
    # inline dump deadlocks the main thread on its own lock. A helper
    # thread merely blocks until the main thread resumes and releases.
    if _sigusr2_inflight.acquire(blocking=False):
        threading.Thread(target=_sigusr2_dump_thread,
                         name="flightrec-sigusr2", daemon=True).start()
    if callable(_prev_sigusr2):
        _prev_sigusr2(signum, frame)


def install():
    """Wire the dump triggers (idempotent): chain ``sys.excepthook`` and
    ``threading.excepthook``, take SIGUSR2 (main thread only; chains to
    any user handler), and enable ``faulthandler`` into a sibling
    ``flightrec_r<rank>_fatal.txt`` unless something (e.g. pytest)
    already owns it. Called at import when the recorder is enabled (not
    inside a pytest process: see the module's last lines)."""
    global _prev_sys_hook, _prev_threading_hook, _prev_sigusr2
    global _fatal_file, _installed
    if _installed:
        return
    _installed = True
    _prev_sys_hook = sys.excepthook
    sys.excepthook = _sys_excepthook
    _prev_threading_hook = threading.excepthook
    threading.excepthook = _threading_excepthook
    try:
        _prev_sigusr2 = signal.signal(signal.SIGUSR2, _sigusr2_handler)
    except (ValueError, OSError, AttributeError):
        _prev_sigusr2 = None  # non-main thread / platform without USR2
    try:
        import faulthandler
        if not faulthandler.is_enabled():
            fatal_path = os.path.join(
                _ensure_dump_dir(), "flightrec_r%d_fatal.txt"
                % int(_getenv("MXTPU_PROC_ID", "0") or 0))
            # append, never truncate: an elastic restart in the same
            # dump dir (same MXTPU_PROC_ID) must not erase the PREVIOUS
            # incarnation's native stacks — the one artifact a SIGSEGV
            # leaves behind. The clean-exit cleanup only removes the
            # file when it is empty, so preserved content survives.
            _fatal_file = open(fatal_path, "a")
            faulthandler.enable(file=_fatal_file)
            import atexit
            atexit.register(_cleanup_fatal_file, fatal_path)
    except Exception:
        _fatal_file = None  # a read-only cwd must not break import


def _cleanup_fatal_file(path):
    """A clean exit leaves no litter: the faulthandler file only stays
    behind when a fatal signal actually wrote native stacks into it."""
    global _fatal_file
    f, _fatal_file = _fatal_file, None
    if f is None:
        return
    try:
        import faulthandler
        if faulthandler.is_enabled():
            faulthandler.disable()
        f.close()
        if os.path.getsize(path) == 0:
            os.remove(path)
            # only the lazily-created DEFAULT dir is cleaned up on a
            # clean exit; an operator-configured MXTPU_FLIGHTREC_DIR
            # (pre-created, owned, permissioned) is never touched
            if not _getenv("MXTPU_FLIGHTREC_DIR", ""):
                try:
                    os.rmdir(os.path.dirname(path))
                except OSError:
                    pass
    except Exception:
        pass


def uninstall():
    """Undo install() (test isolation)."""
    global _prev_sys_hook, _prev_threading_hook, _prev_sigusr2
    global _fatal_file, _installed
    if not _installed:
        return
    _installed = False
    if sys.excepthook is _sys_excepthook:
        sys.excepthook = _prev_sys_hook or sys.__excepthook__
    if threading.excepthook is _threading_excepthook and \
            _prev_threading_hook is not None:
        threading.excepthook = _prev_threading_hook
    if _prev_sigusr2 is not None:
        try:
            if signal.getsignal(signal.SIGUSR2) is _sigusr2_handler:
                signal.signal(signal.SIGUSR2, _prev_sigusr2)
        except (ValueError, OSError):
            pass
    _prev_sys_hook = _prev_threading_hook = _prev_sigusr2 = None
    if _fatal_file is not None:
        try:
            import faulthandler
            if faulthandler.is_enabled():
                faulthandler.disable()
            _fatal_file.close()
        except Exception:
            pass
        _fatal_file = None


# Installed at import, as in the JAX package, but not inside a pytest
# process: there the JAX package's tests share the process and hold its
# hooks to be their own (the handler in place, one shard per signal), and
# the port's tests install and uninstall them explicitly.
if ENABLED and _env_on("MXTPU_FLIGHTREC_HOOKS") and "pytest" not in sys.modules:
    install()
