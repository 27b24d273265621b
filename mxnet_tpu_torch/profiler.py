"""Profiler: per-op tracing + user Domains/Tasks/Counters/Events
(counterpart of mxnet_tpu/profiler.py; ref: python/mxnet/profiler.py,
src/profiler/profiler.h:251, src/profiler/aggregate_stats.cc).

Two sides, as in the JAX package:

* **Device side.** While a profile run is active (``xprof=True``, the
  default), a ``torch.profiler`` session records the card's kernels and
  copies through kineto (CUPTI), where the JAX package starts an xprof
  trace. The session opens with ``DEVICE_PRIMER`` empty kernels and a
  synchronize (a late session can lose the device events of its first
  launches), and at ``set_state('stop')`` kineto's chrome trace is written
  into ``xprof_dir`` (default: ``xprof_trace`` next to ``filename``). Each
  launch of the window is matched to its device event by correlation id:
  ``metrics()['profiler']`` carries the trace's path, its kernel counts by
  name and the launches that found no device event. A session that cannot
  start (another kineto session is active, say) leaves the run host-only,
  as in the JAX package, but not in silence: the reason lands in
  ``metrics()['profiler']['device_error']`` and in the first line of
  ``dumps()``.
* **Host side.** An in-process event recorder mirrors the reference's
  chrome://tracing JSON dump (``DumpProfile``, profiler.h:299) and
  aggregate table (``dumps``), and backs the user-facing
  Domain/Task/Frame/Event/Counter/Marker objects.

The host trace is organized into the JAX package's **lanes** (chrome-trace
tid rows named by ``thread_name`` metadata): ``imperative`` (op dispatch),
``bulk`` (unused: the port has no bulk segments), ``kvstore``
(push/pull/init + byte counters), ``io`` (prefetch spans + queue depth),
``autograd`` (backward sweeps), ``memory`` (per-device memory counters),
``gluon`` (Trainer.step, the fused step), ``user`` (Domain/Task/...),
``compile`` (the first-use kernel builds) and ``health``. Subsystems emit
through ``record_op`` / ``record_counter`` / ``account`` and guard on
``profiler._LIVE`` first, so everything is near zero-cost when profiling
is off. Host times are ``time.perf_counter`` microseconds since import.

``profile_memory`` samples ``storage.stats()`` on a background thread into
the ``memory`` lane. ``continuous_dump``/``dump_period`` rewrite the trace
file atomically every period, so long runs are inspectable mid-flight.
``metrics()`` returns the whole surface as one JSON-safe dict.

Distributed observability: every event carries ``pid=rank`` so per-rank
trace shards merge into one chrome trace (``merge_traces``), aligned by the
clock offsets recorded with ``record_clock_sync``; ``record_latency``
feeds log-bucketed histograms with p50/p95/p99 in ``metrics()['latency']``;
``record_flow`` emits chrome flow events; ``serve_metrics`` exposes the
snapshot as a zero-dependency Prometheus ``/metrics`` HTTP endpoint on
localhost (``MXNET_PROFILER_HTTP_PORT``).
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time

from ._debug import flightrec as _flightrec
from ._debug import locktrace as _locktrace
from .base import getenv as _getenv

__all__ = [
    "set_config", "set_state", "dump", "dumps", "pause", "resume",
    "Domain", "Task", "Frame", "Event", "Counter", "Marker",
    "record_op", "record_counter", "account", "sample_memory", "metrics",
    "is_running", "imperative_stats", "reset_imperative_stats", "LANES",
    "register_stats_provider", "record_latency", "record_flow",
    "record_clock_sync", "clock_sync", "latency_metrics",
    "serve_metrics", "stop_metrics_server", "prometheus_text",
    "merge_traces", "PID",
    "marker", "bump_elastic", "elastic_stats", "reset_elastic_stats",
    "record_compile", "compile_stats", "ensure_lane",
    "record_program", "program_records",
]

# chrome-trace pid of every event this process emits: the worker rank.
# Per-rank trace shards then merge into ONE job-wide trace with each
# rank as its own process row (merge_traces).
PID = int(_getenv("MXTPU_PROC_ID", "0") or 0)

# Stable pid/tid lanes of the host trace. tid doubles as the sort index.
LANES = {
    "imperative": 0,
    "bulk": 1,
    "kvstore": 2,
    "io": 3,
    "autograd": 4,
    "memory": 5,
    "gluon": 6,
    "user": 7,
    "compile": 8,
    "health": 9,
}

# dynamic lanes (ensure_lane) are allocated from here up, so the fixed
# rows above keep their stable sort indices even as subsystems add rows
_DYN_LANE_BASE = 16


def ensure_lane(name, base=None):
    """Allocate (or return) a stable trace tid for a *dynamic* lane —
    e.g. one trace row per decode-pool worker (``io.w0``, ``io.w1``,
    ...). Idempotent: the first caller wins the tid, every later call
    returns it, and the lane shows up in the trace's thread_name
    metadata like the built-in rows. Dynamic tids start at
    ``_DYN_LANE_BASE`` so the fixed lanes keep their sort order."""
    floor = _DYN_LANE_BASE if base is None else int(base)
    with _lock:
        tid = LANES.get(name)
        if tid is None:
            tid = max(max(LANES.values()) + 1, floor)
            LANES[name] = tid
        return tid

_lock = _locktrace.named_lock("profiler.events")
_state = {
    "running": False,
    "paused": False,
    "filename": "profile.json",
    "aggregate_stats": False,
    "profile_memory": False,
    "continuous_dump": False,
    "dump_period": 1.0,
    "xprof": True,
    "xprof_dir": None,
    "xprof_active": False,
    # the device session of the newest run: None until a run asked for
    # one, then {"trace", "error", "kernels", "launches", "lost", ...}
    "xprof_status": None,
}
# Empty kernels (and a synchronize) each device session opens with: a
# torch.profiler window opened late in a long process can drop the device
# events of the launches made near its start.
DEVICE_PRIMER = 256
_kineto = None  # the active torch.profiler.profile of a run, or None
# Fast-path guard mirrored from (running and not paused). Subsystem hooks
# read this module attribute before building any event dict: the
# profiling-off cost of the whole telemetry layer is this one truth test.
_ACTIVE = False
# The SHARED hot-path guard: true when a profile run is active OR the
# always-on flight recorder wants span feeds. Hot call sites guard on
# `_HOOKS and _profiler._LIVE`: ONE inlined truth test covers both
# consumers, and record_op /
# record_counter / marker / account internally fan out to the flight-
# recorder ring before gating trace emission on _ACTIVE. Maintained by
# _update_live() from set_state/pause/resume and flightrec.enable/
# disable.
_LIVE = _flightrec.ENABLED


def _update_live():
    global _LIVE
    _LIVE = _ACTIVE or _flightrec.ENABLED

_events = []          # chrome-trace event dicts
_agg = {}             # name -> [count, total_us, min_us, max_us]
_counters = {}        # cumulative subsystem counters (kvstore/io bytes, ...)
_mem_last = {}        # str(device) -> last sampled memory dict
# name -> [count, sum_us, min_us, max_us, {bucket_idx: count}] — the
# log-bucketed latency histograms behind record_latency()
_latency = {}
# peer -> {"offset_us", "rtt_us", "samples", "primary"}: clock-offset
# estimates from the kvstore heartbeat path (min-RTT sample wins); the
# trace-merge CLI reads these out of each shard's metadata block
_clock_sync = {}
_t0 = time.perf_counter()

# Trace-event cap: a multi-hour run with the 10Hz memory sampler + per-op
# spans must not grow _events (and the continuous-dump serialization of
# it) without bound. Aggregate/counter totals keep counting past the cap;
# only raw timeline events are dropped, tallied in
# counters['profiler.dropped_events'].
_MAX_EVENTS = int(_getenv("MXNET_PROFILER_MAX_EVENTS", "1000000"))
# serializes trace-file writers (continuous-dump daemon vs explicit
# dump()): both write the same temp path, and interleaved writers would
# break the atomic-rewrite guarantee
_dump_lock = _locktrace.named_lock("profiler.dump")


def _append_locked(ev):
    """Append one trace event; caller holds _lock. Drops (and tallies)
    events past _MAX_EVENTS so unbounded runs stay bounded."""
    if len(_events) >= _MAX_EVENTS:
        _counters["profiler.dropped_events"] = \
            _counters.get("profiler.dropped_events", 0) + 1
        return
    _events.append(ev)


_mem_thread = None
_dump_thread = None
_threads_stop = None

_VALID_CONFIG_KEYS = frozenset((
    "filename", "aggregate_stats", "profile_memory", "continuous_dump",
    "dump_period", "xprof", "xprof_dir", "profile_all", "profile_symbolic",
    "profile_imperative", "profile_api", "profile_process",
))


def _now_us():
    return (time.perf_counter() - _t0) * 1e6


def set_config(**kwargs):
    """Configure the profiler (ref: python/mxnet/profiler.py:33
    MXSetProcessProfilerConfig). Accepted keys: ``filename``,
    ``profile_all/profile_symbolic/profile_imperative/profile_api``
    (accepted for parity; host+device tracing is unified here),
    ``profile_memory`` (background device-memory sampling into the
    ``memory`` lane), ``aggregate_stats``, ``continuous_dump``/
    ``dump_period`` (atomic periodic trace rewrite), ``profile_process``,
    and the JAX package's ``xprof`` (bool: record a device trace, default
    True; here a ``torch.profiler`` session) / ``xprof_dir`` (directory
    for it; defaults next to ``filename``).

    The whole kwargs dict is validated before ANY of it is applied, so a
    bad call can never leave the config half-mutated."""
    if not set(kwargs) <= _VALID_CONFIG_KEYS:
        bad = sorted(set(kwargs) - _VALID_CONFIG_KEYS)
        raise ValueError("unknown profiler config key%s %s"
                         % ("s" if len(bad) > 1 else "", ", ".join(
                             repr(k) for k in bad)))
    if "dump_period" in kwargs:
        period = float(kwargs["dump_period"])
        if period <= 0:
            raise ValueError("dump_period must be > 0, got %r"
                             % (kwargs["dump_period"],))
        kwargs["dump_period"] = period
    if "filename" in kwargs and not isinstance(kwargs["filename"], str):
        raise ValueError("filename must be a string")
    with _lock:
        if "filename" in kwargs:
            _state["filename"] = kwargs["filename"]
        for key in ("aggregate_stats", "profile_memory", "continuous_dump",
                    "xprof"):
            if key in kwargs:
                _state[key] = bool(kwargs[key])
        if "dump_period" in kwargs:
            _state["dump_period"] = kwargs["dump_period"]
        if "xprof_dir" in kwargs:
            _state["xprof_dir"] = kwargs["xprof_dir"]


def set_state(state="stop", profile_process="worker"):
    """Start/stop profiling (ref: python/mxnet/profiler.py:89). Starting
    also opens a device session when enabled (``xprof=True``; the module
    docstring), plus the memory-sampler / continuous-dump daemon threads
    when configured. Stopping closes the session and writes its trace."""
    global _ACTIVE
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    if state == "run":
        with _lock:
            if _state["running"]:
                return
            _state["running"] = True
            _state["paused"] = False
            _ACTIVE = True
            _update_live()
            # the session's start/stop stays under _lock so a racing stop
            # can never observe a half-started device trace
            if _state["xprof"]:
                xdir = _state["xprof_dir"]
                if xdir is None:
                    xdir = os.path.join(
                        os.path.dirname(
                            os.path.abspath(_state["filename"])),
                        "xprof_trace")
                _state["xprof_dir"] = xdir
                _device_start_locked()
            profile_memory = _state["profile_memory"]
            continuous = _state["continuous_dump"]
            period = _state["dump_period"]
        _start_daemons(profile_memory, continuous, period)
        # live export: MXNET_PROFILER_HTTP_PORT opts a run into the
        # /metrics endpoint without any code change; set_state('stop')
        # takes it down again (before the final trace dump)
        if _getenv("MXNET_PROFILER_HTTP_PORT"):
            try:
                serve_metrics()
            except (OSError, ValueError, OverflowError):
                pass  # port taken / malformed or out-of-range env value:
                #      host tracing must not die for a telemetry config typo
    else:
        with _lock:
            if not _state["running"]:
                return
            _state["running"] = False
            _ACTIVE = False
            _update_live()
            continuous = _state["continuous_dump"]
            if _state["xprof_active"]:
                _state["xprof_active"] = False
                _device_stop_locked()
        # shutdown ordering: the /metrics endpoint goes down FIRST, before
        # the daemons stop and the final trace rewrite (a scrape racing
        # shutdown could otherwise observe a partially-reset snapshot).
        # The next set_state('run') re-serves via the env autostart.
        stop_metrics_server()
        _stop_daemons()
        if continuous:
            _write_trace()  # final rewrite covers events since last period


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
_device_seq = [0]
_SYNC_EVENT = "mxtpu::clock_sync"


_SYNC_TS = re.compile(r'"name":\s*"%s".{0,400}?"ts":\s*([-+0-9.eE]+),'
                      r'\s*"dur":\s*([-+0-9.eE]+)' % re.escape(_SYNC_EVENT),
                      re.S)


def _stamp_device_trace(path, sync_host_us):
    """Give kineto's chrome trace at ``path`` the metadata of a profiler
    shard: this process's rank, and as its primary clock offset the host
    trace's time minus kineto's at the clock-sync event's midpoint. The
    trace (tens of MB for a few training steps) is edited as text, not
    parsed: its opening brace gains the ``metadata`` key."""
    with open(path) as f:
        text = f.read()
    meta = {"rank": PID, "device_trace": True}
    m = _SYNC_TS.search(text)
    if m:
        meta["clock_sync"] = {"host": {
            "offset_us": float(sync_host_us) - float(m.group(1))
            - float(m.group(2)) / 2,
            "rtt_us": 0.0, "primary": True, "samples": 1}}
    start = text.index("{") + 1
    text = "%s\n  \"metadata\": %s,%s" % (text[:start], json.dumps(meta),
                                         text[start:])
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _device_start_locked():
    """Open the run's torch.profiler session (caller holds _lock). A
    session that cannot start leaves the run host-only and records why."""
    global _kineto
    status = {"trace": None, "error": None, "kernels": {}, "launches": 0,
              "lost": 0, "primer": 0}
    _state["xprof_status"] = status
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        if cuda:
            for _ in range(DEVICE_PRIMER):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            status["primer"] = DEVICE_PRIMER
        # one host event read on both clocks: its midpoint on kineto's
        # clock against the midpoint of this trace's clock reads around
        # it maps the device trace onto the host trace (merge_traces
        # shifts it by the offset)
        t_a = _now_us()
        with torch.profiler.record_function(_SYNC_EVENT):
            pass
        status["sync_host_us"] = (t_a + _now_us()) / 2
    except Exception as e:
        status["error"] = "%s: %s" % (type(e).__name__, e)
        _state["xprof_active"] = False
        _kineto = None
        return
    _kineto = prof
    _state["xprof_active"] = True


def _device_stop_locked():
    """Close the session, write kineto's chrome trace into xprof_dir and
    summarize the device side (caller holds _lock): kernel events by name,
    and the window's launches (after the primer's) whose correlation id
    found no device event."""
    global _kineto
    prof, _kineto = _kineto, None
    status = _state["xprof_status"]
    if prof is None or status is None:
        return
    try:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        evs = prof.profiler.kineto_results.events()
        device = [e for e in evs if str(e.device_type()).endswith("CUDA")]
        seen = {e.correlation_id() for e in device}
        calls = sorted((e.start_ns(), e.correlation_id()) for e in evs
                       if str(e.device_type()).endswith("CPU")
                       and e.name() in _LAUNCH_CALLS)
        window = calls[status["primer"]:]
        status["launches"] = len(window)
        status["lost"] = sum(c not in seen for _, c in window)
        kernels = {}
        primer_ids = {c for _, c in calls[:status["primer"]]}
        for e in device:
            if e.correlation_id() in primer_ids:
                continue
            kernels[e.name()] = kernels.get(e.name(), 0) + 1
        status["kernels"] = kernels
        os.makedirs(_state["xprof_dir"], exist_ok=True)
        _device_seq[0] += 1
        path = os.path.join(_state["xprof_dir"], "kineto_r%d_%03d.json"
                            % (PID, _device_seq[0]))
        prof.export_chrome_trace(path)
        _stamp_device_trace(path, status.get("sync_host_us", 0.0))
        status["trace"] = path
    except Exception as e:
        status["error"] = "%s: %s" % (type(e).__name__, e)


def _device_status():
    """The newest run's device session (the module docstring), or None
    when no run asked for one. Surfaced as ``metrics()['profiler']``."""
    with _lock:
        st = _state["xprof_status"]
        if st is None:
            return None
        out = dict(st)
        out["kernels"] = dict(st["kernels"])
        out["active"] = _state["xprof_active"]
        out["dir"] = _state["xprof_dir"]
    return out


def _start_daemons(profile_memory, continuous, period):
    """Background samplers for an active run. The trace file is written
    IMMEDIATELY when continuous dump is on (then every ``dump_period``), so
    it exists and parses from the first moment of the run.

    Runs outside set_state's lock hold (thread starts must not happen
    under _lock), so a racing set_state('stop') is handled two ways: a
    re-check of ``running`` under _lock before starting anything, and the
    loops themselves exiting once the run is over — a daemon that lost
    the race self-terminates within one period instead of leaking."""
    global _mem_thread, _dump_thread, _threads_stop
    with _lock:
        if not _state["running"]:
            return
        _threads_stop = threading.Event()
    stop = _threads_stop
    if profile_memory:
        sample_memory("start")
        sample_period = float(_getenv(
            "MXNET_PROFILER_MEMORY_SAMPLE_PERIOD", "0.1"))

        def _mem_loop():
            while not stop.wait(sample_period):
                if not _state["running"]:
                    return
                sample_memory("sampler")
                _sample_ledger()

        _mem_thread = threading.Thread(
            target=_mem_loop, daemon=True, name="profiler-mem-sampler")
        _mem_thread.start()
    if continuous:
        _write_trace()

        def _dump_loop():
            while not stop.wait(period):
                if not _state["running"]:
                    return
                try:
                    _write_trace()
                except Exception:
                    pass  # a failed rewrite must not kill the daemon

        _dump_thread = threading.Thread(
            target=_dump_loop, daemon=True, name="profiler-continuous-dump")
        _dump_thread.start()


def _stop_daemons():
    global _mem_thread, _dump_thread, _threads_stop
    if _threads_stop is not None:
        _threads_stop.set()
    for t in (_mem_thread, _dump_thread):
        if t is not None and t.is_alive():
            t.join(timeout=5)
    _mem_thread = _dump_thread = _threads_stop = None


def is_running():
    return _state["running"] and not _state["paused"]


def pause(profile_process="worker"):
    """ref: python/mxnet/profiler.py:193. Emits a ``profiler.pause``
    instant marker (while still active, so the trace explains its own
    gap) and then suspends recording."""
    global _ACTIVE
    with _lock:
        if _state["running"] and not _state["paused"]:
            _append_locked({"name": "profiler.pause", "cat": "profiler",
                            "ph": "i", "s": "g", "ts": _now_us(), "pid": PID,
                            "tid": LANES["user"]})
        _state["paused"] = True
        _ACTIVE = False
        _update_live()


def resume(profile_process="worker"):
    """ref: python/mxnet/profiler.py:209. Re-enables recording and emits a
    ``profiler.resume`` instant marker bounding the gap."""
    global _ACTIVE
    with _lock:
        was_paused = _state["paused"]
        _state["paused"] = False
        _ACTIVE = _state["running"]
        _update_live()
        if _state["running"] and was_paused:
            _append_locked({"name": "profiler.resume", "cat": "profiler",
                            "ph": "i", "s": "g", "ts": _now_us(), "pid": PID,
                            "tid": LANES["user"]})


def record_op(name, dur_us, category="operator", args=None,
              lane="imperative"):
    """Record one completed span into ``lane``. Always feeds the
    flight-recorder ring (the post-mortem black box); the
    trace event + aggregate row are recorded only while a profile run
    is active. Call sites guard with the shared ``_HOOKS and _LIVE``
    idiom. Mirrors the engine's ProfileOperator
    (src/engine/threaded_engine.h:83)."""
    if _flightrec.ENABLED:
        # inlined ring append (record_span's shape): the fused step
        # pays this once per step — the helper call + stats bump would
        # eat a third of the <0.1%-of-step flightrec budget
        _flightrec.RING.append(("X", name, category, LANES.get(lane, 7),
                                time.perf_counter(), dur_us, args))
    if not _ACTIVE:
        return
    end = _now_us()
    ev = {"name": name, "cat": category, "ph": "X",
          "ts": end - dur_us, "dur": dur_us, "pid": PID,
          "tid": LANES.get(lane, LANES["user"])}
    if args:
        ev["args"] = args
    with _lock:
        _append_locked(ev)
        st = _agg.setdefault(name, [0, 0.0, float("inf"), 0.0])
        st[0] += 1
        st[1] += dur_us
        st[2] = min(st[2], dur_us)
        st[3] = max(st[3], dur_us)


def record_counter(name, value, lane="user", series=None):
    """Emit a gauge sample (chrome Counter event) into ``lane`` — e.g. the
    io prefetch queue depth. ``series`` optionally names multiple stacked
    series (a dict of series -> value). Always feeds the flight-recorder
    ring; the trace event gates on the profile run."""
    if _flightrec.ENABLED:
        _flightrec.record_counter(name, series if series is not None
                                  else value, LANES.get(lane, 7))
    if not _ACTIVE:
        return
    args = dict(series) if series is not None else {"value": value}
    ev = {"name": name, "cat": "counter", "ph": "C", "ts": _now_us(),
          "pid": PID, "tid": LANES.get(lane, LANES["user"]), "args": args}
    with _lock:
        _append_locked(ev)


def account(name, delta, lane="kvstore", emit=True):
    """Accumulate a cumulative subsystem counter (kvstore bytes pushed,
    connect retries, heartbeats, io batches, ...) and, when a profile run
    is active, emit the running total as a Counter event so the trace
    shows it over time. The totals surface in ``dumps()`` and
    ``metrics()['counters']``.

    The total accumulates UNCONDITIONALLY — only the trace-event emission
    gates on ``_ACTIVE`` — so production counters (bytes moved, retries,
    worker deaths) never silently drop deltas while profiling is off.
    Accounting sites sit on network/IO/exception paths, not the per-op
    dispatch hot path, so the always-on cost is one lock + dict update
    per already-expensive event (plus one flight-recorder ring append —
    the black box keeps the counter timeline a post-mortem needs)."""
    with _lock:
        total = _counters.get(name, 0) + delta
        _counters[name] = total
        if emit and _ACTIVE:
            _append_locked({"name": name, "cat": "counter", "ph": "C",
                            "ts": _now_us(), "pid": PID,
                            "tid": LANES.get(lane, LANES["user"]),
                            "args": {"value": total}})
    if emit and _flightrec.ENABLED:
        _flightrec.record_counter(name, total, LANES.get(lane, 7))


# -- latency histograms -------------------------------------------------------
# Log-spaced buckets: 8 sub-buckets per octave (power of 2), so every
# bucket spans <= 12.5% of its lower edge — percentile estimates carry a
# bounded ~6% relative error without storing raw samples. Bucket index
# packs (exponent, sub-bucket) from math.frexp; -1 is the [0, 0.5us)
# underflow bucket (sub-0.5us durations would otherwise pack to other
# negative indices that alias the sentinel's (0, 0) bounds — and emit
# duplicate le="0" series in one Prometheus exposition).
_LAT_SUBBITS = 3
_LAT_SUB = 1 << _LAT_SUBBITS


def _bucket_index(dur_us):
    if dur_us < 0.5:
        return -1
    m, e = math.frexp(dur_us)       # dur = m * 2**e, m in [0.5, 1)
    return (e << _LAT_SUBBITS) | int((m - 0.5) * 2 * _LAT_SUB)


def _bucket_bounds(idx):
    """(lo, hi) of bucket ``idx`` in microseconds."""
    if idx < 0:
        return 0.0, 0.5
    e, s = idx >> _LAT_SUBBITS, idx & (_LAT_SUB - 1)
    base = math.ldexp(1.0, e - 1)   # 2**(e-1)
    return base * (1.0 + s / _LAT_SUB), base * (1.0 + (s + 1) / _LAT_SUB)


def record_latency(name, dur_us):
    """Record one duration sample into the log-bucketed histogram
    ``name`` (the primitive behind ``metrics()['latency']`` and the
    Prometheus ``/metrics`` histograms). Hot-path callers guard with the
    inlined ``_HOOKS and _LIVE`` idiom; samples are only
    collected while a profile run is active."""
    if not _ACTIVE:
        return
    idx = _bucket_index(dur_us)
    with _lock:
        st = _latency.get(name)
        if st is None:
            st = _latency[name] = [0, 0.0, float("inf"), 0.0, {}]
        st[0] += 1
        st[1] += dur_us
        st[2] = min(st[2], dur_us)
        st[3] = max(st[3], dur_us)
        st[4][idx] = st[4].get(idx, 0) + 1


def _hist_percentile(buckets, count, q):
    """Quantile estimate by linear interpolation inside the bucket the
    cumulative count crosses ``q * count`` in."""
    target = q * count
    cum = 0.0
    for idx in sorted(buckets):
        n = buckets[idx]
        if cum + n >= target:
            lo, hi = _bucket_bounds(idx)
            return lo + (hi - lo) * ((target - cum) / n)
        cum += n
    return _bucket_bounds(max(buckets))[1]


def latency_metrics(reset=False):
    """{name: {count, sum_us, mean_us, min_us, max_us, p50_us, p95_us,
    p99_us}} — the ``metrics()['latency']`` section. ``reset`` clears
    the histograms under the SAME lock acquisition as the snapshot, so
    a sample recorded concurrently lands in either this snapshot or the
    next one — never in neither."""
    with _lock:
        snap = {n: (st[0], st[1], st[2], st[3], dict(st[4]))
                for n, st in _latency.items()}
        if reset:
            _latency.clear()
    out = {}
    for name, (count, total, mn, mx, buckets) in snap.items():
        if not count:
            continue
        out[name] = {
            "count": count,
            "sum_us": total,
            "mean_us": total / count,
            "min_us": mn,
            "max_us": mx,
            "p50_us": min(mx, _hist_percentile(buckets, count, 0.50)),
            "p95_us": min(mx, _hist_percentile(buckets, count, 0.95)),
            "p99_us": min(mx, _hist_percentile(buckets, count, 0.99)),
        }
    return out


def record_flow(name, flow_id, phase, ts_us=None, lane="kvstore",
                category="kvstore", args=None):
    """Emit one chrome-trace flow event (``ph:'s'`` start / ``'t'`` step /
    ``'f'`` finish) with the job-unique ``flow_id``. A flow binds to the
    enclosing duration span on its pid/tid at ``ts_us``, so a client RTT
    span and the server-side handling span render as one connected arrow
    in the merged trace."""
    if not _ACTIVE:
        return
    if phase not in ("s", "t", "f"):
        raise ValueError("flow phase must be 's', 't' or 'f', got %r"
                         % (phase,))
    ev = {"name": name, "cat": category, "ph": phase, "id": flow_id,
          "ts": _now_us() if ts_us is None else ts_us, "pid": PID,
          "tid": LANES.get(lane, LANES["user"])}
    if phase == "f":
        ev["bp"] = "e"  # bind to the enclosing slice, not the next one
    if args:
        ev["args"] = args
    with _lock:
        _append_locked(ev)


# -- compile attribution -------------------------------------------------------
# Every build of a program reports here: a span in the ``compile`` lane with
# its key, plus the attribution numbers known at build time. The JAX package
# records its jit compiles with XLA's cost analysis; the port has no
# program to compile, and records each CUDA source's first-use build in
# ``kernels/_build.py`` (name ``kernel:<source>``, the build's seconds, the
# source path in ``args``). Like ``account``, the registry accumulates
# UNCONDITIONALLY (builds are rare and expensive); only the trace span gates
# on ``_ACTIVE``.
_compiles = {}  # name -> {count, total_us, key, flops, ...}


def record_compile(name, key=None, dur_us=0.0, flops=None,
                   bytes_accessed=None, comm_bytes=None,
                   modeled_compute_us=None, modeled_comm_us=None,
                   memory=None, args=None):
    """Record one compilation: ``name`` identifies the compiling
    subsystem + program (``kernel:conv_fused`` in the port), ``key`` a
    short signature string (churn shows as the same name with a new key),
    ``dur_us`` the measured wall time. Optional attribution inputs
    (``flops``/``bytes_accessed``, collective payload ``comm_bytes``,
    modeled compute/comm microseconds, a ``memory`` dict of
    ``argument_bytes``/``output_bytes``/``temp_bytes``/``peak_bytes``)
    surface in ``metrics()['compile']`` and the ``dumps()`` tables."""
    with _lock:
        st = _compiles.get(name)
        if st is None:
            st = _compiles[name] = {"count": 0, "total_us": 0.0,
                                    "last_us": 0.0, "key": None}
        st["count"] += 1
        st["total_us"] += float(dur_us)
        st["last_us"] = float(dur_us)
        if key is not None:
            st["key"] = str(key)
        for field, val in (("flops", flops),
                           ("bytes_accessed", bytes_accessed),
                           ("comm_bytes", comm_bytes),
                           ("modeled_compute_us", modeled_compute_us),
                           ("modeled_comm_us", modeled_comm_us)):
            if val is not None:
                st[field] = float(val)
        if memory is not None:
            st["memory"] = {k: int(v) for k, v in dict(memory).items()
                            if v is not None}
    ev_args = {"key": str(key)} if key is not None else {}
    if args:
        ev_args.update(args)
    record_op(name, dur_us, category="compile", args=ev_args or None,
              lane="compile")


def compile_stats():
    """Snapshot of the compile registry — ``metrics()['compile']``."""
    with _lock:
        return {n: dict(st) for n, st in _compiles.items()}


# -- compiled-program artifact capture ---------------------------------------
# Per-signature artifacts (program text + the contract metadata known when
# it was built) for static analysis, in a bounded ring of plain dicts. The JAX
# package feeds it from its fused step's HLO; the port has no program text
# yet, and keeps the surface for the callers that will.
_programs = []  # [{name, sig, hlo, meta, seq}, ...] oldest first
_PROGRAM_CAP = 32
_program_seq = 0  # monotonic capture counter — NEVER reset by the cap


def record_program(name, sig, hlo, meta=None):
    """Capture one compiled program for static analysis: ``name`` the
    compiling subsystem, ``sig`` its signature tag, ``hlo`` the program's
    text, ``meta`` a contract dict. Each record carries a process-monotonic ``seq`` so consumers can
    select "captured after X" robustly — list indexes shift whenever
    the cap trims the front."""
    global _program_seq
    if not hlo:
        return
    rec = {"name": str(name), "sig": str(sig), "hlo": str(hlo),
           "meta": dict(meta) if meta else {}}
    with _lock:
        _program_seq += 1
        rec["seq"] = _program_seq
        _programs.append(rec)
        del _programs[:-_PROGRAM_CAP]


def program_records(name=None):
    """Captured program artifacts, oldest first."""
    with _lock:
        return [dict(r) for r in _programs
                if name is None or r["name"] == name]


def marker(name, args=None, lane="user", category="instant"):
    """Drop one instant event (chrome ``ph:"i"``) into ``lane`` at the
    current trace time — the public form of the internal ``_emit`` the
    faultpoint subsystem uses for ``fault:<point>`` markers. Always
    feeds the flight-recorder ring (markers are exactly the breadcrumbs
    a post-mortem needs); the trace event gates on the profile run, so
    call sites off the per-op hot path don't need their own guard."""
    if _flightrec.ENABLED:
        _flightrec.record_marker(name, category, LANES.get(lane, 7),
                                 args)
    if not _ACTIVE:
        return
    ev = {"name": name, "cat": category, "ph": "i", "s": "p",
          "ts": _now_us(), "pid": PID,
          "tid": LANES.get(lane, LANES["user"])}
    if args:
        ev["args"] = args
    with _lock:
        _append_locked(ev)


# -- elastic-recovery accounting ---------------------------------------------
# One shared store for the elastic-training event counters so BOTH sides
# of the recovery loop — the kvstore dead-node poll (kvstore_async.py)
# and the controller/checkpoint machinery (parallel/elastic.py) — count
# into the same ``metrics()['elastic']`` section without kvstore having
# to import the (heavy) parallel package.
_elastic = {}   # event name -> count (restores, reshards, preemptions, ...)


def bump_elastic(name, delta=1, args=None, lane="user"):
    """Count one elastic-recovery event into ``metrics()['elastic']``
    and, while a profile run is active, drop an ``elastic:<name>``
    instant marker next to the spans it perturbs. The count accumulates
    UNCONDITIONALLY (same contract as ``account``): recovery accounting
    must be trustworthy in production, not only under a profile run."""
    with _lock:
        _elastic[name] = _elastic.get(name, 0) + delta
    # marker() gates internally: flight-recorder ring always, trace
    # event only while a profile run is active
    marker("elastic:%s" % name, args=args, lane=lane,
           category="elastic")


def elastic_stats():
    """Snapshot of the elastic-recovery event counters — the
    ``metrics()['elastic']`` section (registered stats provider)."""
    with _lock:
        return dict(_elastic)


def reset_elastic_stats():
    with _lock:
        _elastic.clear()


def record_clock_sync(peer, offset_us, rtt_us, primary=False):
    """Record one clock-offset estimate against ``peer`` (an NTP-style
    sample from the kvstore heartbeat path: ``offset_us`` added to THIS
    process's trace clock gives the peer's). The minimum-RTT sample wins
    (tightest bound on the true offset). ``primary=True`` marks the
    canonical alignment target (PS server 0) that ``merge_traces``
    shifts this rank's shard by. Always recorded — calibration must not
    depend on when profiling was switched on."""
    with _lock:
        st = _clock_sync.get(peer)
        if st is None or rtt_us <= st["rtt_us"]:
            _clock_sync[peer] = st = {
                "offset_us": float(offset_us), "rtt_us": float(rtt_us),
                "samples": (st["samples"] if st else 0),
                "primary": bool(primary) or bool(st and st["primary"]),
            }
        st["samples"] += 1


def clock_sync():
    """Snapshot of the per-peer clock-offset estimates."""
    with _lock:
        return {p: dict(v) for p, v in _clock_sync.items()}


def sample_memory(trigger=None):
    """Sample per-device memory (``storage.stats()``) into Counter events
    on the ``memory`` lane and remember the snapshot for the ``dumps()``
    table / ``metrics()``. No-op unless profiling is active with
    ``profile_memory=True``. Called by the background sampler."""
    if not (_ACTIVE and _state["profile_memory"]):
        return
    try:
        from . import storage
        device_stats = storage.stats()
    except Exception:
        return
    ts = _now_us()
    events, snap = [], {}
    for s in device_stats:
        dev = str(s.device)
        events.append({
            "name": "memory:%s" % dev, "cat": "memory", "ph": "C",
            "ts": ts, "pid": PID, "tid": LANES["memory"],
            "args": {"bytes_in_use": s.bytes_in_use,
                     "peak_bytes_in_use": s.peak_bytes_in_use}})
        snap[dev] = {
            "bytes_in_use": s.bytes_in_use,
            "peak_bytes_in_use": s.peak_bytes_in_use,
            "peak_since_reset": getattr(s, "peak_since_reset", 0),
            "num_allocs": s.num_allocs,
        }
    with _lock:
        if not (_state["running"] and _state["profile_memory"]):
            return  # stopped while sampling: don't write into a dead run
        for ev in events:
            _append_locked(ev)
        _mem_last.update(snap)


def _sample_ledger():
    """Sampler-daemon companion to :func:`sample_memory`: one stacked
    Counter series per allocation-ledger tag in the memory lane, plus the
    denser-cadence feed into the leak detector's rolling window. Runs
    ONLY on the daemon thread."""
    if not (_ACTIVE and _state["profile_memory"]):
        return
    try:
        from . import storage
        led = storage.ledger_metrics()
        by_tag = {t: b for t, b in led["by_tag"].items() if b}
        if by_tag:
            ev = {"name": "memory.ledger", "cat": "memory", "ph": "C",
                  "ts": _now_us(), "pid": PID, "tid": LANES["memory"],
                  "args": by_tag}
            with _lock:
                _append_locked(ev)
        from ._debug import memwatch as _memwatch
        _memwatch.observe(led)
    except Exception:
        pass  # ledger/detector trouble must not kill the sampler


def _lane_metadata():
    """chrome-trace metadata naming the process and every lane row.
    Rank 0 keeps the bare process name; other ranks qualify it so a
    merged multi-rank trace labels each process row."""
    pname = "mxnet_tpu" if PID == 0 else "mxnet_tpu rank %d" % PID
    events = [
        {"name": "process_name", "ph": "M", "pid": PID,
         "args": {"name": pname}},
        {"name": "process_sort_index", "ph": "M", "pid": PID,
         "args": {"sort_index": PID}},
    ]
    for lane, tid in sorted(LANES.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": PID,
                       "tid": tid, "args": {"name": lane}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": PID,
                       "tid": tid, "args": {"sort_index": tid}})
    return events


def _write_trace():
    """Atomically (write-temp + rename) dump the chrome trace, so a reader
    — or a crash — mid-rewrite never sees a truncated JSON file. Writers
    (continuous-dump daemon vs explicit dump()) are serialized under
    _dump_lock: they share the temp path, and an interleaved pair would
    publish corrupt JSON or race os.replace."""
    with _lock:
        data = {"traceEvents": _lane_metadata() + list(_events),
                "displayTimeUnit": "ms",
                # shard self-description for merge_traces: which
                # rank this is and how its clock maps onto the peers'
                "metadata": {
                    "rank": PID,
                    "clock_sync": {p: dict(v)
                                   for p, v in _clock_sync.items()},
                }}
        fn = _state["filename"]
    with _dump_lock:
        _atomic_json_write(fn, data)


def _atomic_json_write(fn, data):
    """write-temp + rename under _dump_lock (caller holds it). Events may
    carry arbitrary user args (record_op/record_counter are public), so
    unserializable values degrade to str() instead of failing the dump;
    the temp file never outlives a failed write."""
    tmp = "%s.tmp.%d" % (fn, os.getpid())
    try:
        with open(tmp, "w") as f:
            json.dump(data, f, default=str)
        os.replace(tmp, fn)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def dump(finished=True, profile_process="worker", format="chrome"):
    """Write accumulated telemetry to ``filename``
    (ref: python/mxnet/profiler.py:122, DumpProfile profiler.h:299).

    ``format='chrome'`` (or ``'json'``): the chrome://tracing event file.
    ``format='metrics'``: the ``metrics()`` snapshot as JSON — the
    machine-readable aggregate surface for scrapers/bench harnesses."""
    if format in ("chrome", "json"):
        _write_trace()
    elif format == "metrics":
        data = metrics()
        with _lock:
            fn = _state["filename"]
        with _dump_lock:
            _atomic_json_write(fn, data)
    else:
        raise ValueError("format must be 'chrome', 'json' or 'metrics', "
                         "got %r" % (format,))


# Subsystem counter snapshots surfaced as named sections of metrics()
# and trailing lines of dumps() — the gluon fused train step registers
# "fused_step" here; other layers can follow the same pattern instead of
# growing bespoke metrics() fields.
_STATS_PROVIDERS = {}  # name -> (snapshot_fn, reset_fn or None)


def register_stats_provider(name, snapshot, reset=None):
    """Expose a subsystem's counter snapshot (a flat JSON-safe dict) as
    ``metrics()[name]`` and a line of ``dumps()``. ``snapshot()`` must be
    cheap and callable with profiling off; ``reset()`` (optional) is
    invoked by ``metrics(reset=True)`` / ``dumps(reset=True)``."""
    with _lock:
        _STATS_PROVIDERS[name] = (snapshot, reset)


# the elastic-recovery counters live in this module (see bump_elastic);
# registering them here makes metrics()['elastic'] exist from import
register_stats_provider("elastic", elastic_stats, reset_elastic_stats)


def _provider_sections(reset):
    """[(name, stats dict)] from the registered providers; a raising
    provider reports its error instead of killing the snapshot."""
    with _lock:
        providers = sorted(_STATS_PROVIDERS.items())
    out = []
    for name, (snapshot, reset_fn) in providers:
        try:
            stats = dict(snapshot())
            if reset and reset_fn is not None:
                reset_fn()
        except Exception as e:
            stats = {"error": "%s: %s" % (type(e).__name__, e)}
        out.append((name, stats))
    return out


def imperative_stats():
    """The imperative dispatch-cache counters of the JAX package (hits/
    misses/retraces/fallbacks/bulk_flushes/bulk_ops). The port dispatches
    every op eagerly, with no cache and no bulk segments, so they stay 0;
    the section keeps the JAX package's shape."""
    from .ndarray import register as _register
    return _register.dispatch_stats()


def reset_imperative_stats():
    from .ndarray import register as _register
    _register.reset_dispatch_stats()


def _agg_rows():
    """[(name, count, total, min, max, avg)] snapshot — callers hold _lock."""
    return [(n, s[0], s[1], s[2] if s[0] else 0.0, s[3],
             s[1] / s[0] if s[0] else 0.0) for n, s in _agg.items()]


def metrics(reset=False):
    """One JSON-safe snapshot of everything the profiler knows: the
    aggregate span table, imperative dispatch-cache counters, cumulative
    subsystem counters (kvstore/io), and the last per-device memory sample.
    ``json.dumps(profiler.metrics())`` always works — bench.py and external
    scrapers consume this instead of parsing the ``dumps()`` text table."""
    with _lock:
        rows = _agg_rows()
        counters = dict(_counters)
        memory = {dev: dict(vals) for dev, vals in _mem_last.items()}
        compiles = {n: dict(st) for n, st in _compiles.items()}
        num_events = len(_events)
        if reset:
            _agg.clear()
            _events.clear()
            _counters.clear()
            _mem_last.clear()
            _compiles.clear()
    latency = latency_metrics(reset)
    # the memory section: the sampler's per-device snapshot
    # plus the storage-owned ledger/headroom/allocation counters —
    # composed OUTSIDE _lock (the ledger drain takes its own named
    # lock; nesting it under the event lock would order them)
    mem_section = {"devices": memory}
    try:
        from . import storage as _storage_mod
        mem_section.update(_storage_mod.memory_metrics())
    except Exception as e:
        mem_section["error"] = "%s: %s" % (type(e).__name__, e)
    # _clock_sync survives reset on purpose: it is calibration
    # state (clock offsets), not accumulated telemetry
    out = {
        "aggregate": {
            n: {"count": c, "total_us": tot, "min_us": mn, "max_us": mx,
                "avg_us": avg}
            for n, c, tot, mn, mx, avg in rows},
        "imperative": imperative_stats(),
        "counters": counters,
        "latency": latency,
        "memory": mem_section,
        "compile": compiles,
        "clock_sync": clock_sync(),
        "num_events": num_events,
    }
    for name, stats in _provider_sections(reset):
        out.setdefault(name, stats)
    dev = _device_status()
    if dev is not None:
        # the device session of the newest run (a key of the port's: the
        # JAX package's xprof trace has no summary to give)
        out["profiler"] = dev
    if _locktrace.ENABLED:
        # runtime lock-order detector findings (MXNET_DEBUG_LOCKS=1):
        # acquisition-order inversions + locks held across jit/sync
        # boundaries, from mxnet_tpu._debug.locktrace
        out["locks"] = _locktrace.report()
    if reset:
        reset_imperative_stats()
    return out


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Return aggregate stats as a text table (ref: profiler.py:151,
    src/profiler/aggregate_stats.cc), followed by the imperative
    dispatch-cache counters, cumulative subsystem counters, and — when
    memory profiling sampled anything — a per-device memory table."""
    key_idx = {"count": 0, "total": 1, "min": 2, "max": 3,
               "avg": None}.get(sort_by, 1)
    with _lock:
        rows = _agg_rows()
        counters = dict(_counters)
        memory = {dev: dict(vals) for dev, vals in _mem_last.items()}
        compiles = {n: dict(st) for n, st in _compiles.items()}
        if reset:
            _agg.clear()
            _events.clear()
            _counters.clear()
            _mem_last.clear()
            _compiles.clear()
    latency = latency_metrics(reset)
    if key_idx is None:
        rows.sort(key=lambda r: r[5], reverse=not ascending)
    else:
        rows.sort(key=lambda r: r[key_idx + 1], reverse=not ascending)
    lines = []
    dev = _device_status()
    if dev is not None and (dev["error"] or dev["lost"]):
        # the device session of the newest run failed or lost events:
        # the table below is then host-only, or missing device work
        lines.append("device trace: %s" % (
            dev["error"] or "%d of %d launches have no device event"
            % (dev["lost"], dev["launches"])))
    lines.append("%-40s %8s %12s %12s %12s %12s"
                 % ("Name", "Calls", "Total(us)", "Min(us)", "Max(us)",
                    "Avg(us)"))
    for n, c, tot, mn, mx, avg in rows:
        lines.append("%-40s %8d %12.1f %12.1f %12.1f %12.1f"
                     % (n[:40], c, tot, mn, mx, avg))
    st = imperative_stats()
    lines.append("")
    lines.append("imperative dispatch: hits=%d misses=%d retraces=%d "
                 "fallbacks=%d bulk_flushes=%d bulk_ops=%d"
                 % (st["hits"], st["misses"], st["retraces"],
                    st["fallbacks"], st["bulk_flushes"], st["bulk_ops"]))
    for name, stats in _provider_sections(reset):
        lines.append("%s: %s" % (name, " ".join(
            "%s=%s" % (k, stats[k]) for k in sorted(stats))))
    if latency:
        lines.append("")
        lines.append("%-40s %8s %10s %10s %10s %10s" % (
            "Latency", "Count", "p50(us)", "p95(us)", "p99(us)",
            "Max(us)"))
        for name in sorted(latency):
            h = latency[name]
            lines.append("%-40s %8d %10.1f %10.1f %10.1f %10.1f" % (
                name[:40], h["count"], h["p50_us"], h["p95_us"],
                h["p99_us"], h["max_us"]))
    if compiles:
        lines.append("")
        lines.append("%-28s %6s %12s %14s %14s" % (
            "Compile", "Count", "Total(ms)", "GFLOPs", "GB moved"))
        for name in sorted(compiles):
            st = compiles[name]
            lines.append("%-28s %6d %12.1f %14s %14s" % (
                name[:28], st["count"], st["total_us"] / 1e3,
                "%.3f" % (st["flops"] / 1e9)
                if st.get("flops") is not None else "-",
                "%.4f" % (st["bytes_accessed"] / 1e9)
                if st.get("bytes_accessed") is not None else "-"))
        # attribution: modeled split of the measured step into compute
        # vs comm vs host time, where a compile record carries modeled
        # compute; host is the measured mean step minus both
        attr_rows = []
        for name in sorted(compiles):
            st = compiles[name]
            if st.get("modeled_compute_us") is None:
                continue
            comp = st["modeled_compute_us"]
            comm = st.get("modeled_comm_us") or 0.0
            meas = latency.get("fused_step.step", {}).get("mean_us")
            host = max(0.0, meas - comp - comm) if meas else None
            attr_rows.append((name, comp, comm, meas, host))
        if attr_rows:
            lines.append("")
            lines.append("%-28s %12s %12s %12s %12s" % (
                "Attribution (modeled)", "compute(us)", "comm(us)",
                "step(us)", "host(us)"))
            for name, comp, comm, meas, host in attr_rows:
                lines.append("%-28s %12.1f %12.1f %12s %12s" % (
                    name[:28], comp, comm,
                    "%.1f" % meas if meas else "-",
                    "%.1f" % host if host is not None else "-"))
    # Memory table: per-program modeled device footprint, where a compile
    # record carries one
    mem_rows = [(n, st["memory"]) for n, st in sorted(compiles.items())
                if st.get("memory")]
    if mem_rows:
        lines.append("")
        lines.append("%-28s %10s %10s %10s %10s" % (
            "Memory (modeled)", "args(MB)", "out(MB)", "temp(MB)",
            "peak(MB)"))
        for name, mm in mem_rows:
            lines.append("%-28s %10.2f %10.2f %10.2f %10.2f" % (
                name[:28], mm.get("argument_bytes", 0) / 1e6,
                mm.get("output_bytes", 0) / 1e6,
                mm.get("temp_bytes", 0) / 1e6,
                mm.get("peak_bytes", 0) / 1e6))
    if counters:
        lines.append("counters: " + " ".join(
            "%s=%s" % (k, counters[k]) for k in sorted(counters)))
    # allocation ledger: live bytes by tag + headroom (storage owns it)
    try:
        from . import storage as _storage_mod
        smm = _storage_mod.memory_metrics()
    except Exception:
        smm = None
    if smm is not None:
        led = smm.get("ledger", {})
        by_tag = led.get("by_tag", {})
        if any(by_tag.values()):
            lines.append("")
            lines.append("memory ledger (live bytes): total=%d %s" % (
                led.get("total_bytes", 0),
                " ".join("%s=%d" % (t, by_tag[t])
                         for t in sorted(by_tag) if by_tag[t])))
        hr = smm.get("headroom")
        if hr:
            lines.append(
                "memory headroom: modeled_peak=%d device_peak=%d "
                "limit=%d%s" % (
                    hr.get("modeled_peak_bytes", 0),
                    hr.get("device_peak_bytes", 0),
                    hr.get("device_limit_bytes", 0),
                    " headroom=%d" % hr["headroom_bytes"]
                    if "headroom_bytes" in hr else ""))
        lines.append("memory accounting: alloc_fallbacks=%d "
                     "empty_cache_calls=%d" % (
                         smm.get("alloc_fallbacks", 0),
                         smm.get("empty_cache_calls", 0)))
    if memory:
        lines.append("")
        lines.append("%-24s %16s %16s %16s" % (
            "Device memory", "In use(B)", "Peak(B)", "PeakSinceReset(B)"))
        for dev in sorted(memory):
            m = memory[dev]
            lines.append("%-24s %16d %16d %16d" % (
                dev[:24], m["bytes_in_use"], m["peak_bytes_in_use"],
                m["peak_since_reset"]))
    # Goodput table: the run-level wall-clock partition, live while a
    # run is open, the last closed run's totals after.
    # Composed OUTSIDE _lock (goodput owns its own named lock).
    try:
        from ._debug import goodput as _goodput_mod
        g = _goodput_mod.snapshot()
    except Exception:
        g = None
    if g and g.get("run_id"):
        lines.append("")
        lines.append(
            "Goodput run=%s (%s): wall=%.3fs ratio=%.4f steps=%d "
            "warmup=%d replayed=%d recoveries=%d" % (
                g["run_id"], "open" if g.get("open") else
                g.get("outcome", "closed"), g.get("wall_s", 0.0),
                g.get("goodput_ratio", 0.0), g.get("steps", 0),
                g.get("warmup_steps", 0), g.get("replayed_steps", 0),
                g.get("recoveries", 0)))
        lines.append("%-16s %12s %8s" % ("Category", "Seconds",
                                         "Share"))
        wall = g.get("wall_s") or 0.0
        for c in _goodput_mod.CATEGORIES:
            s = g.get("%s_s" % c, 0.0)
            lines.append("%-16s %12.3f %7.1f%%" % (
                c, s, 100.0 * s / wall if wall > 0 else 0.0))
    if reset:
        reset_imperative_stats()
    return "\n".join(lines)


# -- live export: Prometheus text + /metrics HTTP endpoint -------------------

def _prom_num(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if math.isnan(v):
            return "NaN"
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text():
    """Render ``metrics()`` in the Prometheus text exposition format
    (version 0.0.4) — what the ``/metrics`` endpoint serves. Latency
    histograms become real Prometheus histograms (cumulative ``le``
    buckets in seconds plus ``_sum``/``_count``); cumulative subsystem
    counters become counters; memory, heartbeat ages and provider
    sections become gauges. Every sample carries a ``rank`` label so a
    job-wide scrape config can aggregate across workers."""
    m = metrics()
    rank = 'rank="%d"' % PID
    lines = []

    def emit(name, kind, help_text, samples):
        lines.append("# HELP %s %s" % (name, help_text))
        lines.append("# TYPE %s %s" % (name, kind))
        for labels, value in samples:
            lab = ",".join([rank] + labels)
            lines.append("%s{%s} %s" % (name, lab, _prom_num(value)))

    counter_samples = [
        (['name="%s"' % k], v) for k, v in sorted(m["counters"].items())]
    if counter_samples:
        emit("mxtpu_counter_total", "counter",
             "Cumulative subsystem counters (profiler.account).",
             counter_samples)
    # latency histograms: one family, name label distinguishes series
    with _lock:
        hists = {n: (st[0], st[1], dict(st[4]))
                 for n, st in _latency.items()}
    if hists:
        lines.append("# HELP mxtpu_latency_seconds Latency histograms "
                     "(profiler.record_latency), log-spaced buckets.")
        lines.append("# TYPE mxtpu_latency_seconds histogram")
        for name in sorted(hists):
            count, total, buckets = hists[name]
            series = '%s,name="%s"' % (rank, name)
            cum = 0
            for idx in sorted(buckets):
                cum += buckets[idx]
                le = _bucket_bounds(idx)[1] / 1e6  # us -> seconds
                lines.append(
                    'mxtpu_latency_seconds_bucket{%s,le="%.9g"} %d'
                    % (series, le, cum))
            lines.append('mxtpu_latency_seconds_bucket{%s,le="+Inf"} %d'
                         % (series, count))
            lines.append("mxtpu_latency_seconds_sum{%s} %s"
                         % (series, _prom_num(total / 1e6)))
            lines.append("mxtpu_latency_seconds_count{%s} %d"
                         % (series, count))
    mem = m["memory"]
    mem_samples = []
    for dev, vals in sorted(mem.get("devices", {}).items()):
        for k, v in sorted(vals.items()):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                mem_samples.append(
                    (['device="%s"' % dev, 'stat="%s"' % k], v))
    if mem_samples:
        emit("mxtpu_memory_bytes", "gauge",
             "Per-device memory stats (storage.stats).", mem_samples)
    led = mem.get("ledger", {})
    led_samples = [(['tag="%s"' % t], b)
                   for t, b in sorted(led.get("by_tag", {}).items())]
    if led_samples:
        emit("mxtpu_memory_ledger_bytes", "gauge",
             "Live device bytes by allocation-ledger tag "
             "(storage.ledger_metrics).", led_samples)
    alloc_samples = [
        (['name="%s"' % k], mem[k])
        for k in ("alloc_fallbacks", "empty_cache_calls") if k in mem]
    if alloc_samples:
        emit("mxtpu_memory_alloc_events_total", "counter",
             "Allocation-accounting counters (storage.counters).",
             alloc_samples)
    hr = mem.get("headroom")
    if hr:
        emit("mxtpu_memory_headroom_bytes", "gauge",
             "Modeled program peak vs measured peak vs device limit "
             "(storage.headroom).",
             [(['stat="%s"' % k], v) for k, v in sorted(hr.items())])
    # span aggregates: count + total time per named span
    agg_counts, agg_totals = [], []
    for name, st in sorted(m["aggregate"].items()):
        agg_counts.append((['name="%s"' % name], st["count"]))
        agg_totals.append((['name="%s"' % name], st["total_us"] / 1e6))
    if agg_counts:
        emit("mxtpu_span_count", "counter",
             "Completed span count per name (record_op).", agg_counts)
        emit("mxtpu_span_seconds_total", "counter",
             "Total span time per name (record_op).", agg_totals)
    # registered stats providers (fused_step, faults, kvstore_server,
    # imperative): flat numeric gauges
    sections = [("imperative", m.get("imperative", {}))]
    sections += [(k, v) for k, v in sorted(m.items())
                 if k not in ("aggregate", "imperative", "counters",
                              "latency", "memory", "clock_sync",
                              "num_events", "locks")
                 and isinstance(v, dict)]
    gauge_samples = []
    for section, stats in sections:
        for k, v in sorted(stats.items()):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                gauge_samples.append(
                    (['section="%s"' % section, 'name="%s"' % k], v))
    if gauge_samples:
        emit("mxtpu_stat", "gauge",
             "Subsystem stats providers (register_stats_provider).",
             gauge_samples)
    # run-level goodput partition: dedicated families beyond
    # the generic mxtpu_stat{section="goodput"} gauges, so dashboards
    # can stack the categories without label gymnastics
    g = m.get("goodput")
    if isinstance(g, dict) and g.get("run_id"):
        try:
            from ._debug import goodput as _goodput_mod
            cats = _goodput_mod.CATEGORIES
        except Exception:
            cats = ()
        cat_samples = [(['category="%s"' % c], g.get("%s_s" % c, 0.0))
                       for c in cats]
        if cat_samples:
            emit("mxtpu_goodput_seconds", "gauge",
                 "Run wall-clock by goodput category "
                 "(goodput.snapshot).", cat_samples)
        emit("mxtpu_goodput_ratio", "gauge",
             "Productive (compute) fraction of run wall-clock.",
             [([], g.get("goodput_ratio", 0.0))])
        emit("mxtpu_goodput_steps_total", "counter",
             "Completed representative steps in the run.",
             [(['kind="steps"'], g.get("steps", 0)),
              (['kind="warmup"'], g.get("warmup_steps", 0)),
              (['kind="replayed"'], g.get("replayed_steps", 0))])
    emit("mxtpu_profiler_events", "gauge",
         "Raw trace events currently buffered.",
         [([], m["num_events"])])
    return "\n".join(lines) + "\n"


_http_server = None
_http_thread = None


def serve_metrics(port=None, host="127.0.0.1"):
    """Start (idempotently) the zero-dependency ``/metrics`` HTTP
    endpoint rendering ``prometheus_text()`` — plus ``/metrics.json``
    with the raw ``metrics()`` dict — on ``host:port``. ``port=None``
    reads ``MXNET_PROFILER_HTTP_PORT``; ``0`` binds an ephemeral port.
    Returns the bound port. Binds loopback by default — expose it
    beyond the host via your scrape proxy, not by changing ``host``,
    unless the fabric is trusted. ``set_state('stop')`` shuts the
    endpoint down BEFORE the final trace dump (a scrape racing
    shutdown must not observe a partially-reset snapshot); call
    ``serve_metrics`` again to re-serve after a stop."""
    global _http_server, _http_thread
    with _lock:
        if _http_server is not None:
            return _http_server.server_address[1]
    if port is None:
        port = int(_getenv("MXNET_PROFILER_HTTP_PORT", "0"))
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path in ("/metrics", "/"):
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(metrics()).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass  # a scrape every 15s must not spam stderr

    import socketserver

    class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = _Server((host, int(port)), _Handler)
    with _lock:
        if _http_server is not None:  # lost the race to another starter
            srv.server_close()
            return _http_server.server_address[1]
        _http_server = srv
    _http_thread = threading.Thread(target=srv.serve_forever,
                                    kwargs={"poll_interval": 0.2},
                                    daemon=True, name="profiler-metrics")
    _http_thread.start()
    return srv.server_address[1]


def stop_metrics_server():
    """Shut the ``/metrics`` endpoint down (no-op when not serving)."""
    global _http_server, _http_thread
    with _lock:
        srv, _http_server = _http_server, None
        thread, _http_thread = _http_thread, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if thread is not None:
        thread.join(timeout=5)


# -- multi-rank trace merge ---------------------------------------------------

def merge_traces(shards, output=None, align=True):
    """Merge per-rank chrome-trace shards into one job-wide trace.

    ``shards``: paths to (or already-loaded dicts of) trace files dumped
    by each rank (each carries ``metadata.rank`` and the
    ``metadata.clock_sync`` offsets measured on the kvstore heartbeat
    path). Every event's ``pid`` is forced to its shard's rank and, when
    ``align`` (default), its timestamp is shifted by the shard's primary
    clock offset so all ranks share PS server 0's clock — the flow
    events stamped on the wire then pair up client→server in one
    timeline. Writes atomically to ``output`` when given.

    Returns ``(merged_dict, summary)`` where ``summary`` carries per-
    rank offsets and the flow-pairing tally (``flows_started``,
    ``flows_finished``, ``flows_paired``)."""
    loaded = []
    for i, sh in enumerate(shards):
        if isinstance(sh, str):
            with open(sh) as f:
                sh = json.load(f)
        loaded.append(sh)
    events = []
    summary = {"ranks": [], "offsets_us": {}, "events": 0,
               "flightrec_shards": 0}
    seen_meta = set()
    for i, sh in enumerate(loaded):
        meta = sh.get("metadata", {}) or {}
        rank = meta.get("rank")
        if rank is None:  # a shard without a rank: its position
            rank = i
        # a flight-recorder post-mortem shard: same rank/pid
        # and timebase as the live profiler shards, but every event is
        # tagged so the merged view distinguishes black-box evidence
        # from live-profile evidence (they can overlap when profiling
        # was on at crash time)
        flightrec = bool(meta.get("flightrec"))
        summary["flightrec_shards"] += int(flightrec)
        offset = 0.0
        sync = meta.get("clock_sync", {}) or {}
        if align and sync:
            primaries = [v for v in sync.values() if v.get("primary")] \
                or list(sync.values())
            best = min(primaries, key=lambda v: v.get("rtt_us", 0.0))
            offset = float(best.get("offset_us", 0.0))
        summary["ranks"].append(rank)
        summary["offsets_us"][str(rank)] = offset
        for ev in sh.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = rank
            if ev.get("ph") == "M":
                # one metadata event per (pid, name, tid): shards
                # re-emit lane metadata on every dump
                key = (rank, ev.get("name"), ev.get("tid"))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                if ev.get("name") == "process_name" and rank != 0:
                    ev["args"] = {"name": "mxnet_tpu rank %d" % rank}
            if "ts" in ev:
                ev["ts"] = ev["ts"] + offset
            if flightrec and ev.get("ph") != "M":
                a = dict(ev.get("args", ()))
                a["source"] = "flightrec"
                ev["args"] = a
            events.append(ev)
    events.sort(key=lambda e: e.get("ts", -1.0))
    starts = {e["id"] for e in events
              if e.get("ph") == "s" and "id" in e}
    finishes = {e["id"] for e in events
                if e.get("ph") == "f" and "id" in e}
    summary["flows_started"] = len(starts)
    summary["flows_finished"] = len(finishes)
    summary["flows_paired"] = len(starts & finishes)
    summary["events"] = len(events)
    merged = {"traceEvents": events, "displayTimeUnit": "ms",
              "metadata": {"merged_from": summary["ranks"],
                           "offsets_us": summary["offsets_us"]}}
    if output is not None:
        with _dump_lock:
            _atomic_json_write(output, merged)
    return merged, summary


def _reset():
    """Stop profiling and clear every recorded artifact (test helper)."""
    set_state("stop")
    stop_metrics_server()
    with _lock:
        _events.clear()
        _agg.clear()
        _counters.clear()
        _mem_last.clear()
        _latency.clear()
        _clock_sync.clear()
        _elastic.clear()
        _compiles.clear()
        del _programs[:]
        _state["xprof_status"] = None
    reset_imperative_stats()
    try:
        from . import storage as _storage_mod
        _storage_mod.ledger_reset()
    except Exception:
        pass


def _emit(name, ph, cat, ts=None, args=None, tid=None):
    ev = {"name": name, "cat": cat, "ph": ph,
          "ts": _now_us() if ts is None else ts, "pid": PID,
          "tid": LANES["user"] if tid is None else tid}
    if args is not None:
        ev["args"] = args
    with _lock:
        _append_locked(ev)


# -- user-defined profiling objects (ref: profiler.py:226-491) ---------------

class Domain:
    """Named grouping for profiling objects (ref: profiler.py:226)."""

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Span:
    _ph_cat = "task"

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._start = None

    def start(self):
        self._start = _now_us()

    def stop(self):
        if self._start is None:
            return
        if is_running():
            dur = _now_us() - self._start
            record_op("%s::%s" % (self.domain, self.name), dur,
                      category=self._ph_cat, lane="user")
        self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()

    def __str__(self):
        return self.name


class Task(_Span):
    """ref: profiler.py:285."""
    _ph_cat = "task"


class Frame(_Span):
    """ref: profiler.py:327."""
    _ph_cat = "frame"


class Event(_Span):
    """ref: profiler.py:369 (domain-less span)."""
    _ph_cat = "event"

    def __init__(self, name):
        super().__init__(Domain("event"), name)


class Counter:
    """Numeric counter emitted into the trace (ref: profiler.py:405)."""

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self._value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self._value = value
        if is_running():
            _emit(self.name, "C", "counter",
                  args={str(self.domain): self._value})

    def increment(self, delta=1):
        self.set_value(self._value + delta)

    def decrement(self, delta=1):
        self.set_value(self._value - delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self

    def __str__(self):
        return "%s=%s" % (self.name, self._value)


class Marker:
    """Instant event (ref: profiler.py:475)."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        if is_running():
            _emit(self.name, "i", "marker", args={"scope": scope})


# Fault-injection trigger counters (_debug.faultpoint): the chaos-testing
# accounting surface; every injected fault is visible in
# metrics()['faults'].
# Registered here (not in faultpoint) because faultpoint loads as part
# of the _debug package import above, before this module finishes.
from ._debug import faultpoint as _faultpoint  # noqa: E402

register_stats_provider("faults", _faultpoint.metrics,
                        _faultpoint.reset_counters)

# Flight-recorder occupancy/dump accounting: always-on black
# box, so its health belongs in every metrics() snapshot.
register_stats_provider("flightrec", _flightrec.stats)

# Watchdog beacon stats: imported HERE (module bottom — the watchdog
# registers itself via register_stats_provider, which must already be
# defined) rather than from _debug/__init__, so every process has a
# metrics()['watchdog'] section even before the fused step or kvstore
# pull it in.
from ._debug import watchdog as _watchdog  # noqa: E402,F401


# deprecated aliases kept for parity (ref: profiler.py:70,109,143)
def profiler_set_config(mode="symbolic", filename="profile.json"):
    set_config(filename=filename)


def profiler_set_state(state="stop"):
    set_state(state)


def dump_profile():
    dump(True)
