"""Run-level goodput ledger: wall-clock badput attribution per run
(counterpart of mxnet_tpu/_debug/goodput.py).

The trace lanes, the flight recorder, the stall watchdog and the memory
ledger each explain an *instant* of a run. This module accounts for the
whole run: it classifies every second between ``open_run()`` and
``close_run()`` into exactly one of :data:`CATEGORIES`:

==================  =========================================================
``compute``         steady-state training steps (watchdog beacon,
                    non-warm-up, not replayed)
``compile``         the warm-up ramp. In the port there is no program to
                    compile: these are the steps whose mode is not
                    ``"fused"``, and they include the first-use kernel
                    builds (``kernels/_build.py``)
``input_wait``      consumer stalls waiting on the input pipeline (the
                    ``io.prefetch_wait`` series' sites: DevicePrefetchIter,
                    PrefetchingIter)
``checkpoint``      checkpoint save/restore time outside recovery intervals
``recovery``        restore + reshard intervals (the elastic loop of the
                    multi-process slice; 0 until it lands)
``rewind_replay``   steps re-executed after a restore (the same; 0 until
                    then)
``host_overhead``   steady-state fallback steps plus the between-step
                    residual no other category explains
``idle``            wall clock outside the stepping window (set-up,
                    teardown) not explained by recovery or checkpoints
==================  =========================================================

Price engineering: the hot path gains no new clock reads and takes no
lock. Every signal is a value the stack already computes under the shared
telemetry guard: the watchdog step beacon's ``dur`` (one ``note_step`` per
step, not per op, called after the watchdog releases its lock) and the
prefetch consumers' ``wait_us``. The hot sites are one GIL-atomic
``deque.append`` each; all classification folds into the run accumulator
at drain time under one named lock, on whoever asks (the watchdog poller
each pass, ``metrics()``, ``close_run()``), with a size backstop so an
undrained run stays bounded.

Partition math (drain): step-beacon seconds are disjoint intervals inside
the stepping window ``[first step begin, last step end]``; input_wait,
checkpoint and recovery seconds fall between steps. The gap inside the
stepping window not explained by those is ``host_overhead``; wall clock
outside the window not explained by their overflow is ``idle``. The eight
categories always sum to the run's wall clock.

Each closed run publishes an atomic temp + rename manifest
``$MXTPU_RUNS_DIR/<run_id>/manifest.json`` (schema
``mxtpu.goodput.run/1``, the JAX package's: env snapshot, per-category
seconds, goodput ratio, step-time summary, event annotations), so that the
JAX package's ``tools/goodput_report.py`` reads the port's manifests too.

Live surfaces: ``profiler.metrics()['goodput']`` (registered provider),
a Goodput block in ``profiler.dumps()``, ``mxtpu_goodput_*`` gauges on
``/metrics``, and a goodput block in every flight-record dump.

Env knobs, the JAX package's: ``MXTPU_GOODPUT`` (default 1),
``MXTPU_RUNS_DIR`` (default ``./runs``, created lazily at the first
manifest write), ``MXTPU_GOODPUT_EVENTS`` (default 64).
"""
from __future__ import annotations

import collections
import json
import math
import os
import time

from . import locktrace as _locktrace
from ..base import getenv as _getenv

__all__ = [
    "ENABLED", "OPEN", "CATEGORIES", "SCHEMA",
    "open_run", "close_run", "is_open", "current_run_id",
    "note_step", "note_input_wait", "note_checkpoint", "note_event",
    "recovery_begin", "recovery_end", "mark_replay", "fold_pending",
    "snapshot", "last_manifest", "runs_dir", "manifest_path",
    "load_manifest", "write_bench_manifest", "reset",
]

ENABLED = _getenv("MXTPU_GOODPUT", "1") not in ("0", "false", "off")

# the fixed taxonomy — every manifest carries all eight, summing to wall
CATEGORIES = ("compute", "compile", "input_wait", "checkpoint",
              "recovery", "rewind_replay", "host_overhead", "idle")

SCHEMA = "mxtpu.goodput.run/1"

_MAX_EVENTS = max(0, int(_getenv("MXTPU_GOODPUT_EVENTS", "64") or 64))

_lock = _locktrace.named_lock("goodput.run")

# Inline fast flag for the welds (watchdog beacon, prefetch consumers):
# one module-attribute truth test when no run is open — the same shape
# as faultpoint.ACTIVE. Maintained strictly under _lock with _run.
OPEN = False

_run = None    # open-run accumulator dict (all mutation under _lock)
_last = None   # manifest dict of the most recently closed run

# The hot-path mailboxes (the memory ledger's idiom): deque.append is a
# GIL-atomic C op — no lock, no clock read on the step/batch path.
# _PENDING carries (begin_m, dur_s, warmup, mode) step tuples plus
# _REPLAY_MARK order markers; _WAITS carries bare wait_us floats.
# Folded into _run at drain time under _lock; cleared at open_run so a
# stray post-close append can never leak into the next run.
_PENDING = collections.deque()
_WAITS = collections.deque()
_REPLAY_MARK = ("replay",)
# backstop only: the watchdog poller (and every metrics() snapshot)
# folds far more often — this bound just keeps a never-scraped run's
# memory finite (~10 MB of tuples worst case)
_FOLD_AT = 1 << 17


def runs_dir():
    """Where run manifests land: ``MXTPU_RUNS_DIR`` or ``./runs`` —
    created lazily at the first manifest write, so importing the
    framework (or a run that never closes) litters nothing."""
    return _getenv("MXTPU_RUNS_DIR", "") or \
        os.path.join(os.getcwd(), "runs")


def manifest_path(run_id):
    return os.path.join(runs_dir(), str(run_id), "manifest.json")


def is_open():
    return _run is not None


def current_run_id():
    r = _run
    return r["run_id"] if r is not None else None


_RUN_SEQ = [0]


def _default_run_id():
    # wall-clock is metadata here (a human-sortable id), never trace
    # math; collisions are broken by rank, pid, AND a per-process
    # sequence — two sub-second back-to-back loops in one process must
    # not silently overwrite each other's manifest
    lt = time.localtime()
    _RUN_SEQ[0] += 1
    return "run_%04d%02d%02d_%02d%02d%02d_r%s_p%d_%03d" % (
        lt.tm_year, lt.tm_mon, lt.tm_mday, lt.tm_hour, lt.tm_min,
        lt.tm_sec, _getenv("MXTPU_PROC_ID", "0") or "0", os.getpid(),
        _RUN_SEQ[0])


def _env_snapshot(meta):
    """The reproducibility half of the manifest: who ran, on what
    topology. The JAX package adds its compile-signature token values;
    the port traces no program, so its token table is empty."""
    return {
        "rank": int(_getenv("MXTPU_PROC_ID", "0") or 0),
        "world": meta.get("world"),
        "mesh": meta.get("mesh"),
        "signature_tokens": {},
    }


def open_run(run_id=None, meta=None):
    """Open the process's run ledger; returns the run id (``None`` when
    disabled or a run is already open — nested loops do not reopen).
    ``meta`` is a JSON-safe dict stored in the manifest (world/mesh
    topology keys feed the env snapshot)."""
    global OPEN, _run
    if not ENABLED:
        return None
    meta = dict(meta or {})
    with _lock:
        if _run is not None:
            return None
        # stray appends from after the previous close must not leak in
        _PENDING.clear()
        _WAITS.clear()
        _run = {
            "run_id": str(run_id) if run_id else _default_run_id(),
            "opened_unix": time.time(),
            "t0": time.monotonic(),
            "meta": meta,
            "env": _env_snapshot(meta),
            "cat": {c: 0.0 for c in CATEGORIES},
            "stepped_s": 0.0,      # all beacon step seconds (in-window)
            "first_begin": None,   # monotonic begin of the first step
            "last_end": None,      # monotonic end of the last step
            "steps": 0, "warmup_steps": 0, "replayed_steps": 0,
            "fallback_steps": 0,
            "step_sum_s": 0.0, "step_min_s": math.inf,
            "step_max_s": 0.0,
            "buckets": {},         # log-bucket histogram of step seconds
            "sigs": {},            # per-compile-signature step stats
            "sigs_dropped": 0,
            "replay_next": False,
            "in_recovery": False, "rec_t0": None,
            "recoveries": 0, "reshards": 0, "checkpoints": 0,
            "restores": 0, "persists": 0, "persist_s": 0.0,
            "peer_restores": 0,
            "events": [], "events_dropped": 0,
        }
        OPEN = True
        run = _run["run_id"]
    return run


def _event_locked(r, kind, detail):
    if len(r["events"]) >= _MAX_EVENTS:
        r["events_dropped"] += 1
        return
    ev = {"t_s": round(time.monotonic() - r["t0"], 6), "kind": kind}
    if detail:
        ev.update(detail)
    r["events"].append(ev)


def note_event(kind, **detail):
    """Annotate the open run (elastic/fault events land here: rank
    deaths, reshards, step failures). Bounded by
    ``MXTPU_GOODPUT_EVENTS``; overflow is counted, never unbounded."""
    if not OPEN:
        return
    with _lock:
        if _run is not None:
            _event_locked(_run, kind, detail)


def note_step(begin_m, dur_s, warmup=False, mode=None, sig=None):
    """One completed outer training step (the watchdog beacon feed).
    ``begin_m`` is the beacon's monotonic start, ``dur_s`` the duration
    it already computed: no new clock reads, no lock — one GIL-atomic
    append; classification happens at drain
    (:func:`_fold_step_locked`). ``sig`` is the fused step's
    input-signature tag: one extra tuple field, so the manifest can
    carry per-signature step-time stats."""
    if not OPEN:
        return
    _PENDING.append((begin_m, dur_s, warmup, mode, sig))
    if len(_PENDING) >= _FOLD_AT:
        fold_pending()  # backstop: a never-drained run stays bounded


def mark_replay():
    """Tag the NEXT completed step as a rewind replay —
    ``elastic_train_loop`` calls this right before re-executing a step
    index it had already completed before a restore. An order marker in
    the same mailbox keeps the pairing exact across folds."""
    if not OPEN:
        return
    _PENDING.append(_REPLAY_MARK)


def note_input_wait(wait_us):
    """One consumer stall waiting on the input pipeline — fed by the
    ``io.prefetch_wait`` sites from the ``wait_us`` they already
    measured under the shared telemetry guard. One GIL-atomic float
    append; summed at drain."""
    if not OPEN:
        return
    _WAITS.append(wait_us)
    if len(_WAITS) >= _FOLD_AT:
        fold_pending()


_MAX_SIGS = 64  # per-run signature stats cap (hot sigs are few)


def _fold_step_locked(r, begin_m, dur_s, warmup, mode, sig=None):
    """Classify one step entry into the accumulator (caller holds
    ``_lock``): a replay-marked step is ``rewind_replay`` (work the run
    already did once); warm-up completions are ``compile`` (first-use
    + eager-warming ramp) except steady-state ``fallback:*`` modes,
    which are host-bound execution (``host_overhead``); everything else
    is ``compute``. A signature-tagged representative step additionally
    feeds that signature's own stats (the manifest's measured half of
    per-signature table)."""
    end = begin_m + dur_s
    if r["first_begin"] is None or begin_m < r["first_begin"]:
        r["first_begin"] = begin_m
    if r["last_end"] is None or end > r["last_end"]:
        r["last_end"] = end
    r["stepped_s"] += dur_s
    replay = r["replay_next"]
    r["replay_next"] = False
    if replay:
        r["cat"]["rewind_replay"] += dur_s
        r["replayed_steps"] += 1
    elif warmup:
        if mode is not None and mode.startswith("fallback"):
            r["cat"]["host_overhead"] += dur_s
            r["fallback_steps"] += 1
        else:
            r["cat"]["compile"] += dur_s
        r["warmup_steps"] += 1
    else:
        r["cat"]["compute"] += dur_s
    if not warmup:
        # representative step times. Steady-state replays run the same
        # program and count; a replayed step the beacon flagged warmup
        # (e.g. the recompile a post-reshard rewind forces under the
        # new mesh) stays OUT — a seconds-long compile in the p95/max
        # would hand the compare CLI a false cross-run regression
        r["steps"] += 1
        r["step_sum_s"] += dur_s
        r["step_min_s"] = min(r["step_min_s"], dur_s)
        r["step_max_s"] = max(r["step_max_s"], dur_s)
        idx = _bucket_index(dur_s * 1e6)
        r["buckets"][idx] = r["buckets"].get(idx, 0) + 1
        if sig is not None and not replay:
            s = r["sigs"].get(sig)
            if s is None:
                if len(r["sigs"]) >= _MAX_SIGS:
                    r["sigs_dropped"] += 1
                    return
                s = r["sigs"][sig] = {
                    "count": 0, "sum_s": 0.0, "min_s": math.inf,
                    "max_s": 0.0, "buckets": {}}
            s["count"] += 1
            s["sum_s"] += dur_s
            s["min_s"] = min(s["min_s"], dur_s)
            s["max_s"] = max(s["max_s"], dur_s)
            s["buckets"][idx] = s["buckets"].get(idx, 0) + 1


def _fold_locked(r):
    """Drain both mailboxes into the accumulator (caller holds
    ``_lock``). popleft races benignly with concurrent appends: an
    entry lands in either this fold or the next."""
    while _WAITS:
        r["cat"]["input_wait"] += _WAITS.popleft() / 1e6
    while _PENDING:
        e = _PENDING.popleft()
        if e is _REPLAY_MARK:
            r["replay_next"] = True
        else:
            _fold_step_locked(r, *e)


def fold_pending():
    """Fold the hot-path mailboxes into the run accumulator — called by
    the watchdog poller each pass, every snapshot/close, and the
    hot-path size backstop. No-op when no run is open (post-close
    strays are discarded at the next ``open_run``)."""
    with _lock:
        if _run is not None:
            _fold_locked(_run)


def note_checkpoint(dur_s, kind="save"):
    """Checkpoint save/restore wall time (``CheckpointManager`` weld).
    A restore inside a recovery interval is already covered by that
    interval's clock — only the counter ticks, not the category.

    ``kind="persist"`` (asynchronous checkpoints) is the background
    publish leg: its seconds OVERLAP training on the persist thread, so
    they never book into the ``checkpoint`` category — only the counter
    and an overlap gauge (``persist_s``) tick, which is exactly how the
    async path's badput win shows up in a manifest: ``checkpoint``
    seconds shrink to the blocking snapshot while ``persist_s`` records
    the hidden work."""
    if not OPEN:
        return
    with _lock:
        r = _run
        if r is None:
            return
        if kind == "save":
            r["checkpoints"] += 1
        elif kind == "persist":
            r["persists"] += 1
            r["persist_s"] += dur_s
            return
        else:
            r["restores"] += 1
        if not r["in_recovery"]:
            r["cat"]["checkpoint"] += dur_s


def recovery_begin():
    """Open a recovery interval (restore + reshard). Re-entrant safe:
    an already-open interval is left alone (the outer one owns the
    clock)."""
    if not OPEN:
        return
    with _lock:
        r = _run
        if r is None or r["in_recovery"]:
            return
        r["in_recovery"] = True
        r["rec_t0"] = time.monotonic()


def recovery_end(kind="restore", resharded=False, restored_step=None,
                 replay_span=0, ok=True, count=True):
    """Close the recovery interval opened by :func:`recovery_begin`:
    its wall time lands in ``recovery`` (unless ``count=False`` — e.g.
    a loop-start probe that found nothing to restore) and an event
    annotation records what happened."""
    if not OPEN:
        return
    with _lock:
        r = _run
        if r is None or not r["in_recovery"]:
            return
        dur = time.monotonic() - r["rec_t0"]
        r["in_recovery"] = False
        r["rec_t0"] = None
        if not count:
            return
        r["cat"]["recovery"] += dur
        r["recoveries"] += 1
        if resharded:
            r["reshards"] += 1
        if kind == "peer":
            # restore served from a live peer's in-memory replica
            # instead of the filesystem
            r["peer_restores"] += 1
        _event_locked(r, "recovery", {
            "recovery_kind": kind, "seconds": round(dur, 6),
            "resharded": bool(resharded),
            "restored_step": restored_step,
            "replay_span": int(replay_span), "ok": bool(ok)})


# -- drain -------------------------------------------------------------------

def _bucket_index(dur_us):
    """The profiler's own log-bucket packing (lazy import, the
    ``_percentile`` pattern): ONE copy of the (exponent, sub-bucket)
    math, so the step-time percentiles stay exactly comparable with
    the latency histograms."""
    from .. import profiler as _profiler
    return _profiler._bucket_index(dur_us)


def _percentile(buckets, count, q):
    from .. import profiler as _profiler
    return _profiler._hist_percentile(buckets, count, q) / 1e6


def _derive_locked(r, now_m, closing):
    """The partition: category seconds summing exactly to wall-clock.
    Pure arithmetic over the accumulators — no other subsystem locks
    are touched (drain-time discipline)."""
    wall = max(0.0, now_m - r["t0"])
    cat = dict(r["cat"])
    if r["first_begin"] is not None:
        window = max(0.0, r["last_end"] - r["first_begin"])
    else:
        window = 0.0
    in_window = min(r["stepped_s"], window)
    gap_in_window = max(0.0, window - in_window)
    out_window = max(0.0, wall - window)
    # input_wait is the one category fed from threads that can run
    # CONCURRENTLY with steps (a stacked consumer's inner iterator on
    # a producer thread measures the same stall twice): wait seconds
    # beyond the run's total non-step budget are attribution noise,
    # trimmed here so the eight categories keep partitioning wall
    # exactly — the trimmed amount is surfaced, never silently dropped
    other = cat["input_wait"] + cat["checkpoint"] + cat["recovery"]
    overbooked = min(cat["input_wait"],
                     max(0.0, other - gap_in_window - out_window))
    if overbooked > 0.0:
        cat["input_wait"] -= overbooked
        other -= overbooked
    r["input_wait_overbooked_s"] = overbooked
    other_in_window = min(other, gap_in_window)
    cat["host_overhead"] += gap_in_window - other_in_window
    cat["idle"] = max(0.0, wall - window - (other - other_in_window))
    ratio = (cat["compute"] / wall) if wall > 0 else 0.0
    steps = {
        "count": r["steps"],
        "warmup": r["warmup_steps"],
        "replayed": r["replayed_steps"],
        "fallback": r["fallback_steps"],
    }
    if r["steps"]:
        n = r["steps"]
        b = r["buckets"]
        steps["time_s"] = {
            "mean": r["step_sum_s"] / n,
            "min": r["step_min_s"],
            "max": r["step_max_s"],
            "p50": min(r["step_max_s"], _percentile(b, n, 0.50)),
            "p95": min(r["step_max_s"], _percentile(b, n, 0.95)),
            "p99": min(r["step_max_s"], _percentile(b, n, 0.99)),
        }
    if r["sigs"]:
        steps["signatures"] = {
            sig: {
                "count": s["count"],
                "mean_s": s["sum_s"] / s["count"],
                "min_s": s["min_s"],
                "max_s": s["max_s"],
                "p50_s": min(s["max_s"], _percentile(
                    s["buckets"], s["count"], 0.50)),
            } for sig, s in r["sigs"].items()}
        if r["sigs_dropped"]:
            steps["signatures_dropped"] = r["sigs_dropped"]
    return {
        "schema": SCHEMA,
        "run_id": r["run_id"],
        "rank": r["env"].get("rank", 0),
        "opened_unix": r["opened_unix"],
        "wall_s": wall,
        "open": not closing,
        "categories_s": {c: cat[c] for c in CATEGORIES},
        "goodput_ratio": ratio,
        "steps": steps,
        "counters": {
            "recoveries": r["recoveries"],
            "reshards": r["reshards"],
            "checkpoint_saves": r["checkpoints"],
            "checkpoint_restores": r["restores"],
            "checkpoint_persists": r["persists"],
            "checkpoint_persist_s": round(r["persist_s"], 6),
            "peer_restores": r["peer_restores"],
            "events_dropped": r["events_dropped"],
            "input_wait_overbooked_s": round(
                r.get("input_wait_overbooked_s", 0.0), 6),
        },
        "env": r["env"],
        "events": list(r["events"]),
        "meta": dict(r["meta"]),
    }


def close_run(outcome="completed"):
    """Drain the open run into its manifest, publish it atomically
    under ``runs_dir()/<run_id>/manifest.json``, and return the
    manifest dict (``None`` when no run was open). A failed write never
    masks the caller's own exit path: the error lands in the returned
    manifest as ``write_error``."""
    global OPEN, _run, _last
    with _lock:
        r = _run
        if r is None:
            return None
        _fold_locked(r)
        manifest = _derive_locked(r, time.monotonic(), closing=True)
        _run = None
        OPEN = False
    manifest["outcome"] = str(outcome)
    manifest["closed_unix"] = time.time()
    try:
        _write_manifest(manifest)
        manifest["manifest_path"] = manifest_path(manifest["run_id"])
    except Exception as e:
        manifest["write_error"] = "%s: %s" % (type(e).__name__, e)
    with _lock:
        _last = manifest
    return manifest


def _write_manifest(manifest):
    from .. import base
    path = manifest_path(manifest["run_id"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with base.atomic_write(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True, default=str)


def load_manifest(path):
    """Read one manifest (a file path, or a run directory containing
    ``manifest.json``) and validate the schema tag."""
    if os.path.isdir(path):
        path = os.path.join(path, "manifest.json")
    with open(path, encoding="utf-8") as f:
        m = json.load(f)
    if m.get("schema") != SCHEMA:
        raise ValueError("%s: schema %r is not %r"
                         % (path, m.get("schema"), SCHEMA))
    return m


def last_manifest():
    """Manifest of the most recently closed run (this process)."""
    with _lock:
        return dict(_last) if _last is not None else None


def reset():
    """Discard any open run and the last manifest (test isolation)."""
    global OPEN, _run, _last
    with _lock:
        _run = None
        _last = None
        OPEN = False
        _PENDING.clear()
        _WAITS.clear()


# -- live snapshot (the metrics()['goodput'] provider) -----------------------

def snapshot():
    """Flat JSON-safe dict: the OPEN run's live partition, or the last
    closed run's totals. Cheap (pure arithmetic under one lock) and
    callable with profiling off — the stats-provider contract."""
    with _lock:
        if _run is not None:
            _fold_locked(_run)
            m = _derive_locked(_run, time.monotonic(), closing=False)
        elif _last is not None:
            m = _last
        else:
            return {"enabled": int(ENABLED), "open": 0}
    out = {"enabled": int(ENABLED), "open": int(bool(m.get("open"))),
           "run_id": m["run_id"], "wall_s": round(m["wall_s"], 6),
           "goodput_ratio": round(m["goodput_ratio"], 6),
           "steps": m["steps"]["count"],
           "warmup_steps": m["steps"]["warmup"],
           "replayed_steps": m["steps"]["replayed"],
           "recoveries": m["counters"]["recoveries"],
           "reshards": m["counters"]["reshards"]}
    for c in CATEGORIES:
        out["%s_s" % c] = round(m["categories_s"][c], 6)
    t = m["steps"].get("time_s")
    if t:
        out["step_p50_s"] = round(t["p50"], 6)
        out["step_mean_s"] = round(t["mean"], 6)
    if "outcome" in m:
        out["outcome"] = m["outcome"]
    return out


# -- bench manifests ----------------------------------------------------------

# result keys a bench gate may carry, mapped to one representative
# step/op latency in seconds — the first match wins
_BENCH_STEP_KEYS = (
    ("median_step_s", 1.0),
    ("step_time_s", 1.0),
    ("fused_step_us", 1e-6),
    ("dispatch_us_per_op", 1e-6),
    ("p50_ms", 1e-3),
)
_BENCH_RATE_KEYS = ("steps_per_sec", "fused_steps_per_sec",
                    "imgs_per_sec", "samples_per_sec")


def _bench_step_seconds(result):
    for key, scale in _BENCH_STEP_KEYS:
        v = result.get(key)
        if isinstance(v, (int, float)) and v > 0:
            return float(v) * scale
    for key in _BENCH_RATE_KEYS:
        v = result.get(key)
        if isinstance(v, (int, float)) and v > 0:
            return 1.0 / float(v)
    if result.get("metric", "").endswith("_per_sec") and \
            isinstance(result.get("value"), (int, float)) \
            and result["value"] > 0:
        return 1.0 / float(result["value"])
    return None


def write_bench_manifest(model, result, run_id=None):
    """Publish one benchmark result as a goodput-run manifest (same
    schema), so that runs and benchmark rounds compare in one tool. Returns
    the manifest path (``None`` when goodput is disabled)."""
    if not ENABLED:
        return None
    step_s = _bench_step_seconds(dict(result))
    wall = float(result.get("wall_s", 0.0) or 0.0)
    compute = wall if wall > 0 else (step_s or 0.0)
    cats = {c: 0.0 for c in CATEGORIES}
    cats["compute"] = compute
    steps = {"count": 1 if step_s else 0, "warmup": 0, "replayed": 0,
             "fallback": 0}
    if step_s:
        steps["time_s"] = {"mean": step_s, "min": step_s,
                           "max": step_s, "p50": step_s, "p95": step_s,
                           "p99": step_s}
    gate = result.get("gate") if isinstance(result.get("gate"), dict) \
        else {}
    now_unix = time.time()
    manifest = {
        "schema": SCHEMA,
        "run_id": str(run_id) if run_id else
        "bench_%s_%d" % (model, int(now_unix * 1000)),
        "rank": int(_getenv("MXTPU_PROC_ID", "0") or 0),
        "opened_unix": now_unix,
        "closed_unix": now_unix,
        "wall_s": max(wall, compute),
        "open": False,
        "outcome": "completed" if gate.get("ok", True) else
        "gate_breached",
        "categories_s": cats,
        "goodput_ratio": 1.0 if compute > 0 else 0.0,
        "steps": steps,
        "counters": {"recoveries": 0, "reshards": 0,
                     "checkpoint_saves": 0, "checkpoint_restores": 0,
                     "events_dropped": 0},
        "env": _env_snapshot({}),
        "events": [],
        "meta": {"bench_model": str(model)},
        "bench": {"model": str(model), "result": result},
    }
    _write_manifest(manifest)
    return manifest_path(manifest["run_id"])


# registered at import, like the watchdog provider: every process that
# loads the telemetry stack carries metrics()['goodput']
from .. import profiler as _profiler  # noqa: E402,F401  (registration)

_profiler.register_stats_provider("goodput", snapshot)
