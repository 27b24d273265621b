"""Roofline/MFU attribution: the modeled-vs-measured efficiency join
(counterpart of mxnet_tpu/_debug/perfmodel.py).

The program says how efficiently it runs, per step signature, live. The
compile registry (``profiler.record_compile``) holds the MODELED side of a
program -- its flops and bytes -- and the watchdog step beacon measures
every step's wall clock. This module joins them.

The modeled side. The JAX package reads XLA's ``cost_analysis()``. The
port has no compiled program: the fused train step counts the work of the
first step of each input signature under ``kernels._cost.counting()``
(aten matmuls and convolutions by ``torch.utils.flop_counter``'s formulas,
every kernel of the port by its declared ``cost()``, bytes of every aten
operator without fusion: an upper estimate) and records it as
``fused_step:<crc32>`` -- the tag the beacon carries -- with the dominant
dtype and the card's peak for it.

The measured side is the beacon's duration: host time from
``step_begin`` to ``step_end``. CUDA runs asynchronously, so a step that
synchronizes nowhere is timed at its dispatch, and its MFU can read above
1 while the queue fills; in steady state the host waits for the card (the
launch queue is bounded) and the beacon's sum over a window tracks the
card's wall clock. The JAX package keeps the same definition.

Per hot signature it derives, at drain time:

``mfu``            flops / (median step time x peak FLOP/s for the
                   program's dominant dtype, from the card table below)
``membw_util``     bytes / (median step time x memory bandwidth)
``intensity``      arithmetic intensity, flops / bytes
roofline verdict   which term binds the step: ``compute`` / ``memory``
                   / ``comm`` / ``overhead``. The first three are the
                   modeled lower bounds (the modeled device time is
                   ``max(t_compute, t_mem) + t_comm``; ``comm`` is 0 on
                   one device); ``overhead`` is the residual of the
                   MEASURED median time over that modeled floor.

The hardware model is the card table (``PEAKS``, ``INT8_PEAKS``): dense
data-sheet rates keyed by the name ``torch.cuda.get_device_name()`` gives.
On the CPU, or on a card the table does not know, there is none: a row
then carries counts and times but no ``mfu`` or ``membw_util``, as a JAX
row without ``comm_model`` does.

Price engineering: the hot path is ONE GIL-atomic ``deque.append`` of a
``(sig, dur_s)`` tuple riding the watchdog beacon's own clock reads -- no
lock, no new clock read. ALL math folds under one named lock
(``perfmodel.state``) at drain, on whoever asks: the watchdog poller each
pass, ``metrics()``, a flight-record dump, ``close_run``.

Efficiency-collapse detector (the memwatch latch idiom): a step whose MFU
drops below ``MXTPU_PERF_MFU_DROP`` x the signature's own rolling median
trips ONE ``perf`` flight-record dump per episode, naming the signature
and which roofline term grew. Collapsed steps stay OUT of the rolling
windows, so a sustained collapse cannot drag its own baseline down; the
latch re-arms on the first clean step.

Surfaces: ``metrics()['perf']`` (registered provider), the dumps()
Roofline table, the ``mxtpu_mfu`` / ``mxtpu_membw_util`` /
``mxtpu_roofline_bound`` Prometheus families, a ``metadata.perf`` block in
every flight-record dump and a ``perf`` block in goodput run manifests
(``SCHEMA`` ``mxtpu.perf/1``, the JAX package's, so the blocks keep one
format).

Nothing here touches a tensor of the step: ``MXTPU_PERF=1`` training is
bit for bit ``MXTPU_PERF=0`` training.

Env knobs, the JAX package's: ``MXTPU_PERF`` (default 1),
``MXTPU_PERF_WINDOW`` (32), ``MXTPU_PERF_MFU_DROP`` (0.5),
``MXTPU_PERF_MIN_SAMPLES`` (5).
"""
from __future__ import annotations

import collections
import statistics

from . import flightrec as _flightrec
from . import locktrace as _locktrace
from ..base import getenv as _getenv
from .watchdog import _envf

__all__ = [
    "ENABLED", "SCHEMA", "BOUNDS", "configure", "reset",
    "note_compile", "note_step", "fold_pending", "snapshot", "table",
    "manifest_block", "PEAKS", "INT8_PEAKS", "card", "assumptions_for",
    "peak_tflops",
]

ENABLED = _getenv("MXTPU_PERF", "1") not in ("0", "false", "off")

SCHEMA = "mxtpu.perf/1"

# the roofline verdict vocabulary, in tie-break order (a tie goes to
# the more actionable/modeled term)
BOUNDS = ("compute", "memory", "comm", "overhead")

_lock = _locktrace.named_lock("perfmodel.state")

# hot-path mailbox (the goodput _PENDING idiom): (sig, dur_s) tuples,
# appended by watchdog.step_end AFTER it releases its own lock, riding
# the beacon's already-computed duration
_PENDING = collections.deque()  # mxlint: disable=MX003 (GIL-atomic deque appends on the per-step hot path; all join math folds under _lock at drain — the goodput-ledger idiom)
_FOLD_AT = 1 << 17  # backstop only: the watchdog poller drains each pass

_MODELS_CAP = 256   # modeled-side entries (compile registry mirror)
_MEAS_CAP = 64      # measured-side signatures (hot sigs are few)

_cfg = {}
_models = {}   # sig -> modeled dict (flops, bytes, comm, peak, ...)
_meas = {}     # sig -> measured accumulator (windows, counts, latch)  # mxlint: disable=MX003 (mutated only from _fold_locked, which every caller runs under _lock)
_stats = {"steps": 0, "collapses": 0, "collapse_dumps": 0,  # mxlint: disable=MX003 (same _fold_locked contract as _meas)
          "dropped_sigs": 0}


def _defaults():
    return {
        "window": max(2, int(_envf("MXTPU_PERF_WINDOW", 32))),
        "mfu_drop": _envf("MXTPU_PERF_MFU_DROP", 0.5),
        "min_samples": max(2, int(_envf("MXTPU_PERF_MIN_SAMPLES", 5))),
    }


_cfg.update(_defaults())


def configure(enabled=None, window=None, mfu_drop=None,
              min_samples=None):
    """Override the env-derived knobs at runtime (tests, notebooks)."""
    global ENABLED
    with _lock:
        if window is not None:
            _cfg["window"] = max(2, int(window))
            for st in _meas.values():
                st["durs"] = collections.deque(
                    st["durs"], maxlen=_cfg["window"])
                st["mfus"] = collections.deque(
                    st["mfus"], maxlen=_cfg["window"])
        if mfu_drop is not None:
            _cfg["mfu_drop"] = float(mfu_drop)
        if min_samples is not None:
            _cfg["min_samples"] = max(2, int(min_samples))
    if enabled is not None:
        ENABLED = bool(enabled)


def reset():
    """Clear all state; knobs re-read from the env (test isolation)."""
    global ENABLED
    with _lock:
        _models.clear()
        _meas.clear()
        _PENDING.clear()
        for k in _stats:
            _stats[k] = 0
        _cfg.clear()
        _cfg.update(_defaults())
    ENABLED = _getenv("MXTPU_PERF", "1") not in ("0", "false", "off")


# -- the card table -----------------------------------------------------------

# Dense peaks from NVIDIA's data sheets: (bf16 tensor FLOP/s, f32 FLOP/s on
# the CUDA cores, memory bytes/s), matched on the name the driver gives
# (the first key it contains, so "H100 PCIe" before "H100").
PEAKS = [("H100 PCIe", (756e12, 51e12, 2.0e12)),
         ("H100 NVL", (835e12, 60e12, 3.9e12)),
         ("H200", (989e12, 67e12, 4.8e12)),
         ("H100", (989e12, 67e12, 3.35e12))]
# Dense int8 tensor-core operations/s (twice the bf16 rate), keyed like
# PEAKS.
INT8_PEAKS = {"H100 PCIe": 1513e12, "H100 NVL": 1671e12, "H200": 1979e12,
              "H100": 1979e12}


def card(name):
    """``(key, (bf16_peak, f32_peak, bytes_per_s))`` of the table row that
    matches a device name, or None."""
    for key, vals in PEAKS:
        if key in str(name):
            return key, vals
    return None


def assumptions_for(name):
    """The hardware model of the card called ``name`` in the JAX
    ``comm_model.ASSUMPTIONS`` shape (``chip``, ``peak_tflops`` by dtype
    key, ``hbm_bw_GBps``), or None for a name the table lacks."""
    row = card(name)
    if row is None:
        return None
    key, (bf16, f32, bw) = row
    return {"chip": key,
            "peak_tflops": {"bf16": bf16 / 1e12, "f16": bf16 / 1e12,
                            "f32": f32 / 1e12,
                            "int8": INT8_PEAKS[key] / 1e12},
            "hbm_bw_GBps": bw / 1e9}


def peak_tflops(dtype, assumptions):
    """The peak (TFLOP/s) of ``assumptions`` for a program whose dominant
    dtype is ``dtype`` (``bf16``/``f16``/``f32``/``int8``; others take
    bf16's), or None without assumptions."""
    if assumptions is None:
        return None
    table = assumptions["peak_tflops"]
    return table.get(str(dtype), table["bf16"])


_CARD = {}


def _assumptions():
    """The hardware model of the current CUDA device, or ``None`` in a
    process that has not initialised CUDA (the CPU) or on a card the table
    does not know -- rows then carry counts and times but no
    memory-bandwidth utilization."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    dev = torch.cuda.current_device()
    if dev not in _CARD:
        _CARD[dev] = assumptions_for(torch.cuda.get_device_name(dev))
    return _CARD[dev]


# -- feeds -------------------------------------------------------------------

def note_compile(name, key, flops=None, bytes_accessed=None,
                 comm_bytes=None, modeled_comm_us=None, args=None):
    """The modeled side: one compile-registry record (called from
    ``profiler.record_compile``; records are rare, so this takes the
    lock). The signature tag is ``name:key``, the same tag the fused
    step threads through ``watchdog.step_end`` so the measured side
    joins exactly. ``args`` carries the recording site's extras
    (``dtype``/``peak_tflops``/``dp`` from the fused step)."""
    if not ENABLED or key is None:
        return
    sig = "%s:%s" % (name, key)
    args = args or {}
    with _lock:
        if sig not in _models and len(_models) >= _MODELS_CAP:
            # evict entries that never joined a measured step first
            for k in [k for k in _models if k not in _meas]:
                del _models[k]
            if len(_models) >= _MODELS_CAP:
                _models.clear()
        _models[sig] = {
            "name": str(name),
            "flops": float(flops) if flops else None,
            "bytes_accessed":
                float(bytes_accessed) if bytes_accessed else None,
            "comm_bytes": float(comm_bytes) if comm_bytes else None,
            "comm_s": (float(modeled_comm_us) / 1e6
                       if modeled_comm_us is not None else None),
            "peak_tflops": args.get("peak_tflops"),
            "dtype": args.get("dtype"),
            "dp": args.get("dp"),
        }


def note_step(sig, dur_s):
    """The measured side: one completed fused step for signature
    ``sig`` (the watchdog beacon feed — its already-computed duration;
    no lock, no clock read, one GIL-atomic append)."""
    if not ENABLED:
        return
    _PENDING.append((sig, dur_s))
    if len(_PENDING) >= _FOLD_AT:
        fold_pending()


# -- drain -------------------------------------------------------------------

def _mfu_of(model, dur_s):
    flops, peak = model.get("flops"), model.get("peak_tflops")
    if not flops or not peak or dur_s <= 0:
        return None
    return flops / (dur_s * peak * 1e12)


def _fold_locked():
    """Drain the mailbox: per-sig windows, per-step MFU, and the
    collapse latch. Returns dump requests to fire AFTER the lock is
    released (a flight-record dump must never run under a subsystem
    lock). popleft races benignly with concurrent appends."""
    dumps = []
    while _PENDING:
        sig, dur = _PENDING.popleft()
        st = _meas.get(sig)
        if st is None:
            if len(_meas) >= _MEAS_CAP:
                _stats["dropped_sigs"] += 1
                continue
            st = _meas[sig] = {
                "count": 0, "sum_s": 0.0, "last_s": 0.0,
                "durs": collections.deque(maxlen=_cfg["window"]),
                "mfus": collections.deque(maxlen=_cfg["window"]),
                "collapses": 0, "tripped": False,
            }
        st["count"] += 1
        st["sum_s"] += dur
        st["last_s"] = dur
        _stats["steps"] += 1
        model = _models.get(sig)
        mfu = _mfu_of(model, dur) if model else None
        collapsed = False
        if mfu is not None and \
                len(st["mfus"]) >= _cfg["min_samples"]:
            baseline = statistics.median(st["mfus"])
            if mfu < _cfg["mfu_drop"] * baseline:
                collapsed = True
                st["collapses"] += 1
                _stats["collapses"] += 1
                if not st["tripped"]:
                    # latch: ONE dump per episode (memwatch idiom)
                    st["tripped"] = True
                    dumps.append(_trip_info(sig, st, model, dur,
                                            mfu, baseline))
        if collapsed:
            # a collapsed step stays OUT of the windows: a sustained
            # collapse must not drag its own baseline down and
            # self-heal the alarm
            continue
        if st["tripped"]:
            st["tripped"] = False  # clean step: episode over, re-arm
        st["durs"].append(dur)
        if mfu is not None:
            st["mfus"].append(mfu)
    return dumps


def _trip_info(sig, st, model, dur, mfu, baseline):
    """Trip payload for the collapse dump: the full roofline term
    table at the tripping duration vs the baseline median, naming
    which term grew (the modeled terms are per-compile constants, so
    between compiles the delta is all overhead — a re-record that
    moved a modeled term shows up in the table instead)."""
    base_med = statistics.median(st["durs"]) if st["durs"] else dur
    now = _terms(model, dur)
    base = _terms(model, base_med)
    grew, grew_by = "overhead", 0.0
    for b in BOUNDS:
        d = now.get(b, 0.0) - base.get(b, 0.0)
        if d > grew_by:
            grew, grew_by = b, d
    return {
        "signature": sig, "mfu": round(mfu, 6),
        "median_mfu": round(baseline, 6),
        "drop_threshold": _cfg["mfu_drop"],
        "measured_s": round(dur, 6),
        "baseline_median_s": round(base_med, 6),
        "grew": grew, "grew_by_s": round(grew_by, 9),
        "terms_s": {b: round(now.get(b, 0.0), 9) for b in BOUNDS},
    }


def _terms(model, dur_s):
    """The roofline decomposition of one measured duration against a
    signature's modeled costs: compute and memory lower bounds (they
    overlap on the card, so the modeled device floor is their max), the
    comm term (``comm_s`` of the record: 0 on one device), and the
    overhead residual."""
    a = _assumptions()
    out = {}
    flops, peak = model.get("flops"), model.get("peak_tflops")
    if flops and not peak and a:
        peak = a.get("peak_tflops", {}).get("bf16")
    out["compute"] = (flops / (peak * 1e12)
                      if flops and peak else 0.0)
    b = model.get("bytes_accessed")
    bw = a.get("hbm_bw_GBps") if a else None
    out["memory"] = b / (bw * 1e9) if b and bw else 0.0
    out["comm"] = model.get("comm_s") or 0.0
    floor = max(out["compute"], out["memory"]) + out["comm"]
    out["overhead"] = max(0.0, dur_s - floor)
    return out


def fold_pending():
    """Fold the hot-path mailbox — called by the watchdog poller each
    pass, every snapshot, and the size backstop. Collapse dumps fire
    here, outside the lock."""
    with _lock:
        dumps = _fold_locked()
    for info in dumps:
        path = _flightrec.dump("perf", extra=info, swallow=True)
        if path is not None:
            with _lock:
                _stats["collapse_dumps"] += 1


# -- derived surfaces --------------------------------------------------------

def _row_locked(sig, st):
    model = _models.get(sig) or {}
    med = statistics.median(st["durs"]) if st["durs"] else \
        (st["last_s"] or None)
    row = {
        "sig": sig,
        "steps": st["count"],
        "collapses": st["collapses"],
        "median_s": med,
        "mean_s": st["sum_s"] / st["count"] if st["count"] else None,
        "flops": model.get("flops"),
        "bytes_accessed": model.get("bytes_accessed"),
        "comm_bytes": model.get("comm_bytes"),
        "peak_tflops": model.get("peak_tflops"),
        "dtype": model.get("dtype"),
        "mfu": None, "membw_util": None, "intensity": None,
        "bound": None, "terms_s": None,
    }
    if model and med:
        terms = _terms(model, med)
        row["terms_s"] = {b: terms[b] for b in BOUNDS}
        row["mfu"] = _mfu_of(model, med)
        if terms["memory"] > 0:
            row["membw_util"] = terms["memory"] / med
        if model.get("flops") and model.get("bytes_accessed"):
            row["intensity"] = model["flops"] / model["bytes_accessed"]
        row["bound"] = max(BOUNDS, key=lambda b: terms[b])
    return row


def table():
    """Joined per-signature rows, hottest first — the dumps() Roofline
    table, the Prometheus families, and the manifest perf block all
    render from this one list."""
    with _lock:
        _fold_locked()  # cheap; dump firing is the poller's job
        rows = [_row_locked(sig, st) for sig, st in _meas.items()]
    rows.sort(key=lambda r: -r["steps"])
    return rows


def snapshot():
    """``metrics()['perf']``: flat top-level counters plus the
    per-signature join under ``per_signature`` (JSON-safe; the
    Prometheus exporter takes only the numeric top-level keys — the
    per-sig gauges have their own ``mxtpu_mfu``/``mxtpu_roofline_bound``
    families)."""
    rows = table()
    out = {"enabled": int(ENABLED), "signatures": len(rows)}
    with _lock:
        out.update(_stats)
    joined = [r for r in rows if r["mfu"] is not None]
    if joined:
        hot = joined[0]  # hottest joined signature: the headline gauge
        out["mfu"] = round(hot["mfu"], 6)
        out["hot_signature"] = hot["sig"]
        if hot["bound"]:
            out["hot_bound"] = hot["bound"]
    out["per_signature"] = {
        r["sig"]: {k: (round(v, 9) if isinstance(v, float) else v)
                   for k, v in r.items() if k != "sig"}
        for r in rows}
    return out


def manifest_block():
    """The ``perf`` block embedded in goodput run manifests (the JAX
    package's ``tools/perf_report.py`` renders and compares it).
    ``None`` when nothing joined (a manifest without the block is a
    run that never ran a tagged fused step)."""
    rows = [r for r in table() if r["mfu"] is not None]
    if not rows:
        return None
    a = _assumptions()
    return {
        "schema": SCHEMA,
        "assumptions": {
            k: a.get(k) for k in ("chip", "peak_tflops", "hbm_bw_GBps")
        } if a else None,
        "signatures": {
            r["sig"]: {
                "steps": r["steps"],
                "median_s": r["median_s"],
                "mfu": r["mfu"],
                "membw_util": r["membw_util"],
                "intensity": r["intensity"],
                "bound": r["bound"],
                "terms_s": r["terms_s"],
                "flops": r["flops"],
                "bytes_accessed": r["bytes_accessed"],
                "comm_bytes": r["comm_bytes"],
                "peak_tflops": r["peak_tflops"],
                "dtype": r["dtype"],
                "collapses": r["collapses"],
            } for r in rows},
    }


# registered at import like the watchdog/goodput providers: every
# process that loads the telemetry stack carries metrics()['perf']
from .. import profiler as _profiler  # noqa: E402

_profiler.register_stats_provider("perf", snapshot)
