"""Training-health plane: tensor-health sentinels in the fused step,
per-layer grad/weight statistics, step digests, and anomaly-triggered
post-mortems (counterpart of mxnet_tpu/_debug/healthmon.py) -- the
numerics sibling of watchdog (time), memwatch (memory) and goodput (wall
clock).

A NaN'd gradient, an exploding layer or a rank silently computing wrong
numbers gives no signal until the loss curve is garbage. The reference
ships Python forward hooks (``monitor.py``) and host array walks
(``tensor_inspector.h``); this module puts the checks into the fused train
step instead:

- **Sentinels** (:func:`graph_summary`): when ``MXTPU_HEALTH=1`` the fused
  step (``gluon/fused_step.py``) reduces, on the device, each bucket of
  ``parallel/overlap.bucket_plan`` (dtype-homogeneous segments) to the sum
  of squares of its gradients and of its weights (one NaN or inf poisons
  the sum, so per-bucket non-finite flags follow from the sums, with no
  separate count pass), plus the loss's non-finite count, sum and
  abs-max, packed into ONE f32 vector: one host transfer per step, never
  one sync per leaf. The reductions are ``torch._foreach_norm`` over the
  leaves (multi-tensor launches) and a stack per bucket. With the fault
  point disarmed, training with ``MXTPU_HEALTH=1`` is bit for bit training
  with ``MXTPU_HEALTH=0``: the sentinels only read.

- **Per-layer statistics and the Monitor**: every
  ``MXTPU_HEALTH_INTERVAL`` steps (and whenever an attached ``Monitor`` is
  activated, or at the first anomaly of an episode) a per-layer pass
  computes each parameter's weight/grad non-finite count, abs-max and L2
  from one batched host transfer, in float64 on the host.
  ``Monitor.install()`` on a block registers the monitor here
  (:func:`attach_monitor`); its rows arrive through the monitor's own
  ``stat_func`` under the reference's ``(batch, name, stat)`` contract.

- **Digests**: each checked step folds the packed summary into a CRC32
  checksum (:func:`last_digest`). :func:`shared_digest` publishes it only
  for programs whose gradients are bitwise-shared across ranks; its
  caller, the asynchronous kvstore's heartbeat, comes with the multi-GPU
  slice (ROADMAP M10).

- **Anomaly response** (:func:`note_step`): a non-finite sentinel, or a
  loss spike past ``MXTPU_HEALTH_LOSS_FACTOR`` x the rolling-median loss,
  trips ONE ``numerics`` flight-record dump per episode -- the offending
  bucket's parameter names, the per-layer stats and the last-K loss
  window -- and applies ``MXTPU_HEALTH_ACTION``:

  ============= =====================================================
  ``record``    dump + counters only (default)
  ``skip_step`` the poisoned update is DISCARDED: the step bitwise
                never happened (counted, goodput-annotated via
                ``note_event``)
  ``halt``      the update is discarded the same way, then
                :class:`HealthHaltError` raises out of the step
  ============= =====================================================

  The JAX step selects the old weights in its program. The port's update
  writes in place, so the fused step reads the packed summary BEFORE its
  update phase and, when it is not clean under ``skip_step`` or ``halt``,
  does not run the update, rolls the update counts back and restores the
  BatchNorm moving statistics its forward already wrote. A finite loss
  spike is seen only after the update: spikes are record-only under every
  action, as in the JAX package.

Chaos: the ``health.grad.corrupt`` fault point corrupts the first
gradient (:func:`corruption_operand`, applied by
:func:`apply_corruption`): ``raise:ArithmeticError`` gives NaN,
``raise:OverflowError`` inf, any other raise a finite doubling (the
silent-corruption shape only a cross-rank digest can catch).

Surfaces: ``profiler.metrics()['health']`` (registered provider, counted
with profiling off), a ``dumps()`` line, ``mxtpu_health_*`` on
``/metrics``, ``health:*`` markers in the ``health`` trace lane, and the
``numerics`` flight-record dumps. Env knobs, the JAX package's:
``MXTPU_HEALTH`` (default 0), ``MXTPU_HEALTH_ACTION`` (record),
``MXTPU_HEALTH_INTERVAL`` (0), ``MXTPU_HEALTH_LOSS_FACTOR`` (8),
``MXTPU_HEALTH_WINDOW`` (32).
"""
from __future__ import annotations

import collections
import functools as _functools
import math
import statistics
import weakref
import zlib

from . import faultpoint as _faultpoint
from . import flightrec as _flightrec
from . import goodput as _goodput
from . import locktrace as _locktrace
from .watchdog import _envf
from ..base import getenv as _getenv

__all__ = [
    "HealthHaltError", "enabled", "action", "configure", "reset",
    "graph_summary", "apply_corruption", "corruption_operand",
    "note_step", "note_amp", "attach_monitor", "detach_monitor",
    "last_digest", "shared_digest", "layer_stats", "last_layer_stats",
    "stats",
]

ACTIONS = ("record", "skip_step", "halt")


class HealthHaltError(RuntimeError):
    """Raised out of the fused step when a non-finite sentinel fires
    under ``MXTPU_HEALTH_ACTION=halt``. The step raises only after its
    update was discarded (the weights, optimizer state and BatchNorm
    moving statistics are those from before the step) and the
    update-count bookkeeping was rolled back: a caller that catches this
    can checkpoint-and-exit cleanly."""


def enabled():
    """Whether the sentinels are on (``MXTPU_HEALTH``). Read from the env
    PER STEP (never per op), so a run may flip it between steps."""
    return _getenv("MXTPU_HEALTH", "0") not in ("", "0", "false", "off")


def action():
    """The anomaly response policy (``MXTPU_HEALTH_ACTION``); unknown
    values degrade to ``record`` (observability must not crash the
    step it observes). Env-read per step, as :func:`enabled`."""
    act = _getenv("MXTPU_HEALTH_ACTION", "record") or "record"
    return act if act in ACTIONS else "record"


_lock = _locktrace.named_lock("healthmon.state")
_cfg = {}


def _defaults():
    return {
        # full per-layer pass cadence (0 = only when a Monitor asks or
        # an anomaly dump needs the rows)
        "interval": int(_envf("MXTPU_HEALTH_INTERVAL", 0)),
        # loss-spike envelope: factor x rolling median (0 = off)
        "loss_factor": _envf("MXTPU_HEALTH_LOSS_FACTOR", 8.0),
        "window": int(_envf("MXTPU_HEALTH_WINDOW", 32)),
        "min_samples": 3,  # spike check arms like the watchdog median
    }


_cfg.update(_defaults())

# mxlint: disable=MX003 (every mutation below sits under the healthmon.state named lock; the waiver covers the definition lines the rule anchors to)
_stats = {
    "steps": 0,            # fused steps the sentinels checked
    "anomalies": 0,        # steps with any anomaly (nonfinite or spike)
    "nonfinite_steps": 0,
    "loss_spikes": 0,
    "skipped_steps": 0,    # updates discarded under action=skip_step
    "halts": 0,
    "dumps": 0,            # numerics flight-record shards written
    "episodes": 0,         # anomaly episodes (latch: one dump each)
    "layer_passes": 0,     # full per-layer stat passes
    "monitor_rows": 0,     # rows delivered to attached Monitors
    "last_anomaly_step": -1,
    "last_loss": 0.0,
    # AMP loss-scaler accounting (single owner): fed by
    # contrib/amp/loss_scaler.py with or without profiling
    "amp_overflow_skips": 0,
    "amp_scale_updates": 0,
    "amp_loss_scale": 0.0,
}
_losses = collections.deque(maxlen=max(1, _cfg["window"]))
_state = {"episode": False, "digest": None,
          "digest_shared": False, "layer_rows": None}
_monitors = []  # weakrefs to attached Monitor instances


def configure(interval=None, loss_factor=None, window=None,
              min_samples=None):
    """Override the env-derived host knobs at runtime (tests,
    notebooks). The switches ``MXTPU_HEALTH`` / ``MXTPU_HEALTH_ACTION``
    change through the env only, as in the JAX package."""
    global _losses
    with _lock:
        if interval is not None:
            _cfg["interval"] = int(interval)
        if loss_factor is not None:
            _cfg["loss_factor"] = float(loss_factor)
        if min_samples is not None:
            _cfg["min_samples"] = int(min_samples)
        if window is not None:
            _cfg["window"] = int(window)
            _losses = collections.deque(_losses,
                                        maxlen=max(1, int(window)))


def reset():
    """Clear all counters/windows/latches and re-read the knobs from
    the env (test isolation). Attached monitors are dropped."""
    global _losses
    with _lock:
        _cfg.clear()
        _cfg.update(_defaults())
        _losses = collections.deque(maxlen=max(1, _cfg["window"]))
        for k in _stats:
            _stats[k] = -1 if k == "last_anomaly_step" else 0
        _stats["last_loss"] = _stats["amp_loss_scale"] = 0.0
        _state["episode"] = False
        _state["digest"] = None
        _state["digest_shared"] = False
        _state["layer_rows"] = None
        del _monitors[:]


def stats():
    """Flat JSON-safe snapshot -- ``profiler.metrics()['health']``."""
    with _lock:
        out = dict(_stats)
        out["loss_median"] = round(statistics.median(_losses), 6) \
            if _losses else 0.0
        out["in_episode"] = int(_state["episode"])
        d = _state["digest"]
        if d is not None:
            out["digest_seq"], out["digest_checksum"] = d
        out["interval"] = _cfg["interval"]
        out["loss_factor"] = _cfg["loss_factor"]
    out["enabled"] = int(enabled())
    out["action"] = action()
    return out


def last_digest():
    """(seq, CRC32 checksum) of the newest checked step's per-bucket
    summary, or None -- the local digest gauge
    (``metrics()['health']['digest_seq'/'digest_checksum']``)."""
    return _state["digest"]


def shared_digest():
    """The digest a kvstore heartbeat publishes for cross-rank comparison
    of silent data corruption, or None. Only digests of steps whose
    gradients are BITWISE-SHARED across ranks qualify (a data-parallel
    step that reduces them before the summary): a single-device digest
    would diverge on every healthy step. The step marks eligibility in
    ``hmeta['replicated']``: the fused step's data-parallel mode sets it
    (its gradients are summed over 'dp' before the summary); the
    heartbeat that reads this comes with the asynchronous server (ROADMAP
    M10b)."""
    return _state["digest"] if _state["digest_shared"] else None


def last_layer_stats():
    """The newest full per-layer pass's rows
    (``[(name, {w_/g_ nonfinite/absmax/l2}), ...]``), or None."""
    return _state["layer_rows"]


# -- monitors ----------------------------------------------------------------

def attach_monitor(mon, params=None):
    """Route per-layer rows from the fused step's health pass into
    ``mon`` (a ``mxnet_tpu_torch.monitor.Monitor``): the parameter rows of
    a step the fused path ran. ``params`` (an iterable of parameter NAMES —
    ``Monitor.install`` passes the installed block's) scopes delivery:
    a monitor only receives rows for its own block's parameters, and
    only a monitor that actually received rows has its eager
    ``toc()`` sweep suppressed -- two monitors on two nets in one
    process never cross-talk. ``None`` = receive every trainer's rows.
    Held weakly; detach is automatic on collection."""
    scope = frozenset(params) if params is not None else None
    with _lock:
        for i, (r, s) in enumerate(_monitors):
            if r() is mon:
                # one monitor installed on several blocks: scopes union
                _monitors[i] = (r, None if scope is None or s is None
                                else s | scope)
                return
        _monitors[:] = [(r, s) for r, s in _monitors
                        if r() is not None]
        _monitors.append((weakref.ref(mon), scope))


def detach_monitor(mon):
    with _lock:
        _monitors[:] = [(r, s) for r, s in _monitors
                        if r() is not None and r() is not mon]


def _live_monitors():
    with _lock:
        refs = list(_monitors)
    return [(m, s) for m, s in ((r(), s) for r, s in refs)
            if m is not None]


# -- the device half ---------------------------------------------------------
# Functions over the step's tensors: no env, no clocks, no host RNG.

def graph_summary(plan, grads, weights, loss, axis_name=None):
    """The sentinel summary, on the device: per-bucket sums of squares
    over ``grads`` and ``weights`` (``plan`` is an ``overlap.bucket_plan``
    index grouping) plus the loss's non-finite count / sum / abs-max.

    Sum reductions only: one NaN or inf poisons its bucket's sum, so
    non-finiteness needs no count pass (exact counts and abs-max live in
    the per-layer pass, which runs on interval/anomaly only); a sum of
    squares that overflows f32 flags too. ``weights`` should be the
    PRE-update weights.

    Returns ``(packed, ok)``: ``packed`` is ONE f32 vector of length
    ``2 * n_buckets + 3``, ``[g_sumsq..., w_sumsq..., loss_bad, loss_sum,
    loss_absmax]`` (one output, ONE host transfer per step), and ``ok``
    the 0-d all-finite flag on the device. :func:`unpack_summary`
    restores the named dict on the host. ``axis_name`` (a mesh axis whose
    replicas fold their loss stats) comes with the multi-GPU slice."""
    import torch
    if axis_name is not None:
        raise NotImplementedError(
            "graph_summary(axis_name=...): mesh folding comes with the "
            "multi-GPU slice (ROADMAP M10)")

    def _bucket_sumsq(arrs):
        norms = torch._foreach_norm(
            [a.detach() for a in arrs], 2, dtype=torch.float32)
        return torch.stack([torch.stack([norms[i] for i in bucket])
                            .square().sum() for bucket in plan])

    g_sumsq = _bucket_sumsq(list(grads))
    w_sumsq = _bucket_sumsq(list(weights))
    lf32 = loss.detach().reshape(-1).float()
    loss_bad = (~torch.isfinite(lf32)).sum()
    loss_sum = lf32.sum()
    loss_absmax = lf32.abs().max()
    packed = torch.cat([
        g_sumsq, w_sumsq,
        torch.stack([loss_bad.float(), loss_sum, loss_absmax])])
    ok = torch.isfinite(g_sumsq).all() & torch.isfinite(w_sumsq).all() \
        & (loss_bad == 0)
    return packed, ok


def unpack_summary(packed, n_buckets):
    """Host half of the packed summary wire format (see
    :func:`graph_summary`): a numpy view of the packed vector back
    into the named dict, with the per-bucket poisoned indicators
    derived from sum finiteness."""
    import numpy as np
    v = np.asarray(packed)
    g_sumsq = v[:n_buckets]
    w_sumsq = v[n_buckets:2 * n_buckets]
    out = {
        "g_sumsq": g_sumsq, "w_sumsq": w_sumsq,
        "g_bad": (~np.isfinite(g_sumsq)).astype(np.int32),
        "w_bad": (~np.isfinite(w_sumsq)).astype(np.int32),
        "loss_bad": int(v[2 * n_buckets]),
        "loss_sum": float(v[2 * n_buckets + 1]),
        "loss_absmax": float(v[2 * n_buckets + 2]),
    }
    out["ok"] = bool(out["g_bad"].sum() == 0
                     and out["w_bad"].sum() == 0
                     and out["loss_bad"] == 0)
    return out


def apply_corruption(grads, corrupt):
    """Scale the first gradient leaf by ``1 + corrupt`` -- an EXACT
    identity at ``corrupt == 0.0`` (x * 1.0 is bitwise x for every float,
    sign of zero included), NaN/inf poison or a finite doubling when the
    ``health.grad.corrupt`` fault point armed the operand. Returns a
    tuple; the first leaf is a new tensor."""
    grads = list(grads)
    import torch
    factor = torch.tensor(1.0 + corrupt, dtype=torch.float32) \
        .to(grads[0].dtype)
    grads[0] = grads[0] * factor.to(grads[0].device)
    return tuple(grads)


def corruption_operand():
    """Host half of the chaos seam: consult the ``health.grad.corrupt``
    faultpoint and return the corruption scalar (0.0 = clean). The
    configured exception type picks the corruption: OverflowError -> inf,
    any other ArithmeticError -> NaN, any other Exception -> 1.0 (grads
    doubled: finite silent corruption)."""
    if not _faultpoint.ACTIVE:
        return 0.0
    try:
        _faultpoint.check("health.grad.corrupt")
    except OverflowError:
        return float("inf")
    except ArithmeticError:
        return float("nan")
    except Exception:
        return 1.0
    return 0.0


# -- the host half -----------------------------------------------------------

def layer_stats(names, grads, weights):
    """Full per-layer pass: one batched host transfer of every grad and
    weight, then per-parameter nonfinite/abs-max/L2 rows in float64.
    Interval/anomaly/Monitor path only -- never per step."""
    import numpy as np
    from ..tensor_inspector import host_arrays
    grads, weights = list(grads), list(weights)
    host = host_arrays(grads + weights)[0]
    host = (host[:len(grads)], host[len(grads):])

    def _one(a):
        a = np.asarray(a)
        a64 = a.astype(np.float64)
        return (int((~np.isfinite(a)).sum()),
                float(np.max(np.abs(a64))) if a.size else 0.0,
                float(np.sqrt(np.square(a64).sum())))

    rows = []
    for name, g, w in zip(names, host[0], host[1]):
        g_bad, g_absmax, g_l2 = _one(g)
        w_bad, w_absmax, w_l2 = _one(w)
        rows.append((name, {
            "g_nonfinite": g_bad, "g_absmax": g_absmax, "g_l2": g_l2,
            "w_nonfinite": w_bad, "w_absmax": w_absmax, "w_l2": w_l2,
        }))
    return rows


def _deliver_monitor_rows(mons, names, grads, weights):
    """Feed activated attached Monitors the per-layer rows through
    their OWN ``stat_func`` -- the reference ``(batch, name, stat)`` row
    contract, weight then ``<name>_grad``, in parameter order (what the
    eager ``toc()`` sweep produces). Each monitor receives only the
    rows inside its attach scope, and only monitors that actually got
    rows are marked so ``toc()`` skips their collect_params pass for
    this batch (no duplicates, no cross-talk between blocks)."""
    active = [(m, s) for m, s in mons if getattr(m, "activated", False)]
    if not active:
        return 0
    from ..ndarray import NDArray
    delivered = 0
    got = set()
    for name, g, w in zip(names, grads, weights):
        gname = name + "_grad"
        takers = [m for m, s in active if s is None or name in s]
        if not takers:
            continue
        wnd = gnd = None
        for m in takers:
            # honor the monitor's own name filter here, so the
            # delivered count (and the toc-suppression mark) reflect
            # rows that actually enqueued -- a pattern matching nothing
            # leaves the monitor to its eager sweep
            sent = 0
            if m.re_prog.match(name):
                wnd = NDArray(w.detach()) if wnd is None else wnd
                m.stat_helper_always(name, wnd)
                sent += 1
            if m.re_prog.match(gname):
                gnd = NDArray(g.detach()) if gnd is None else gnd
                m.stat_helper_always(gname, gnd)
                sent += 1
            if sent:
                delivered += sent
                got.add(id(m))
    for m, _s in active:
        if id(m) in got:
            m._fused_batch = m.step
    return delivered


def note_step(summary, hmeta, grads, weights, batch_size):
    """The per-step host half, called by the fused step after its update
    phase (or in place of it, when the step is skipped). ``summary`` is
    the packed vector of :func:`graph_summary`, already on the host (the
    step's one transfer) or still on the device. Updates the digest/loss
    window, runs the interval/Monitor per-layer pass over ``grads`` and
    ``weights`` (the weights the step leaves), and applies the anomaly
    response. Returns ``{"anomaly": bool, "skipped": bool, "halt":
    exc-or-None}``: under ``action=halt`` the error is RETURNED, not
    raised -- the caller rolls the update counts back first."""
    import numpy as np
    if not isinstance(summary, np.ndarray):
        summary = summary.detach().cpu().numpy()
    packed = np.asarray(summary, np.float32)
    host = unpack_summary(packed, len(hmeta["plan"]))
    g_bad = host["g_bad"]
    w_bad = host["w_bad"]
    loss_bad = host["loss_bad"]
    # poisoned buckets (indicators) + poisoned loss elements
    nonfinite = int(g_bad.sum()) + int(w_bad.sum()) + loss_bad
    loss_mean = host["loss_sum"] / max(int(batch_size), 1)
    checksum = zlib.crc32(packed.tobytes())
    act = hmeta["action"]
    spike = False
    with _lock:
        _stats["steps"] += 1
        seq = _stats["steps"]
        _state["digest"] = (seq, int(checksum))
        _state["digest_shared"] = bool(hmeta.get("replicated"))
        finite_loss = loss_bad == 0 and math.isfinite(loss_mean)
        if finite_loss:
            _stats["last_loss"] = round(loss_mean, 6)
        factor = _cfg["loss_factor"]
        if finite_loss and factor > 0 \
                and len(_losses) >= _cfg["min_samples"]:
            med = statistics.median(_losses)
            if med > 0 and loss_mean > factor * med:
                spike = True
        anomaly = nonfinite > 0 or spike
        if anomaly:
            _stats["anomalies"] += 1
            _stats["last_anomaly_step"] = seq
            if nonfinite:
                _stats["nonfinite_steps"] += 1
            if spike:
                _stats["loss_spikes"] += 1
        elif finite_loss:
            # anomalous losses stay out of the window: a spike must not
            # drag the median up toward itself (the leave-one-out
            # spirit of the straggler baseline)
            _losses.append(loss_mean)
        skipped = bool(nonfinite and act == "skip_step")
        if skipped:
            _stats["skipped_steps"] += 1
        if nonfinite and act == "halt":
            _stats["halts"] += 1
        first_in_episode = anomaly and not _state["episode"]
        if anomaly and first_in_episode:
            _stats["episodes"] += 1
        _state["episode"] = anomaly
        interval = _cfg["interval"]
        loss_window = list(_losses)
    # everything below runs OUTSIDE the state lock (flightrec/profiler
    # take their own locks -- the watchdog trip discipline)
    mons = _live_monitors()
    name_set = set(hmeta["names"])
    mons = [(m, s) for m, s in mons if s is None or s & name_set]
    want_layers = (interval > 0 and seq % interval == 0) \
        or any(getattr(m, "activated", False) for m, _s in mons) \
        or first_in_episode
    rows = None
    if want_layers:
        rows = layer_stats(hmeta["names"], grads, weights)
        delivered = _deliver_monitor_rows(mons, hmeta["names"], grads,
                                          weights)
        with _lock:
            _stats["layer_passes"] += 1
            _stats["monitor_rows"] += delivered
            _state["layer_rows"] = rows
    if not anomaly:
        return {"anomaly": False, "skipped": False, "halt": None}

    reason = "nonfinite" if nonfinite else "loss_spike"
    offending = []
    for b in range(len(g_bad)):
        if int(g_bad[b]) or int(w_bad[b]):
            offending.append({
                "bucket": b,
                "params": hmeta["bucket_names"][b],
                "grad_poisoned": int(g_bad[b]),
                "weight_poisoned": int(w_bad[b]),
                "grad_sumsq": float(host["g_sumsq"][b]),
            })
    from .. import profiler as _profiler
    _profiler.marker("health:%s" % reason, lane="health",
                     category="health",
                     args={"step": seq, "nonfinite": nonfinite,
                           "loss": loss_mean, "action": act,
                           "skipped": skipped})
    if first_in_episode:
        # ONE flight-record dump per episode: a NaN that persists for
        # 500 steps is one readable post-mortem, not a dump storm; the
        # latch re-arms on the first clean step
        path = _flightrec.dump(
            "numerics",
            extra={
                "step": seq, "reason": reason, "action": act,
                "skipped": skipped,
                "suspect_rank": _profiler.PID,
                "nonfinite": nonfinite, "loss_bad": loss_bad,
                "loss_mean": loss_mean,
                "loss_window": loss_window,
                "offending_buckets": offending,
                "layer_stats": [
                    {"name": n, **st} for n, st in (rows or [])],
            },
            swallow=True)
        if path is not None:
            with _lock:
                _stats["dumps"] += 1
    if skipped and _goodput.OPEN:
        # the discarded update is badput the run ledger must name: the
        # step's wall time stays in compute (the work WAS done), the
        # event row says the result was thrown away
        _goodput.note_event("health_skip_step", step=seq, reason=reason)
    halt = None
    if nonfinite and act == "halt":
        halt = HealthHaltError(
            "non-finite training step %d (poisoned buckets %s): "
            "MXTPU_HEALTH_ACTION=halt" % (
                seq, [o["bucket"] for o in offending] or ["loss"]))
    return {"anomaly": True, "skipped": skipped, "halt": halt}


def note_amp(overflow, loss_scale):
    """AMP loss-scaler accounting (fed by
    ``contrib/amp/loss_scaler.py`` -- ``metrics()['health']`` is the
    single owner of overflow/skip counts, with or without profiling,
    the ``account`` contract)."""
    with _lock:
        _stats["amp_scale_updates"] += 1
        _stats["amp_loss_scale"] = float(loss_scale)
        if overflow:
            _stats["amp_overflow_skips"] += 1


# surfaces as metrics()['health'] and a dumps() provider line
# (healthmon is imported by gluon/fused_step and the loss scaler, after
# the profiler module is fully loaded: no cycle)
from .. import profiler as _profiler  # noqa: E402

_profiler.register_stats_provider("health", stats)
