"""Fault-injection points (``MXNET_FAULTPOINTS=...``): chaos testing
for the port's degradation paths (counterpart of
mxnet_tpu/_debug/faultpoint.py).

Named fault points are woven into the failure seams (prefetch error
propagation, atomic checkpoint writes, device placement, the fused step's
set-up), so that failure semantics can be driven under seeded schedules
and checked: no hang, no silent corruption, full accounting.

Fault-point catalog: where each fires in the JAX package. The whole
catalog is kept, so that one spec configures both packages; the points
that fire in the port are listed after it.

==========================  ================================================
``kvstore.connect``         ``AsyncPSClient`` socket connect (per attempt)
``kvstore.send``            ``AsyncPSClient._call`` transport (per attempt)
``kvstore.pull``            ``AsyncPSClient.pull`` transport (per attempt)
``io.prefetch.place``       ``DevicePrefetchIter`` worker, before place_fn
``engine.bulk.compile``     bulk-segment runner compile (register.py)
``imperative.jit.compile``  dispatch-cache compile (register.py)
``fused_step.trace``        ``FusedTrainStep._build`` trace entry
``checkpoint.save``         ``base.atomic_write``, after the temp write,
                            before the atomic rename (mid-save crash)
``checkpoint.persist``      ``CheckpointManager._persist_bg``, after the
                            snapshot is taken, before the durable write
                            starts (the async snapshot→persist gap: a
                            death here loses exactly the one
                            unpublished step)
``storage.alloc``           creation-factory device placement
                            (``nd._ctx_place``)
``collective.allreduce``    gradient-reduction launch seams: the host
                            kvstore reducer (``parallel/elastic.py``
                            ``HostGradReducer``) per call, and
                            ``parallel/collectives.py`` helpers at
                            trace/launch time
``elastic.restore``         ``CheckpointManager.restore`` entry, before
                            any checkpoint bytes are read
``elastic.reshard``         ``ElasticController.reshard`` entry, before
                            the surviving world is committed
``io.shard.read``           ``RecordIORangeReader`` range-fetch, per
                            attempt (retried under ``_retry``)
``io.record.corrupt``       ``RecordIORangeReader`` record validation —
                            an injected raise is treated as a corrupt
                            record (skip-and-count under the budget)
``io.worker.decode``        ``DecodePool`` worker, before ``decode_fn``
                            (a raise is a worker death; the pool
                            restarts it under its per-worker budget)
``io.service.fetch``        ``ShardService.fetch_batch`` entry — the
                            disaggregated-service RPC seam
``health.grad.corrupt``     fused-step gradient corruption
                            (``_debug/healthmon.corruption_operand``):
                            the configured exception type picks the
                            in-graph poison — ``raise:OverflowError``
                            → inf, any other ``ArithmeticError`` →
                            NaN, any other raise → a finite exponent
                            bit-flip (grads doubled, the pure-SDC
                            shape only the cross-rank digest catches)
``net.partition``           kvstore frame send/recv seam
                            (``kvstore_async._send_frame`` /
                            ``_recv_frame``): a ``raise:
                            ConnectionError`` models the link going
                            down mid-frame; ``@skip``/``@p`` shape
                            asymmetric partitions
``net.delay``               same seam, ``delay:<t>`` — a slow or
                            congested link, per frame
``net.drop``                send seam only: a trigger (any action)
                            silently swallows the frame — it is sent
                            locally but never arrives, so the caller
                            blocks in recv until
                            ``MXTPU_PS_RECV_TIMEOUT`` surfaces it
``net.half_open``           recv seam only, ``delay:<silence>`` — the
                            peer holds the connection open but never
                            answers for ``<silence>`` seconds; with a
                            recv timeout configured the seam then
                            raises the same ``socket.timeout`` a real
                            silent peer produces
==========================  ================================================

The points that fire in the port: ``io.prefetch.place`` (the
``DevicePrefetchIter`` worker, before the placement), ``checkpoint.save``
(``base.atomic_write``, between the temp write and the rename),
``storage.alloc`` (the creation factories' placement,
``ndarray._ctx_place``), ``fused_step.trace`` (where a
``FusedTrainStep`` first sets up an input signature),
``health.grad.corrupt`` (the fused step, ``MXTPU_HEALTH=1``),
``checkpoint.persist`` and ``elastic.restore``
(``parallel.elastic.CheckpointManager``), ``io.shard.read`` and
``io.record.corrupt`` (``io.RecordIORangeReader``), ``io.worker.decode``
(``io.DecodePool``) and ``io.service.fetch`` (``io.ShardService``).
``imperative.jit.compile`` and ``engine.bulk.compile`` never fire: the
port has no dispatch cache and no bulk segments. The kvstore, collective,
reshard and network points arrive with their modules (ROADMAP M10).

Configuration — env var (parsed at import) or programmatic::

    MXNET_FAULTPOINTS="kvstore.send=raise:ConnectionError@p=0.3;\
io.prefetch.place=delay:50ms@n=3"
    MXNET_FAULTPOINTS_SEED=7   # default 0

    faultpoint.configure(
        "kvstore.send=raise:ConnectionError@p=0.3", seed=7)
    faultpoint.configure({"fused_step.trace": "raise:RuntimeError@n=1"})
    faultpoint.reset()

Spec grammar: ``point=action[@mod]...`` joined with ``;``. Actions:
``raise:ExcName`` (a builtin Exception subclass) and ``delay:50ms`` /
``delay:0.2s`` / ``delay:0.05``. Modifiers: ``p=<0..1>`` trigger
probability, ``n=<int>`` max triggers (then the point goes quiet),
``skip=<int>`` hits to let pass before arming.

Every chaos run is **deterministic and replayable**: each point draws
from its own ``random.Random`` seeded with ``(seed, point name)``, so a
point's trigger pattern depends only on the seed and its own hit
sequence, not on cross-point interleaving.

Zero overhead when inactive: instrumented sites guard with the inlined
``if _faultpoint.ACTIVE:`` module-bool test — the same idiom as the
profiler hooks' ``_HOOKS and _LIVE`` guard.

Observability: per-point trigger counters surface as
``profiler.metrics()['faults']`` (registered stats provider — counted
even while no profile run is active) and each trigger emits a
``fault:<point>`` instant marker into the trace when profiling is on.
"""
from __future__ import annotations

import builtins
import random
import time

from . import locktrace as _locktrace
from ..base import getenv as _getenv

__all__ = [
    "ACTIVE", "POINTS", "configure", "reset", "check", "is_active",
    "metrics", "reset_counters", "triggers",
]

# Module-level gate, read inline by the instrumented sites
# (`if _faultpoint.ACTIVE: _faultpoint.check(name)`) so the unconfigured
# cost is one attribute load + truth test.
ACTIVE = False

# The woven seams. configure() validates names against this catalog so a
# typo'd spec fails loudly instead of silently injecting nothing.
POINTS = frozenset((
    "kvstore.connect",
    "kvstore.send",
    "kvstore.pull",
    "io.prefetch.place",
    "engine.bulk.compile",
    "imperative.jit.compile",
    "fused_step.trace",
    "checkpoint.save",
    "checkpoint.persist",
    "storage.alloc",
    "collective.allreduce",
    "elastic.restore",
    "elastic.reshard",
    "io.shard.read",
    "io.record.corrupt",
    "io.worker.decode",
    "io.service.fetch",
    "health.grad.corrupt",
    # on-the-wire network chaos (kvstore_async frame send/recv seam)
    "net.partition",
    "net.delay",
    "net.drop",
    "net.half_open",
))

_lock = _locktrace.named_lock("faultpoint.config")
_rules = {}     # point name -> _Rule
_counters = {}  # point name -> times a fault actually triggered


class _Rule:
    """One configured fault: action + arming state + per-point RNG."""

    __slots__ = ("name", "action", "exc_type", "delay_s", "p",
                 "remaining", "skip", "rng", "spec")

    def __init__(self, name, action, exc_type, delay_s, p, n, skip, seed,
                 spec):
        self.name = name
        self.action = action        # "raise" | "delay"
        self.exc_type = exc_type    # Exception subclass for "raise"
        self.delay_s = delay_s      # seconds for "delay"
        self.p = p                  # trigger probability per armed hit
        self.remaining = n          # triggers left (None = unlimited)
        self.skip = skip            # hits to let pass before arming
        # (seed, name)-derived stream: a point's schedule is a pure
        # function of the seed and its own hit sequence — replayable
        # regardless of how other points interleave
        self.rng = random.Random("%s:%s" % (seed, name))
        self.spec = spec            # original text, for reporting


def _resolve_exception(name):
    exc = getattr(builtins, name, None)
    if not (isinstance(exc, type) and issubclass(exc, Exception)):
        raise ValueError(
            "faultpoint raise action needs a builtin Exception subclass, "
            "got %r" % (name,))
    return exc


def _parse_delay(arg):
    if arg.endswith("ms"):
        return float(arg[:-2]) / 1000.0
    if arg.endswith("s"):
        return float(arg[:-1])
    return float(arg)


def _parse_one(name, spec, seed):
    """``action[:arg][@k=v]...`` -> _Rule for ``name``."""
    if name not in POINTS:
        raise ValueError(
            "unknown fault point %r; known points: %s"
            % (name, ", ".join(sorted(POINTS))))
    head, *mods = spec.split("@")
    action, _, arg = head.partition(":")
    action = action.strip()
    exc_type, delay_s = None, 0.0
    if action == "raise":
        exc_type = _resolve_exception(arg.strip() or "RuntimeError")
    elif action == "delay":
        delay_s = _parse_delay(arg.strip() or "0.05")
        if delay_s < 0:
            raise ValueError("faultpoint delay must be >= 0, got %r"
                             % (arg,))
    else:
        raise ValueError(
            "unknown faultpoint action %r (want raise:Exc or delay:50ms)"
            % (action,))
    p, n, skip = 1.0, None, 0
    for mod in mods:
        k, _, v = mod.partition("=")
        k = k.strip()
        if k == "p":
            p = float(v)
            if not 0.0 <= p <= 1.0:
                raise ValueError("faultpoint p must be in [0, 1], got %r"
                                 % (v,))
        elif k == "n":
            n = int(v)
            if n < 0:
                raise ValueError("faultpoint n must be >= 0, got %r"
                                 % (v,))
        elif k == "skip":
            skip = int(v)
            if skip < 0:
                raise ValueError("faultpoint skip must be >= 0, got %r"
                                 % (v,))
        else:
            raise ValueError("unknown faultpoint modifier %r "
                             "(want p=/n=/skip=)" % (k,))
    return _Rule(name, action, exc_type, delay_s, p, n, skip, seed, spec)


def parse(spec, seed=0):
    """Parse a full ``MXNET_FAULTPOINTS`` string (or dict of
    point -> action spec) into {name: _Rule} without installing it."""
    if isinstance(spec, dict):
        items = spec.items()
    else:
        items = []
        for part in str(spec).split(";"):
            part = part.strip()
            if not part:
                continue
            name, eq, body = part.partition("=")
            if not eq:
                raise ValueError(
                    "bad faultpoint spec %r (want point=action)" % (part,))
            items.append((name.strip(), body.strip()))
    return {name: _parse_one(name, body, seed) for name, body in items}


def configure(spec, seed=None):
    """Install a fault schedule, REPLACING any previous one (so a run's
    behavior is a pure function of this call). ``spec`` is the env-string
    grammar or a dict of ``point -> "action[@mods]"``. ``seed`` defaults
    to ``MXNET_FAULTPOINTS_SEED`` (0 when unset). Returns the installed
    point names."""
    global ACTIVE
    if seed is None:
        seed = int(_getenv("MXNET_FAULTPOINTS_SEED", "0"))
    rules = parse(spec, seed)
    with _lock:
        _rules.clear()
        _rules.update(rules)
        _counters.clear()  # a new schedule starts its accounting at zero
        ACTIVE = bool(_rules)
    return sorted(rules)


def reset():
    """Remove every configured fault and clear the trigger counters
    (test isolation). The instrumented sites go back to the single
    guarded-branch cost."""
    global ACTIVE
    with _lock:
        _rules.clear()
        _counters.clear()
        ACTIVE = False


def is_active():
    return ACTIVE


def triggers(name):
    """How many times the named point actually fired."""
    with _lock:
        return _counters.get(name, 0)


def metrics():
    """JSON-safe per-point trigger counts — the ``faults`` section of
    ``profiler.metrics()`` (registered as a stats provider; counted with
    or without an active profile run)."""
    with _lock:
        return dict(_counters)


def reset_counters():
    with _lock:
        _counters.clear()


def check(name):
    """The injection site. Callers guard with ``if _faultpoint.ACTIVE:``
    so the unconfigured cost stays off the hot path. Decides — under the
    point's seeded RNG — whether this hit triggers; a trigger counts,
    emits a trace marker, then sleeps (``delay``) or raises (``raise``)
    the configured exception out of the instrumented seam, exactly where
    a real failure would surface. Returns True when a non-raising
    trigger fired (after its sleep) and False otherwise, so seams with
    behavior beyond sleep-or-raise — the ``net.drop`` /
    ``net.half_open`` socket shim — can act on the trigger themselves."""
    with _lock:
        rule = _rules.get(name)
        if rule is None:
            return False
        if rule.skip > 0:
            rule.skip -= 1
            return False
        if rule.remaining is not None and rule.remaining <= 0:
            return False
        if rule.p < 1.0 and rule.rng.random() >= rule.p:
            return False
        if rule.remaining is not None:
            rule.remaining -= 1
        _counters[name] = _counters.get(name, 0) + 1
        action, exc_type, delay_s = rule.action, rule.exc_type, rule.delay_s
    _mark(name, action)
    if action == "delay":
        time.sleep(delay_s)
        return True
    raise exc_type("faultpoint %r injected %s" % (name, exc_type.__name__))


def _mark(name, action):
    """Instant marker in the trace so injected faults are visible next to
    the spans they perturb — and in the always-on flight-recorder ring,
    where a ``fault:*`` breadcrumb right before a crash dump is exactly
    the evidence a post-mortem wants. Lazy profiler import: profiler
    imports this package at module load (the stats-provider
    registration), so a top-level import here would be circular."""
    from . import flightrec as _flightrec
    if _flightrec.ENABLED:
        _flightrec.record_marker("fault:%s" % name, "fault",
                                 args={"action": action})
    from .. import profiler as _profiler
    if _profiler._ACTIVE:
        _profiler._emit("fault:%s" % name, "i", "fault",
                        args={"action": action})


def report():
    """Configured schedule + trigger counts (debugging aid)."""
    with _lock:
        return {
            "active": ACTIVE,
            "points": {n: r.spec for n, r in sorted(_rules.items())},
            "triggers": dict(_counters),
        }


# Env activation at import: the instrumented modules load after this one
# (profiler pulls in the _debug package before any subsystem), so an env
# schedule is live for the whole process without code changes.
_env_spec = _getenv("MXNET_FAULTPOINTS", "").strip()
if _env_spec:
    configure(_env_spec)
