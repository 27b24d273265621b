"""Device memory / storage introspection + the tagged allocation ledger
(counterpart of mxnet_tpu/storage.py; ref: src/storage/,
include/mxnet/storage.h:36-137).

PyTorch's CUDA caching allocator owns the card's memory, so the port's job
is introspection and control, not an allocator of its own:

* per-device usage stats (``stats()``). On the card they come from
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``:
  ``bytes_in_use`` is ``allocated_bytes.all.current`` (what
  ``torch.cuda.memory_allocated()`` returns), ``peak_bytes_in_use``
  ``allocated_bytes.all.peak``, ``num_allocs``
  ``allocation.all.allocated``, ``bytes_reserved``
  ``reserved_bytes.all.current`` and ``bytes_limit`` the card's total
  memory. Without a card (the CPU tests), the one ``cpu`` device has no
  allocator counters, and the JAX package's ``jax.live_arrays()`` fallback
  becomes a walk of the live CPU tensors: every ``torch.Tensor`` the
  garbage collector tracks (``gc.get_objects()``), each storage counted
  once (views share one), its ``nbytes`` summed. The walk is O(heap): its
  callers are the profiler's memory sampler and the memwatch poll, never
  a hot path.
* an explicit release hook (``release_all``: ``gc.collect`` and
  ``torch.cuda.empty_cache``, counted).

The tagged allocation ledger: every tensor created at a choke point of the
port (``invoke`` results, ``Parameter`` storage, optimizer states, the
creation factories' placement, the io placement) is registered with a
category tag

    param / grad / opt_state / activation / io / workspace / checkpoint /
    other

Tags belong to storages, not tensors: a ``Parameter``'s live view, a
reshape or a slice shares its base's ``untyped_storage()``, and the
storage is what the allocator holds. The ledger keys each entry by the
storage's identity and holds a weak reference to it; PyTorch keeps one
Python storage object per live storage, so the reference dies exactly
when the last tensor over the storage is freed, and the drain that finds
it dead retires the entry. A storage registered under two tags keeps the
more specific one (``param`` over ``opt_state`` over ``grad`` over the
generic tags), whatever the order of registration.

Hot-path price: the per-op dispatch site appends one ``(weakref, site)``
pair to a per-tag ``deque``: no size read, no lock; ``deque.append`` is a
GIL-atomic C call. All bookkeeping (folding pending appends into the
live-entry table, pruning dead storages, per-tag byte totals) happens at
drain time on whoever asks (the profiler's memory sampler, the memwatch
daemon, ``metrics()``) under one named lock. Call-site attribution is
sampled (1 in ``_SITE_SAMPLE`` helper registrations walks the stack).
``MXTPU_MEMLEDGER=0`` is the kill switch; the hot sites also sit behind
the shared ``_HOOKS and _LIVE`` telemetry guard.
"""
from __future__ import annotations

import collections
import gc
import weakref

import torch

from ._debug import locktrace as _locktrace
from .base import getenv as _getenv

__all__ = ["DeviceStats", "stats", "total_bytes_in_use", "release_all",
           "empty_cache", "reset_peak",
           "LEDGER_TAGS", "ledger_register", "ledger_register_tree",
           "ledger_retire", "ledger_metrics", "ledger_reset",
           "pending_append", "set_ledger_enabled", "memory_metrics",
           "note_modeled_peak", "headroom", "bump", "counters"]

# Framework-side high-water mark per device, updated on every stats() call:
# reset_peak() rebases it to the current usage and the next samples grow it
# from there, so a window's peak (one training step between two profiler
# memory samples) is re-derivable without touching the allocator's own
# peak counter.
_hwm_lock = _locktrace.named_lock("storage.hwm")
_hwm = {}  # str(device) -> high-water bytes_in_use since last reset_peak()
# newest stats() snapshot: str(device) -> (bytes_in_use, peak_since_reset,
# bytes_limit). The headroom gauge reads this instead of re-querying the
# allocator per training step.
_last_stats = {}


class DeviceStats:
    """Memory stats for one device (ref: the pool counters in
    src/storage/pooled_storage_manager.h:61-115)."""

    def __init__(self, device, raw):
        self.device = device
        self.bytes_in_use = int(raw.get("bytes_in_use", 0))
        self.peak_bytes_in_use = int(raw.get("peak_bytes_in_use", 0))
        self.bytes_limit = int(raw.get("bytes_limit", 0))
        self.num_allocs = int(raw.get("num_allocs", 0))
        self.largest_alloc_size = int(raw.get("largest_alloc_size", 0))
        self.peak_since_reset = 0  # filled in by stats()
        self.raw = dict(raw)

    def __repr__(self):
        return ("DeviceStats(%s, in_use=%d, peak=%d, limit=%d)"
                % (self.device, self.bytes_in_use, self.peak_bytes_in_use,
                   self.bytes_limit))


def _devices():
    """The devices ``stats()`` reports: every CUDA device when there is
    one (as the JAX package lists the accelerators), else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _live_tensor_stats():
    """{bytes_in_use, num_allocs, largest_alloc_size} of the live CPU
    tensors, each storage once (the module docstring)."""
    seen = set()
    out = {"bytes_in_use": 0, "num_allocs": 0, "largest_alloc_size": 0}
    tensor = torch.Tensor
    for o in gc.get_objects():
        # type(), not isinstance(): isinstance reads __class__, which some
        # module-level proxies answer with a deprecation warning
        if not issubclass(type(o), tensor):
            continue
        try:
            if o.device.type != "cpu":
                continue
            st = o.untyped_storage()
            key = st.data_ptr()
            if key in seen or not key:
                continue
            seen.add(key)
            nb = int(st.nbytes())
        except Exception:
            continue
        out["bytes_in_use"] += nb
        out["num_allocs"] += 1
        if nb > out["largest_alloc_size"]:
            out["largest_alloc_size"] = nb
    return out


def _raw_stats(device):
    if device.type != "cuda":
        raw = _live_tensor_stats()
        raw["source"] = "live_tensors"
        return raw
    ms = torch.cuda.memory_stats(device)
    raw = {"bytes_in_use": ms.get("allocated_bytes.all.current", 0),
           "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
           "num_allocs": ms.get("allocation.all.allocated", 0),
           "bytes_reserved": ms.get("reserved_bytes.all.current", 0),
           "source": "torch.cuda.memory_stats"}
    try:
        free, total = torch.cuda.mem_get_info(device)
        raw["bytes_free"] = int(free)
        raw["bytes_limit"] = int(total)
    except RuntimeError:
        pass
    return raw


def stats():
    """Per-device memory stats (the module docstring says where each
    number comes from). Each call advances the framework-side high-water
    mark behind ``peak_since_reset`` (see ``reset_peak``)."""
    out = []
    with _hwm_lock:
        for d in _devices():
            ds = DeviceStats(d, _raw_stats(d))
            key = str(d)
            mark = _hwm.get(key)
            if mark is None or ds.bytes_in_use > mark:
                mark = ds.bytes_in_use
                _hwm[key] = mark
            ds.peak_since_reset = mark
            _last_stats[key] = (ds.bytes_in_use, mark, ds.bytes_limit)
            out.append(ds)
    return out


def reset_peak():
    """Rebase the framework-side peak mark to current usage (per device),
    so ``DeviceStats.peak_since_reset`` measures the high-water mark of the
    window since this call, and reset the caching allocator's own peak
    counters on the card. Returns {str(device): rebased bytes_in_use}."""
    out = {}
    with _hwm_lock:
        for d in _devices():
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
            key = str(d)
            _hwm[key] = int(_raw_stats(d).get("bytes_in_use", 0))
            out[key] = _hwm[key]
    return out


def total_bytes_in_use():
    return sum(s.bytes_in_use for s in stats())


def release_all():
    """Drop unreferenced device buffers (ref: Storage::ReleaseAll,
    include/mxnet/storage.h; MXStorageEmptyCache in the C API): a
    collection pass, then the caching allocator's unused blocks go back
    to the card (``torch.cuda.empty_cache``). Counted in
    ``metrics()['memory']['empty_cache_calls']`` (the account contract:
    counts with profiling off)."""
    bump("empty_cache_calls")
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


empty_cache = release_all


# ---------------------------------------------------------------------------
# Allocation accounting counters (metrics()['memory'] is their one owner).
# ---------------------------------------------------------------------------

_counters = {
    "alloc_fallbacks": 0,   # device placement failed (counted, re-raised)
    "empty_cache_calls": 0,
}


def bump(name, delta=1):
    """Accumulate one allocation-accounting counter. Unconditional (the
    ``profiler.account`` contract): degradation accounting must be
    trustworthy with profiling off."""
    _counters[name] = _counters.get(name, 0) + delta


def counters():
    return dict(_counters)


# ---------------------------------------------------------------------------
# The tagged allocation ledger.
# ---------------------------------------------------------------------------

LEDGER_TAGS = ("param", "grad", "opt_state", "activation", "io",
               "workspace", "checkpoint", "other")

_LEDGER_ON = _getenv("MXTPU_MEMLEDGER", "1") not in ("0", "false", "off")
# emergency bound per pending deque: maxlen drops OLDEST registrations if
# no drainer runs for a long time (daemons dead): bounded memory beats
# perfect accounting in that degenerate state.
_PENDING_CAP = 1 << 16
# STABLE deque objects: hot modules cache `pending_append(tag)` bound
# methods at import, so reset clears these in place, never replaces them.
_pending = {t: collections.deque(maxlen=_PENDING_CAP) for t in LEDGER_TAGS}

_ledger_lock = _locktrace.named_lock("storage.ledger")
_entries = {}       # id(storage) -> [weakref, tag, nbytes | None, site,
#                                   device]
# Explicit retires that arrived before their registration drained:
# id(buf) -> weakref(buf). The weakref validates the marker at drain
# time — CPython reuses freed addresses, and a stale id-only marker
# would silently swallow some FUTURE buffer's registration forever.
_retired = {}
_cum = {t: 0 for t in LEDGER_TAGS}   # registrations integrated, per tag
_modeled_peaks = {}  # program name -> modeled peak bytes (note_modeled_peak)
# sampled call-site capture budget: 1-in-N helper registrations walk the
# stack (a full walk costs ~10us; the sample keeps attribution ~free)
_SITE_SAMPLE = 64
_site_tick = [0]
_watch_started = [False]


def set_ledger_enabled(enabled):
    """Runtime kill switch (``MXTPU_MEMLEDGER`` sets the process
    default). Returns the previous value."""
    global _LEDGER_ON
    prev = _LEDGER_ON
    _LEDGER_ON = bool(enabled)
    return prev


def pending_append(tag):
    """The raw hot-path registration primitive: the bound
    ``deque.append`` for ``tag``'s pending queue. Hot modules cache it at
    import and append ``(weakref.ref(tensor), site)`` pairs directly;
    everything else (the storage, liveness, sizes, totals) is drain-time
    work. The deque object is stable for the life of the
    process."""
    return _pending[tag].append


# Memoized profiler module ref: the lazy import breaks the storage <->
# profiler cycle, and reading `_PROFILER._LIVE` inline in ledger_register
# spares a helper call.
_PROFILER = None


def _capture_site():
    """First stack frame outside the package: the user code that
    triggered the allocation."""
    import sys
    try:
        f = sys._getframe(2)
    except ValueError:
        return None
    for _ in range(12):
        if f is None:
            return None
        fn = f.f_code.co_filename
        if "mxnet_tpu" not in fn.replace("\\", "/"):
            return "%s:%d" % (fn.rsplit("/", 1)[-1], f.f_lineno)
        f = f.f_back
    return None


def _storage_of(buf):
    """The ``untyped_storage()`` of a tensor, an NDArray or a Parameter,
    or None for anything else (a Python scalar, a numpy array, a meta
    tensor)."""
    t = buf
    if not isinstance(t, torch.Tensor):
        t = getattr(buf, "_data", None)
        if not isinstance(t, torch.Tensor):
            return None
    if t.device.type == "meta":
        return None
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def ledger_register(buf, tag, site=None):
    """Register one tensor's storage (a ``torch.Tensor``, an NDArray or a
    Parameter) under ``tag``. Cheap no-op when the ledger is off or
    telemetry is fully disabled (the shared ``_LIVE`` guard). ``site``
    labels the allocation for the leak watchdog's top-sites table; when
    omitted, a sampled stack capture fills it in 1 in ``_SITE_SAMPLE``
    calls."""
    p = _PROFILER
    if p is None:
        from . import profiler as p
        globals()["_PROFILER"] = p
    if not (_LEDGER_ON and p._LIVE):
        return
    if not _watch_started[0]:
        # the first registration lazily starts the memwatch daemon (the
        # step watchdog's idiom): leak detection is on whenever the
        # ledger has anything to watch, no wiring required
        _watch_started[0] = True
        try:
            from ._debug import memwatch
            memwatch.ensure_thread()
        except Exception:
            pass
    st = _storage_of(buf)
    if st is None:
        return
    if site is None:
        _site_tick[0] += 1
        if _site_tick[0] % _SITE_SAMPLE == 0:
            site = _capture_site()
    _pending[tag].append((weakref.ref(st), site))


def ledger_register_tree(tree, tag, site=None):
    """Register every tensor leaf of a nested tuple/list state tree (the
    optimizer-state shape)."""
    if tree is None:
        return
    if isinstance(tree, (tuple, list)):
        for t in tree:
            ledger_register_tree(t, tag, site)
        return
    ledger_register(tree, tag, site)


def ledger_retire(buf):
    """Explicitly retire a tensor's storage (sites that want deterministic
    accounting before the last reference dies). Exactly once: the entry
    pop is the single ownership transfer; the weakref death later finds
    nothing."""
    st = _storage_of(buf)
    if st is None:
        return
    key = id(st)
    with _ledger_lock:
        if _entries.pop(key, None) is None:
            _retired[key] = weakref.ref(st)
            if len(_retired) > 4 * _PENDING_CAP:
                _retired.clear()  # unmatched retires must not leak


# Drain order, generic tags first; a storage's tag is the most specific one
# it was registered under (_RANK), whichever drain saw which first.
_DRAIN_ORDER = ("activation", "io", "workspace", "checkpoint", "other",
                "grad", "opt_state", "param")
_RANK = {t: i for i, t in enumerate(_DRAIN_ORDER)}


def _drain_locked():
    """Fold pending registrations into the live-entry table. Caller holds
    _ledger_lock. Entries whose storage already died (the typical eager
    temporary) integrate as nothing: that IS their retirement."""
    for tag in _DRAIN_ORDER:
        pop = _pending[tag].popleft
        while True:
            try:
                ref, site = pop()
            except IndexError:
                break
            o = ref()
            if o is None:
                continue  # died before integration
            if isinstance(o, torch.Tensor):
                # a hot-path registration: the tensor's storage, found
                # now (a tensor that died first never pays for it)
                o = _storage_of(o)
                if o is None:
                    continue
                ref = weakref.ref(o)
            key = id(o)
            marker = _retired.get(key)
            if marker is not None:
                del _retired[key]
                if marker() is o:
                    continue  # the retire matches THIS storage
                # stale marker (its storage died, the id was reused):
                # fall through and register the new storage normally
            ent = _entries.get(key)
            if ent is not None and ent[0]() is o:
                if _RANK[tag] > _RANK[ent[1]]:
                    ent[1] = tag
                    ent[3] = site or ent[3]
                continue
            _entries[key] = [ref, tag, None, site, None]
            _cum[tag] = _cum.get(tag, 0) + 1
    # markers whose storage died can never legitimately match again: any
    # future hit on that id is address reuse. Prune them.
    for k in [k for k, r in _retired.items() if r() is None]:
        del _retired[k]


def _walk_locked():
    """(live bytes by tag, live counts by tag, live bytes by (tag, site),
    live bytes by device): prunes dead entries as it goes. Caller holds
    _ledger_lock."""
    by_tag = dict.fromkeys(LEDGER_TAGS, 0)
    counts = dict.fromkeys(LEDGER_TAGS, 0)
    sites = {}
    devices = {}
    dead = []
    for key, ent in _entries.items():
        o = ent[0]()
        if o is None:
            dead.append(key)
            continue
        nb = ent[2]
        if nb is None:
            try:
                nb = int(o.nbytes())
                dev = str(o.device)
            except Exception:
                nb, dev = 0, "?"
            ent[2], ent[4] = nb, dev
        tag = ent[1]
        by_tag[tag] = by_tag.get(tag, 0) + nb
        counts[tag] = counts.get(tag, 0) + 1
        devices[ent[4]] = devices.get(ent[4], 0) + nb
        if ent[3]:
            k = (tag, ent[3])
            sites[k] = sites.get(k, 0) + nb
    for key in dead:
        del _entries[key]
    return by_tag, counts, sites, devices


def ledger_metrics(top_sites=8):
    """One drained snapshot of the ledger: live bytes and counts by tag,
    the total, live bytes by device, cumulative integrations, and the
    top ``top_sites`` allocation sites by live bytes."""
    with _ledger_lock:
        _drain_locked()
        by_tag, counts, sites, devices = _walk_locked()
        cum = dict(_cum)
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:top_sites]
    return {
        "enabled": bool(_LEDGER_ON),
        "by_tag": by_tag,
        "counts": counts,
        "total_bytes": sum(by_tag.values()),
        "by_device": devices,
        "registered_total": cum,
        "top_sites": [{"tag": t, "site": s, "bytes": b}
                      for (t, s), b in top],
    }


def ledger_reset():
    """Drop every ledger entry and pending registration (test
    isolation)."""
    with _ledger_lock:
        for dq in _pending.values():
            dq.clear()
        _entries.clear()
        _retired.clear()
        for t in list(_cum):
            _cum[t] = 0
        _modeled_peaks.clear()
    for k in list(_counters):
        _counters[k] = 0


def note_modeled_peak(name, peak_bytes):
    """Record one program's modeled peak device bytes: the ``modeled`` leg
    of the headroom gauge. Keyed by name; the newest record of a name
    wins. The JAX package feeds it from XLA's ``memory_analysis()``; the
    port traces no program, so only its callers' own estimates land
    here."""
    with _ledger_lock:
        _modeled_peaks[str(name)] = int(peak_bytes)


def headroom(modeled_peak=None):
    """The ``memory.headroom`` gauge: modeled program peak vs the
    framework-side measured peak (``DeviceStats.peak_since_reset``) vs
    the device limit, from the newest ``stats()`` snapshot (cheap: no
    allocator query). Returns None when nothing is known yet."""
    with _ledger_lock:
        if modeled_peak is None and _modeled_peaks:
            modeled_peak = max(_modeled_peaks.values())
    snap = dict(_last_stats)
    dev_peak = max((v[1] for v in snap.values()), default=0)
    dev_limit = max((v[2] for v in snap.values()), default=0)
    if not snap and modeled_peak is None:
        return None
    out = {
        "modeled_peak_bytes": int(modeled_peak or 0),
        "device_peak_bytes": int(dev_peak),
        "device_limit_bytes": int(dev_limit),
    }
    if dev_limit:
        out["headroom_bytes"] = int(
            dev_limit - max(int(modeled_peak or 0), dev_peak))
    return out


def memory_metrics():
    """The storage-owned half of ``profiler.metrics()['memory']``: the
    ledger snapshot, the allocation-accounting counters (single owner —
    the account contract, counts with profiling off), the headroom
    gauge, and the leak-watchdog state."""
    out = {
        "ledger": ledger_metrics(),
        "alloc_fallbacks": _counters.get("alloc_fallbacks", 0),
        "empty_cache_calls": _counters.get("empty_cache_calls", 0),
    }
    hr = headroom()
    if hr is not None:
        out["headroom"] = hr
    try:
        from ._debug import memwatch
        out["memwatch"] = memwatch.stats()
    except Exception:
        pass
    return out
