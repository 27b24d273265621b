"""Persistent compile cache (counterpart of mxnet_tpu/gluon/compile_cache.py):
reuse yesterday's builds from disk instead of rebuilding.

The JAX package serializes the fused step's XLA executable. The port has
no compiled program to serialize: its compiled artifacts are the kernels'
shared libraries, which ``kernels/_build.py`` compiles with ``nvcc`` at
first use. With ``MXTPU_COMPILE_CACHE_DIR`` set, each library lands there
(``store``) and a later process loads it from there (``load``) instead of
running ``nvcc``. An entry's key holds the source's digest (the ``.cu``
file, the shared headers and the flags: ``_build._target``), the ``nvcc``
version, torch's CUDA version and the device's compute capability, so an
entry never loads under another source, toolkit or card.

- ``cache_path(key)``: the entry of one key, ``<dir>/<sha256>.so``, and
  its digest sidecar ``<entry>.sha256``.
- ``load(key)``: the ``ctypes.CDLL`` of the entry, or None. An entry whose
  bytes do not match the digest written beside it, or that does not load,
  is counted in ``deserialize_errors`` and removed; the caller then builds
  the library again from the same source. Never fatal, and never a
  fallback: the plain version of a kernel never runs in its place, and a
  failing ``nvcc`` still raises.
- ``store(key, path)``: publishes a built library (temp write + rename,
  ``base.atomic_write``, the digest first). A failure is counted in
  ``store_errors`` and loses the entry, never the build.

Counters in ``metrics()['compile_cache']``: ``hits``, ``misses``,
``stores``, ``deserialize_errors``, ``store_errors``.
"""
from __future__ import annotations

import hashlib
import os

from .. import base as _base
from .. import profiler as _profiler
from ..base import getenv as _getenv

__all__ = ["enabled", "cache_dir", "cache_path", "load", "store",
           "stats", "reset_stats"]

# mxlint: disable=MX003 (GIL-atomic best-effort counters, same contract as fused_step._STATS)
_STATS = {
    "hits": 0,       # libraries loaded from the persistent cache
    "misses": 0,     # no entry for this key (a build follows)
    "stores": 0,     # libraries published to the cache
    "deserialize_errors": 0,  # entry present but unloadable (torn or
                              # corrupt bytes, a digest mismatch): counted,
                              # removed, then rebuilt; never fatal
    "store_errors": 0,        # publishing failed: the build is kept, the
                              # cache entry lost
}


def stats():
    """Snapshot of the persistent-cache counters."""
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


# surfaces as metrics()['compile_cache'] and a dumps() line
_profiler.register_stats_provider("compile_cache", stats, reset_stats)


def cache_dir():
    """The cache root, or ``None`` when the cache is off. Read per call,
    so tests and late-configured launchers can flip it."""
    d = _getenv("MXTPU_COMPILE_CACHE_DIR", "")
    return d or None


def enabled():
    return cache_dir() is not None


def cache_path(key):
    """Entry path for one key (any value with a deterministic ``repr``;
    ``_build`` passes the tuple of source digest, ``nvcc`` version, torch's
    CUDA version and compute capability), or None when the cache is off."""
    d = cache_dir()
    if d is None:
        return None
    h = hashlib.sha256(repr(key).encode("utf-8")).hexdigest()
    return os.path.join(d, h[:32] + ".so")


def _digest(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _drop(path):
    for p in (path, path + ".sha256"):
        try:
            os.remove(p)
        except OSError:
            pass


def load(key):
    """The ``ctypes.CDLL`` of the cached library for ``key``, or ``None``
    (a miss, or an unloadable entry: counted and removed). The caller
    builds the library from its source either way."""
    import ctypes
    path = cache_path(key)
    if path is None:
        return None
    if not os.path.exists(path):
        _STATS["misses"] += 1
        return None
    try:
        with open(path + ".sha256") as f:
            want = f.read().strip()
        if _digest(path) != want:
            raise OSError("digest mismatch: the entry is torn or corrupt")
        lib = ctypes.CDLL(path)
    except Exception as e:
        _STATS["deserialize_errors"] += 1
        _profiler.record_op(
            "compile_cache.deserialize_error", 0.0, category="compile",
            lane="compile",
            args={"entry": os.path.basename(path),
                  "error": "%s: %s" % (type(e).__name__, e)})
        _drop(path)
        return None
    _STATS["hits"] += 1
    return lib


def store(key, built):
    """Publish the library at ``built`` under ``key``. Best-effort: a
    failure loses the cache entry, never the build. Returns the entry's
    path, or None."""
    path = cache_path(key)
    if path is None:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(built, "rb") as f:
            blob = f.read()
        with _base.atomic_write(path + ".sha256", "w") as f:
            f.write(hashlib.sha256(blob).hexdigest() + "\n")
        with _base.atomic_write(path, "wb") as f:
            f.write(blob)
    except Exception:
        _STATS["store_errors"] += 1
        return None
    _STATS["stores"] += 1
    return path
