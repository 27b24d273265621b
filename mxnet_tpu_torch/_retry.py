"""Unified transport retry: exponential backoff + jitter + deadline
(counterpart of mxnet_tpu/_retry.py).

Every retry loop of the port backs off the same way, is bounded the same
way, and is tuned by the same ``MXTPU_PS_RETRY_*`` env knobs as the JAX
package's. Its callers there (the async parameter-server client) arrive
with the multi-process slice; the policy is here first so that they and
the io readers share one:

===========================  =======  =====================================
``MXTPU_PS_RETRY_MAX``       ``8``    max retry attempts after the first
                                      try (0 disables retrying)
``MXTPU_PS_RETRY_BASE``      ``0.05`` first backoff in seconds; doubles
                                      each attempt
``MXTPU_PS_RETRY_CAP``       ``2.0``  per-sleep ceiling in seconds
``MXTPU_PS_RETRY_DEADLINE``  ``30``   total seconds across all attempts;
                                      when the next sleep would cross it,
                                      the last error re-raises instead
===========================  =======  =====================================

Jitter is the classic decorrelation trick (up to +50% of each sleep) so
N workers retrying against one recovering server do not thundering-herd
in lockstep; it perturbs only *when* a retry happens, never *what* it
does, so chaos-run results stay deterministic. Under a configured
``MXNET_FAULTPOINTS_SEED`` the jitter stream itself is seeded per policy
(the faultpoint ``(seed, name)`` idiom), so a seeded chaos run's backoff
schedule replays identically run-to-run; unset keeps production
decorrelation.
"""
from __future__ import annotations

import random
import time

from .base import getenv as _getenv

__all__ = ["RetryPolicy", "call"]


class RetryPolicy:
    """Backoff schedule: ``base * 2**attempt`` capped at ``cap``, plus
    0-50% jitter, bounded by both ``max_retries`` and ``deadline``
    seconds of total elapsed time. Env knobs supply the defaults at
    construction time (so tests can monkeypatch them per case)."""

    def __init__(self, max_retries=None, base=None, cap=None,
                 deadline=None):
        self.max_retries = int(_getenv("MXTPU_PS_RETRY_MAX", "8")) \
            if max_retries is None else int(max_retries)
        self.base = float(_getenv("MXTPU_PS_RETRY_BASE", "0.05")) \
            if base is None else float(base)
        self.cap = float(_getenv("MXTPU_PS_RETRY_CAP", "2.0")) \
            if cap is None else float(cap)
        self.deadline = float(_getenv("MXTPU_PS_RETRY_DEADLINE", "30")) \
            if deadline is None else float(deadline)
        # chaos determinism: with a faultpoint seed
        # configured, this policy's jitter draws from its own seeded
        # stream — two policies built under the same seed replay the
        # same backoff sequence. Unset (production) keeps the shared
        # unseeded RNG's decorrelation across workers.
        seed = _getenv("MXNET_FAULTPOINTS_SEED", "")
        self._rng = random.Random("%s:retry" % seed) if seed else None

    def backoff(self, attempt):
        """Sleep before retry ``attempt`` (1-based), jittered."""
        raw = min(self.cap, self.base * (2.0 ** (attempt - 1)))
        return raw * (1.0 + 0.5 * (self._rng or random).random())


def call(fn, retryable=(ConnectionError, OSError), policy=None,
         on_retry=None):
    """Run ``fn()`` with retries on ``retryable`` exceptions.

    ``on_retry(attempt, exc, delay)`` fires before each backoff sleep —
    the hook where callers count retries distinctly per subsystem and
    drop broken sockets. Exhausting ``max_retries`` or the deadline
    re-raises the last error unchanged, so callers' exception contracts
    are the same as the unretried call's."""
    if policy is None:
        policy = RetryPolicy()
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            attempt += 1
            if attempt > policy.max_retries:
                raise
            delay = policy.backoff(attempt)
            if time.monotonic() + delay - start > policy.deadline:
                raise
            if on_retry is not None:
                on_retry(attempt, e, delay)
            time.sleep(delay)
