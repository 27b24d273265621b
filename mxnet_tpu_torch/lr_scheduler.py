"""Learning-rate schedules (counterpart of mxnet_tpu/lr_scheduler.py).

Every schedule is a closed-form function of the optimizer's global update
count::

    lr(t) = warmup(t)              while t is inside the warmup ramp
    lr(t) = _decayed(t)            afterwards

so resuming at step t needs no replay of the t-1 calls before it, and
each ``lr(t)`` is the JAX package's float for the same ``t`` (plain
Python arithmetic on both sides).

``base_lr`` stays a plain mutable attribute because the optimizer
re-points it after construction (``lr_scheduler.base_lr =
learning_rate``).
"""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]

_log = logging.getLogger(__name__)


class LRScheduler:
    """Maps the optimizer's update counter to a learning rate.

    ``warmup_steps > 0`` prepends a ramp from ``warmup_begin_lr`` up to
    ``base_lr`` — linear per default, or flat at ``warmup_begin_lr``
    with ``warmup_mode="constant"``. Subclasses implement the
    post-warmup schedule as ``_decayed(num_update)``.
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if not isinstance(warmup_steps, int) or warmup_steps < 0:
            raise ValueError("warmup_steps must be a non-negative int, "
                             "got %r" % (warmup_steps,))
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("warmup_mode must be 'linear' or 'constant', "
                             "got %r" % (warmup_mode,))
        if warmup_begin_lr > base_lr:
            raise ValueError("warmup ramps upward: warmup_begin_lr=%g "
                             "exceeds base_lr=%g" % (warmup_begin_lr,
                                                     base_lr))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode
        # frozen at construction like the reference: the optimizer's
        # later base_lr reassignment must not re-aim (or invert) a ramp
        # that was validated against the construction-time target
        self.warmup_final_lr = base_lr

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        ramp = num_update / float(self.warmup_steps)
        return self.warmup_begin_lr \
            + ramp * (self.warmup_final_lr - self.warmup_begin_lr)

    def _decayed(self, num_update):
        raise NotImplementedError(
            "%s must implement _decayed(num_update)"
            % type(self).__name__)

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decayed(num_update)


def _check_factor(factor):
    if factor > 1.0:
        raise ValueError("a decay factor > 1 would grow the rate, got %g"
                         % factor)


class FactorScheduler(LRScheduler):
    """``base_lr * factor**k``, stepping k once per ``step`` updates and
    flooring at ``stop_factor_lr``.

    Closed form ``k(t) = (t - 1) // step`` — the same k the reference
    walks with a count/while loop (ref: lr_scheduler.py:81).
    """

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr,
                         warmup_mode)
        if step < 1:
            raise ValueError("step must be >= 1, got %r" % (step,))
        _check_factor(factor)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._announced_k = 0

    def _decayed(self, num_update):
        k = max(0, (int(num_update) - 1) // self.step)
        lr = max(self.base_lr * self.factor ** k, self.stop_factor_lr)
        if k > self._announced_k:  # log each NEW decay level once
            self._announced_k = k
            _log.info("update %d: learning rate -> %.5e", num_update, lr)
        return lr


class MultiFactorScheduler(LRScheduler):
    """``base_lr * factor**k`` where k counts the milestones already
    passed (ref: lr_scheduler.py:131 walks the same milestones with a
    cursor index)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr,
                         warmup_mode)
        if not isinstance(step, (list, tuple)):
            # a scalar step otherwise dies with a TypeError mid-iteration
            # below; the reference's isinstance check names the contract
            raise ValueError("step must be a list or tuple of ints, got %r "
                             "(use FactorScheduler for a fixed interval)"
                             % (step,))
        if not step or any(s < 1 for s in step):
            raise ValueError("step must be a non-empty list of ints >= 1, "
                             "got %r" % (step,))
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must strictly increase, got %r"
                             % (step,))
        _check_factor(factor)
        self.step = list(step)
        self.factor = factor
        self._announced_k = 0

    def _decayed(self, num_update):
        k = sum(1 for milestone in self.step if num_update > milestone)
        lr = self.base_lr * self.factor ** k
        if k > self._announced_k:
            self._announced_k = k
            _log.info("update %d: learning rate -> %.5e", num_update, lr)
        return lr


class _RampDown(LRScheduler):
    """Shared shape of the fixed-horizon decays: a monotone profile
    p(x) on x in [0, 1] scaled between base_lr and final_lr."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr,
                         warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive int, got %r"
                             % (max_update,))
        self.max_update = max_update
        self.final_lr = final_lr
        # frozen at construction, like the reference's base_lr_orig —
        # the optimizer's later base_lr assignment intentionally does
        # not rescale fixed-horizon schedules
        self.base_lr_orig = self.base_lr
        self.max_steps = max_update - warmup_steps

    def _profile(self, x):
        raise NotImplementedError

    def _decayed(self, num_update):
        x = (num_update - self.warmup_steps) / float(self.max_steps)
        span = self.base_lr_orig - self.final_lr
        return self.final_lr + span * self._profile(min(x, 1.0))


class PolyScheduler(_RampDown):
    """Polynomial ramp-down (1 - x)^pwr over max_update steps
    (ref: lr_scheduler.py:190)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _profile(self, x):
        return (1.0 - x) ** self.power


class CosineScheduler(_RampDown):
    """Half-cosine ramp-down over max_update steps
    (ref: lr_scheduler.py:238)."""

    def _profile(self, x):
        return 0.5 * (1.0 + math.cos(math.pi * x))
