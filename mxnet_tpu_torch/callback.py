"""Training callbacks (counterpart of mxnet_tpu/callback.py; ref:
python/mxnet/callback.py module_checkpoint :31, do_checkpoint :59,
log_train_metric :83, Speedometer :108, ProgressBar :177,
LogValidationMetricsCallback :205).

A batch-end callback takes the fit loop's ``BatchEndParam`` (``epoch``,
``nbatch``, ``eval_metric``, ``locals``); an epoch-end callback takes
(iter_no, sym, arg, aux). The lines logged are the JAX package's. Metric
values come from ``metric.py``'s device accumulators, so a Speedometer
with ``frequent=50`` reads the device once per 50 batches.

``module_checkpoint`` saves through ``Module.save_checkpoint``,
``do_checkpoint`` through ``model.save_checkpoint``: the reference's
``prefix-symbol.json`` and ``prefix-%04d.params`` (epoch numbers from 1),
every ``period`` epochs.
"""
from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]

_log = logging.getLogger(__name__)


def _every(period):
    """True on epochs 0-indexed period-1, 2*period-1, ... (the reference
    checkpoints on (iter_no + 1) % period == 0)."""
    period = max(1, int(period))
    return lambda iter_no: (iter_no + 1) % period == 0


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving ``mod`` every ``period`` epochs
    (ref: callback.py:31)."""
    due = _every(period)

    def _on_epoch_end(iter_no, sym=None, arg=None, aux=None):
        if due(iter_no):
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _on_epoch_end


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving the (sym, arg, aux) triple every
    ``period`` epochs (ref: callback.py:59)."""
    from .model import save_checkpoint
    due = _every(period)

    def _on_epoch_end(iter_no, sym, arg, aux):
        if due(iter_no):
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _on_epoch_end


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches."""
    def _on_batch_end(param):
        metric = param.eval_metric
        if param.nbatch % period != 0 or metric is None:
            return
        for name, value in metric.get_name_value():
            _log.info("Iter[%d] Batch[%d] Train-%s=%f", param.epoch,
                      param.nbatch, name, value)
        if auto_reset:
            metric.reset_local()
    return _on_batch_end


class Speedometer:
    """Batch-end callback logging samples/sec and the metric every
    ``frequent`` batches. With ``auto_reset`` the metric restarts after
    each report, so the values cover the last ``frequent`` batches;
    without, they cover the epoch so far."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size, self.frequent = batch_size, frequent
        self.auto_reset = auto_reset
        self.last_count = 0
        self._window_start = None  # None: the first call of an epoch

    def __call__(self, param):
        n = param.nbatch
        if self.last_count > n:  # nbatch restarted: a new epoch
            self._window_start = None
        self.last_count = n

        if self._window_start is None:
            self._window_start = time.time()
            return
        if n % self.frequent != 0:
            return

        elapsed = time.time() - self._window_start
        speed = (self.frequent * self.batch_size / elapsed) if elapsed \
            else float("inf")
        metric = param.eval_metric
        if metric is None:
            _log.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                      param.epoch, n, speed)
        else:
            pairs = metric.get_name_value()
            lo = n - self.frequent if self.auto_reset else 0
            if self.auto_reset:
                metric.reset_local()
            _log.info("Epoch[%d] Batch [%d-%d]\tSpeed: %.2f "
                      "samples/sec%s", param.epoch, lo, n, speed,
                      "".join("\t%s=%f" % nv for nv in pairs))
        self._window_start = time.time()


class ProgressBar:
    """Batch-end callback drawing an ASCII bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len, self.total = length, total

    def __call__(self, param):
        done = param.nbatch / float(self.total)
        fill = int(round(self.bar_len * done))
        sys.stdout.write("[%s] %s%%\r" % (
            "=" * fill + "-" * (self.bar_len - fill),
            math.ceil(100.0 * done)))


class LogValidationMetricsCallback:
    """Epoch-end (evaluation) callback logging every validation metric."""

    def __call__(self, param):
        for name, value in (param.eval_metric.get_name_value()
                            if param.eval_metric else ()):
            _log.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                      value)
