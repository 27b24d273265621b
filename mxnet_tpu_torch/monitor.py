"""Monitor outputs, weights and gradients for debugging (counterpart of
mxnet_tpu/monitor.py; ref: python/mxnet/monitor.py Monitor :33).

``install`` registers a forward hook on a Gluon block (each output's stat,
``<block>_output<i>``) or keeps an executor; ``tic``/``toc`` around a batch
collect the same ``(batch, name, stat)`` rows as the reference, with every
parameter (and ``<name>_grad``) swept at ``toc``. ``Module.fit(monitor=)``
and ``Module.install_monitor`` install it on the module's executor. An
executor's ``set_monitor_callback(mon.stat_helper)`` adds its outputs'
rows after each forward, as in the reference.

The port runs eagerly, hybridized blocks included, so the forward hooks
fire on every call (the JAX package's cached programs skip them). A block
is also registered with the training-health plane
(``_debug.healthmon.attach_monitor``, scoped to its parameters): with
``MXTPU_HEALTH=1`` the fused train step delivers the parameter rows of an
activated batch, and ``toc`` then skips its own sweep of that block.
"""
from __future__ import annotations

import logging
import re

import torch

from .ndarray import NDArray

__all__ = ["Monitor"]


def _nd(array):
    if isinstance(array, NDArray):
        return array
    if isinstance(array, torch.Tensor):
        return NDArray(array.detach())
    from . import ndarray as nd
    return nd.array(array)


class Monitor:
    """Collect per-tensor stats every `interval` batches (ref: monitor.py:33)."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return x.abs().mean()
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, array):
        """One named array's row, when activated and the name matches
        (the executor's monitor callback and the block hooks)."""
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(_nd(array))))

    def install(self, exe, strict=False):
        """Install the monitor on an executor or a Gluon block. ``strict``
        is the JAX package's: there it raises for a hybridized block whose
        cached program would skip the hooks; the port's hooks always fire,
        so it changes nothing here."""
        del strict
        if hasattr(exe, "register_forward_hook"):
            mon = self

            def hook(block, inputs, output):
                outs = output if isinstance(output, (list, tuple)) \
                    else [output]
                for i, o in enumerate(outs):
                    mon.stat_helper("%s_output%d" % (block.name, i), o)
            exe.register_forward_hook(hook)
            if hasattr(exe, "collect_params"):
                from ._debug import healthmon as _healthmon
                _healthmon.attach_monitor(
                    self, params=exe.collect_params().keys())
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if the interval hits
        (ref: monitor.py tic)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting and return (step, name, stat) rows.

        When the training-health plane already delivered this batch's
        parameter rows out of the fused step (``healthmon`` sets
        ``_fused_batch`` at delivery), the ``collect_params`` sweep of a
        hybridized block is skipped: same rows, one source."""
        if not self.activated:
            return []
        self.activated = False
        fused_batch = getattr(self, "_fused_batch", None)
        for exe in self.exes:
            if fused_batch == self.step \
                    and getattr(exe, "_active", False):
                continue
            if hasattr(exe, "collect_params"):
                for name, p in exe.collect_params().items():
                    if p._data is not None:
                        self.stat_helper_always(name, p.data())
                        if p._data.grad is not None:
                            self.stat_helper_always(name + "_grad",
                                                    p.grad())
            elif hasattr(exe, "arg_dict"):
                for name, array in exe.arg_dict.items():
                    self.stat_helper_always(name, array)
                if hasattr(exe, "grad_dict"):
                    for name, array in exe.grad_dict.items():
                        if array is not None:
                            self.stat_helper_always(name + "_grad", array)
        res = []
        queue = self.queue
        if self.sort:
            queue = sorted(queue, key=lambda x: x[1])
        for n, k, v_list in queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            assert isinstance(v_list, list)
            s = ""
            for v in v_list:
                assert isinstance(v, NDArray)
                if v.shape == (1,) or v.shape == ():
                    s += str(v.asscalar()) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def stat_helper_always(self, name, array):
        if not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(_nd(array))))

    def toc_print(self):
        """Collect and print stats (ref: monitor.py toc_print)."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
        return res
