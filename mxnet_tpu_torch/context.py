"""Device contexts mapped onto ``torch.device`` (counterpart of
mxnet_tpu/context.py).

The port runs on the card unless the caller asks for the CPU: the default
context is ``gpu(0)``, and resolving a GPU context with no CUDA device
raises instead of carrying on on the CPU. Tests pass ``ctx=mx.cpu()`` or
enter ``with mx.cpu():``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "as_device", "num_gpus"]


class Context:
    """A device context: ``Context("gpu", 0)`` is CUDA device 0."""

    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in ("cpu", "gpu", "cpu_pinned"):
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._saved = []

    @property
    def device(self):
        """The ``torch.device``. Raises for a GPU context on a host with no
        CUDA device (or too few). ``cpu_pinned`` is host memory that the
        card can read directly: the CPU device, with the arrays placed
        there pinned (which needs a CUDA device)."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s: no CUDA device is available. The port runs on the "
                "card by default; pass ctx=mx.cpu() to run on the CPU."
                % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%s: only %d CUDA device(s) present"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        self._saved.append(getattr(Context._default, "value", None))
        Context._default.value = self
        return self

    def __exit__(self, *exc):
        Context._default.value = self._saved.pop()
        return False

    def __eq__(self, other):
        return isinstance(other, Context) and \
            (self.device_type, self.device_id) == \
            (other.device_type, other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def cpu_pinned(device_id=0):
    """Pinned (page-locked) host memory."""
    return Context("cpu_pinned", device_id)


def num_gpus():
    """The number of CUDA devices."""
    return torch.cuda.device_count()


def current_context():
    """The context entered last with ``with ctx:``, else ``gpu(0)``.
    Raises when that is a GPU context and no CUDA device is present."""
    ctx = getattr(Context._default, "value", None)
    if ctx is None:
        ctx = gpu(0)
        ctx.device  # raises with no CUDA device
    return ctx


def as_device(ctx=None):
    """``torch.device`` of ``ctx`` (a Context, a torch.device, a device
    string, or None for the current context)."""
    if ctx is None:
        return current_context().device
    if isinstance(ctx, Context):
        return ctx.device
    return torch.device(ctx)
