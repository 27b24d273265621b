"""The ``F`` namespace: one plain function per registered op (counterpart
of mxnet_tpu/ndarray/register.py). ``hybrid_forward(F, ...)`` calls
``F.Convolution(...)`` and gets a ``torch.Tensor`` back.

``invoke`` is the one dispatch point: it supplies ``_training`` from
``autograd.is_training()`` to ops that take it and calls the op. Private
OpDefs that stay out of the registry (the fused ResNet link) are invoked
through it too.
"""
from __future__ import annotations

import inspect

from .. import autograd
from .. import ops as _ops  # noqa: F401  (fills the registry)
from ..ops import registry as _registry

__all__ = ["invoke", "populate"]

_TAKES_TRAINING = {}


def _takes_training(opdef):
    flag = _TAKES_TRAINING.get(opdef.name)
    if flag is None:
        flag = "_training" in inspect.signature(opdef.fn).parameters
        _TAKES_TRAINING[opdef.name] = flag
    return flag


def invoke(opdef, args, kwargs):
    """Run ``opdef`` on torch tensors."""
    if _takes_training(opdef) and "_training" not in kwargs:
        kwargs = dict(kwargs, _training=autograd.is_training())
    return opdef.fn(*args, **kwargs)


def _make(opdef):
    def op(*args, **kwargs):
        return invoke(opdef, args, kwargs)
    op.__name__ = opdef.name
    op.__doc__ = opdef.fn.__doc__
    return op


def populate(namespace):
    """Bind every registered op (and alias) into ``namespace``."""
    for name in _registry.list_ops():
        namespace[name] = _make(_registry.get_op(name))
