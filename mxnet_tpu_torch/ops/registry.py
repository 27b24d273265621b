"""Operator registry (counterpart of mxnet_tpu/ops/registry.py).

Each op is a plain function on ``torch.Tensor``s: ``fn(*tensors,
**params)``. ``ndarray/register.py`` turns the registry into the ``F``
namespace that ``hybrid_forward`` receives.
"""
from __future__ import annotations

__all__ = ["register", "get_op", "list_ops", "OpDef"]

_OPS = {}


class OpDef:
    __slots__ = ("name", "fn", "aliases")

    def __init__(self, name, fn, aliases=()):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)


def register(name, aliases=()):
    """Decorator: register a functional op under ``name`` (and aliases)."""
    def _reg(fn):
        opdef = OpDef(name, fn, aliases=aliases)
        _OPS[name] = opdef
        for a in aliases:
            _OPS[a] = opdef
        return fn
    return _reg


def get_op(name):
    return _OPS[name]


def list_ops():
    return sorted(_OPS)
