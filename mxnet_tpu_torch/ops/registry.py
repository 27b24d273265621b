"""Operator registry (counterpart of mxnet_tpu/ops/registry.py).

Each op is a plain function on ``torch.Tensor``s: ``fn(*tensors,
**params)``. ``ndarray/register.py`` turns the registry into the ``F``
namespace that ``hybrid_forward`` receives, ``symbol/register.py`` into
``mx.sym``.

Two fields serve the symbol front end, as in the JAX package:
``input_names``, the op's ordered tensor inputs where its signature does
not say them (None: read them off the signature; ``VARIADIC``: every
positional Symbol is an input), and ``num_outputs``, its output count in
a graph (an int, or a function of the node's attrs; None: one).
"""
from __future__ import annotations

__all__ = ["register", "get_op", "list_ops", "OpDef", "VARIADIC"]

_OPS = {}

# ``input_names`` of an op whose positional Symbols are all inputs.
VARIADIC = "*"


class OpDef:
    __slots__ = ("name", "fn", "aliases", "input_names", "num_outputs")

    def __init__(self, name, fn, aliases=(), input_names=None,
                 num_outputs=None):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)
        self.input_names = input_names
        self.num_outputs = num_outputs


def register(name, aliases=(), input_names=None, num_outputs=None):
    """Decorator: register a functional op under ``name`` (and aliases)."""
    def _reg(fn):
        opdef = OpDef(name, fn, aliases=aliases, input_names=input_names,
                      num_outputs=num_outputs)
        _OPS[name] = opdef
        for a in aliases:
            _OPS[a] = opdef
        return fn
    return _reg


def get_op(name):
    return _OPS[name]


def list_ops():
    return sorted(_OPS)
