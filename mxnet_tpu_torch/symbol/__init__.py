"""``mx.sym``: the symbolic graph API (counterpart of
mxnet_tpu/symbol/__init__.py; ref: python/mxnet/symbol/__init__.py).

One function per registered op (``register.py``), ``Symbol``, ``var``,
``Group``, ``load``/``load_json``, and the sub-namespaces ``contrib``
(control flow), ``random``, ``linalg`` and ``image``, as ``nd.<ns>``.
``sym.Custom`` makes a custom-op node (``operator.py``), and
``symbol.subgraph`` partitions a graph into fused regions. Not here yet:
``sym.sparse`` (it needs ``cast_storage`` and ``_sparse_retain``, op names
the port has not registered).
"""
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     zeros, ones)
from .register import populate as _populate

_populate(globals())

from . import contrib  # noqa: E402  (after populate: contrib uses registry)
from . import random  # noqa: E402  (sub-namespaces mirror nd.<ns>)
from . import linalg  # noqa: E402
from . import image  # noqa: E402


def Custom(*args, **kwargs):
    """A custom-op node; the executor runs the operator inline on its
    tensors (ref: python/mxnet/operator.py sym.Custom)."""
    from .. import operator as _op_mod  # registers the "Custom" graph op
    from ..ops import registry as _r
    from .register import make_symbol_op_func
    assert _op_mod is not None
    return make_symbol_op_func(_r.get_op("Custom"), "Custom")(
        *args, **kwargs)


__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "contrib", "random", "linalg", "image",
           "Custom"]
