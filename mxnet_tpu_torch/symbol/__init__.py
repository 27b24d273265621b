"""``mx.sym``: the symbolic graph API (counterpart of
mxnet_tpu/symbol/__init__.py; ref: python/mxnet/symbol/__init__.py).

One function per registered op (``register.py``), ``Symbol``, ``var``,
``Group``, ``load``/``load_json``, and the sub-namespaces ``contrib``
(control flow), ``random``, ``linalg`` and ``image``, as ``nd.<ns>``.
Not here yet: ``sym.sparse`` (it needs ``cast_storage`` and
``_sparse_retain``, op names the port has not registered) and
``sym.Custom`` (with ``operator.py``).
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
    """A custom-op node: arrives with ``operator.py`` (``CustomOp``,
    ``nd.Custom``), which the port has not ported yet."""
    raise NotImplementedError(
        "sym.Custom arrives with operator.py (CustomOp, nd.Custom), which "
        "is not ported yet")


__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones", "contrib", "random", "linalg", "image",
           "Custom"]
