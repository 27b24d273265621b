"""``mx.sym.linalg`` namespace (counterpart of mxnet_tpu/symbol/linalg.py; ref:
python/mxnet/symbol/linalg.py — generated from the same `linalg_*` registry
entries as nd.linalg)."""
from __future__ import annotations

from ..ops import registry as _registry
from .register import make_symbol_op_func

__all__ = []


def _populate_linalg():
    g = globals()
    for name in _registry.list_ops():
        if name.startswith("linalg_") and not name.startswith("linalg__"):
            short = name[len("linalg_"):]
            if short not in g:
                g[short] = make_symbol_op_func(_registry.get_op(name),
                                               short)
                __all__.append(short)


_populate_linalg()
