"""``mx.sym.image`` namespace (counterpart of mxnet_tpu/symbol/image.py; ref:
python/mxnet/symbol/image.py — generated from the `_image_*` registry
entries like nd.image)."""
from __future__ import annotations

from ..ops import registry as _registry
from .register import make_symbol_op_func

__all__ = []


def _populate_image():
    g = globals()
    for name in _registry.list_ops():
        if name.startswith("_image_"):
            short = name[len("_image_"):]
            if short not in g:
                g[short] = make_symbol_op_func(_registry.get_op(name),
                                               short)
                __all__.append(short)


_populate_image()
