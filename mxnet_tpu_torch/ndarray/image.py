"""``mx.nd.image``: each registered ``_image_X`` op as ``X`` (counterpart of
mxnet_tpu/ndarray/image.py; ref: python/mxnet/ndarray/image.py). The ops
run on their input's device; tensors give tensors and NDArrays NDArrays."""
from __future__ import annotations

from ..ops import registry as _registry
from .register import make_op as _make_op

__all__ = []


def _populate_image():
    g = globals()
    for name in _registry.list_ops():
        if name.startswith("_image_"):
            short = name[len("_image_"):]
            if short not in g:
                g[short] = _make_op(_registry.get_op(name), short)
                __all__.append(short)


_populate_image()
