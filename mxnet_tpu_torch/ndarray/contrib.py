"""The ``nd.contrib`` namespace (counterpart of mxnet_tpu/ndarray/contrib.py):
every registered ``_contrib_X`` op as ``X`` (``nd.contrib.quantized_conv``,
``nd.contrib.quantize_v2``, ...), and ``quantize`` / ``dequantize`` of
``contrib.quantization``, which take the names first, as in the JAX
package and the reference."""
from ..contrib.quantization import quantize, dequantize
from ..ops import registry as _registry
from .register import make_op as _make_op


def _populate_contrib():
    g = globals()
    for name in _registry.list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if short not in g:
                g[short] = _make_op(_registry.get_op(name), short)


_populate_contrib()

__all__ = sorted(k for k in globals() if not k.startswith("_"))
