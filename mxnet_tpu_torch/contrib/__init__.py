"""Contributed subsystems (counterpart of mxnet_tpu/contrib/): int8
quantization (``quantization``)."""
from . import quantization

__all__ = ["quantization"]
