"""Contributed subsystems (counterpart of mxnet_tpu/contrib/): int8
quantization (``quantization``) and automatic mixed precision (``amp``)."""
from . import quantization
from . import amp

__all__ = ["quantization", "amp"]
