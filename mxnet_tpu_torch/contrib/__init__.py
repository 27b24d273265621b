"""Contributed subsystems (counterpart of mxnet_tpu/contrib/): int8
quantization (``quantization``), automatic mixed precision (``amp``) and
the DataLoader-as-DataIter adapter (``io``)."""
from . import quantization
from . import amp
from . import io

__all__ = ["quantization", "amp", "io"]
