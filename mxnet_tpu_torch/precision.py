"""Matmul/convolution precision policy (counterpart of mxnet_tpu/precision.py).

On an NVIDIA card a float32 matrix product or convolution may run in TF32
on the tensor cores (about three decimal digits). Two PyTorch switches
decide it: ``torch.backends.cuda.matmul.allow_tf32`` (matmuls, off by
PyTorch's default) and ``torch.backends.cudnn.allow_tf32`` (cuDNN
convolutions, on by PyTorch's default). This module sets both together:

  - ``"default"``: TF32 allowed for both, the fastest path;
  - ``"float32"`` and ``"highest"``: TF32 off for both, true float32
    products (what every float32 comparison on the card uses).

Three layers, most specific wins: the scoped ``matmul_precision()``
context manager, the process-global ``set_matmul_precision()``, and the
``MXTPU_MATMUL_PRECISION`` environment variable, read once at import. With
none of them set, PyTorch's own defaults stand.
"""
from __future__ import annotations

import contextlib

import torch

from .base import getenv

__all__ = ["set_matmul_precision", "get_matmul_precision",
           "matmul_precision"]

ENV_VAR = "MXTPU_MATMUL_PRECISION"
_NAMES = ("default", "float32", "highest")
_CURRENT = [None]


def _apply(precision):
    if precision not in _NAMES:
        raise ValueError("matmul precision must be one of %s, got %r"
                         % (_NAMES, precision))
    tf32 = precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _CURRENT[0] = precision


def set_matmul_precision(precision):
    """Set the process-global policy; returns the previous name. ``None``
    means ``"default"``."""
    prev = get_matmul_precision()
    _apply("default" if precision is None else precision)
    return prev


def get_matmul_precision():
    """The policy set last ("default" when none was set)."""
    return _CURRENT[0] or "default"


@contextlib.contextmanager
def matmul_precision(precision):
    """Scoped policy::

        with mx.precision.matmul_precision("float32"):
            y = net(x)          # no TF32 in matmuls or convolutions
    """
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, _CURRENT[0])
    _apply("default" if precision is None else precision)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _CURRENT[0]) = saved


def _apply_env():
    val = getenv(ENV_VAR)
    if val:
        set_matmul_precision(val)


_apply_env()
