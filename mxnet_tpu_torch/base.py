"""Base helpers of the PyTorch port: the env-read choke point, the error
type, and the dtype table (counterpart of mxnet_tpu/base.py)."""
from __future__ import annotations

import os as _os

import torch

__all__ = ["getenv", "MXNetError", "canonical_dtype"]


def getenv(name, default=None):
    """The env-read choke point for the port: ``os.environ.get``."""
    return _os.environ.get(name, default)


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API parity with MXNet)."""


_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def canonical_dtype(dtype):
    """A dtype given as a name, a numpy dtype or a torch dtype, as a
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    name = {"float": "float32", "double": "float64", "half": "float16",
            "bf16": "bfloat16"}.get(name, name)
    if name not in _DTYPES:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]

