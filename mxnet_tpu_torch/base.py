"""Base helpers of the PyTorch port: the env-read choke point, the error
type, the dtype table and crash-consistent file writes (counterpart of
mxnet_tpu/base.py)."""
from __future__ import annotations

import contextlib as _contextlib
import os as _os

import torch

__all__ = ["getenv", "MXNetError", "canonical_dtype", "is_low_precision",
           "weak_scalar", "atomic_write"]


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
    "int16": torch.int16,
    "uint8": torch.uint8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def canonical_dtype(dtype):
    """A dtype given as a name, a numpy dtype or a torch dtype, as a
    ``torch.dtype``; None is float32, as in the JAX package."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    name = getattr(dtype, "name", None) or str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
    name = {"float": "float32", "double": "float64", "half": "float16",
            "bf16": "bfloat16"}.get(name, name)
    if name not in _DTYPES:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _DTYPES[name]


def is_low_precision(dtype):
    """float16 or bfloat16."""
    return dtype in (torch.float16, torch.bfloat16)


def weak_scalar(v, dtype):
    """A scalar operand of an op on a ``dtype`` tensor, rounded as JAX's
    weak typing rounds it: for a half-precision tensor a Python float
    becomes a float32 value and then a ``dtype`` value before the op
    (PyTorch would keep it at float32 op precision); a tensor scalar or
    vector is cast to ``dtype``. Other dtypes leave ``v`` as it is."""
    if not is_low_precision(dtype):
        return v
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return float(torch.tensor(float(v), dtype=torch.float32).to(dtype))


@_contextlib.contextmanager
def atomic_write(fname, mode="wb"):
    """Yields a file open on a sibling temp path and renames it onto
    ``fname`` only once the body completed, so an interrupted save never
    leaves a half-written file where the previous one was."""
    tmp = "%s.tmp.%d" % (fname, _os.getpid())
    try:
        with open(tmp, mode) as f:
            yield f
        _os.replace(tmp, fname)
    except BaseException:
        try:
            _os.remove(tmp)
        except OSError:
            pass
        raise
