"""Base helpers of the PyTorch port: the env-read choke point, the error
type, the dtype table, crash-consistent file writes and the one import of
OpenCV (counterpart of mxnet_tpu/base.py)."""
from __future__ import annotations

import contextlib as _contextlib
import os as _os

import numpy as _np
import torch

__all__ = ["getenv", "getenv_dynamic", "MXNetError", "string_types",
           "numeric_types", "canonical_dtype", "DTYPE_NAMES",
           "is_low_precision", "weak_scalar", "atomic_write", "cv2"]


def getenv(name, default=None):
    """The env-read choke point for the port: ``os.environ.get``."""
    return _os.environ.get(name, default)


def getenv_dynamic(name, default=None, family=None):
    """An env read whose name is computed (``family`` names the
    documented base name, for the reader): ``os.environ.get``."""
    del family
    return _os.environ.get(name, default)


class MXNetError(RuntimeError):
    """Framework-level error (name kept for API parity with MXNet)."""


string_types = (str,)
numeric_types = (float, int, _np.generic)


def cv2():
    """The ``cv2`` module: OpenCV decodes, encodes, resizes and converts
    every image of the port, as it does in the JAX package, so both give
    the same bytes on one build. It is imported here, at the first call,
    and never when the package is imported; without it the call raises
    ImportError, and nothing stands in for it."""
    try:
        import cv2 as _cv2
    except ImportError as e:
        raise ImportError("this image path needs OpenCV (the cv2 module), "
                          "which does not import here: %s" % e) from e
    return _cv2


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
# The dtype names the port knows, each with its torch dtype.
DTYPE_NAMES = _DTYPES


# A type object names its numpy dtype; the JAX package (64-bit types off)
# holds ``float``, ``int``, ``np.float64`` and ``np.int64`` in 32 bits.
_NARROW_TYPES = {"float64": "float32", "int64": "int32"}


def canonical_dtype(dtype):
    """A dtype given as a name, a numpy dtype, a torch dtype or a type
    object (``np.float32``, ``float``, ``int``, ``bool``), as a
    ``torch.dtype``; None is float32, as in the JAX package."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    if isinstance(dtype, type):
        try:
            dtype = _np.dtype(dtype).name
        except TypeError:
            raise MXNetError("unsupported dtype %r" % (dtype,)) from None
        dtype = _NARROW_TYPES.get(dtype, dtype)
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
    leaves a half-written file where the previous one was. The
    ``checkpoint.save`` fault point fires between the temp write and the
    rename, the worst instant for a crash."""
    from ._debug import faultpoint as _faultpoint
    tmp = "%s.tmp.%d" % (fname, _os.getpid())
    try:
        with open(tmp, mode) as f:
            yield f
        if _faultpoint.ACTIVE:
            _faultpoint.check("checkpoint.save")
        _os.replace(tmp, fname)
    except BaseException:
        try:
            _os.remove(tmp)
        except OSError:
            pass
        raise
