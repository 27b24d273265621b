"""``mx.nd``: the NDArray class, the creation functions, the checkpoint
format, and one function per registered op (counterpart of
mxnet_tpu/ndarray/__init__.py).

The op functions are also the ``F`` namespace that ``hybrid_forward``
receives: on tensors they return tensors, on NDArrays NDArrays
(``register.invoke``). The optimizer update ops keep the reference's
in-place ``out=`` convention (``nd.sgd_mom_update(w, g, m, lr=...,
out=w)``, ``optimizer_ops.py``) and take the place of the registry's pure
forms of the same names.

``save`` and ``load`` read and write the reference's binary ``.params``
format byte for byte, as the JAX package does, so each package loads the
other's files: a list of V2 records (V3 for a 0-dim array), each with the
context ``cpu(0)`` and an mshadow type flag; bf16 stored as float32;
names sorted for a dict; no names for a list.

``nd.random`` (``ndarray/random.py``) draws on the current context's
generator, ``nd.linalg`` (``ndarray/linalg.py``) wraps the ``linalg_*``
ops, ``nd.image`` (``ndarray/image.py``) the ``_image_*`` ops. ``nd.Custom`` runs a
registered Python custom op (``operator.py``). Not ported here:
``nd.sparse``.
"""
from __future__ import annotations

import pickle
import struct

import numpy as _np
import torch

from .. import storage as _storage
from .._debug import faultpoint as _faultpoint
from ..base import atomic_write as _atomic_write
from ..base import canonical_dtype
from ..context import current_context
from ..ops import registry as _registry
from ..ops.tensor import arange_values as _arange_values
from .ndarray import NDArray, array, concatenate, place as _place
from .ndarray import wrap as _wrap, _from_numpy, _to_numpy
from .register import invoke, invoke_by_name, populate, _unwrap

__all__ = ["NDArray", "array", "concatenate", "zeros", "ones", "full",
           "empty", "arange", "eye", "linspace", "hanning", "hamming",
           "blackman", "waitall", "save", "load",
           "imperative_invoke", "boolean_mask", "unique", "dot", "invoke"]


# -- creation ----------------------------------------------------------------

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _ctx_place(build, ctx, nbytes=None):
    """The creation factories' placement: ``build(device)`` makes the
    values on ``ctx``'s device (the host for a pinned context), then they
    are placed on ``ctx`` (default: the current context). A placement that
    fails raises: nothing falls back to the host. The failure is counted
    (``metrics()['memory']['alloc_fallbacks']``) and, for an out-of-memory
    error or an injected ``storage.alloc`` fault, written up first as an
    OOM post-mortem shard naming the request (``nbytes``) and what was
    resident (``_debug.memwatch.oom_report``); the error then propagates
    unchanged. The result is registered in the allocation ledger."""
    ctx = ctx if ctx is not None else current_context()
    try:
        if _faultpoint.ACTIVE:
            _faultpoint.check("storage.alloc")
        dev = "cpu" if ctx.device_type == "cpu_pinned" else ctx.device
        t = _place(build(dev), ctx)
    except Exception as e:
        _storage.bump("alloc_fallbacks")
        from .._debug import memwatch as _memwatch
        if _memwatch.is_oom(e) or "storage.alloc" in str(e):
            _memwatch.oom_report(e, requested_bytes=nbytes,
                                 where="storage.alloc")
        raise
    out = _wrap(t, ctx=ctx)
    _storage.ledger_register(out, "other")
    return out


def _make(t, ctx):
    """``t`` (built on the host) as an NDArray on ``ctx``."""
    return _ctx_place(lambda dev: t, ctx, t.nbytes)


def _filled(shape, fill, dtype, ctx):
    """An NDArray of ``shape`` filled with ``fill``, made on ``ctx``'s
    device."""
    shape = _shape(shape)
    dt = canonical_dtype(dtype)
    nbytes = torch.empty((), dtype=dt).element_size()
    for d in shape:
        nbytes *= d
    return _ctx_place(lambda dev: torch.full(shape, fill, dtype=dt,
                                             device=dev), ctx, nbytes)


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    return _filled(shape, 0, dtype, ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _filled(shape, 1, dtype, ctx)


def full(shape, val, ctx=None, dtype=None, **kwargs):
    return _filled(shape, val, dtype, ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return _make(_arange_values(start, stop, step, repeat, dtype, "cpu"),
                 ctx)


def eye(N, M=0, k=0, ctx=None, dtype=None):
    M = M if M else N
    rows = torch.arange(N).unsqueeze(1)
    cols = torch.arange(M).unsqueeze(0)
    return _make((cols - rows == k).to(canonical_dtype(dtype)), ctx)


def _window_op(name):
    """``nd.hanning``/``hamming``/``blackman``: the registry's window of M
    points as an NDArray on ``ctx`` (default: the current context)."""
    opdef = _registry.get_op(name)

    def window(M=1, dtype="float32", ctx=None, **kwargs):
        return _make(opdef.fn(M, dtype, "cpu"), ctx)
    window.__name__ = name
    window.__doc__ = opdef.fn.__doc__
    return window


hanning = _npi_hanning = _window_op("_npi_hanning")
hamming = _npi_hamming = _window_op("_npi_hamming")
blackman = _npi_blackman = _window_op("_npi_blackman")


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    dt = canonical_dtype(dtype)
    np_dt = _np.float32 if dt == torch.bfloat16 else \
        torch.empty((), dtype=dt).numpy().dtype
    vals = _np.linspace(start, stop, num, endpoint=endpoint, dtype=np_dt)
    return _make(torch.from_numpy(vals).to(dt), ctx)


def waitall():
    """Wait for all work on every CUDA device (``Engine::WaitForAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def imperative_invoke(name, *args, **kwargs):
    return invoke_by_name(name, *args, **kwargs)


# -- dynamic-shape ops -----------------------------------------------------------

def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero;
    differentiable in ``data`` (the gather's gradient scatters back)."""
    m = index._value() if isinstance(index, NDArray) else \
        torch.as_tensor(_np.asarray(index))
    keep = torch.nonzero(m.reshape(-1) != 0).reshape(-1)
    return invoke(_BOOLEAN_MASK, (data, keep.to(_unwrap(data).device)),
                  {"axis": axis})


_BOOLEAN_MASK = _registry.OpDef(
    "boolean_mask", lambda x, keep, axis=0: torch.index_select(x, axis, keep))


def unique(data):
    """Sorted unique values."""
    t = data._value() if isinstance(data, NDArray) else torch.as_tensor(data)
    return _wrap(torch.unique(t, sorted=True))


def dot(lhs, rhs, transpose_a=False, transpose_b=False, out=None, **kw):
    """The dense product. Sparse (CSR) operands arrive with ``nd.sparse``
    and raise here."""
    for x in (lhs, rhs):
        if getattr(x, "stype", "default") != "default":
            raise NotImplementedError(
                "dot of a %s operand needs nd.sparse (not ported)"
                % x.stype)
    res = invoke(_registry.get_op("dot"), (lhs, rhs),
                 dict(kw, transpose_a=transpose_a, transpose_b=transpose_b))
    if out is None:
        return res
    out._assign(_unwrap(res))
    return out


# -- serialization: the reference's binary .params format -------------------

_MAGIC = b"MXTPU_ND1"          # the JAX package's early pickle snapshot
_LIST_MAGIC = 0x112
_ND_V2_MAGIC = 0xF993fac9
_ND_V3_MAGIC = 0xF993faca      # np-shape semantics (0-dim); same layout
_TYPE_FLAGS = {               # mshadow type_flag <-> numpy dtype
    0: _np.dtype("float32"), 1: _np.dtype("float64"),
    2: _np.dtype("float16"), 3: _np.dtype("uint8"),
    4: _np.dtype("int32"), 5: _np.dtype("int8"), 6: _np.dtype("int64"),
    7: _np.dtype("bool"),
}
_DTYPE_TO_FLAG = {v: k for k, v in _TYPE_FLAGS.items()}


def _host_array(arr):
    """numpy values of what ``save`` takes (an NDArray, a tensor or an
    array-like); bf16 as float32 (it has no reference type flag)."""
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            arr = arr.detach().float()
        return _to_numpy(arr)
    a = _np.asarray(arr)
    if str(a.dtype) == "bfloat16":
        a = a.astype(_np.float32)
    return a


def _write_one(f, arr):
    a = _host_array(arr)
    if a.dtype not in _DTYPE_TO_FLAG:
        raise TypeError("dtype %s has no reference type flag; cast before "
                        "saving" % a.dtype)
    f.write(struct.pack("<I", _ND_V3_MAGIC if a.ndim == 0
                        else _ND_V2_MAGIC))
    f.write(struct.pack("<i", 0))                      # kDefaultStorage
    f.write(struct.pack("<i", a.ndim))
    f.write(struct.pack("<%dq" % a.ndim, *a.shape))
    f.write(struct.pack("<ii", 1, 0))                  # Context: cpu(0)
    f.write(struct.pack("<i", _DTYPE_TO_FLAG[a.dtype]))
    f.write(_np.ascontiguousarray(a).tobytes())


def _read_one(f, ctx):
    magic, = struct.unpack("<I", f.read(4))
    if magic not in (_ND_V2_MAGIC, _ND_V3_MAGIC):
        raise ValueError("unsupported NDArray record magic 0x%x (V1 legacy "
                         "files are not supported)" % magic)
    stype, = struct.unpack("<i", f.read(4))
    if stype != 0:
        raise ValueError("only dense (default storage) records are "
                         "supported, got stype=%d" % stype)
    ndim, = struct.unpack("<i", f.read(4))
    shape = struct.unpack("<%dq" % ndim, f.read(8 * ndim)) if ndim else ()
    struct.unpack("<ii", f.read(8))                    # context, ignored
    type_flag, = struct.unpack("<i", f.read(4))
    dtype = _TYPE_FLAGS.get(type_flag)
    if dtype is None:
        raise ValueError("NDArray record has unsupported mshadow type "
                         "flag %d" % type_flag)
    count = int(_np.prod(shape)) if shape else 1
    buf = bytearray(f.read(count * dtype.itemsize))
    data = _np.frombuffer(buf, dtype=dtype).reshape(shape)
    return _make(_from_numpy(data), ctx)


def save(fname, data):
    """Save an NDArray, a list of them or a dict of them in the
    reference's ``.params`` format (the module docstring). The file is
    written to a temporary sibling and renamed into place
    (``base.atomic_write``): an interrupted save leaves any earlier file
    whole."""
    if isinstance(data, NDArray):
        arrays, names = [data], []
    elif isinstance(data, (list, tuple)):
        if any(not isinstance(a, NDArray) for a in data):
            raise TypeError("save expects NDArrays")
        arrays, names = list(data), []
    elif isinstance(data, dict):
        names = sorted(data)
        arrays = [data[k] for k in names]
    else:
        raise TypeError("unsupported save payload %r" % type(data))
    with _atomic_write(fname) as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_one(f, a)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def _load_stream(f, where, ctx):
    head = f.read(len(_MAGIC))
    if head == _MAGIC:        # the JAX package's early pickle snapshot
        kind, payload = pickle.load(f)

        def one(a):
            return array(_np.asarray(a), ctx=ctx)
        if kind == "single":
            return one(payload)
        if kind == "list":
            return [one(a) for a in payload]
        return {k: one(v) for k, v in payload.items()}
    f.seek(0)
    try:
        header, _reserved = struct.unpack("<QQ", f.read(16))
        if header != _LIST_MAGIC:
            raise ValueError("not an NDArray file: %s" % where)
        count, = struct.unpack("<Q", f.read(8))
        arrays = [_read_one(f, ctx) for _ in range(count)]
        nnames, = struct.unpack("<Q", f.read(8))
        names = []
        for _ in range(nnames):
            ln, = struct.unpack("<Q", f.read(8))
            names.append(f.read(ln).decode("utf-8"))
    except struct.error:
        raise ValueError("truncated or corrupt NDArray file: %s" % where)
    if count == 0:
        # a count of 0 is ambiguous on disk; a dict is what every
        # parameter loader expects from an empty save
        return {}
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise ValueError("invalid NDArray file (%d names for %d arrays): %s"
                         % (len(names), len(arrays), where))
    return dict(zip(names, arrays))


def load(fname, ctx=None):
    """Load a ``.params`` file or file-like object: a list where the
    records have no names, else (and for an empty file) a dict. The
    arrays go to ``ctx`` (default: the current context)."""
    ctx = ctx if ctx is not None else current_context()
    if hasattr(fname, "read"):
        return _load_stream(fname, "<stream>", ctx)
    with open(fname, "rb") as f:
        return _load_stream(f, fname, ctx)


# -- generated op functions ---------------------------------------------------
populate(globals())

# the optimizer update ops with the reference's in-place convention take
# the place of the registry's pure forms of the same names
from .optimizer_ops import *  # noqa: E402,F401,F403

from . import random  # noqa: E402,F401  (nd.random)
from . import linalg  # noqa: E402,F401  (nd.linalg)
from . import image  # noqa: E402,F401  (nd.image)


def Custom(*args, **kwargs):
    """Run a registered Python custom op
    (ref: python/mxnet/operator.py register + nd.Custom)."""
    from ..operator import invoke as _custom_invoke
    return _custom_invoke(*args, **kwargs)
