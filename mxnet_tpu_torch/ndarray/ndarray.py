"""NDArray: an array with MXNet's semantics over a ``torch.Tensor``
(counterpart of mxnet_tpu/ndarray/ndarray.py).

An ``NDArray`` holds one tensor (``_data``) and a context. It is not a
``torch.Tensor`` subclass: MXNet's ``size`` (an int), ``dtype`` (a numpy
dtype), ``reshape``, ``sum(axis=)``, ``sort``, ``flip`` and ``repeat``
would clash with torch's own methods, which the port's internals and
torch itself call. The port's ops and blocks run on tensors; the NDArray
boundary is the op wrappers of ``mx.nd`` (``register.invoke``),
``Block.__call__``, the Trainer and the kvstore, which unwrap NDArray
arguments and wrap the results.

Value semantics, as the JAX package's immutable buffers give them: an
ordinary NDArray never writes its tensor in place. ``x += 1`` and
``x[0] = 5`` compute a new tensor and rebind ``_data`` (``_assign``), so
``copy()``, ``copyto``, ``detach()`` and every op result stay as they
were, even where they share storage with ``x``. A Parameter's
``data()`` and ``grad()`` are live views instead (``gluon/parameter.py``):
writes through them land in the parameter's own tensor, which the
optimizer also updates in place, so whatever is taken from them is a
copy.

Types follow the JAX package with 64-bit types off: an NDArray holds no
float64 or int64 tensor (they become float32 and int32, as ``jnp`` makes
them), and a Python scalar on one side of an op is weakly typed (a bf16
array plus 0.1 rounds 0.1 to bf16 first).

``asnumpy()`` of a bf16 array is an ``ml_dtypes.bfloat16`` array where
``ml_dtypes`` imports (as the JAX package's); where it does not, it is a
float32 array of the same, exact values.
"""
from __future__ import annotations

import functools

import numpy as _np
import torch

from ..base import MXNetError, canonical_dtype
from ..context import Context, current_context
from .. import autograd

try:  # bf16 on the host, as the JAX package gives it
    import ml_dtypes as _ml_dtypes
except ImportError:  # pragma: no cover - depends on the host
    _ml_dtypes = None

__all__ = ["NDArray", "array", "concatenate", "place", "wrap",
           "has_ndarray", "call_inplace", "nd_io"]

# jnp with 64-bit types off holds neither: the NDArray layer narrows them.
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _np_dtype(dt):
    """The numpy dtype of torch dtype ``dt`` (bf16: ml_dtypes', else
    ``torch.bfloat16`` itself)."""
    if dt == torch.bfloat16:
        return _np.dtype(_ml_dtypes.bfloat16) if _ml_dtypes is not None \
            else torch.bfloat16
    return torch.empty((), dtype=dt).numpy().dtype


def _ctx_of(t):
    dev = t.device
    if dev.type == "cuda":
        return Context("gpu", dev.index if dev.index is not None
                       else torch.cuda.current_device())
    return Context("cpu", 0)


def place(t, ctx):
    """``t`` on context ``ctx`` (a copy where it moves). A placement that
    fails raises: nothing falls back to the host."""
    dev = ctx.device                     # raises for a GPU with no CUDA
    if t.device != dev:
        t = t.to(dev)
    if ctx.device_type == "cpu_pinned" and not t.is_pinned():
        if not torch.cuda.is_available():
            raise MXNetError("%s: pinned host memory needs a CUDA device"
                             % ctx)
        t = t.pin_memory()
    return t


def _to_numpy(t):
    """A host copy of ``t`` as numpy (bf16 as ml_dtypes' bfloat16, or as
    float32 without ml_dtypes)."""
    t = t.detach()
    t = t.cpu() if t.device.type != "cpu" else t.clone()
    if t.dtype == torch.bfloat16:
        if _ml_dtypes is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(_ml_dtypes.bfloat16)
    return t.numpy()


def _from_numpy(a):
    """A CPU tensor holding numpy array ``a`` (bf16 from ml_dtypes)."""
    a = _np.require(a, requirements="C")
    if _ml_dtypes is not None and a.dtype == _ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(_np.int16).copy()).view(
            torch.bfloat16)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


class NDArray:
    """N-dimensional array on a device context."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "__weakref__")

    # an ordinary NDArray never writes its tensor in place (the module
    # docstring); the views of a Parameter do
    _live = False

    def __init__(self, data, ctx=None):
        self._data = data
        self._ctx = ctx
        self._grad = None
        self._grad_req = "null"

    # -- the tensor ---------------------------------------------------------
    def _value(self):
        """The tensor, safe to keep: it is never written in place."""
        return self._data.detach()

    def _assign(self, t):
        """Rebind the array to tensor ``t`` (a write: ``x += 1``, ``x[:] =
        v``, ``out=``, a pull). An array with a gradient attached stays
        a variable."""
        if self._grad is not None:
            self._data = t.detach()
            autograd._bind_grad(self)
        else:
            self._data = t

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    @property
    def nbytes(self):
        return self.size * self._data.element_size()

    @property
    def context(self):
        return self._ctx if self._ctx is not None else _ctx_of(self._data)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        from . import transpose
        return transpose(self)

    # -- sync / host transfer -----------------------------------------------
    def wait_to_read(self):
        """Block until the work producing this array is done (synchronizes
        its device)."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy (bf16: see the module docstring)."""
        return _to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "\n%s\n<%s %s @%s>" % (
            str(self.asnumpy()), type(self).__name__,
            "x".join(map(str, self.shape)), self.context)

    # -- conversion / copy --------------------------------------------------
    def astype(self, dtype, copy=True):
        from . import cast
        return cast(self, dtype=canonical_dtype(dtype))

    def copy(self):
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._assign(place(self._value(), other.context).clone())
            return other
        if isinstance(other, Context):
            return NDArray(place(self._value(), other).clone(), ctx=other)
        raise TypeError("copyto target must be NDArray or Context")

    def as_in_context(self, context):
        if context == self.context:
            return self
        return NDArray(place(self._value(), context), ctx=context)

    def as_in_ctx(self, ctx):
        return self.as_in_context(ctx)

    def as_nd_ndarray(self):
        return self

    def as_np_ndarray(self):
        raise NotImplementedError(
            "the mx.np array type is not ported (the long tail, M11)")

    def tostype(self, stype):
        if stype == "default":
            return self
        raise NotImplementedError(
            "sparse storage is not ported (M11); stype %r" % (stype,))

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable: backward writes (``"write"``) or
        adds (``"add"``) its gradient into ``.grad``, a zero array now;
        ``"null"`` detaches it."""
        t = self._data.detach()
        self._grad_req = grad_req
        if grad_req == "null":
            self._grad = None
            self._data = t
            return
        self._grad = NDArray(torch.zeros_like(t))
        self._data = t
        autograd._bind_grad(self)

    def detach(self):
        return NDArray(self._value(), ctx=self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad], retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- shape ops (method forms) -------------------------------------------
    def reshape(self, *shape, **kwargs):
        from . import reshape as _reshape
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape and "shape" in kwargs:
            shape = kwargs["shape"]
        return _reshape(self, shape=shape,
                        reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        from . import expand_dims as _f
        return _f(self, axis=axis)

    def squeeze(self, axis=None):
        from . import squeeze as _f
        return _f(self, axis=axis)

    def transpose(self, *axes):
        from . import transpose as _f
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _f(self, axes=axes if axes else None)

    def swapaxes(self, dim1, dim2):
        from . import swapaxes as _f
        return _f(self, dim1=dim1, dim2=dim2)

    def flatten(self):
        from . import flatten as _f
        return _f(self)

    def flip(self, axis):
        from . import reverse as _f
        return _f(self, axis=axis)

    def tile(self, reps):
        from . import tile as _f
        return _f(self, reps=reps)

    def repeat(self, repeats, axis=None):
        from . import repeat as _f
        return _f(self, repeats=repeats, axis=axis)

    def broadcast_to(self, shape):
        from . import broadcast_to as _f
        return _f(self, shape=shape)

    def broadcast_like(self, other):
        from . import broadcast_like as _f
        return _f(self, other)

    def slice(self, begin, end, step=None):
        from . import slice as _f
        return _f(self, begin=begin, end=end, step=step or ())

    def slice_axis(self, axis, begin, end):
        from . import slice_axis as _f
        return _f(self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        from . import take as _f
        return _f(self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, **kw):
        from . import one_hot as _f
        return _f(self, depth=depth, **kw)

    def pick(self, index, axis=-1, keepdims=False):
        from . import pick as _f
        return _f(self, index, axis=axis, keepdims=keepdims)

    def clip(self, a_min, a_max):
        from . import clip as _f
        return _f(self, a_min=a_min, a_max=a_max)

    def abs(self):
        from . import abs as _f
        return _f(self)

    def sign(self):
        from . import sign as _f
        return _f(self)

    def sqrt(self):
        from . import sqrt as _f
        return _f(self)

    def square(self):
        from . import square as _f
        return _f(self)

    def exp(self):
        from . import exp as _f
        return _f(self)

    def log(self):
        from . import log as _f
        return _f(self)

    def sigmoid(self):
        from . import sigmoid as _f
        return _f(self)

    def tanh(self):
        from . import tanh as _f
        return _f(self)

    def relu(self):
        from . import relu as _f
        return _f(self)

    def softmax(self, axis=-1):
        from . import softmax as _f
        return _f(self, axis=axis)

    def log_softmax(self, axis=-1):
        from . import log_softmax as _f
        return _f(self, axis=axis)

    def sum(self, axis=None, keepdims=False, **kw):
        from . import sum as _f
        return _f(self, axis=axis, keepdims=keepdims, **kw)

    def mean(self, axis=None, keepdims=False, **kw):
        from . import mean as _f
        return _f(self, axis=axis, keepdims=keepdims, **kw)

    def prod(self, axis=None, keepdims=False):
        from . import prod as _f
        return _f(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        from . import max as _f
        return _f(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        from . import min as _f
        return _f(self, axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        from . import norm as _f
        return _f(self, ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        from . import argmax as _f
        return _f(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        from . import argmin as _f
        return _f(self, axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        from . import argsort as _f
        return _f(self, axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        from . import sort as _f
        return _f(self, axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        from . import topk as _f
        return _f(self, axis=axis, k=k, ret_typ=ret_typ, is_ascend=is_ascend)

    def dot(self, other, **kw):
        from . import dot as _f
        return _f(self, other, **kw)

    def zeros_like(self):
        from .register import invoke_by_name
        return invoke_by_name("zeros_like", self)

    def ones_like(self):
        from .register import invoke_by_name
        return invoke_by_name("ones_like", self)

    # -- arithmetic operators -----------------------------------------------
    def _binop(self, name, other, reverse=False):
        if isinstance(other, _np.ndarray):
            other = _from_numpy(other).to(self._data.device)
        a, b = (other, self) if reverse else (self, other)
        return _register_mod().invoke_by_name(name, a, b)

    def __add__(self, other):
        return self._binop("add", other)

    def __radd__(self, other):
        return self._binop("add", other, True)

    def __sub__(self, other):
        return self._binop("subtract", other)

    def __rsub__(self, other):
        return self._binop("subtract", other, True)

    def __mul__(self, other):
        return self._binop("multiply", other)

    def __rmul__(self, other):
        return self._binop("multiply", other, True)

    def __truediv__(self, other):
        return self._binop("divide", other)

    def __rtruediv__(self, other):
        return self._binop("divide", other, True)

    __div__ = __truediv__

    def __mod__(self, other):
        return self._binop("mod", other)

    def __rmod__(self, other):
        return self._binop("mod", other, True)

    def __pow__(self, other):
        return self._binop("power", other)

    def __rpow__(self, other):
        return self._binop("power", other, True)

    def __neg__(self):
        from . import negative as _f
        return _f(self)

    def __abs__(self):
        return self.abs()

    def __eq__(self, other):
        if other is None:
            return False
        return self._binop("equal", other)

    def __ne__(self, other):
        if other is None:
            return True
        return self._binop("not_equal", other)

    def __gt__(self, other):
        return self._binop("greater", other)

    def __ge__(self, other):
        return self._binop("greater_equal", other)

    def __lt__(self, other):
        return self._binop("lesser", other)

    def __le__(self, other):
        return self._binop("lesser_equal", other)

    __hash__ = object.__hash__

    # in-place forms: a new value, then a write (``_assign``)
    def _check_inplace(self):
        if autograd.is_recording() and self._data.grad_fn is not None:
            raise RuntimeError(
                "in-place mutation of a recorded NDArray inside "
                "autograd.record() is not supported (matches reference "
                "restriction on arrays that need grad)")

    def _inplace(self, name, other):
        self._check_inplace()
        with torch.no_grad():
            new = self._binop(name, other)
        self._assign(new._data.to(self._data.dtype)
                     if self._live else new._data)
        return self

    def __iadd__(self, other):
        return self._inplace("add", other)

    def __isub__(self, other):
        return self._inplace("subtract", other)

    def __imul__(self, other):
        return self._inplace("multiply", other)

    def __itruediv__(self, other):
        return self._inplace("divide", other)

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, key):
        return _register_mod().invoke_getitem(self, key)

    def __setitem__(self, key, value):
        self._check_inplace()
        k = _clean_index(key, self._data.device)
        if isinstance(value, NDArray):
            value = value._value()
        elif isinstance(value, _np.ndarray):
            value = _from_numpy(value)
        if isinstance(value, torch.Tensor):
            value = value.to(self._data.device, self._data.dtype)
        with torch.no_grad():
            if self._live:
                setitem(self._data, k, value)
            else:
                t = self._data.detach().clone()
                setitem(t, k, value)
                self._assign(t)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # numpy and dlpack protocols
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    @property
    def dlpack(self):
        """The tensor, which carries the ``__dlpack__`` protocol."""
        return self._value()

    def __dlpack__(self, *args, **kwargs):
        return self._value().__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()


def _clean_index(key, device):
    """An index for a tensor: NDArray and list indices become tensors
    (integer ones int64, as torch indexes), numpy arrays too."""
    if isinstance(key, NDArray):
        key = key._value()
    if isinstance(key, torch.Tensor):
        key = key.to(device)
        return key if key.dtype == torch.bool else key.long()
    if isinstance(key, _np.ndarray):
        return _clean_index(_from_numpy(key), device)
    if isinstance(key, tuple):
        return tuple(_clean_index(k, device) for k in key)
    if isinstance(key, list):
        return _clean_index(torch.tensor(key), device)
    return key


def _step_positive(t, key):
    """``t`` and ``key`` with every slice of negative step replaced by one
    of positive step on a flipped dimension (torch slices only forward),
    and the dimensions flipped. Keys of ints, slices and None only; others
    pass as they are."""
    if not isinstance(key, tuple):
        key = (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in key):
        return t, key, ()
    if not all(k is None or isinstance(k, (int, slice)) for k in key):
        raise NotImplementedError(
            "a negative slice step mixed with an advanced index")
    out, dims, dim = [], [], 0
    for k in key:
        if k is None:
            out.append(k)
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = t.shape[dim]
            r = range(*k.indices(n))
            dims.append(dim)
            if len(r) == 0:
                k = slice(0, 0)
            else:
                start = n - 1 - r[0]
                k = slice(start, start + (len(r) - 1) * -k.step + 1,
                          -k.step)
        out.append(k)
        dim += 1
    return t.flip(dims), tuple(out), tuple(dims)


def getitem(t, key):
    """``t[key]`` with numpy's slicing (negative steps too)."""
    t, key, _ = _step_positive(t, key)
    return t[key]


def setitem(t, key, value):
    """``t[key] = value`` in place, with numpy's slicing."""
    f, k, dims = _step_positive(t, key)
    if not dims:
        t[key] = value
        return
    f[k] = value
    t.copy_(f.flip(dims))


_REGISTER_MOD = None


def _register_mod():
    """``.register`` (it imports this module; a top-level import here would
    cycle), memoized."""
    global _REGISTER_MOD
    if _REGISTER_MOD is None:
        from . import register
        _REGISTER_MOD = register
    return _REGISTER_MOD


def wrap(t, ctx=None):
    """``t`` as an NDArray, float64 and int64 narrowed (the module
    docstring)."""
    narrow = _NARROW.get(t.dtype)
    if narrow is not None:
        t = t.to(narrow)
    return NDArray(t, ctx=ctx)


def array(source_array, ctx=None, dtype=None):
    """An NDArray from any array-like, on ``ctx`` (default: the current
    context), in ``dtype`` (default: the source's; float64 becomes float32
    as in the JAX package)."""
    ctx = ctx if ctx is not None else current_context()
    own = isinstance(source_array, NDArray)
    if own:
        t = source_array._value()
    elif isinstance(source_array, torch.Tensor):
        t = source_array.detach()
    else:
        src = source_array
        if dtype is not None:
            dt = canonical_dtype(dtype)
            if dt != torch.bfloat16:
                src = _np.asarray(src, dtype=_np_dtype(dt))
        t = _from_numpy(_np.asarray(src))
    src_t = t
    if dtype is not None:
        t = t.to(canonical_dtype(dtype))
    t = place(t, ctx)
    if t is src_t and not own:
        t = t.clone()     # the caller's buffer stays the caller's
    out = wrap(t, ctx=ctx)
    from .. import storage as _storage
    _storage.ledger_register(out, "other")
    return out


def has_ndarray(obj):
    """Whether ``obj`` (nested in tuples and lists) holds an NDArray."""
    if isinstance(obj, NDArray):
        return True
    if isinstance(obj, (tuple, list)):
        return any(has_ndarray(o) for o in obj)
    return False


def call_inplace(fn, *args, wrap_result=False):
    """``fn(*args)`` for a function that writes some of its tensor
    arguments in place (an optimizer update, a kvstore pull), given
    NDArrays (nested in tuples and lists): each NDArray is passed as a
    private copy of its tensor, which it takes back afterwards, so the
    write reaches it and nothing else; a live view (a Parameter's) passes
    its own tensor, written in place. With ``wrap_result`` the result
    comes back as NDArrays: an argument's tensor as that NDArray."""
    taken, by_id, seen = [], {}, {}

    def down(o):
        if isinstance(o, NDArray):
            if id(o) in seen:           # one array passed twice: one copy
                return seen[id(o)]
            if o._live:
                t = o._data
            else:
                t = o._data.detach().clone()
                taken.append((o, t))
            by_id[id(t)] = o
            seen[id(o)] = t
            return t
        if isinstance(o, (tuple, list)):
            return type(o)(down(x) for x in o)
        return o

    def up(r):
        if isinstance(r, torch.Tensor):
            nd = by_id.get(id(r))
            return nd if nd is not None else wrap(r)
        if isinstance(r, (tuple, list)):
            return type(r)(up(x) for x in r)
        return r

    with torch.no_grad():
        out = fn(*[down(a) for a in args])
    for o, t in taken:
        o._assign(t)
    return up(out) if wrap_result else out


def nd_io(fn):
    """``fn``, a function on tensors that may write some of them in place,
    also on NDArrays (``call_inplace``, results as NDArrays); on tensors
    it is ``fn`` after one type check."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        if not (has_ndarray(args) or
                (kwargs and has_ndarray(tuple(kwargs.values())))):
            return fn(*args, **kwargs)
        keys = list(kwargs)
        vals = [kwargs[k] for k in keys]
        n = len(args)
        return call_inplace(
            lambda *a: fn(*a[:n], **dict(zip(keys, a[n:]))), *args, *vals,
            wrap_result=True)
    return op


def concatenate(arrays, axis=0, always_copy=True):
    from . import concat
    return concat(*arrays, dim=axis)
