"""Parameter and ParameterDict (counterpart of mxnet_tpu/gluon/parameter.py).

A ``Parameter`` keeps the MXNet surface (name, shape, dtype, init,
deferred shape inference) over one tensor. Once assigned to a Block it
stores that tensor in the block's own torch registries: a trainable
parameter as an ``nn.Parameter`` in ``_parameters``, an auxiliary state
such as BatchNorm's running statistics (``differentiable=False``) as a
buffer in ``_buffers``. ``state_dict()``, ``named_parameters()`` and
``Module.to`` therefore see them under the structural names
("features.5.0.body.3.weight") that ``_collect_params_with_prefix`` uses.

Gradients are torch's ``.grad`` with MXNet's conventions
(``autograd.track``): ``grad_req`` "write" overwrites at each backward,
"add" accumulates, "null" takes none, and each backward marks the tensor's
gradient fresh (``_tensor()._fresh_grad``) for ``Trainer``.

``data()`` and ``grad()`` return NDArrays, as the JAX package's do: one
live view of each per parameter, through which ``p.data()[:] = v`` and
``p.data() += g`` write the parameter itself. The port's own code reads
the tensors through ``_tensor()`` and ``_grad_tensor()``.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from .. import initializer as _initializer
from .. import ndarray as nd
from ..base import MXNetError, canonical_dtype
from ..context import Context, as_device
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """The parameter's shape is not known until the first forward."""


class _ParamArray(NDArray):
    """``Parameter.data()``: a live NDArray view of the parameter's tensor.
    Writes through it (``[:] =``, ``+=``, ``out=``, a kvstore pull) land in
    the tensor in place, in its dtype; what is taken from it is a copy."""

    __slots__ = ("_param",)
    _live = True

    def __init__(self, param):
        self._param = param
        self._ctx = None
        self._grad = None
        self._grad_req = "null"

    @property
    def _data(self):
        return self._param._tensor()

    def _value(self):
        return self._data.detach().clone()

    def _assign(self, t):
        with torch.no_grad():
            self._data.copy_(t)

    @property
    def grad(self):
        return self._param.grad()

    def attach_grad(self, grad_req="write", stype=None):
        self._param.grad_req = grad_req


class _GradArray(_ParamArray):
    """``Parameter.grad()``: a live NDArray view of the parameter's
    gradient (zeros until the first backward)."""

    __slots__ = ()

    @property
    def _data(self):
        return self._param._grad_tensor()

    @property
    def grad(self):
        return None


def _first(ctx):
    if isinstance(ctx, (list, tuple)):
        return ctx[0] if ctx else None
    return ctx


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._own = None            # the tensor while no Block owns it
        self._owner = None          # (block, attribute name)
        self._deferred_init = None  # (init, device, default_init)
        self._views = None          # (data(), grad()) once asked for

    # -- storage ------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._data is not None:
            autograd.track(self._data, req)

    def _registry(self):
        mod = self._owner[0]
        return mod._parameters if self._differentiable else mod._buffers

    @property
    def _data(self):
        if self._owner is None:
            return self._own
        return self._registry().get(self._owner[1])

    def _store(self, t):
        t = t.detach()
        if self._differentiable:
            t = autograd.track(torch.nn.Parameter(t, requires_grad=False),
                               self._grad_req)
        if self._owner is None:
            self._own = t
        else:
            self._registry()[self._owner[1]] = t
        self.shape = tuple(t.shape)

    def _attach(self, block, attr):
        """Make ``block.<attr>`` this parameter's home in torch's
        registries."""
        t = self._data
        self._owner = (block, attr)
        if t is not None:
            self._store(t)

    # -- init ---------------------------------------------------------------
    def _shape_known(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._data is not None and not force_reinit:
            return
        device = as_device(_first(ctx))
        default_init = default_init or _initializer.Uniform()
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init)
                return
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape %s and deferred init is not allowed."
                % (self.name, self.shape))
        self._finish_init(init, device, default_init)

    def _finish_init(self, init, device, default_init):
        specific = init if init is not None else self.init
        chosen = _initializer.get(specific if specific is not None
                                  else default_init)
        self._store(_initializer.fill(chosen, self.name, self.shape,
                                      self.dtype, device,
                                      specific=specific is not None))
        self._deferred_init = None

    def _finish_deferred_init(self, shape):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized" % self.name)
        self.shape = tuple(shape)
        init, device, default_init = self._deferred_init
        self._finish_init(init, device, default_init)

    # -- access -------------------------------------------------------------
    def _tensor(self):
        """The parameter's tensor (what the port's code reads)."""
        t = self._data
        if t is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter '%s' deferred; run a forward pass or set "
                    "shape first" % self.name)
            raise MXNetError("Parameter '%s' has not been initialized. "
                             "Call initialize()" % self.name)
        return t

    def _grad_tensor(self):
        """The gradient tensor (zeros until the first backward). Raises for
        grad_req "null"."""
        t = self._tensor()
        if self._grad_req == "null":
            raise MXNetError("Parameter '%s' has no gradient (grad_req=null)"
                             % self.name)
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return t.grad

    def _view(self, i):
        if self._views is None:
            self._views = (_ParamArray(self), _GradArray(self))
        return self._views[i]

    def data(self, ctx=None):
        """The parameter's NDArray (a live view; the module docstring)."""
        self._tensor()
        return self._view(0)

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient's NDArray (a live view). Raises for grad_req
        "null"."""
        self._grad_tensor()
        return self._view(1)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        t = self._data
        return [NDArray(t).context] if t is not None else []

    def zero_grad(self):
        t = self._data
        if t is not None and t.grad is not None:
            t.grad.zero_()

    def set_data(self, data, ctx=None):
        """Write ``data`` (an NDArray, a tensor or a numpy array) into the
        parameter, cast to its dtype, on its device (for a parameter that
        has none yet: the device its initialize() chose, else ``ctx`` or
        the current context's). Raises on a shape that disagrees with a
        known dim."""
        if isinstance(data, NDArray):
            data = data._value()
        elif isinstance(data, _np.ndarray):
            data = torch.from_numpy(_np.ascontiguousarray(data))
        if self.shape is not None and (
                len(self.shape) != data.dim()
                or any(s > 0 and s != d
                       for s, d in zip(self.shape, data.shape))):
            raise ValueError(
                "Parameter %r: cannot set data of shape %s on declared "
                "shape %s" % (self.name, tuple(data.shape), self.shape))
        cur = self._data
        if cur is not None and tuple(cur.shape) == tuple(data.shape):
            with torch.no_grad():
                cur.copy_(data)
            return
        if cur is not None:
            device = cur.device
        elif self._deferred_init is not None:
            device = self._deferred_init[1]
        else:
            device = as_device(ctx)
        # a copy: the parameter is updated in place and must not alias the
        # caller's array
        self._store(data.to(device=device, dtype=self.dtype, copy=True))
        self._deferred_init = None

    def cast(self, dtype):
        self.dtype = canonical_dtype(dtype)
        if self._data is not None:
            self._store(self._data.to(self.dtype))

    def reset_ctx(self, ctx):
        """Move the parameter (or its pending deferred initialization) to
        context ``ctx``; its gradient starts afresh there."""
        device = as_device(_first(ctx))
        if self._data is not None:
            self._store(self._data.to(device))
        elif self._deferred_init is not None:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, device, default_init)

    def var(self):
        """The parameter as a symbol Variable of its name and shape."""
        from ..symbol import var
        return var(self.name, shape=self.shape)

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, str(self.dtype).replace("torch.", ""))


class Constant(Parameter):
    """A parameter that never learns: ``grad_req="null"``, so no gradient
    and no Trainer update; initialized to ``value`` (a numpy array, an
    NDArray, a tensor or anything ``numpy.asarray`` takes) whatever
    default initializer the block is given."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        elif isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = _np.asarray(value)
        self.value = value
        # the dtype's type object: float64 and int64 are held in 32 bits,
        # as in the JAX package
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype.type,
                         init=_initializer.Constant(value))


class ParameterDict:
    """Name -> Parameter, with a prefix (MXNet's ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __contains__(self, name):
        return name in self._params

    def __getitem__(self, name):
        return self._params[name]

    def get(self, name, **kwargs):
        """Create-or-retrieve ``prefix + name``."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        elif kwargs.get("shape") is not None and not param._shape_known():
            shape = kwargs["shape"]
            param.shape = (shape,) if isinstance(shape, int) \
                else tuple(shape)
        return param

    def get_constant(self, name, value=None):
        """Create-or-retrieve the Constant ``prefix + name``; creating one
        needs ``value``."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise KeyError("constant %r not found and no value given"
                               % name)
            param = Constant(full, value)
            self._params[full] = param
        return param

    def _get_impl(self, full):
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared:
            self._params[full] = self._shared[full]
            return self._params[full]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("duplicate parameter name %r" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, ``gpu(0)`` unless a ``with ctx:`` says otherwise; raises
        with no CUDA device)."""
        device = as_device(_first(ctx))
        for p in self._params.values():
            p.initialize(init=None, ctx=device, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        """Move every parameter to context ``ctx``."""
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter (``setattr("grad_req",
        "null")`` freezes them all)."""
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every initialized parameter with ``nd.save``, keyed by its
        name less ``strip_prefix``."""
        arg = {}
        for name, p in self._params.items():
            if p._data is None:
                continue
            k = name[len(strip_prefix):] if name.startswith(strip_prefix) \
                else name
            arg[k] = p.data()
        nd.save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load what ``save`` wrote, each key given ``restore_prefix``."""
        loaded = nd.load(filename, ctx=Context("cpu"))
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self._params.items():
            if name in loaded:
                p.set_data(loaded[name], ctx=_first(ctx))
            elif not allow_missing:
                raise KeyError("Parameter %r missing in file %s"
                               % (name, filename))
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise KeyError("File %s contains extra parameters: %s"
                               % (filename, sorted(extra)))

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self._params)
