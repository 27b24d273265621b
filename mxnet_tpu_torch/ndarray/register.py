"""The ``F`` and ``mx.nd`` namespace: one plain function per registered op
(counterpart of mxnet_tpu/ndarray/register.py). ``hybrid_forward(F, ...)``
calls ``F.Convolution(...)`` on tensors and gets a ``torch.Tensor`` back;
user code calls ``mx.nd.relu(x)`` on an NDArray and gets an NDArray.

``invoke`` is the one dispatch point. It first lets the AMP cast hook
(``set_amp_cast_hook``, installed by ``contrib.amp.init``) recast the
arguments, on both routes below: inside a Gluon net the ops run on
tensors, so a hook that saw only NDArrays would leave a net's ops in its
parameters' dtype. It supplies ``_training`` from
``autograd.is_training()`` to ops that take it and calls the op. Where an
argument or keyword value is an NDArray, it unwraps them, runs the op on
the tensors (outside ``autograd.record()`` under ``torch.no_grad()``, as
the JAX package records nothing there) and wraps the outputs as NDArrays;
with no NDArray among them it adds one type check and nothing else, so
tensors in give tensors out. Private OpDefs that stay out of the registry
(the fused ResNet link) are invoked through it too.
"""
from __future__ import annotations

import inspect

import torch

from .. import autograd
from .. import ops as _ops  # noqa: F401  (fills the registry)
from ..ops import registry as _registry
from .ndarray import NDArray, getitem as _getitem, wrap as _wrap
from .ndarray import _clean_index

__all__ = ["invoke", "invoke_by_name", "invoke_getitem", "populate",
           "make_op", "set_amp_cast_hook"]

# The AMP input-cast hook, ``hook(op_name, args, kwargs) -> (args,
# kwargs)``, or None.
_amp_cast_hook = None


def set_amp_cast_hook(hook):
    global _amp_cast_hook
    _amp_cast_hook = hook

_TAKES_TRAINING = {}


def _takes_training(opdef):
    flag = _TAKES_TRAINING.get(opdef.name)
    if flag is None:
        try:
            flag = "_training" in inspect.signature(opdef.fn).parameters
        except ValueError:      # a builtin (torch.exp): it takes no flag
            flag = False
        _TAKES_TRAINING[opdef.name] = flag
    return flag


def invoke(opdef, args, kwargs):
    """Run ``opdef`` on tensors, or on NDArrays (the module docstring)."""
    if _amp_cast_hook is not None:
        args, kwargs = _amp_cast_hook(opdef.name, args, kwargs)
    for a in args:
        if isinstance(a, NDArray):
            return _invoke_nd(opdef, args, kwargs)
    if kwargs:
        for v in kwargs.values():
            if isinstance(v, NDArray):
                return _invoke_nd(opdef, args, kwargs)
    if _takes_training(opdef) and "_training" not in kwargs:
        kwargs = dict(kwargs, _training=autograd.is_training())
    return opdef.fn(*args, **kwargs)


def _unwrap(v):
    return v._data if isinstance(v, NDArray) else v


def _outputs(out, inputs, live):
    """Wrap a result (a tensor or a tuple of them). A result that shares
    storage with a live input (a Parameter's view, written in place
    later) is copied."""
    ptrs = {i.untyped_storage().data_ptr() for i in inputs} if live else ()

    def one(t):
        if live and t.untyped_storage().data_ptr() in ptrs:
            t = t.clone()
        return _wrap(t)
    if isinstance(out, (tuple, list)):
        return tuple(one(t) for t in out)
    return one(out)


def _invoke_nd(opdef, args, kwargs):
    nds = [a for a in args if isinstance(a, NDArray)] + \
        [v for v in kwargs.values() if isinstance(v, NDArray)]
    live = any(a._live for a in nds)
    targs = [_unwrap(a) for a in args]
    tkwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    if _takes_training(opdef) and "_training" not in tkwargs:
        tkwargs["_training"] = autograd.is_training()
    if not autograd.is_recording() and torch.is_grad_enabled():
        with torch.no_grad():
            out = opdef.fn(*targs, **tkwargs)
    else:
        out = opdef.fn(*targs, **tkwargs)
    return _outputs(out, [a._data for a in nds], live)


def invoke_by_name(name, *args, **kwargs):
    return invoke(_registry.get_op(name), args, kwargs)


def invoke_getitem(arr, key):
    """``arr[key]``, basic, advanced or boolean indexing, as an NDArray; a
    differentiable gather under ``autograd.record()``."""
    k = _clean_index(key, arr._data.device)
    if not autograd.is_recording() and torch.is_grad_enabled():
        with torch.no_grad():
            out = _getitem(arr._data, k)
    else:
        out = _getitem(arr._data, k)
    return _outputs(out, [arr._data], arr._live)


def _deliver(out, res, name):
    """Write result(s) ``res`` into ``out`` (the reference's ``out=``): an
    NDArray takes the value (``_assign``), a tensor is written in place."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    ress = res if isinstance(res, (tuple, list)) else (res,)
    if len(outs) != len(ress):
        raise ValueError("%s: out= has %d arrays but the op produces %d "
                         "outputs" % (name, len(outs), len(ress)))
    for o, r in zip(outs, ress):
        r = _unwrap(r)
        if tuple(o.shape) != tuple(r.shape):
            raise ValueError("%s: out= array has shape %s but the result "
                             "has shape %s" % (name, tuple(o.shape),
                                               tuple(r.shape)))
        if isinstance(o, NDArray):
            o._assign(r.to(o._data.device))
        else:
            with torch.no_grad():
                o.copy_(r)
    return out


def make_op(opdef, name=None):
    """A plain function that runs ``opdef`` (named ``name``, default the
    op's own), with the reference's ``out=`` (and a ``name=`` it
    ignores)."""
    name = name or opdef.name

    def op(*args, **kwargs):
        if "out" in kwargs or "name" in kwargs:
            out = kwargs.pop("out", None)
            kwargs.pop("name", None)
            res = invoke(opdef, args, kwargs)
            return res if out is None else _deliver(out, res, name)
        return invoke(opdef, args, kwargs)
    op.__name__ = name
    op.__doc__ = opdef.fn.__doc__
    return op


def populate(namespace):
    """Bind every registered op (and alias) into ``namespace``, except the
    names it defines already (``nd.zeros``, ``nd.arange``, ...)."""
    for name in _registry.list_ops():
        if name not in namespace:
            namespace[name] = make_op(_registry.get_op(name))
