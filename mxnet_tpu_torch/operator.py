"""Custom operators in Python: ``mx.operator.CustomOp`` / ``CustomOpProp``
(counterpart of mxnet_tpu/operator.py; ref: python/mxnet/operator.py,
CustomOp :378, CustomOpProp :512, register :636, over
src/operator/custom/custom-inl.h:52 CustomOperator).

``register(name)`` files a ``CustomOpProp`` subclass under an op type;
``mx.nd.Custom(*inputs, op_type=name, **kwargs)`` (``invoke``) builds the
property with ``kwargs``, infers the outputs' shapes and types, creates the
operator and runs its ``forward`` on NDArrays, whose outputs it hands back.
Under ``autograd.record()`` the call is one node of torch's graph (a
``torch.autograd.Function``, as ``autograd.Function`` carries a user
function) whose backward calls the operator's ``backward``, as the JAX
package records one tape node whose vjp does.

The ``Custom`` registry op makes ``mx.sym.Custom`` and runs a Custom node
in the executor. The JAX package lowers that node to a
``jax.pure_callback``: XLA calls back onto the host for exactly this node.
The port's executor interprets the graph eagerly on the device's tensors,
so the node runs the operator's Python inline on those tensors, with no
copy to the host (a user operator that calls ``asnumpy()`` makes its own).
Shape inference, which runs the graph on meta tensors, takes the
property's ``infer_shape`` and ``infer_type`` instead of running the
operator.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import canonical_dtype
from .ndarray.ndarray import NDArray
from .ops.registry import register as _reg_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop", "invoke"]

_CUSTOM_PROPS = {}


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under ``op_type``
    (ref: python/mxnet/operator.py:636 register)."""
    def do_register(prop_cls):
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_prop(op_type):
    try:
        return _CUSTOM_PROPS[op_type]
    except KeyError:
        raise KeyError("custom op %r is not registered; call "
                       "mx.operator.register(%r) on a CustomOpProp "
                       "subclass first" % (op_type, op_type))


def _value(src, like):
    """``src`` (an NDArray, a tensor or an array-like) as a tensor in
    ``like``'s dtype, on its device."""
    if isinstance(src, NDArray):
        src = src._data
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(src)
    return src.to(device=like.device, dtype=like.dtype)


class CustomOp:
    """Base class for user-defined operators
    (ref: python/mxnet/operator.py:378)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into the NDArray ``dst`` as ``req`` says
        (ref: operator.py CustomOp.assign): ``write``/``inplace`` replace
        its value, ``add`` adds to it, ``null`` leaves it."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst._data = _value(src, dst._data)
        elif req == "add":
            dst._data = dst._data + _value(src, dst._data)
        else:
            raise ValueError("unknown req %r" % req)


class CustomOpProp:
    """Operator properties: arguments/outputs/shapes/types + factory
    (ref: python/mxnet/operator.py:512)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def infer_storage_type(self, in_stype):
        return (in_stype, ["default"] * len(self.list_outputs()),
                ["default"] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def _signature(op_type, kwargs, tensors):
    """(property, output and aux (shape, torch dtype) lists) of one call."""
    prop = get_prop(op_type)(**kwargs)
    in_shapes = [list(t.shape) for t in tensors]
    _, out_shapes, aux_shapes = prop.infer_shape(in_shapes)
    in_types = [NDArray(t).dtype for t in tensors]
    _, out_types, aux_types = prop.infer_type(in_types)
    outs = [(tuple(s), canonical_dtype(dt))
            for s, dt in zip(out_shapes, out_types)]
    aux = [(tuple(s), canonical_dtype(dt))
           for s, dt in zip(aux_shapes, aux_types)]
    return prop, in_shapes, in_types, outs, aux


class _Call:
    """One invocation of a custom op: its operator and the NDArrays its
    forward saw, which its backward gets again."""

    def __init__(self, op_type, kwargs, is_train):
        self.op_type = op_type
        self.kwargs = kwargs
        self.is_train = is_train

    def forward(self, tensors):
        prop, in_shapes, in_types, outs, aux = _signature(
            self.op_type, self.kwargs, tensors)
        dev = tensors[0].device if tensors else None
        self.in_data = [NDArray(t) for t in tensors]
        ctx = self.in_data[0].context if tensors else None
        self.op = prop.create_operator(ctx, in_shapes, in_types)
        self.out_data = [NDArray(torch.zeros(s, dtype=dt, device=dev))
                         for s, dt in outs]
        self.aux = [NDArray(torch.zeros(s, dtype=dt, device=dev))
                    for s, dt in aux]
        with autograd.pause():
            self.op.forward(is_train=self.is_train,
                            req=["write"] * len(self.out_data),
                            in_data=self.in_data, out_data=self.out_data,
                            aux=self.aux)
        return [o._data for o in self.out_data]

    def backward(self, cts):
        out_grad = [NDArray(torch.zeros_like(o._data) if c is None else c)
                    for c, o in zip(cts, self.out_data)]
        in_grad = [NDArray(torch.zeros_like(a._data)) for a in self.in_data]
        with autograd.pause():
            self.op.backward(req=["write"] * len(in_grad),
                             out_grad=out_grad, in_data=self.in_data,
                             out_data=self.out_data, in_grad=in_grad,
                             aux=self.aux)
        return [g._data for g in in_grad]


class _CustomNode(torch.autograd.Function):
    """A custom op's call as one node of torch's graph: its backward is
    the operator's."""

    @staticmethod
    def forward(ctx, call, *tensors):
        ctx.call = call
        return tuple(call.forward(tensors))

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + tuple(ctx.call.backward(cts))


def _run(op_type, tensors, kwargs, node):
    """The outputs (tensors) of one call; ``node``: record it in torch's
    graph."""
    call = _Call(op_type, kwargs,
                 autograd.is_training() or autograd.is_recording() or node)
    if node and any(t.requires_grad for t in tensors):
        return list(_CustomNode.apply(call, *tensors))
    with torch.no_grad():
        return call.forward(tensors)


def invoke(*inputs, op_type, **kwargs):
    """``mx.nd.Custom``: run the custom op ``op_type`` on ``inputs``
    (NDArrays, or tensors, which give tensors back: under
    ``autograd.record()``, as a block's outputs, ``autograd.Head``s whose
    ``backward()`` seeds ones); one node of the graph under
    ``autograd.record()``."""
    as_nd = any(isinstance(x, NDArray) for x in inputs)
    tensors = [x._data if isinstance(x, NDArray) else torch.as_tensor(x)
               for x in inputs]
    recording = autograd.is_recording()
    outs = _run(op_type, tensors, kwargs, recording)
    if as_nd:
        outs = [NDArray(o) for o in outs]
    elif recording:
        outs = [o.as_subclass(autograd.Head) if o.requires_grad else o
                for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


@_reg_op("Custom")
def Custom(*inputs, op_type=None, **kwargs):
    """A custom-op node of a graph (ref: src/operator/custom/
    custom-inl.h CustomOperator): the operator runs inline on the
    executor's tensors, one node of torch's graph where gradients are
    taken; on meta tensors (shape inference) its property's inferred
    outputs."""
    if op_type is None:
        raise ValueError("Custom requires op_type")
    kwargs.pop("_training", None)
    if any(t.device.type == "meta" for t in inputs):
        outs = _signature(op_type, kwargs, inputs)[3]
        res = [torch.empty(s, dtype=dt, device="meta") for s, dt in outs]
    else:
        res = _run(op_type, list(inputs), kwargs, torch.is_grad_enabled())
    return res[0] if len(res) == 1 else tuple(res)
