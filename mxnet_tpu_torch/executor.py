"""Executor: a bound symbolic graph (counterpart of mxnet_tpu/executor.py;
ref: src/executor/graph_executor.cc, python/mxnet/executor.py).

``_GraphProgram`` interprets a Symbol's nodes in topological order on
tensors, each node one call of its registered op, as the reference's
GraphExecutor runs its ops one by one (the JAX package traces the same
interpreter into one jitted program instead). ``Executor`` owns the bound
NDArrays: arguments, gradients and auxiliary states.

``forward(is_train=True)`` runs the graph under torch autograd, with the
arguments that take a gradient as fresh leaves, writes the BatchNorm
moving statistics into the aux arrays, and keeps the graph for
``backward``, which takes ``torch.autograd.grad`` of the outputs with the
head gradients (ones by default; a loss head such as ``SoftmaxOutput``
ignores them) and drops the graph. ``grad_req`` is the reference's:
``"write"`` replaces the gradient array's value, ``"add"`` adds to it,
``"null"`` takes no gradient. ``forward(is_train=False)`` runs without
recording.

The graph runs on the executor's context (default: the current context,
``gpu(0)``); ops without a tensor input build there. Random ops draw from
the port's generator of that device, not from the JAX package's per-node
keys. ``group2ctx`` (node groups on several devices) waits for the
multi-device slice and raises.
"""
from __future__ import annotations

import inspect

import numpy as _np
import torch

from .base import MXNetError, canonical_dtype, weak_scalar
from .context import Context, current_context
from .ndarray.ndarray import NDArray, _from_numpy, wrap as _wrap
from .ops import registry as _registry
from .symbol.control_flow import CONTROL_FLOW_OPS as _CONTROL_FLOW_OPS
from .symbol.control_flow import lower as _cf_lower

__all__ = ["Executor"]

_SIG_CACHE = {}  # op name -> (its parameter names, takes **kwargs)


def _fn_params(opdef):
    sp = _SIG_CACHE.get(opdef.name)
    if sp is None:
        try:
            sig = inspect.signature(opdef.fn)
        except ValueError:       # a torch builtin: it takes no attrs
            sp = (frozenset(), False)
        else:
            sp = (frozenset(sig.parameters),
                  any(p.kind == inspect.Parameter.VAR_KEYWORD
                      for p in sig.parameters.values()))
        _SIG_CACHE[opdef.name] = sp
    return sp


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _moving(value, stat, momentum):
    """``momentum * value + (1 - momentum) * stat`` in ``value``'s dtype,
    the scalars rounded as the JAX package's weak types round them."""
    stat = stat.detach().to(value.dtype)
    return weak_scalar(momentum, value.dtype) * value \
        + weak_scalar(1.0 - momentum, value.dtype) * stat


class _GraphProgram:
    """Evaluates a Symbol graph on tensors."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.nodes = symbol._topo()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.heads = list(symbol._outputs)

    def run(self, values, is_train):
        """values: {var_name: tensor}. Returns (outputs, aux_updates), the
        updates {aux name: new value} of the BatchNorm moving statistics
        in training mode (detached)."""
        vals = {}
        aux_updates = {}
        for node in self.nodes:
            if node.is_variable():
                if node.name not in values:
                    raise MXNetError("unbound variable %r" % node.name)
                vals[(id(node), 0)] = values[node.name]
                continue
            ins = [vals[(id(src), oi)] for src, oi in node.inputs]
            if node.op in _CONTROL_FLOW_OPS:
                outs, cf_aux = _cf_lower(node, ins, is_train)
                for i, o in enumerate(outs):
                    vals[(id(node), i)] = o
                # subgraph BatchNorm moving-stat writes: cut variables keep
                # their outer names, so these merge like direct aux writes
                for name, val in cf_aux.items():
                    if name in values:
                        aux_updates[name] = val
                continue
            opdef = _registry.get_op(node.op)
            pnames, has_var_kw = _fn_params(opdef)
            attrs = {}
            for k, v in node.attrs.items():
                if k.startswith("__"):
                    continue
                if has_var_kw or k in pnames:
                    attrs[k] = _tuplify(v)
            if "_training" in pnames:
                attrs["_training"] = is_train
            input_names = node.attrs.get("__input_names__")
            if input_names:
                kw = dict(zip(input_names, ins))
                kw.update(attrs)
                out = opdef.fn(**kw)
            else:
                out = opdef.fn(*ins, **attrs)
            raw = list(out) if isinstance(out, (tuple, list)) else [out]
            for i, o in enumerate(raw):
                vals[(id(node), i)] = o
            if node.op in ("BatchNorm", "batch_norm") and is_train \
                    and not node.attrs.get("use_global_stats", False) \
                    and input_names:
                momentum = float(node.attrs.get("momentum", 0.9))
                name_of = dict(zip(input_names,
                                   [src.name for src, _ in node.inputs]))
                for pname, stat in (("moving_mean", raw[1]),
                                    ("moving_var", raw[2])):
                    vname = name_of.get(pname)
                    if vname is not None and vname in values:
                        aux_updates[vname] = _moving(values[vname], stat,
                                                     momentum)
        outs = [vals[(id(node), oi)] for node, oi in self.heads]
        return outs, aux_updates


def _tensor_of(v):
    """The tensor of an NDArray, tensor or array-like."""
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return _from_numpy(_np.asarray(v))


def _set(arr, value):
    """Write ``value`` into NDArray ``arr``, in its dtype and on its
    device."""
    t = _tensor_of(value).detach()
    arr._data = t.to(device=arr._data.device, dtype=arr._data.dtype)


class Executor:
    """A bound graph with its argument, gradient and aux arrays."""

    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None):
        if group2ctx:
            raise MXNetError(
                "group2ctx places node groups on several devices, which "
                "arrives with the multi-device slice (ROADMAP M10)")
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._device = Context(self._ctx).device   # raises with no CUDA
        self._prog = _GraphProgram(symbol)
        arg_names = self._prog.arg_names
        aux_names = self._prog.aux_names

        self.arg_dict = self._normalize(args, arg_names, "args")
        self.aux_dict = self._normalize(aux_states, aux_names, "aux_states",
                                        allow_none=True)
        self.grad_dict = self._normalize(args_grad, arg_names, "args_grad",
                                         allow_none=True, partial_ok=True)
        self._grad_req = self._normalize_req(grad_req, arg_names)
        # gradients only for float args with a buffer and req != null
        self._grad_names = [n for n in arg_names
                            if self._grad_req.get(n, "null") != "null"
                            and n in self.grad_dict
                            and self.arg_dict[n]._data.is_floating_point()]
        self.outputs = []
        self._pending = None     # (outputs, leaves) of a training forward
        self._monitor = None

    # -- binding helpers ----------------------------------------------------
    def _place(self, v):
        """``v`` as an NDArray on the executor's device: an NDArray there is
        kept (the binding shares it), anything else is copied there."""
        if isinstance(v, NDArray) and v._data.device == self._device:
            return v
        t = _tensor_of(v).detach()
        return _wrap(t.to(self._device, copy=True), ctx=self._ctx)

    def _normalize(self, vals, names, what, allow_none=False,
                   partial_ok=False):
        if vals is None:
            if allow_none:
                return {}
            raise MXNetError("%s must be provided to bind" % what)
        if isinstance(vals, dict):
            out = {k: self._place(v) for k, v in vals.items() if k in names}
            missing = [n for n in names if n not in out]
            if missing and not (allow_none or partial_ok):
                raise MXNetError("missing %s for %s" % (what, missing))
            return out
        vals = list(vals)
        if len(vals) != len(names) and not partial_ok:
            raise MXNetError("%s length %d != expected %d"
                             % (what, len(vals), len(names)))
        return {n: self._place(v) for n, v in zip(names, vals)
                if v is not None}

    @staticmethod
    def _normalize_req(grad_req, arg_names):
        if isinstance(grad_req, str):
            return {n: grad_req for n in arg_names}
        if isinstance(grad_req, (list, tuple)):
            return dict(zip(arg_names, grad_req))
        return dict(grad_req)

    @classmethod
    def simple_bind(cls, symbol, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **kwargs):
        """Arguments, gradients and aux states of zeros, of the shapes
        ``infer_shape(**kwargs)`` gives, in ``type_dict``'s dtypes (default
        float32)."""
        ctx = ctx if ctx is not None else current_context()
        device = Context(ctx).device
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        type_dict = type_dict or {}

        def zeros(name, shape):
            dt = canonical_dtype(type_dict.get(name, "float32"))
            return _wrap(torch.zeros(shape, dtype=dt, device=device),
                         ctx=ctx)
        args = {}
        for n, s in zip(arg_names, arg_shapes):
            if s is None:
                raise MXNetError("cannot infer shape of argument %r" % n)
            args[n] = zeros(n, s)
        aux = {n: zeros(n, s) for n, s in zip(aux_names, aux_shapes)
               if s is not None}
        req = cls._normalize_req(grad_req, arg_names)
        grads = {n: _wrap(torch.zeros_like(args[n]._data), ctx=ctx)
                 for n in arg_names
                 if req.get(n, "null") != "null"
                 and args[n]._data.is_floating_point()}
        return cls(symbol, ctx, args=args, args_grad=grads, grad_req=req,
                   aux_states=aux, group2ctx=group2ctx)

    # -- running ------------------------------------------------------------
    def _values(self, leaves=None):
        values = {n: a._data for n, a in self.arg_dict.items()}
        values.update({n: a._data for n, a in self.aux_dict.items()})
        if leaves:
            values.update(leaves)
        return values

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` first write argument values. Returns
        the outputs (NDArrays). In training mode it also writes the moving
        statistics and keeps the graph for ``backward``."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %r" % k)
            _set(self.arg_dict[k], v)
        self._pending = None
        if is_train:
            leaves = {n: self.arg_dict[n]._data.detach().requires_grad_(True)
                      for n in self._grad_names}
            with torch.enable_grad(), self._ctx:
                outs, aux_up = self._prog.run(self._values(leaves), True)
            self._write_aux(aux_up)
            self._pending = (outs, leaves)
        else:
            with torch.no_grad(), self._ctx:
                outs, _ = self._prog.run(self._values(), False)
        self.outputs = [_wrap(o.detach(), ctx=self._ctx) for o in outs]
        if self._monitor is not None:
            for name, arr in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor(name, arr)
        return self.outputs

    def _write_aux(self, aux_up):
        for n, v in aux_up.items():
            if n in self.aux_dict:
                _set(self.aux_dict[n], v)

    def backward(self, out_grads=None):
        """Gradients of the last training forward's outputs (run one first
        if there was none) for ``out_grads`` (default: ones), delivered to
        the gradient arrays by their ``grad_req``. The graph is released."""
        if self._pending is None:
            self.forward(is_train=True)
        outs, leaves = self._pending
        self._pending = None
        if out_grads is not None and not isinstance(out_grads,
                                                    (list, tuple)):
            out_grads = [out_grads]
        heads, cots = [], []
        for i, o in enumerate(outs):
            if not o.requires_grad:
                continue
            heads.append(o)
            if out_grads is None:
                cots.append(torch.ones_like(o))
            else:
                cots.append(_tensor_of(out_grads[i]).to(o.device, o.dtype))
        names = list(leaves)
        if heads and names:
            grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                        cots, allow_unused=True)
        else:
            grads = [None] * len(names)
        for n, g in zip(names, grads):
            buf = self.grad_dict[n]
            if g is None:
                g = torch.zeros_like(leaves[n])
            g = g.detach().to(buf._data.dtype)
            if self._grad_req.get(n, "write") == "add":
                buf._data = buf._data + g
            else:
                buf._data = g

    # -- views matching the reference Executor -------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._prog.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._prog.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._prog.aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                _set(self.arg_dict[k], v)
            elif not allow_extra_params:
                raise MXNetError("unknown arg param %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _set(self.aux_dict[k], v)
            elif not allow_extra_params:
                raise MXNetError("unknown aux param %r" % k)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new Executor at new input shapes that shares every array whose
        shape stays (ref: executor.py Executor.reshape)."""
        new_shapes = {}
        for n in self._prog.arg_names:
            new_shapes[n] = kwargs[n] if n in kwargs \
                else self.arg_dict[n].shape
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**new_shapes)

        def keep_or_zeros(old, shape):
            if tuple(old.shape) == tuple(shape):
                return old
            return _wrap(torch.zeros(shape, dtype=old._data.dtype,
                                     device=self._device), ctx=self._ctx)
        args = {n: keep_or_zeros(self.arg_dict[n], s)
                for n, s in zip(self._prog.arg_names, arg_shapes)}
        aux = {n: keep_or_zeros(self.aux_dict[n], s)
               for n, s in zip(self._prog.aux_names, aux_shapes)}
        grads = {n: _wrap(torch.zeros_like(args[n]._data), ctx=self._ctx)
                 for n in self.grad_dict}
        return Executor(self._symbol, self._ctx, args=args, args_grad=grads,
                        grad_req=self._grad_req, aux_states=aux)

    def set_monitor_callback(self, callback, monitor_all=False):
        """``callback(name, array)`` on each output after every forward."""
        self._monitor = callback

    def debug_str(self):
        return self._symbol.debug_str()
