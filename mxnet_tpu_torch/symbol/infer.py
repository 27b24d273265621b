"""Shape inference over symbol graphs (counterpart of
mxnet_tpu/symbol/infer.py; ref: src/executor/infer_graph_attr_pass.cc).

Shapes propagate forward in topological order. Each op's output shapes
come from running its registered function on ``meta`` tensors (shapes and
dtypes, no data; the JAX package evaluates it abstractly with
``jax.eval_shape``); the kernel wrappers give empty meta outputs of the
kernel's shapes. Unknown parameter shapes are deduced first from the data
shape by the JAX package's hint table, copied as it is: a Convolution's
input channels are ``data[1]``, so a channels-last (NHWC) graph does not
infer, in either package.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..context import Context
from ..ops import registry as _registry

__all__ = ["infer_shape"]

# Gates per cell of the fused RNN op's modes (the JAX package's
# ops/nn.py), for the packed parameter length of an RNN node.
_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def _rnn_packed_param_size(mode, input_size, state_size, num_layers, ndir):
    g = _RNN_GATES[mode]
    h = state_size
    return ndir * g * h * (input_size + h + 2) \
        + (num_layers - 1) * ndir * g * h * (h * ndir + h + 2)


def _pairify(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _hint_param_shapes(node, in_shapes):
    """Deduce parameter-input shapes from the data shape + attrs.
    in_shapes: {input_name: shape or None}. Returns updates dict."""
    op = node.op
    a = node.attrs
    data = in_shapes.get("x") or in_shapes.get("data")
    out = {}
    if data is None:
        return out
    if op == "FullyConnected":
        nh = int(a.get("num_hidden"))
        flatten = a.get("flatten", True)
        in_units = int(_np.prod(data[1:])) if flatten else data[-1]
        out["weight"] = (nh, in_units)
        out["bias"] = (nh,)
    elif op in ("Convolution", "Deconvolution"):
        kernel = a.get("kernel")
        nd = len(kernel) if kernel is not None else len(data) - 2
        kernel = _pairify(kernel, nd)
        nf = int(a.get("num_filter"))
        g = int(a.get("num_group", 1))
        cin = data[1]
        if op == "Convolution":
            out["weight"] = (nf, cin // g) + kernel
        else:
            out["weight"] = (cin, nf // g) + kernel
        out["bias"] = (nf,)
    elif op in ("BatchNorm", "InstanceNorm", "GroupNorm"):
        axis = int(a.get("axis", 1))
        c = data[axis % len(data)]
        for nm in ("gamma", "beta", "moving_mean", "moving_var"):
            out[nm] = (c,)
    elif op == "LayerNorm":
        axis = int(a.get("axis", -1))
        c = data[axis % len(data)]
        out["gamma"] = (c,)
        out["beta"] = (c,)
    elif op == "Embedding":
        out["weight"] = (int(a.get("input_dim")), int(a.get("output_dim")))
    elif op in ("RNN", "rnn"):
        # packed parameter length + state shapes
        h = int(a.get("state_size"))
        layers = int(a.get("num_layers", 1))
        nd = 2 if a.get("bidirectional") else 1
        out["parameters"] = (_rnn_packed_param_size(
            a.get("mode", "lstm"), data[-1], h, layers, nd),)
        out["state"] = (layers * nd, data[1], h)
        out["state_cell"] = (layers * nd, data[1], h)
    return out


def infer_shape(sym, *args, partial=False, **kwargs):
    """Returns (arg_shapes, out_shapes, aux_shapes) in the list orders of
    list_arguments()/list_outputs()/list_auxiliary_states()."""
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    known = {}
    if args:
        assert len(args) <= len(arg_names)
        for n, s in zip(arg_names, args):
            if s is not None:
                known[n] = tuple(s)
    for k, v in kwargs.items():
        if v is not None:
            known[k] = tuple(v)

    nodes = sym._topo()
    # shapes per (node id, out_index)
    shapes = {}
    for node in nodes:
        if node.is_variable():
            s = known.get(node.name) or node._shape or \
                (tuple(node.attrs["__shape__"])
                 if "__shape__" in node.attrs else None)
            shapes[(id(node), 0)] = tuple(s) if s else None

    # pass 1+2: deduce parameter variable shapes from hints, then eval
    for node in nodes:
        if node.is_variable():
            continue
        from .control_flow import CONTROL_FLOW_OPS as _CF
        if node.op in _CF:
            # recurse into subgraphs so parameters used inside loop bodies
            # (auto-created weights etc.) get hint-inferred like the
            # reference's subgraph shape inference
            _cf_propagate_var_hints(node, shapes)
        input_names = node.attrs.get("__input_names__")
        in_shapes = {}
        if input_names:
            for iname, (src, oi) in zip(input_names, node.inputs):
                in_shapes[iname] = shapes.get((id(src), oi))
        hints = _hint_param_shapes(node, in_shapes)
        if input_names:
            for iname, (src, oi) in zip(input_names, node.inputs):
                if shapes.get((id(src), oi)) is None and iname in hints:
                    shapes[(id(src), oi)] = tuple(hints[iname])
        if node.attrs.get("__fused_json__") and any(
                shapes.get((id(src), oi)) is None
                for src, oi in node.inputs):
            # fused subgraph node with unknown inputs: deduce them by
            # running inference on the INNER region graph
            # (ref: subgraph FInferShape runs the inner graph's pass).
            # __fused_json__ is specific to fusion nodes, so this can
            # never collide with control-flow's __subgraph__/_cf_cache.
            if isinstance(node._cf_cache, tuple):
                sub_sym, sub_inputs = node._cf_cache
            else:
                from .symbol import load_json as _load_json
                sub_sym = _load_json(node.attrs["__fused_json__"])
                sub_inputs = list(node.attrs["__fused_inputs__"])
                node._cf_cache = (sub_sym, sub_inputs)
            known_inner = {}
            for iname, (src, oi) in zip(sub_inputs, node.inputs):
                si = shapes.get((id(src), oi))
                if si is not None:
                    known_inner[iname] = si
            try:
                arg_sh, _o, _a = infer_shape(sub_sym, partial=True,
                                             **known_inner)
                by_name = dict(zip(sub_sym.list_arguments(), arg_sh))
            except Exception:  # noqa: BLE001 -- fall through to eval
                by_name = {}
            for iname, (src, oi) in zip(sub_inputs, node.inputs):
                if shapes.get((id(src), oi)) is None \
                        and by_name.get(iname) is not None:
                    shapes[(id(src), oi)] = tuple(by_name[iname])
        # now try abstract eval
        ins = [shapes.get((id(src), oi)) for src, oi in node.inputs]
        if any(s is None for s in ins):
            if partial:
                for i in range(node.num_outputs):
                    shapes[(id(node), i)] = None
                continue
            missing = [src.name for (src, oi), s in zip(node.inputs, ins)
                       if s is None]
            raise ValueError("cannot infer shape for inputs %s of %s(%s)"
                             % (missing, node.op, node.name))
        outs = _abstract_eval(node, ins)
        for i, s in enumerate(outs):
            shapes[(id(node), i)] = s

    def var_shape(name):
        for node in nodes:
            if node.is_variable() and node.name == name:
                return shapes.get((id(node), 0))
        return None

    arg_shapes = [var_shape(n) for n in arg_names]
    aux_shapes = [var_shape(n) for n in aux_names]
    out_shapes = [shapes.get((id(node), oi)) for node, oi in sym._outputs]
    return arg_shapes, out_shapes, aux_shapes


def _cf_propagate_var_hints(node, shapes):
    """Run partial shape inference inside a control-flow node's subgraphs
    and write inferred shapes back onto unknown outer input VARIABLES
    (loop-body parameters). Mutates `shapes` in place."""
    from .symbol import load_json
    a = node.attrs
    in_shapes = [shapes.get((id(src), oi)) for src, oi in node.inputs]
    carry_off = int(a.get("__num_data__", 0))
    for js, mapping in zip(a["__subgraph__"], a["__subg_inputs__"]):
        sub = load_json(js)
        kwargs = {}
        for vn, kind, idx in mapping:
            if kind == "slice":
                s = in_shapes[idx]
                if s is not None and len(s) >= 1:
                    kwargs[vn] = tuple(s[1:])
            else:
                src_idx = carry_off + idx if kind == "carry" else idx
                s = in_shapes[src_idx]
                if s is not None:
                    kwargs[vn] = tuple(s)
        try:
            arg_shapes, _, _ = infer_shape(sub, partial=True, **kwargs)
        except Exception:
            continue
        inferred = dict(zip(sub.list_arguments(), arg_shapes))
        for vn, kind, idx in mapping:
            s = inferred.get(vn)
            if s is None:
                continue
            src_idx = carry_off + idx if kind == "carry" else idx
            if kind == "slice" or src_idx >= len(node.inputs):
                continue
            src, oi = node.inputs[src_idx]
            if src.is_variable() and shapes.get((id(src), oi)) is None:
                shapes[(id(src), oi)] = tuple(s)
                in_shapes[src_idx] = tuple(s)


def _abstract_eval(node, in_shapes):
    """The output shapes of ``node`` on float32 inputs of ``in_shapes``."""
    from .control_flow import CONTROL_FLOW_OPS, abstract as _cf_abstract
    metas = [torch.empty(s, dtype=torch.float32, device="meta")
             for s in in_shapes]
    if node.op in CONTROL_FLOW_OPS:
        return [tuple(o.shape) for o in _cf_abstract(node, metas)]
    opdef = _registry.get_op(node.op)
    from ..executor import _fn_params, _tuplify
    params, has_var_kw = _fn_params(opdef)
    # node.attrs can carry metadata (AttrScope tags, ctx_group, ...) that
    # must never reach the op function
    attrs = {k: _tuplify(v) for k, v in node.attrs.items()
             if not k.startswith("__") and (has_var_kw or k in params)}
    input_names = node.attrs.get("__input_names__")
    if input_names:
        kw = dict(zip(input_names, metas))
        kw.update(attrs)
        call = lambda: opdef.fn(**kw)  # noqa: E731
    else:
        call = lambda: opdef.fn(*metas, **attrs)  # noqa: E731
    if metas:
        out = call()
    else:
        # an op without a tensor input builds on the current context:
        # the host's, for its shape only
        with Context("cpu"):
            out = call()
    if isinstance(out, (tuple, list)):
        return [tuple(o.shape) for o in out]
    return [tuple(out.shape)]
