"""Symbol-level control flow: subgraph capture and its run (counterpart of
mxnet_tpu/symbol/control_flow.py; ref: src/operator/control_flow.cc
_foreach, _while_loop, _cond; python/mxnet/symbol/contrib.py).

A control-flow node keeps its subgraph(s) as graph JSON in its attrs, the
same JSON in both packages. The JAX package lowers the node to
``lax.scan``/``while_loop``/``cond``; here the executor runs it as the
port's ``nd.contrib`` control flow runs, a Python loop over the
subgraph's program on tensors (under autograd when the executor records),
with ``while_loop``'s predicate read on the host once per step. BatchNorm
moving statistics inside a subgraph thread through the steps and come
back keyed by their outer variable names.

Capture works by creation order: every ``_Node`` carries a monotonically
increasing ``uid``. Anything the body references that was created before
the capture started (outer op results), and every free variable, is "cut"
into an explicit input of the control-flow node.
"""
from __future__ import annotations

import torch

from .symbol import Symbol, _Node, _node_uid

__all__ = ["CONTROL_FLOW_OPS", "capture_subgraph", "lower", "abstract"]

CONTROL_FLOW_OPS = ("_foreach", "_while_loop", "_cond")


def capture_subgraph(heads, placeholders, marker):
    """Serialize the graph reachable from `heads` into standalone JSON.

    heads        : list[(node, out_index)] subgraph outputs
    placeholders : {id(node): varname} — loop placeholders, kept as subgraph
                   input variables under the given name
    marker       : uid watermark; nodes with uid < marker are outer values

    Free variables and outer op results become fresh input variables of the
    subgraph ("cuts"). Returns (json_str, input_varnames, cut_entries) where
    cut_entries is the ordered list of outer (node, out_index) pairs feeding
    the cut variables, and input_varnames lists every subgraph input
    variable name in [placeholder..., cut...] order.
    """
    memo = {}       # id(inner node) -> copied node
    cut_memo = {}   # (id(node), oi) -> copied var node
    cuts = []       # [(node, oi)] outer values, in first-use order
    cut_names = []

    def is_boundary(node):
        return (id(node) not in placeholders
                and (node.is_variable() or node.uid < marker))

    def cut_var(src, oi):
        k = (id(src), oi)
        if k in cut_memo:
            return cut_memo[k]
        if src.is_variable():
            name = src.name               # keep bindable parameter names
        else:
            name = "_cut_%s_out%d" % (src.name, oi)
        nn = _Node(None, name, {})
        cut_memo[k] = nn
        cuts.append((src, oi))
        cut_names.append(name)
        return nn

    def copy(node):
        if id(node) in memo:
            return memo[id(node)]
        if id(node) in placeholders:
            nn = _Node(None, placeholders[id(node)], {})
        else:
            nn = _Node(node.op, node.name, dict(node.attrs), (),
                       node.num_outputs)
            for src, oi in node.inputs:
                if is_boundary(src):
                    nn.inputs.append((cut_var(src, oi), 0))
                else:
                    nn.inputs.append((copy(src), oi))
        memo[id(node)] = nn
        return nn

    new_heads = []
    for node, oi in heads:
        if is_boundary(node):
            new_heads.append((cut_var(node, oi), 0))
        else:
            new_heads.append((copy(node), oi))
    sub = Symbol(new_heads)
    input_names = list(placeholders.values()) + cut_names
    return sub.tojson(), input_names, cuts


def _programs(node):
    """Parse (and cache) the node's subgraph JSON into graph programs."""
    if node._cf_cache is None:
        from .symbol import load_json
        from ..executor import _GraphProgram
        node._cf_cache = [_GraphProgram(load_json(js))
                          for js in node.attrs["__subgraph__"]]
    return node._cf_cache


def _bind(mapping, node_ins, carry, slices):
    """Resolve a subgraph's {varname: value} dict from its input mapping.

    mapping entries are [varname, kind, idx]:
      kind "slice" -- per-step slice idx of the scanned sequences
      kind "carry" -- loop-carried value idx
      kind "input" -- node input idx (closure / initial value)
    """
    values = {}
    for name, kind, idx in mapping:
        if kind == "slice":
            values[name] = slices[idx]
        elif kind == "carry":
            values[name] = carry[idx]
        else:
            values[name] = node_ins[idx]
    return values


def lower(node, ins, is_train):
    """Run one control-flow node on tensors. ins: node input values in
    node input order. Returns (outputs list, aux_updates dict)."""
    if node.op == "_foreach":
        return _run_foreach(node, ins, is_train)
    if node.op == "_while_loop":
        return _run_while(node, ins, is_train)
    if node.op == "_cond":
        return _run_cond(node, ins, is_train)
    raise ValueError(node.op)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _stack(steps, i):
    return torch.stack([outs[i] for outs in steps])


def _run_foreach(node, ins, is_train):
    a = node.attrs
    nd_, ns_ = int(a["__num_data__"]), int(a["__num_states__"])
    nod = int(a["__num_out_data__"])
    (mapping,) = a["__subg_inputs__"]
    (prog,) = _programs(node)
    data = ins[:nd_]
    states = list(ins[nd_:nd_ + ns_])
    aux = {}
    steps = []
    for t in range(data[0].shape[0]):
        values = _bind(mapping, ins, states, [d[t] for d in data])
        values.update(aux)                  # current moving stats
        outs, aux_up = prog.run(values, is_train)
        aux.update(aux_up)
        steps.append(outs[:nod])
        states = outs[nod:]
    if not steps:       # no step: empty outputs of the body's shapes
        probe = abstract(node, [_meta(t) for t in ins])
        return ([torch.empty((0,) + tuple(o.shape[1:]), dtype=o.dtype,
                             device=data[0].device)
                 for o in probe[:nod]] + states), {}
    return [_stack(steps, i) for i in range(nod)] + list(states), aux


def _run_while(node, ins, is_train):
    a = node.attrs
    nvars = int(a["__num_vars__"])
    nod = int(a["__num_out_data__"])
    max_iter = int(a["max_iterations"])
    map_cond, map_body = a["__subg_inputs__"]
    prog_cond, prog_body = _programs(node)
    vars_ = list(ins[:nvars])
    aux = {}
    steps = []
    while len(steps) < max_iter:
        outs, _ = prog_cond.run(_bind(map_cond, ins, vars_, ()), is_train)
        if not bool(outs[0].reshape(())):
            break
        values = _bind(map_body, ins, vars_, ())
        values.update(aux)
        outs, aux_up = prog_body.run(values, is_train)
        aux.update(aux_up)
        steps.append(outs[:nod])
        vars_ = outs[nod:]
    # outputs stacked and padded with zeros to max_iterations rows
    if steps:
        shapes = [(o.shape, o.dtype) for o in steps[0]]
    else:
        probe = abstract(node, [_meta(t) for t in ins])
        shapes = [(o.shape[1:], o.dtype) for o in probe[:nod]]
    dev = ins[0].device
    stacked = []
    for i, (shape, dtype) in enumerate(shapes):
        pad = torch.zeros((max_iter - len(steps),) + tuple(shape),
                          dtype=dtype, device=dev)
        col = [_stack(steps, i).to(dtype)] if steps else []
        stacked.append(torch.cat(col + [pad]) if col else pad)
    return stacked + list(vars_), aux


def _run_cond(node, ins, is_train):
    map_pred, map_then, map_else = node.attrs["__subg_inputs__"]
    prog_pred, prog_then, prog_else = _programs(node)
    pred_outs, aux = prog_pred.run(_bind(map_pred, ins, (), ()), is_train)
    if bool(pred_outs[0].reshape(())):
        prog, mapping = prog_then, map_then
    else:
        prog, mapping = prog_else, map_else
    # the untaken branch's aux stays at its incoming value
    outs, aux_up = prog.run(_bind(mapping, ins, (), ()), is_train)
    aux = dict(aux)
    aux.update(aux_up)
    return list(outs), aux


def abstract(node, ins):
    """The node's outputs as meta tensors of their shapes and dtypes, from
    meta inputs (one step of a loop's body; a cond's then-branch)."""
    a = node.attrs
    progs = _programs(node)
    if node.op == "_foreach":
        nd_, ns_ = int(a["__num_data__"]), int(a["__num_states__"])
        nod = int(a["__num_out_data__"])
        (mapping,) = a["__subg_inputs__"]
        data = ins[:nd_]
        outs, _ = progs[0].run(_bind(mapping, ins, ins[nd_:nd_ + ns_],
                                     [d[0] for d in data]), False)
        length = data[0].shape[0]
        return [torch.empty((length,) + tuple(o.shape), dtype=o.dtype,
                            device="meta") for o in outs[:nod]] \
            + list(outs[nod:])
    if node.op == "_while_loop":
        nvars = int(a["__num_vars__"])
        nod = int(a["__num_out_data__"])
        max_iter = int(a["max_iterations"])
        outs, _ = progs[1].run(_bind(a["__subg_inputs__"][1], ins,
                                     ins[:nvars], ()), False)
        return [torch.empty((max_iter,) + tuple(o.shape), dtype=o.dtype,
                            device="meta") for o in outs[:nod]] \
            + list(outs[nod:])
    outs, _ = progs[1].run(_bind(a["__subg_inputs__"][1], ins, (), ()),
                           False)
    return list(outs)


def next_marker():
    """uid watermark for capture: nodes created after this call have
    uid >= the returned value."""
    return next(_node_uid)
