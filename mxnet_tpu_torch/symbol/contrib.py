"""``mx.sym.contrib``: symbol-level control flow and contrib ops
(counterpart of mxnet_tpu/symbol/contrib.py; ref:
python/mxnet/symbol/contrib.py foreach :212, while_loop :375, cond :598).

``foreach``, ``while_loop`` and ``cond`` cut the subgraph that the Python
body builds out of the trace and keep it in a control-flow node
(``control_flow.py``), as the JAX package does; the executor runs it.
"""
from __future__ import annotations

from .symbol import Symbol, Variable
from .register import _scoped_name, make_symbol_op_func
from .control_flow import capture_subgraph, next_marker
from .symbol import _Node

__all__ = ["foreach", "while_loop", "cond"]


def _flatten(x, what):
    if isinstance(x, Symbol):
        return [x], 0
    if not isinstance(x, (list, tuple)):
        raise TypeError("%s must be a Symbol or nested list of Symbols, "
                        "got %s" % (what, type(x)))
    flat, fmt = [], []
    for i in x:
        f, s = _flatten(i, what)
        flat.extend(f)
        fmt.append(s)
    return flat, fmt


def _regroup(flat, fmt):
    if fmt == 0:
        return flat[0], flat[1:]
    out = []
    for s in fmt:
        v, flat = _regroup(flat, s)
        out.append(v)
    return out, flat


def _single_out(sym, what):
    if len(sym._outputs) != 1:
        raise ValueError("%s must be single-output symbols" % what)
    return sym._outputs[0]


def _node_outputs(node, n):
    return [Symbol([(node, i)]) for i in range(n)]


def foreach(body, data, init_states, name="foreach"):
    """Scan `body(data_t, states) -> (out, new_states)` over axis 0 of
    `data`, stacking outputs (ref: symbol/contrib.py:212 foreach)."""
    node_name = _scoped_name(name if name != "foreach" else None, "foreach")
    flat_data, data_fmt = _flatten(data, "foreach data")
    if not flat_data:
        raise ValueError("foreach requires at least one input sequence")
    flat_states, state_fmt = _flatten(init_states, "foreach init_states")

    marker = next_marker()
    data_ph = [Variable("%s_data%d" % (node_name, i))
               for i in range(len(flat_data))]
    state_ph = [Variable("%s_state%d" % (node_name, i))
                for i in range(len(flat_states))]
    data_arg, _ = _regroup(data_ph, data_fmt)
    state_arg, _ = _regroup(state_ph, state_fmt)
    outs, new_states = body(data_arg, state_arg)

    flat_out, out_fmt = _flatten([] if outs is None else outs, "foreach out")
    flat_nst, _ = _flatten(new_states, "foreach new_states")
    if len(flat_nst) != len(flat_states):
        raise ValueError("body must return as many states as init_states "
                         "(%d vs %d)" % (len(flat_nst), len(flat_states)))

    placeholders = {}
    roles = {}
    for i, s in enumerate(data_ph):
        n = s._outputs[0][0]
        placeholders[id(n)] = n.name
        roles[n.name] = ("slice", i)
    for j, s in enumerate(state_ph):
        n = s._outputs[0][0]
        placeholders[id(n)] = n.name
        roles[n.name] = ("carry", j)

    heads = [_single_out(s, "foreach outputs") for s in flat_out + flat_nst]
    js, input_names, cuts = capture_subgraph(heads, placeholders, marker)

    n_fixed = len(flat_data) + len(flat_states)
    mapping = []
    for k, vn in enumerate(input_names):
        if vn in roles:
            kind, idx = roles[vn]
            mapping.append([vn, kind, idx])
        else:
            mapping.append([vn, "input",
                            n_fixed + (k - len(placeholders))])

    node_inputs = ([_single_out(s, "foreach data") for s in flat_data]
                   + [_single_out(s, "foreach states") for s in flat_states]
                   + cuts)
    total = len(flat_out) + len(flat_states)
    attrs = {
        "__subgraph__": [js],
        "__subg_inputs__": [mapping],
        "__num_data__": len(flat_data),
        "__num_states__": len(flat_states),
        "__num_out_data__": len(flat_out),
        "__num_outputs__": total,
    }
    node = _Node("_foreach", node_name, attrs, node_inputs,
                 num_outputs=max(total, 1))
    outs_syms = _node_outputs(node, total)
    out_res, rest = _regroup(outs_syms[:len(flat_out)], out_fmt) \
        if flat_out else ([], outs_syms)
    st_res, _ = _regroup(outs_syms[len(flat_out):], state_fmt) \
        if flat_states else ([], [])
    return out_res, st_res


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """`while cond(*loop_vars): step_out, loop_vars = func(*loop_vars)`,
    outputs stacked and zero-padded to `max_iterations`
    (ref: symbol/contrib.py:375 while_loop)."""
    if max_iterations is None:
        raise ValueError("max_iterations must be provided")
    max_iterations = int(max_iterations)
    if max_iterations <= 0:
        raise ValueError("max_iterations must be positive")
    node_name = _scoped_name(name if name != "while_loop" else None,
                             "while_loop")
    flat_vars, var_fmt = _flatten(loop_vars, "while_loop loop_vars")
    if not flat_vars:
        raise ValueError("while_loop requires at least one loop var")

    marker = next_marker()
    var_ph = [Variable("%s_var%d" % (node_name, i))
              for i in range(len(flat_vars))]
    var_arg, _ = _regroup(var_ph, var_fmt)
    var_args = var_arg if isinstance(var_arg, list) else [var_arg]

    pred = cond(*var_args)
    step_out, new_vars = func(*var_args)
    flat_out, out_fmt = _flatten([] if step_out is None else step_out,
                                 "while_loop step_output")
    flat_nv, _ = _flatten(new_vars, "while_loop new_loop_vars")
    if len(flat_nv) != len(flat_vars):
        raise ValueError("func must return as many loop_vars as it takes "
                         "(%d vs %d)" % (len(flat_nv), len(flat_vars)))

    placeholders = {}
    roles = {}
    for j, s in enumerate(var_ph):
        n = s._outputs[0][0]
        placeholders[id(n)] = n.name
        roles[n.name] = ("carry", j)

    js_c, names_c, cuts_c = capture_subgraph(
        [_single_out(pred, "while_loop cond")], placeholders, marker)
    heads_b = [_single_out(s, "while_loop outputs")
               for s in flat_out + flat_nv]
    js_b, names_b, cuts_b = capture_subgraph(heads_b, placeholders, marker)

    # merge closure cuts of both subgraphs into one node-input list
    node_inputs = [_single_out(s, "while_loop loop_vars")
                   for s in flat_vars]
    cut_index = {}
    for src, oi in cuts_c + cuts_b:
        if (id(src), oi) not in cut_index:
            cut_index[(id(src), oi)] = len(node_inputs)
            node_inputs.append((src, oi))

    def mapping_of(input_names, cuts):
        m = []
        ci = iter(cuts)
        for vn in input_names:
            if vn in roles:
                kind, idx = roles[vn]
                m.append([vn, kind, idx])
            else:
                src, oi = next(ci)
                m.append([vn, "input", cut_index[(id(src), oi)]])
        return m

    total = len(flat_out) + len(flat_vars)
    attrs = {
        "__subgraph__": [js_c, js_b],
        "__subg_inputs__": [mapping_of(names_c, cuts_c),
                            mapping_of(names_b, cuts_b)],
        "__num_vars__": len(flat_vars),
        "__num_out_data__": len(flat_out),
        "__num_outputs__": total,
        "max_iterations": max_iterations,
    }
    node = _Node("_while_loop", node_name, attrs, node_inputs,
                 num_outputs=max(total, 1))
    outs_syms = _node_outputs(node, total)
    out_res, _ = _regroup(outs_syms[:len(flat_out)], out_fmt) \
        if flat_out else ([], [])
    var_res, _ = _regroup(outs_syms[len(flat_out):], var_fmt)
    return out_res, var_res


def cond(pred, then_func, else_func, name="cond"):
    """Run one of two subgraphs on a scalar predicate Symbol
    (ref: symbol/contrib.py:598 cond)."""
    node_name = _scoped_name(name if name != "cond" else None, "cond")

    marker = next_marker()
    p = pred
    t = then_func()
    e = else_func()
    flat_t, t_fmt = _flatten(t, "cond then outputs")
    flat_e, _ = _flatten(e, "cond else outputs")
    if len(flat_t) != len(flat_e):
        raise ValueError("then_func and else_func must return the same "
                         "number of outputs (%d vs %d)"
                         % (len(flat_t), len(flat_e)))

    js_p, names_p, cuts_p = capture_subgraph(
        [_single_out(p, "cond pred")], {}, marker)
    js_t, names_t, cuts_t = capture_subgraph(
        [_single_out(s, "cond then") for s in flat_t], {}, marker)
    js_e, names_e, cuts_e = capture_subgraph(
        [_single_out(s, "cond else") for s in flat_e], {}, marker)

    node_inputs = []
    cut_index = {}
    for src, oi in cuts_p + cuts_t + cuts_e:
        if (id(src), oi) not in cut_index:
            cut_index[(id(src), oi)] = len(node_inputs)
            node_inputs.append((src, oi))

    def mapping_of(input_names, cuts):
        m = []
        ci = iter(cuts)
        for vn in input_names:
            src, oi = next(ci)
            m.append([vn, "input", cut_index[(id(src), oi)]])
        return m

    total = len(flat_t)
    attrs = {
        "__subgraph__": [js_p, js_t, js_e],
        "__subg_inputs__": [mapping_of(names_p, cuts_p),
                            mapping_of(names_t, cuts_t),
                            mapping_of(names_e, cuts_e)],
        "__num_outputs__": total,
    }
    node = _Node("_cond", node_name, attrs, node_inputs,
                 num_outputs=max(total, 1))
    outs_syms = _node_outputs(node, total)
    res, _ = _regroup(outs_syms, t_fmt)
    return res


# curated contrib op surface, mirroring nd.contrib (boolean_mask,
# arange_like, quantize, ...) via the shared registry
def _expose(*names):
    from ..ops import registry as _registry
    for n in names:
        try:
            opdef = _registry.get_op(n)
        except Exception:
            continue
        globals()[n] = make_symbol_op_func(opdef, n)
        __all__.append(n)


_expose("boolean_mask", "arange_like", "quantize", "dequantize",
        "quantize_v2", "div_sqrt_dim", "index_copy", "index_array",
        "getnnz", "edge_id", "interleaved_matmul_selfatt_qk",
        "interleaved_matmul_selfatt_valatt")
