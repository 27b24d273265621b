"""Symbol: declarative graph nodes (counterpart of
mxnet_tpu/symbol/symbol.py; ref: python/mxnet/symbol/symbol.py,
nnvm::Symbol).

A Symbol is a handle onto (node, output) pairs of a graph of ``_Node``s;
``bind`` gives an ``Executor`` (``executor.py``) that interprets the graph
on tensors. The JSON of ``tojson``/``save`` is the JAX package's, which is
the reference's nnvm graph JSON (nodes, arg_nodes, heads), so a file that
either package writes loads in the other; ``load_json`` also reads the
reference's 1.x and pre-1.0 files.
"""
from __future__ import annotations

import json
import threading

import numpy as _np

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones"]

_name_lock = threading.local()


def _counter():
    if not hasattr(_name_lock, "counts"):
        _name_lock.counts = {}
    return _name_lock.counts


def _auto_name(hint):
    # an active NameManager/Prefix scope takes over naming
    from ..name import current as _current_nm
    nm = _current_nm()
    if nm is not None:
        return nm.get(None, hint)
    counts = _counter()
    idx = counts.get(hint, 0)
    counts[hint] = idx + 1
    return "%s%d" % (hint, idx)


# parameter names that denote graph inputs (tensor-valued) in op signatures
INPUT_PARAM_NAMES = (
    "x", "data", "lhs", "rhs", "weight", "bias", "gamma", "beta",
    "moving_mean", "moving_var", "label", "grid", "indices", "index",
    "condition", "cond", "a", "b", "y", "mu", "sigma", "low", "high",
    "lam", "alpha",
    "loc", "scale", "shape_like", "data1", "data2", "rois", "anchors",
    "cls_pred", "loc_pred", "parameters", "state", "state_cell", "like",
    "sequence_length", "A", "B", "C",
)

# aux-state naming convention (BatchNorm moving stats et al.)
AUX_SUFFIXES = ("moving_mean", "moving_var", "running_mean", "running_var")


import itertools

_node_uid = itertools.count()


class _Node:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "_shape",
                 "uid", "_cf_cache")

    def __init__(self, op, name, attrs=None, inputs=(), num_outputs=1,
                 shape=None):
        self.op = op               # registry op name; None for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)  # list[(Symbol's node, out_index)]
        self.num_outputs = num_outputs
        self._shape = shape        # user-annotated shape for variables
        self.uid = next(_node_uid)  # creation order, for subgraph cutting
        self._cf_cache = None      # parsed control-flow subgraph programs

    def is_variable(self):
        return self.op is None


class Symbol:
    """A (multi-)output handle onto graph nodes (ref: symbol.py Symbol)."""

    def __init__(self, outputs):
        # outputs: list[(node, out_index)]
        self._outputs = list(outputs)

    # -- construction helpers ---------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group[%d]" % len(self._outputs))

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            for i, (node, oi) in enumerate(self._outputs):
                if node.name == idx:
                    return Symbol([self._outputs[i]])
            raise ValueError("no output named %r" % idx)
        out = self._outputs[idx]
        if isinstance(idx, slice):
            return Symbol(out)
        return Symbol([out])

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    # -- graph traversal ---------------------------------------------------
    def _topo(self):
        seen = {}
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen[id(node)] = True
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._outputs:
            visit(node)
        return order

    def list_arguments(self):
        """Free variables in topo order, aux excluded (ref: symbol.py)."""
        return [n.name for n in self._topo() if n.is_variable()
                and not n.name.endswith(AUX_SUFFIXES)]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo() if n.is_variable()
                and n.name.endswith(AUX_SUFFIXES)]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.is_variable()]

    def list_outputs(self):
        names = []
        for node, oi in self._outputs:
            if node.num_outputs > 1:
                names.append("%s_output%d" % (node.name, oi))
            else:
                names.append("%s_output" % node.name)
        return names

    def get_internals(self):
        outs = []
        for n in self._topo():
            if not n.is_variable():
                for i in range(n.num_outputs):
                    outs.append((n, i))
            else:
                outs.append((n, 0))
        return Symbol(outs)

    def get_children(self):
        kids = []
        for node, _ in self._outputs:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    @property
    def attr_dict(self):
        return {n.name: dict(n.attrs) for n in self._topo()}

    def attr(self, key):
        return self._outputs[0][0].attrs.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0].attrs.update(
            {k: str(v) for k, v in kwargs.items()})

    # -- composition --------------------------------------------------------
    def __call__(self, *args, **kwargs):
        raise NotImplementedError("composition via call is not supported; "
                                  "pass symbols as op arguments")

    # arithmetic (mirrors ndarray ops on symbols)
    def __add__(self, other):
        return _binop("elemwise_add", "_plus_scalar", self, other)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return _binop("elemwise_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        return _binop("_rminus_scalar", None, self, other, swap=True)

    def __mul__(self, other):
        return _binop("elemwise_mul", "_mul_scalar", self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return _binop("elemwise_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        return _binop("_rdiv_scalar", None, self, other, swap=True)

    def __pow__(self, other):
        return _binop("_power", "_power_scalar", self, other)

    def __neg__(self):
        return self.__mul__(-1.0)

    def __mod__(self, other):
        return _binop("mod", "_mod_scalar", self, other)

    def __eq__(self, other):
        if other is None:
            return False
        return _binop("equal", "_equal_scalar", self, other)

    def __ne__(self, other):
        if other is None:
            return True
        return _binop("not_equal", "_not_equal_scalar", self, other)

    def __gt__(self, other):
        return _binop("greater", "_greater_scalar", self, other)

    def __ge__(self, other):
        return _binop("greater_equal", "_greater_equal_scalar", self, other)

    def __lt__(self, other):
        return _binop("lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _binop("lesser_equal", "_lesser_equal_scalar", self, other)

    __hash__ = object.__hash__

    def __bool__(self):
        # ref: symbol.py:123 — a Symbol has no runtime value to branch on;
        # use sym.contrib.cond instead
        raise TypeError("Symbol cannot be used in boolean context; it has "
                        "no value until bound (use sym.contrib.cond)")

    def __getattr__(self, name):
        # registry ops as methods (`s.sum()`, `s.reshape(...)`), like the
        # reference's generated Symbol methods (ref: symbol/register.py)
        if name.startswith("_"):
            raise AttributeError(name)
        from ..ops import registry as _reg
        try:
            _reg.get_op(name)
        except KeyError:
            raise AttributeError("Symbol has no attribute %r" % name)
        from .register import make_symbol_op_func
        fn = make_symbol_op_func(_reg.get_op(name), name)

        def method(*args, **kwargs):
            return fn(self, *args, **kwargs)

        method.__name__ = name
        return method

    # -- shape/type inference ----------------------------------------------
    def infer_shape(self, *args, **kwargs):
        from .infer import infer_shape as _infer
        return _infer(self, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        from .infer import infer_shape as _infer
        return _infer(self, partial=True, *args, **kwargs)

    def infer_type(self, **kwargs):
        args = self.list_arguments()
        dt = _np.float32
        return ([kwargs.get(a, dt) for a in args], [dt] * len(self._outputs),
                [dt] * len(self.list_auxiliary_states()))

    # -- serialization ------------------------------------------------------
    def tojson(self):
        nodes = self._topo()
        index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_variable() else n.op,
                "name": n.name,
                "attrs": {k: json.dumps(v) for k, v in n.attrs.items()},
                "inputs": [[index[id(src)], oi, 0] for src, oi in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable()]
        heads = [[index[id(node)], oi, 0] for node, oi in self._outputs]
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": arg_nodes,
            "heads": heads,
            "attrs": {"mxnet_tpu_version": [1, "1.6.0.tpu1"]},
        }, indent=2)

    def save(self, fname):
        # atomic publication: a crash mid-write must not leave a
        # truncated -symbol.json next to a valid .params file
        from ..base import atomic_write
        with atomic_write(fname, "w") as f:
            f.write(self.tojson())

    # -- evaluation / binding ----------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """The outputs on ``kwargs`` (name: array) in inference mode."""
        exe = self.bind(ctx, args=kwargs)
        return exe.forward()

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An Executor over ``args`` on ``ctx`` (default: the current
        context, ``gpu(0)``). ``group2ctx`` places node groups on several
        devices, which waits for the multi-device slice: it raises."""
        from ..executor import Executor
        return Executor(self, ctx, args=args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **kwargs):
        """An Executor with arrays of zeros of the shapes that
        ``infer_shape(**kwargs)`` gives."""
        from ..executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict,
                                    group2ctx=group2ctx, **kwargs)

    # convenience used by module/model code
    def debug_str(self):
        lines = []
        for n in self._topo():
            kind = "Variable" if n.is_variable() else n.op
            lines.append("%s %s <- %s" % (kind, n.name,
                                          [s.name for s, _ in n.inputs]))
        return "\n".join(lines)


def _binop(op_name, scalar_op, lhs, rhs, swap=False):
    from .register import create_symbol_op
    if isinstance(rhs, Symbol):
        return create_symbol_op(op_name, [lhs, rhs], {})
    # scalar path
    if swap:
        return create_symbol_op(op_name, [lhs], {"scalar": float(rhs)})
    return create_symbol_op(scalar_op, [lhs], {"scalar": float(rhs)})


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """ref: symbol.py var/Variable."""
    from ..attribute import apply as _attr_apply
    attrs = _attr_apply(attr)
    if shape is not None:
        attrs["__shape__"] = list(shape)
    if dtype is not None:
        attrs["__dtype__"] = str(_np.dtype(dtype))
    if init is not None:
        # serialized so it survives tojson round-trips; honored by
        # Initializer.__call__ (ref: symbol.py var() __init__ attr)
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    if lr_mult is not None:
        attrs["__lr_mult__"] = float(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = float(wd_mult)
    node = _Node(None, name, attrs, shape=tuple(shape) if shape else None)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _parse_attr_value(v):
    """Attr values come in three dialects: this framework's tojson
    (JSON-encoded), the reference 1.x dmlc strings ("(3, 3)", "False",
    "64"), and plain strings ("relu"). Try them in that order
    (ref: src/nnvm/legacy_json_util.cc does the same normalization)."""
    if not isinstance(v, str):
        return v
    try:
        return json.loads(v)
    except (ValueError, TypeError):
        pass
    import ast
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load_json(json_str):
    """Parse a symbol JSON — this framework's own output, the
    reference's 1.x format (`attrs`, 3-tuple inputs, mxnet_version
    attr), or the pre-1.0 legacy format (`param` + `attr` per node,
    2-tuple inputs; ref: src/nnvm/legacy_json_util.cc UpgradeJSON_*).
    Compat is proven against fixture files emitted by real MXNet
    (tests/fixtures/ref_mxnet_*_symbol.json)."""
    g = json.loads(json_str)
    nodes = []
    for jn in g["nodes"]:
        raw = dict(jn.get("attrs") or jn.get("param") or {})
        attrs = {k: _parse_attr_value(v) for k, v in raw.items()}
        # legacy per-node metadata (ctx_group/lr_mult/wd_mult...) rides
        # in "attr"; keep it out of kernel kwargs via the __-prefix
        for k, v in (jn.get("attr") or {}).items():
            attrs.setdefault("__%s__" % k, v)
        if jn["op"] == "null":
            node = _Node(None, jn["name"], attrs)
        else:
            node = _Node(jn["op"], jn["name"], attrs)
        nodes.append(node)
    for jn, node in zip(g["nodes"], nodes):
        node.inputs = [(nodes[e[0]], e[1]) for e in jn["inputs"]]
        if not node.is_variable():
            node.num_outputs = _num_outputs_of(node)
            if node.op in ("BatchNorm", "batch_norm") \
                    and len(node.inputs) == 3:
                # pre-1.0 BatchNorm had implicit moving stats; the
                # reference's JSON upgrade adds the aux inputs
                # (ref: src/nnvm/legacy_json_util.cc UpgradeJSON_000800)
                for suffix in ("moving_mean", "moving_var"):
                    aux = _Node(None, "%s_%s" % (node.name, suffix))
                    node.inputs.append((aux, 0))
            if "__input_names__" not in node.attrs:
                # reference JSON carries no input-name metadata; recover
                # it from the op signature so parameter-shape hinting
                # works on loaded graphs (ref: nnvm op FListInputNames)
                from .register import op_input_names
                from ..ops import registry as _registry
                try:
                    names = op_input_names(_registry.get_op(node.op))
                except KeyError:
                    names = None
                if names and len(names) >= len(node.inputs):
                    node.attrs["__input_names__"] = \
                        list(names[:len(node.inputs)])
    return Symbol([(nodes[e[0]], e[1]) for e in g["heads"]])


def _num_outputs_of(node):
    # multi-output ops known to the framework; attr-dependent counts
    # mirror the reference's per-op FNumOutputs (ref: nnvm op registry)
    if "__num_outputs__" in node.attrs:
        return int(node.attrs["__num_outputs__"])
    if node.op in ("BatchNorm", "batch_norm"):
        return 3
    if node.op in ("split", "SliceChannel"):
        return int(node.attrs.get("num_outputs", 1))
    if node.op in ("RNN", "rnn"):
        if node.attrs.get("state_outputs"):
            return 3 if node.attrs.get("mode", "lstm") == "lstm" else 2
        return 1
    if node.op == "moments":
        return 2
    if node.op == "topk":
        return 2 if node.attrs.get("ret_typ") == "both" else 1
    from ..ops import registry as _reg
    try:
        declared = _reg.get_op(node.op).num_outputs
    except KeyError:
        declared = None
    if declared is not None:
        return declared(node.attrs) if callable(declared) else int(declared)
    return 1


def zeros(shape, dtype="float32", name=None, **kwargs):
    from .register import create_symbol_op
    return create_symbol_op("_zeros", [], {"shape": shape, "dtype": dtype},
                            name=name)


def ones(shape, dtype="float32", name=None, **kwargs):
    from .register import create_symbol_op
    return create_symbol_op("_ones", [], {"shape": shape, "dtype": dtype},
                            name=name)
