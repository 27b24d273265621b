"""The ``mx.sym`` op functions, made from the op registry (counterpart of
mxnet_tpu/symbol/register.py; ref: python/mxnet/symbol/register.py).

Every registered op gets a function that takes Symbols (positionally or by
input name) and its static parameters, makes the parameter Variables it is
not given (``<node>_weight``, ``_bias``, ``_gamma``, ``_beta``,
``_moving_mean``, ``_moving_var``, ``_label``), and returns the new node's
Symbol. An op's inputs are its explicit ``input_names`` or the leading
parameters of its function whose names are in ``INPUT_PARAM_NAMES``, as
the JAX package reads them; the port's op functions keep the JAX
package's parameter names, so both give a node the same inputs.
"""
from __future__ import annotations

import inspect

from ..ops import registry as _registry
from .symbol import Symbol, _Node, _auto_name, Variable, INPUT_PARAM_NAMES

__all__ = ["populate", "create_symbol_op", "op_input_names"]

_INPUT_CACHE = {}  # op name -> its input names (None: variadic)


def op_input_names(opdef):
    """Ordered tensor-input parameter names of an op fn; None if variadic."""
    if opdef.input_names == _registry.VARIADIC:
        return None
    if opdef.input_names is not None:
        return list(opdef.input_names)
    if opdef.name in _INPUT_CACHE:
        return _INPUT_CACHE[opdef.name]
    sig = inspect.signature(opdef.fn)
    names = []
    variadic = False
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            variadic = True
            break
        if p.name in INPUT_PARAM_NAMES:
            names.append(p.name)
        elif p.name in ("key", "_training"):
            continue
        else:
            # first non-input, non-special param ends the input prefix
            break
    res = None if variadic else names
    _INPUT_CACHE[opdef.name] = res
    return res


def _scoped_name(name, hint):
    """Node naming through the active NameManager/Prefix: explicit names
    also pass through it, so Prefix('net_') prefixes them like the
    reference."""
    from ..name import current as _current_nm
    nm = _current_nm()
    if nm is not None:
        return nm.get(name, hint)
    return name or _auto_name(hint)


def create_symbol_op(op_name, sym_inputs, attrs, name=None):
    """Build a Symbol node for `op_name` with the given input Symbols."""
    opdef = _registry.get_op(op_name)
    node_name = _scoped_name(name, opdef.name.lower())
    inputs = []
    for s in sym_inputs:
        assert isinstance(s, Symbol), type(s)
        assert len(s._outputs) == 1, "op inputs must be single-output symbols"
        inputs.append(s._outputs[0])
    from ..attribute import apply as _attr_apply
    attrs = _attr_apply(attrs)
    node = _Node(opdef.name, node_name, attrs, inputs)
    from .symbol import _num_outputs_of
    node.num_outputs = _num_outputs_of(node)
    return Symbol([(node, 0)])


def make_symbol_op_func(opdef, public_name):
    input_names = op_input_names(opdef)

    def op_func(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        node_name = _scoped_name(name, opdef.name.lower())
        sym_inputs = []
        attrs = {}
        if input_names is None:
            # variadic op: all positional Symbol args are inputs
            for a in args:
                if isinstance(a, Symbol):
                    sym_inputs.append(a)
                else:
                    raise TypeError("positional args must be Symbols")
            for k, v in kwargs.items():
                if isinstance(v, Symbol):
                    sym_inputs.append(v)
                else:
                    attrs[k] = v
        else:
            # the reference's docs/wrappers spell the first input `data`
            # while many registry fns name it `x` (and vice versa) —
            # accept either spelling
            for given, actual in (("data", "x"), ("x", "data")):
                if given in kwargs and given not in input_names \
                        and actual in input_names and actual not in kwargs:
                    kwargs[actual] = kwargs.pop(given)
            provided = {}
            pos = list(args)
            for iname in input_names:
                if iname in kwargs:
                    provided[iname] = kwargs.pop(iname)
                elif pos:
                    provided[iname] = pos.pop(0)
            # remaining kwargs are static attrs; a Symbol under a name the
            # op doesn't declare as an input would be silently dropped
            # from the graph — make that an error instead
            for k, v in kwargs.items():
                if isinstance(v, Symbol):
                    if k not in input_names:
                        raise TypeError(
                            "%s got Symbol for unknown input %r "
                            "(inputs: %s)" % (public_name, k, input_names))
                    provided[k] = v
                else:
                    attrs[k] = v
            no_bias = bool(attrs.get("no_bias", False))
            for iname in input_names:
                v = provided.get(iname)
                if v is None and iname in provided:
                    # explicit None (e.g. bias=None passed positionally)
                    # must not survive into the input list
                    del provided[iname]
                if v is None:
                    if iname == "bias" and no_bias:
                        continue
                    if iname in ("label",):
                        v = Variable("%s_%s" % (node_name, iname))
                    elif iname in ("weight", "bias", "gamma", "beta",
                                   "moving_mean", "moving_var"):
                        # auto-created parameter variable (ref behavior)
                        v = Variable("%s_%s" % (node_name, iname))
                    else:
                        continue
                if not isinstance(v, Symbol):
                    raise TypeError("input %s must be a Symbol, got %s"
                                    % (iname, type(v)))
                provided[iname] = v
            if any(isinstance(p, Symbol) for p in pos):
                raise TypeError(
                    "%s got %d unexpected positional Symbol input(s) "
                    "beyond its declared inputs %s"
                    % (public_name, sum(isinstance(p, Symbol) for p in pos),
                       input_names))
            sym_inputs = [provided[i] for i in input_names if i in provided]
            attrs["__input_names__"] = [i for i in input_names
                                        if i in provided]
        inputs = []
        for s in sym_inputs:
            assert len(s._outputs) == 1, \
                "op inputs must be single-output symbols"
            inputs.append(s._outputs[0])
        from ..attribute import apply as _attr_apply
        merged = _attr_apply(None)
        merged.update(attrs)           # op params
        if attr:
            merged.update(attr)        # explicit per-call attrs win
        attrs = merged
        node = _Node(opdef.name, node_name, attrs, inputs)
        from .symbol import _num_outputs_of
        node.num_outputs = _num_outputs_of(node)
        # BatchNorm exposes one visible output in symbolic graphs (the
        # reference's NumVisibleOutputs=1 — mean/var are internal); other
        # multi-output ops return a group symbol so unpacking works
        if node.op in ("BatchNorm", "batch_norm"):
            return Symbol([(node, 0)])
        return Symbol([(node, i) for i in range(node.num_outputs)])

    op_func.__name__ = public_name
    op_func.__doc__ = opdef.fn.__doc__
    return op_func


def populate(namespace_dict):
    for name in _registry.list_ops():
        opdef = _registry.get_op(name)
        if name not in namespace_dict:
            namespace_dict[name] = make_symbol_op_func(opdef, name)
