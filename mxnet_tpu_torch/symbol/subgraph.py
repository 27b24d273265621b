"""Subgraph partitioning extension seam (counterpart of
mxnet_tpu/symbol/subgraph.py; ref: src/operator/subgraph/
subgraph_property.h SubgraphProperty / SubgraphSelector,
build_subgraph.cc): a property selects a connected node set by predicate
and replaces it with ONE fused node whose compute is a user-supplied
compile function.

    class MyProperty(SubgraphProperty):
        name = "bnrelu"
        def select(self, node):            # is this node fusible?
            return node.op in ("BatchNorm", "Activation")
        def compile(self, subgraph, input_names):
            # subgraph: a Symbol over Variables named like the outer
            # graph's inputs; return a callable taking the inputs
            # positionally (tensors). Default: the interpreted subgraph.
            return super().compile(subgraph, input_names)

    fused_sym = partition(sym, MyProperty())

It is how a user hands a chosen subgraph to a custom kernel while the rest
of the graph stays on the default path. Selection grows maximal
single-consumer CHAINS of selected nodes (the conv->bn->relu shape). Fused
nodes are registered as ordinary ops (``_subgraph_<prop>_<n>``), so the
executor, autograd and ``SymbolBlock`` treat them like built-ins: the
default ``compile`` interprets the region with the executor's
``_GraphProgram`` under torch autograd, so gradients flow through it. The
fused nodes, their names and their JSON are the JAX package's for the same
symbol and property.

Limitation, as in the JAX package: BatchNorm moving-statistic updates
inside a fused region are dropped (the fused node is a pure function);
training still differentiates correctly through the batch statistics.
"""
from __future__ import annotations

import itertools

from .symbol import Symbol, _Node, Variable

__all__ = ["SubgraphProperty", "partition"]

_fused_uid = itertools.count()


class SubgraphProperty:
    """Base property (ref: subgraph_property.h SubgraphProperty)."""

    name = "subgraph"

    def select(self, node):
        """Can `node` start or join a fused region?"""
        raise NotImplementedError

    def select_input(self, node, producer):
        """May the region grow from `node` through `producer`?
        Default: the producer must itself be selectable."""
        return self.select(producer)

    def compile(self, subgraph, input_names):
        """subgraph Symbol + ordered input names -> a callable over
        positional input tensors. Override to hand the region to a custom
        kernel; the default interprets the subgraph with the executor's
        program evaluator, and drops the region's moving-statistic updates
        as the JAX package's does."""
        from ..executor import _GraphProgram

        prog = _GraphProgram(subgraph)

        def fused(*arrays, _training=False):
            values = dict(zip(input_names, arrays))
            outs, _aux = prog.run(values, _training)
            return outs[0] if len(outs) == 1 else tuple(outs)

        return fused


def _consumers(symbol, nodes):
    cons = {}
    for n in nodes:
        for src, _oi in n.inputs:
            cons.setdefault(id(src), []).append(n)
    # graph heads are consumers too: a chain MEMBER that is also an
    # output must not be swallowed into a region (it would leave a
    # duplicate unfused copy feeding the head)
    for src, _oi in symbol._outputs:
        cons.setdefault(id(src), []).append("__head__")
    return cons


def partition(symbol, prop):
    """Replace every maximal selected chain in `symbol` with one fused
    node compiled by `prop` (ref: build_subgraph.cc BuildSubgraph)."""
    from ..ops import registry as _registry

    nodes = symbol._topo()
    cons = _consumers(symbol, nodes)
    selected = {id(n): n for n in nodes
                if not n.is_variable() and prop.select(n)}
    # honor select_input vetoes on growth edges
    assigned = {}
    regions = []
    for n in reversed(nodes):  # start from consumers (chain tails)
        if id(n) not in selected or id(n) in assigned:
            continue
        chain = [n]
        node = n
        while True:
            producers = [src for src, _ in node.inputs
                         if id(src) in selected
                         and id(src) not in assigned
                         and prop.select_input(node, src)]
            growable = [p for p in producers
                        if len(cons.get(id(p), [])) == 1]
            if len(growable) != 1:
                break
            node = growable[0]
            chain.append(node)
        chain.reverse()
        for c in chain:
            assigned[id(c)] = len(regions)
        regions.append(chain)

    if not regions:
        return symbol

    # rebuild the graph bottom-up, swapping fused regions in
    replace = {}   # id(old node) -> (new node, out_index base)

    def mapped(src, oi):
        if id(src) in replace:
            new, base = replace[id(src)]
            return (new, base + oi)
        return (remap.get(id(src), src), oi)

    remap = {}
    region_of = {id(c): i for i, chain in enumerate(regions)
                 for c in chain}
    done_regions = set()
    for n in nodes:
        if id(n) in region_of:
            ridx = region_of[id(n)]
            if ridx in done_regions:
                continue
            chain = regions[ridx]
            if n is not chain[-1]:
                continue  # emit the fused node at the chain TAIL's slot
            done_regions.add(ridx)
            in_chain = {id(c) for c in chain}
            # external inputs, in first-use order
            ext, seen = [], set()
            for c in chain:
                for src, oi in c.inputs:
                    if id(src) in in_chain:
                        continue
                    k = (id(src), oi)
                    if k not in seen:
                        seen.add(k)
                        ext.append((src, oi))
            input_names = ["sg_in_%d" % i for i in range(len(ext))]
            # build the inner subgraph over fresh Variables
            inner_map = {}
            for (src, oi), nm in zip(ext, input_names):
                inner_map[(id(src), oi)] = Variable(nm)._outputs[0]
            for c in chain:
                new_inputs = []
                for src, oi in c.inputs:
                    if id(src) in in_chain:
                        inner, ibase = inner_map[(id(src), 0)][0], 0
                        new_inputs.append((inner, oi))
                    else:
                        new_inputs.append(inner_map[(id(src), oi)])
                inner_node = _Node(c.op, c.name, dict(c.attrs),
                                   new_inputs, c.num_outputs)
                inner_map[(id(c), 0)] = (inner_node, 0)
            tail = chain[-1]
            inner_tail = inner_map[(id(tail), 0)][0]
            # expose ALL tail outputs (a multi-output tail like split/
            # BatchNorm may have external consumers of index > 0)
            sub_sym = Symbol([(inner_tail, i)
                              for i in range(tail.num_outputs)])
            fused_fn = prop.compile(sub_sym, input_names)
            op_name = "_subgraph_%s_%d" % (prop.name, next(_fused_uid))
            _registry.register(op_name)(fused_fn)
            fused = _Node(op_name, op_name,
                          {"__fused_subgraph__": prop.name,
                           # serialized inner graph: shape inference
                           # must survive tojson/deepcopy round trips
                           "__fused_json__": sub_sym.tojson(),
                           "__fused_inputs__": list(input_names)},
                          [mapped(src, oi) for src, oi in ext],
                          tail.num_outputs)
            # parsed-cache for inference (rebuilt from the JSON attrs
            # lazily after a round trip; the _cf_cache slot is free on
            # fused nodes — control-flow ops are never fused)
            fused._cf_cache = (sub_sym, list(input_names))
            replace[id(tail)] = (fused, 0)
            continue
        if n.is_variable():
            continue
        new_inputs = [mapped(src, oi) for src, oi in n.inputs]
        if new_inputs != n.inputs:
            nn = _Node(n.op, n.name, dict(n.attrs), new_inputs,
                       n.num_outputs)
            remap[id(n)] = nn

    heads = []
    for node, oi in symbol._outputs:
        if id(node) in replace:
            new, base = replace[id(node)]
            heads.append((new, base + oi))
        else:
            heads.append((remap.get(id(node), node), oi))
    return Symbol(heads)
