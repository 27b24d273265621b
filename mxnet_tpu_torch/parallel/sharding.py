"""Sharding strategies: parameter partition rules over the mesh
(counterpart of mxnet_tpu/parallel/sharding.py).

A strategy is data: a list of (parameter-path regex, PartitionSpec) rules,
the batch's mesh axes and the gradient-reduce axes. ``match_partition_rules``
maps a whole parameter tree ('/'-joined key paths, first matching regex
wins, scalars replicated) to a PartitionSpec tree, stacked ``[L, ...]``
layer trees included, where a rule written for the per-layer shape applies
with the leading axis replicated. Specs are fitted to each array: trimmed
to its rank, and a mesh axis that does not divide its dimension is dropped
(divide or replicate). Every function yields the JAX package's spec for
the same path, shape and mesh axis sizes.

On a one-device mesh placing a parameter under any spec is moving it to
the mesh's device. ``named_shardings``, ``host_array`` and
``relayout_params`` place arrays across several devices and come with the
multi-process slice (M10 in ROADMAP.md).
"""
from __future__ import annotations

import re

import numpy as _np

from .mesh import NamedSharding, PartitionSpec as P

__all__ = ["PartitionRules", "ShardingStrategy", "data_parallel", "fsdp",
           "tensor_parallel", "make_param_sharding", "infer_rules_for_block",
           "host_array", "relayout_params", "match_partition_rules",
           "named_shardings"]

_MULTI = "the multi-process slice (M10): arrays placed across devices"


class PartitionRules:
    """Ordered (regex, PartitionSpec) rules; the first match wins."""

    def __init__(self, rules=()):
        self.rules = [(re.compile(pat), P(*spec) if isinstance(spec, tuple)
                       and not isinstance(spec, P) else spec)
                      for pat, spec in rules]

    def spec_for(self, path, shape=None, mesh=None):
        for pat, spec in self.rules:
            if pat.search(path):
                if shape is not None:
                    spec = _fit_spec(spec, shape, mesh)
                return spec
        return P()

    def describe(self):
        """[(pattern, spec)]: the rule table."""
        return tuple((pat.pattern, tuple(spec)) for pat, spec in self.rules)

    def __add__(self, other):
        out = PartitionRules()
        out.rules = list(self.rules) + list(other.rules)
        return out


def _mesh_sizes(mesh):
    """{axis: size} of a DeviceMesh, or None."""
    if mesh is None:
        return None
    return {a: int(s) for a, s in mesh.shape.items()}


def _axis_size(sizes, part):
    """Devices behind one PartitionSpec entry (an axis name or a tuple of
    them)."""
    if part is None:
        return 1
    names = part if isinstance(part, (tuple, list)) else (part,)
    n = 1
    for a in names:
        n *= int(sizes.get(a, 1))
    return n


def _fit_spec(spec, shape, mesh=None):
    """A PartitionSpec fitted to one array: trimmed to its rank, padded
    with None, and (with the mesh known) without axes that do not divide
    their dimension. Scalars are replicated."""
    if not shape:
        return P()
    parts = list(spec)[:len(shape)]
    parts += [None] * (len(shape) - len(parts))
    sizes = _mesh_sizes(mesh)
    if sizes is not None:
        parts = [None if p is not None and (
            _axis_size(sizes, p) <= 1 or dim % _axis_size(sizes, p) != 0)
            else p for p, dim in zip(parts, shape)]
    return P(*parts)


def _map_with_path(tree, fn, path=()):
    """``tree`` with each leaf replaced by ``fn(key path, leaf)``: dicts
    (keys in sorted order), lists and tuples are nodes, None is an empty
    node (the JAX pytree conventions)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(tree[k], fn, path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def match_partition_rules(rules, tree, mesh=None, sep="/",
                          stacked_prefixes=("layers",), strict=False):
    """Map a parameter tree to a same-structure PartitionSpec tree.

    Each leaf's key path is '/'-joined and run through ``rules`` (a
    ``PartitionRules``, a ``ShardingStrategy`` or a raw ``[(regex, spec)]``
    list); the first matching rule's spec is fitted to the leaf. Scalars
    map to ``P()``. Leaves under a ``stacked_prefixes`` subtree whose spec
    is one short of the leaf's rank are stacked ``[L, ...]`` trees: None
    is prepended. With ``strict=True`` an unmatched non-scalar leaf
    raises."""
    rules = _as_rules(rules)

    def spec_of(keys, leaf):
        path = sep.join(keys)
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if not shape:
            return P()
        matched = None
        for pat, spec in rules.rules:
            if pat.search(path):
                matched = spec
                break
        if matched is None:
            if strict:
                raise ValueError(
                    "no partition rule matches param path %r" % path)
            return P()
        if len(matched) == len(shape) - 1 and any(
                path.startswith(pfx + sep) or (sep + pfx + sep) in path
                for pfx in stacked_prefixes):
            matched = P(None, *matched)
        return _fit_spec(matched, shape, mesh)
    return _map_with_path(tree, spec_of)


def _as_rules(rules):
    if isinstance(rules, PartitionRules):
        return rules
    if isinstance(rules, ShardingStrategy):
        return rules.param_rules
    return PartitionRules(rules)


def named_shardings(mesh, spec_tree):
    """PartitionSpec tree -> sharding tree: waits for M10."""
    raise NotImplementedError("named_shardings: " + _MULTI)


class ShardingStrategy:
    """Mesh, parameter rules, the batch's mesh axes and the gradient-reduce
    axes (the mesh axes over which per-device gradients are summed)."""

    def __init__(self, mesh, param_rules=None, batch_axes=("dp",),
                 grad_reduce_axes=("dp",), name="custom"):
        self.mesh = mesh
        self.param_rules = param_rules or PartitionRules()
        self.batch_axes = tuple(batch_axes)
        self.grad_reduce_axes = tuple(grad_reduce_axes)
        self.name = name

    def param_sharding(self, params):
        """{path: array or shape} -> {path: NamedSharding}."""
        return make_param_sharding(self.mesh, params, self.param_rules)

    def batch_spec(self, extra=()):
        return P(self.batch_axes if len(self.batch_axes) > 1
                 else self.batch_axes[0], *extra)

    def batch_sharding(self):
        return NamedSharding(self.mesh, self.batch_spec())

    def __repr__(self):
        return "ShardingStrategy(%s, batch=%s)" % (self.name,
                                                   self.batch_axes)


def make_param_sharding(mesh, params, rules):
    out = {}
    for path, v in params.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        out[path] = NamedSharding(mesh, rules.spec_for(path, shape, mesh))
    return out


def host_array(a):
    """One array staged to host numpy across devices: waits for M10."""
    raise NotImplementedError("host_array: " + _MULTI)


def relayout_params(params, strategy):
    """Re-place a parameter tree on a rebuilt mesh: waits for M10."""
    raise NotImplementedError("relayout_params: " + _MULTI)


def data_parallel(mesh):
    """Pure data parallelism: replicated parameters, the batch on 'dp'."""
    return ShardingStrategy(mesh, PartitionRules(), batch_axes=("dp",),
                            grad_reduce_axes=("dp",), name="data_parallel")


class _FsdpRules(PartitionRules):
    """Every parameter of at least ``min_size`` elements split on its
    largest dimension that ``axis`` divides."""

    def __init__(self, mesh, axis, min_size):
        super().__init__()
        self._n = int(mesh.shape.get(axis, 1))
        self._axis = axis
        self._min_size = min_size

    def spec_for(self, path, shape=None, mesh=None):
        if shape is None or not shape:
            return P()
        if int(_np.prod(shape)) < self._min_size:
            return P()
        n = self._n
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if n and shape[i] % max(n, 1) == 0:
                parts = [None] * len(shape)
                parts[i] = self._axis
                return P(*parts)
        return P()


def fsdp(mesh, axis="fsdp", min_size=1024):
    """ZeRO-3/FSDP: every parameter split on its largest dimension over
    ``axis``; the batch on ('dp', axis)."""
    return ShardingStrategy(mesh, _FsdpRules(mesh, axis, min_size),
                            batch_axes=("dp", axis),
                            grad_reduce_axes=("dp",), name="fsdp")


def tensor_parallel(mesh, extra_rules=(), axis="tp", batch_axes=("dp",)):
    """Megatron-style rules: column-parallel then row-parallel pairs for
    attention and FFN weights ((out, in) layout: column-parallel splits
    dimension 0, row-parallel dimension 1), the embedding split on its
    second dimension, and the transformer's stacked layer-tree names."""
    rules = PartitionRules(list(extra_rules) + [
        (r"(qkv|query|key|value|wq|wk|wv|w1|wi|gate|up|expand|fc1)"
         r".*weight$", (axis, None)),
        (r"(out_proj|wo|w2|down|proj|fc2|contract).*weight$", (None, axis)),
        (r"(qkv|query|key|value|wq|wk|wv|w1|wi|gate|up|expand|fc1)"
         r".*bias$", (axis,)),
        (r"embed.*weight$", (None, axis)),
        (r"(^|/)layers/(wq|wk|wv)$", (None, axis, None)),
        (r"(^|/)layers/wo$", (axis, None, None)),
        (r"(^|/)layers/(w_gate|w_up)$", (None, axis)),
        (r"(^|/)layers/w_down$", (axis, None)),
        (r"(^|/)embed$", (axis, None)),
        (r"(^|/)w_out$", (None, axis)),
    ])
    return ShardingStrategy(mesh, rules, batch_axes=tuple(batch_axes),
                            grad_reduce_axes=("dp",), name="tensor_parallel")


def infer_rules_for_block(block, mesh, strategy="dp"):
    """Choose a strategy for a gluon Block. ``"auto"`` picks
    ``tensor_parallel`` when the mesh has a 'tp' axis over 1 and one of the
    block's parameter names matches a TP rule, else data parallelism."""
    if strategy in ("dp", "data_parallel", "local", "device", "nccl"):
        return data_parallel(mesh)
    if strategy in ("fsdp", "zero", "dist_sync"):
        return fsdp(mesh)
    if strategy in ("tp", "tensor_parallel"):
        return tensor_parallel(mesh)
    if strategy in ("auto", "3d"):
        sizes = _mesh_sizes(mesh) or {}
        tp = tensor_parallel(mesh)
        if int(sizes.get("tp", 1)) > 1 and block is not None:
            names = [p.name for p in block._all_params_list()] \
                if hasattr(block, "_all_params_list") else []
            if any(tp.param_rules.spec_for(n) != P() for n in names):
                return tp
        return data_parallel(mesh)
    raise ValueError("unknown strategy %r" % strategy)
