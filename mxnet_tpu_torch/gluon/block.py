"""Block / HybridBlock on ``torch.nn.Module`` (counterpart of
mxnet_tpu/gluon/block.py).

Blocks keep the MXNet surface: name prefixes and ``name_scope``,
``initialize``, ``collect_params``, ``_collect_params_with_prefix``,
``hybridize`` (a flag) and ``cast``. Children are torch submodules, so the
structural names of ``_collect_params_with_prefix`` ("features.0.weight")
are also the keys of ``state_dict()``. ``hybrid_forward(F, x, **params)``
receives ``F``, the module of plain op functions (``mxnet_tpu_torch.nd``),
and the parameters' tensors.

Blocks run eagerly. Outside ``autograd.record()`` a block call runs under
``torch.no_grad()``; under recording its tensor output is an
``autograd.Head``, whose ``backward()`` seeds ones like MXNet's.

A block called with NDArrays unwraps them, runs on the tensors and wraps
its outputs as NDArrays; called with tensors it returns tensors. The
children it calls get tensors, so nothing is wrapped inside a forward.
``save_parameters``/``load_parameters`` write and read the reference's
``.params`` format (``nd.save``), keyed by structural name.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import ndarray as _F
from ..context import Context
from ..ndarray.ndarray import NDArray, wrap as _wrap
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "report_aux_update"]


class _AuxCollector(threading.local):
    """Collects the (param, new_data) running-statistic updates that a
    forward under ``parallel.train.functional_call`` reports, so that the
    call returns them instead of writing them. Each entry of ``stack`` is
    a list that takes the updates, or None to drop them (a remat
    recompute replays a forward whose updates were collected already)."""

    def __init__(self):
        self.stack = []

    def active(self):
        return bool(self.stack)

    def add(self, param, new_data):
        if self.stack[-1] is not None:
            self.stack[-1].append((param, new_data))


_AUX = _AuxCollector()


class _BlockScope(threading.local):
    def __init__(self):
        self.counters = {}
        self.prefix = ""     # active name_scope() prefix
        self.stack = []      # per-scope counters (numbering restarts)


_SCOPE = _BlockScope()


def _gen_prefix(hint):
    counters = _SCOPE.stack[-1] if _SCOPE.stack else _SCOPE.counters
    cnt = counters.get(hint, 0)
    counters[hint] = cnt + 1
    return _SCOPE.prefix + "%s%d_" % (hint, cnt)


class Block(torch.nn.Module):
    """Base for all layers and models."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        if prefix is not None:
            self._prefix = (_SCOPE.prefix + prefix) if prefix else prefix
        else:
            self._prefix = _gen_prefix(self._alias())
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}
        self._active = False

    def _alias(self):
        return type(self).__name__.lower()

    # Parameters live in _reg_params (MXNet surface) and their tensors in
    # torch's _parameters/_buffers under the same attribute name.
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is None:
                raise AttributeError("assign parameters after "
                                     "Block.__init__()")
            reg[name] = value
            self._params._params[value.name] = value
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            return reg[name]
        return super().__getattr__(name)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self):
        return self._params

    def name_scope(self):
        """Children created inside the scope nest under this block's
        prefix, and name numbering restarts per scope."""
        block = self

        class _NS:
            def __enter__(self_ns):
                self_ns._saved_prefix = _SCOPE.prefix
                _SCOPE.prefix = block._prefix
                _SCOPE.stack.append({})
                return block

            def __exit__(self_ns, *a):
                _SCOPE.prefix = self_ns._saved_prefix
                _SCOPE.stack.pop()
                return None
        return _NS()

    def _child_blocks(self):
        return [(n, c) for n, c in self._modules.items() if c is not None]

    def collect_params(self, select=None):
        """All parameters of this block and its children, by full name;
        ``select`` is a regex on that name."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            ret.update({n: p for n, p in self._params.items()
                        if pat.match(n)})
        for _, child in self._child_blocks():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Structural parameter paths ("features.0.weight"), stable across
        model instances and equal to the JAX package's."""
        out = {}
        for name, p in self._reg_params.items():
            out[prefix + name] = p
        for cname, child in self._child_blocks():
            out.update(child._collect_params_with_prefix(
                prefix + cname + "."))
        return out

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize all parameters on ``ctx`` (default ``gpu(0)``;
        raises with no CUDA device unless a CPU context is given)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        """Cast every parameter (running statistics included) to
        ``dtype``."""
        for _, child in self._child_blocks():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """Mark this block and its children hybridized (``_active``), which
        ``gluon.train_step`` requires to run fused, as in the JAX package.
        The forward still runs eagerly; capturing it in a CUDA graph is
        later work."""
        self._active = bool(active)
        for _, child in self._child_blocks():
            child.hybridize(active, **kwargs)

    def _all_params_list(self):
        """Every parameter of the block tree once, in structural-name
        order."""
        seen, out = set(), []
        for _, p in sorted(self._collect_params_with_prefix().items()):
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
        return out

    # -- persistence (the reference's block.py:366 save_parameters, :408) ---
    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters with ``nd.save``, keyed by structural name
        ("features.0.weight"); ``deduplicate`` saves a shared parameter
        once, under its first name."""
        params = self._collect_params_with_prefix()
        arg, seen = {}, set()
        for n, p in params.items():
            if p._data is None or (deduplicate and id(p) in seen):
                continue
            seen.add(id(p))
            arg[n] = p.data()
        _F.save(filename, arg)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load what ``save_parameters`` (or, by full names, an older
        ``ParameterDict.save``) wrote. Each value is cast to its
        parameter's dtype, or with ``cast_dtype`` and ``dtype_source=
        "saved"`` the parameter takes the file's. A parameter without data
        yet is placed on ``ctx`` (default: the current context)."""
        loaded = _F.load(filename, ctx=Context("cpu"))
        canonical = self._collect_params_with_prefix()
        if loaded and canonical and not any(k in canonical for k in loaded):
            # full-name keys, as an older ParameterDict.save wrote them
            canonical = {}
            for n, p in self.collect_params().items():
                short = n[len(self._prefix):] \
                    if n.startswith(self._prefix) else n
                canonical[short] = p
        ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        for k, v in loaded.items():
            if k in canonical:
                if cast_dtype and dtype_source == "saved":
                    canonical[k].cast(v._data.dtype)
                canonical[k].set_data(v, ctx=ctx)
            elif not ignore_extra:
                raise KeyError("Parameter %r in file not found in Block" % k)
        if not allow_missing:
            missing = [k for k, p in canonical.items()
                       if p._data is None and p._deferred_init is None
                       and k not in loaded]
            if missing:
                raise KeyError("Missing parameters in file: %s" % missing)

    save_params = save_parameters
    load_params = load_parameters

    def summary(self, *inputs):
        """Run the block on ``inputs`` (which finishes deferred shapes) and
        return "<name>: <n> parameters", n the count of parameter values
        (running statistics included)."""
        self(*inputs)
        n = sum(p._tensor().numel() for p in self.collect_params().values()
                if p._data is not None)
        return "%s: %d parameters" % (self.name, n)

    def __call__(self, *args, **kwargs):
        for a in args:
            if isinstance(a, NDArray):
                return _nd_call(self, args, kwargs)
        for a in kwargs.values():
            if isinstance(a, NDArray):
                return _nd_call(self, args, kwargs)
        if not autograd.is_recording():
            if torch.is_grad_enabled():
                with torch.no_grad():
                    return super().__call__(*args, **kwargs)
            return super().__call__(*args, **kwargs)
        out = super().__call__(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.requires_grad \
                and not isinstance(out, autograd.Head):
            out = out.as_subclass(autograd.Head)
        return out


def _nd_call(block, args, kwargs):
    """A block called with NDArrays: the call on their tensors, its
    outputs wrapped."""
    out = block(*[a._data if isinstance(a, NDArray) else a for a in args],
                **{k: v._data if isinstance(v, NDArray) else v
                   for k, v in kwargs.items()})
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) if isinstance(o, torch.Tensor) else o
                         for o in out)
    return _wrap(out) if isinstance(out, torch.Tensor) else out


class HybridBlock(Block):
    """A block written as ``hybrid_forward(F, x, *args, **params)``."""

    def forward(self, x, *args):
        params = {}
        for name, p in self._reg_params.items():
            try:
                params[name] = p._tensor()
            except DeferredInitializationError:
                self._infer_param_shapes(x, *args)
                params[name] = p._tensor()
        return self.hybrid_forward(_F, x, *args, **params)

    def _infer_param_shapes(self, *args):
        """Finish deferred init from the shapes ``_shape_hint`` reads off
        the inputs."""
        hinted = self._shape_hint(*args)
        for p in self._reg_params.values():
            if p._data is None and p._deferred_init is not None:
                shape = hinted.get(p)
                if shape is None:
                    raise DeferredInitializationError(
                        "cannot infer shape for %s" % p.name)
                p._finish_deferred_init(shape)

    def _shape_hint(self, *args):
        """Layers map input shapes to parameter shapes here."""
        return {}

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def report_aux_update(param, new_data):
    """Publish a running-statistic update. Inside
    ``parallel.train.functional_call`` it is collected (detached) and
    returned by the call; otherwise, the eager paths (``Trainer``,
    ``gluon.train_step``), it is written in place, outside the graph
    (also under recording)."""
    if _AUX.active():
        _AUX.add(param, new_data.detach())
        return
    with torch.no_grad():
        param._tensor().copy_(new_data)
