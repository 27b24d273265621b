"""Block / HybridBlock on ``torch.nn.Module`` (counterpart of
mxnet_tpu/gluon/block.py).

Blocks keep the MXNet surface: name prefixes and ``name_scope``,
``initialize``, ``collect_params``, ``_collect_params_with_prefix``,
``hybridize`` and ``cast``. Children are torch submodules, so the
structural names of ``_collect_params_with_prefix`` ("features.0.weight")
are also the keys of ``state_dict()``. ``hybrid_forward(F, x, **params)``
receives ``F``, the module of plain op functions (``mxnet_tpu_torch.nd``),
and the parameters' tensors.

Blocks run eagerly. Autograd recording is not ported yet, so a block call
runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import ndarray as _F
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "report_aux_update"]


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
        """Accepted for API parity and ignored: blocks run eagerly.
        Capturing the forward in a CUDA graph is later work."""

    def __call__(self, *args, **kwargs):
        if torch.is_grad_enabled() and not autograd.is_recording():
            with torch.no_grad():
                return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)


class HybridBlock(Block):
    """A block written as ``hybrid_forward(F, x, *args, **params)``."""

    def forward(self, x, *args):
        params = {}
        for name, p in self._reg_params.items():
            try:
                params[name] = p.data()
            except DeferredInitializationError:
                self._infer_param_shapes(x, *args)
                params[name] = p.data()
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
    """Publish a running-statistic update: eagerly, written in place."""
    with torch.no_grad():
        param.data().copy_(new_data)
