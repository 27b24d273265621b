"""Standalone CachedOp and ``jit`` (counterpart of mxnet_tpu/jit.py; ref:
src/imperative/cached_op.{h,cc}).

``CachedOp(sym)`` is callable on arrays bound to the symbol's inputs in
``list_inputs`` order and runs the graph in inference mode
(``executor._GraphProgram``); ``CachedOp(fn)`` and ``@jit`` wrap a
function of tensors. Both keep the JAX package's observable contract:
``calls`` counts calls, ``compiles`` the distinct input signatures
(shapes and dtypes), and ``static_shape=True`` raises on a second
signature. Nothing is compiled or captured here: each call runs the ops
eagerly (a CUDA-graph capture is later speed work, ROADMAP S4).
"""
from __future__ import annotations

import torch

from .ndarray.ndarray import NDArray, wrap as _wrap

__all__ = ["CachedOp", "jit"]


def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


class CachedOp:
    """A callable over a Symbol or a function of tensors (ref:
    cached_op.cc:96). For a Symbol, inputs bind in ``list_inputs``
    order."""

    def __init__(self, sym_or_fn, static_alloc=False, static_shape=False,
                 inline_limit=2, flags=()):
        self._static_alloc = bool(static_alloc)
        self._static_shape = bool(static_shape)
        self._signature = None
        self._flags = dict(flags)
        self.calls = 0
        self._seen_signatures = set()
        if callable(sym_or_fn) and not hasattr(sym_or_fn, "list_inputs"):
            self._input_names = None
            self._fn = sym_or_fn
        else:
            self._input_names = list(sym_or_fn.list_inputs())
            self._fn = self._symbol_fn(sym_or_fn)

    def _symbol_fn(self, sym):
        from .executor import _GraphProgram
        prog = _GraphProgram(sym)

        def run(*arrs):
            with torch.no_grad():
                outs, _ = prog.run(dict(zip(self._input_names, arrs)),
                                   is_train=False)
            return outs
        return run

    @property
    def compiles(self):
        """Distinct input signatures seen (the JAX package's compiles)."""
        return len(self._seen_signatures)

    def __call__(self, *args):
        targs = tuple(_tensor(a) for a in args)
        sig = tuple((tuple(a.shape), str(a.dtype).replace("torch.", ""))
                    for a in targs)
        self.calls += 1
        self._seen_signatures.add(sig)
        if self._static_shape:
            if self._signature is None:
                self._signature = sig
            elif sig != self._signature:
                raise ValueError(
                    "CachedOp(static_shape=True) called with a new input "
                    "signature %r != %r (ref: cached_op.cc "
                    "CheckDynamicShape)" % (sig, self._signature))
        out = self._fn(*targs)
        if isinstance(out, (list, tuple)):
            outs = [_wrap(o) for o in out]
            return outs if len(outs) != 1 else outs[0]
        return _wrap(out)


def jit(fn=None, *, static_alloc=False, static_shape=False, inline_limit=2):
    """Decorator form: ``@mx.jit.jit`` wraps a function of tensors as a
    CachedOp."""
    def deco(f):
        op = CachedOp(f, static_alloc=static_alloc,
                      static_shape=static_shape, inline_limit=inline_limit)
        op.__name__ = getattr(f, "__name__", "jit")
        return op
    return deco(fn) if fn is not None else deco
