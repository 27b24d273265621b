"""Deployment predictor: the c_predict_api workflow in Python
(counterpart of mxnet_tpu/predictor.py; ref: include/mxnet/c_predict_api.h
MXPredCreate :84, MXPredSetInput :254, MXPredForward :263,
MXPredGetOutput :289, MXPredReshape :214).

A Predictor binds a symbol (JSON text, a path, or a Symbol) with the raw
bytes of a ``.params`` checkpoint (``arg:``/``aux:`` keys) at fixed input
shapes on ``dev_type`` (default ``gpu(0)``; the JAX package's is the CPU),
then runs set_input / forward / get_output. The C ABI over it (the
``_c_*`` entry points) belongs to the C extension seams, which the port
has not ported: they raise.
"""
from __future__ import annotations

import numpy as _np

from . import ndarray as nd
from .base import MXNetError
from .context import Context, gpu
from .executor import _set
from .symbol import load_json as _sym_load_json

__all__ = ["Predictor"]


class Predictor:
    """Fixed-shape inference session (ref: c_predict_api.h:84
    MXPredCreate: symbol json + param bytes + input shapes)."""

    def __init__(self, symbol_json, param_raw_bytes=None, dev_type=None,
                 input_shapes=None, arg_params=None, aux_params=None,
                 output_keys=None):
        from .symbol.symbol import Symbol
        self._ctx = Context(dev_type) if dev_type is not None else gpu(0)
        self._ctx.device                 # raises for a GPU with no CUDA
        if isinstance(symbol_json, Symbol):
            self._symbol = symbol_json
        else:
            if isinstance(symbol_json, (bytes, bytearray)):
                symbol_json = symbol_json.decode("utf-8")
            if symbol_json.lstrip().startswith("{"):
                self._symbol = _sym_load_json(symbol_json)
            else:  # path
                with open(symbol_json) as f:
                    self._symbol = _sym_load_json(f.read())
        if output_keys:
            # partial outputs (ref: MXPredCreatePartialOut :155), by node
            # name as the JAX package takes them
            from .symbol import Group
            outs = self._symbol.get_internals()
            self._symbol = outs[output_keys] if isinstance(output_keys, str) \
                else Group([outs[k] for k in output_keys])

        if param_raw_bytes is not None:
            import io as _io
            # reference passes raw .params bytes (MXPredCreate param_bytes)
            loaded = nd.load(_io.BytesIO(param_raw_bytes), ctx=self._ctx)
            if not isinstance(loaded, dict):
                raise ValueError("param bytes must contain NAMED arrays "
                                 "('arg:name'/'aux:name' keys, the "
                                 "save_checkpoint format)")
            arg_params, aux_params = {}, {}
            for k, v in loaded.items():
                if k.startswith("arg:"):
                    arg_params[k[4:]] = v
                elif k.startswith("aux:"):
                    aux_params[k[4:]] = v
                else:
                    arg_params[k] = v
        self._arg_params = dict(arg_params or {})
        self._aux_params = dict(aux_params or {})
        self._input_shapes = dict(input_shapes or {})
        self._inputs = {k: nd.zeros(v, ctx=self._ctx)
                        for k, v in self._input_shapes.items()}
        self._outputs = None
        self._bind()

    def _bind(self):
        args = dict(self._arg_params)
        args.update(self._inputs)
        # infer shapes for auxiliary input vars the caller did not declare
        # (e.g. SoftmaxOutput's label at inference) and zero-fill them --
        # what the reference's predictor bind does through the executor's
        # shape inference (ref: src/c_api/c_predict_api.cc MXPredCreate)
        missing = [n for n in self._symbol.list_arguments() if n not in args]
        if missing:
            shapes = {k: tuple(v) for k, v in self._input_shapes.items()}
            arg_shapes, _, _ = self._symbol.infer_shape_partial(**shapes)
            batch = next(iter(self._input_shapes.values()))[0] \
                if self._input_shapes else 1
            for n, s in zip(self._symbol.list_arguments(), arg_shapes):
                if n in missing:
                    # un-inferable vars (loss labels -- forward output does
                    # not depend on them) default to (batch,) zeros, the
                    # reference loss ops' default label shape
                    args[n] = nd.zeros(s if s is not None else (batch,),
                                       ctx=self._ctx)
        self._executor = self._symbol.bind(
            self._ctx, args=args, aux_states=self._aux_params,
            grad_req="null")

    # -- reference workflow -------------------------------------------------
    def set_input(self, key, data):
        """ref: MXPredSetInput (c_predict_api.h:254)."""
        if key not in self._inputs:
            raise KeyError("unknown input %r; declared inputs: %s"
                           % (key, sorted(self._inputs)))
        arr = data if isinstance(data, nd.NDArray) else nd.array(
            _np.asarray(data, "float32"), ctx=self._ctx)
        if tuple(arr.shape) != tuple(self._input_shapes[key]):
            raise ValueError("input %r shape %s != declared %s (use "
                             "reshape())" % (key, arr.shape,
                                             self._input_shapes[key]))
        _set(self._executor.arg_dict[key], arr)

    def forward(self):
        """ref: MXPredForward (c_predict_api.h:263)."""
        self._outputs = self._executor.forward(is_train=False)

    def get_output_shape(self, index=0):
        """ref: MXPredGetOutputShape (c_predict_api.h:229) -- from shape
        inference, without running the program."""
        if self._outputs is not None:
            return tuple(self._outputs[index].shape)
        shapes = {k: tuple(v) for k, v in self._input_shapes.items()}
        _, out_shapes, _ = self._symbol.infer_shape_partial(**shapes)
        return tuple(out_shapes[index])

    def get_output(self, index=0):
        """ref: MXPredGetOutput (c_predict_api.h:289) -- host numpy copy."""
        if self._outputs is None:
            raise RuntimeError("call forward() before get_output()")
        return self._outputs[index].asnumpy()

    def reshape(self, new_input_shapes):
        """Rebind at new shapes (ref: MXPredReshape :214)."""
        self._input_shapes.update(new_input_shapes)
        self._inputs = {k: nd.zeros(v, ctx=self._ctx)
                        for k, v in self._input_shapes.items()}
        self._outputs = None
        self._bind()

    @classmethod
    def from_checkpoint(cls, prefix, epoch, input_shapes, dev_type=None,
                        output_keys=None):
        """Load '<prefix>-symbol.json' + '<prefix>-%04d.params'
        (the reference examples' standard deploy pairing)."""
        from .model import load_checkpoint
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(sym, dev_type=dev_type, input_shapes=input_shapes,
                   arg_params=arg_params, aux_params=aux_params,
                   output_keys=output_keys)


# -- the native C predict ABI's entry points ---------------------------------
# They belong to the C extension seams (src/c_api), which the port has not
# ported (ROADMAP M11).

def _no_c_abi(*args, **kwargs):
    raise MXNetError("the C predict ABI belongs to the C extension seams, "
                     "which are not ported yet (ROADMAP M11)")


_c_create = _c_set_input = _c_get_output = _c_reshape = _no_c_abi
