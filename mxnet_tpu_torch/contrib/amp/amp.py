"""Automatic mixed precision (counterpart of mxnet_tpu/contrib/amp/amp.py;
ref: python/mxnet/contrib/amp/amp.py).

``init()`` installs one cast hook at the op dispatch point
(``ndarray.register.invoke``), which every op of ``F`` and ``mx.nd``
passes, on tensors (inside a Gluon net) and on NDArrays alike:

- the matmul-bound ops (``lists.symbol.TARGET_DTYPE_OPS``: Convolution,
  FullyConnected, dot, ...) get their floating inputs cast to the target
  dtype (bfloat16 by default);
- the accumulation-sensitive ops (``FP32_OPS``: the normalizations,
  softmax, the losses, exp and log) get float32 inputs;
- the multi-input elementwise ops (``WIDEST_TYPE_CASTS``) get every
  floating input cast to the widest floating dtype among them, by JAX's
  promotion of the float types (``_promote``);
- every other op runs in its inputs' dtype.

A cast is part of the graph, so a float32 parameter read by a bfloat16
op gets its gradient in float32. ``init_trainer`` attaches a dynamic
``LossScaler`` to a Trainer and makes its update skip a step whose
gradients overflow; ``scale_loss`` scales the loss for the backward and
the Trainer's rescale undoes it.
"""
from __future__ import annotations

import contextlib
import logging
import warnings

import torch

from ... import autograd
from ...base import canonical_dtype
from ...ndarray import register as _register
from ...ndarray.ndarray import NDArray
from .loss_scaler import LossScaler
from .lists import symbol as _lists

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block", "list_lp16_ops",
           "list_fp32_ops", "list_widest_type_cast"]

_amp_initialized = False
_target_dtype = None
_NORM_PARAM_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                        "moving_mean", "moving_var")
# The active op classification (set by init, cleared by _reset). The lists
# in lists/symbol.py are never mutated, so custom lists given to one init
# do not survive a _reset.
_active_lists = None

# JAX's promotion of two distinct float types (jnp.promote_types): float64
# wins, float32 over either half type, and the two half types meet at
# float32.
_RANK = {torch.bfloat16: 0, torch.float16: 0, torch.float32: 1,
         torch.float64: 2}


def _promote(a, b):
    if a == b:
        return a
    ra, rb = _RANK[a], _RANK[b]
    if ra == rb:                        # bfloat16 and float16
        return torch.float32
    return a if ra > rb else b


def _float_dtype(x):
    """The floating torch dtype of a tensor or NDArray, else None."""
    t = x._data if isinstance(x, NDArray) else x
    if isinstance(t, torch.Tensor) and t.dtype.is_floating_point:
        return t.dtype
    return None


def _cast(x, dtype):
    dt = _float_dtype(x)
    if dt is None or dt == dtype:
        return x
    if isinstance(x, NDArray):
        return x.astype(dtype)
    return x.to(dtype)


def _make_hook(target, fp32, widest, target_dtype):

    def hook(op_name, args, kwargs):
        if op_name in target:
            dt = target_dtype
        elif op_name in fp32:
            dt = torch.float32
        elif op_name in widest:
            dts = [d for d in map(_float_dtype,
                                  list(args) + list(kwargs.values()))
                   if d is not None]
            if len(set(dts)) < 2:
                return args, kwargs
            dt = dts[0]
            for d in dts[1:]:
                dt = _promote(dt, d)
        else:
            return args, kwargs
        args = tuple(_cast(a, dt) for a in args)
        kwargs = {k: _cast(v, dt) for k, v in kwargs.items()}
        return args, kwargs

    return hook


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on for the process (ref: amp.py:251 init). A second call
    does nothing."""
    global _amp_initialized, _target_dtype, _active_lists
    if _amp_initialized:
        return
    target = canonical_dtype(target_dtype)
    assert target in (torch.bfloat16, torch.float16), \
        "AMP target dtype must be bfloat16 or float16"
    if target == torch.float16:
        warnings.warn("float16 AMP: float16 has a narrower exponent range "
                      "than bfloat16 and leans on the loss scaler")
    tops = set(_lists.TARGET_DTYPE_OPS) | set(target_precision_ops or ())
    fp32 = set(_lists.FP32_OPS) | set(fp32_ops or ())
    if conditional_fp32_ops:
        # the reference applies these only for some attribute values; as
        # the JAX package does, they are pinned to float32
        fp32 |= {op for op, _, _ in conditional_fp32_ops}
    widest = set(_lists.WIDEST_TYPE_CASTS)
    logging.info("Using AMP (target dtype %s)", target)
    _active_lists = {"target": tops, "fp32": fp32, "widest": widest}
    _register.set_amp_cast_hook(_make_hook(tops, fp32, widest, target))
    _amp_initialized = True
    _target_dtype = target


def _reset():
    """Turn AMP off again (a testing hook: the reference's namespace
    rewrite cannot be undone)."""
    global _amp_initialized, _target_dtype, _active_lists
    _register.set_amp_cast_hook(None)
    _amp_initialized = False
    _target_dtype = None
    _active_lists = None


def init_trainer(trainer):
    """Attach a dynamic loss scaler to a Gluon Trainer and make its update
    skip a step whose gradients hold an inf or a NaN (ref: amp.py:288
    init_trainer). A skipped step leaves weights and optimizer states as
    they were, marks the gradients consumed (so the stale-gradient check
    does not fire at the next step) and lowers the scale."""
    assert _amp_initialized, "call amp.init() before amp.init_trainer()"
    if hasattr(trainer, "_amp_loss_scaler"):
        return
    trainer._amp_loss_scaler = LossScaler()
    trainer._amp_original_scale = trainer._scale
    original_update = trainer._update

    def _amp_update(ignore_stale_grad=False):
        scaler = trainer._amp_loss_scaler
        overflow = scaler.has_overflow(trainer._params)
        if overflow:
            # the flag lives on the parameter's tensor, which Trainer reads
            # (a Parameter's data() is a view made afresh at each call)
            for param in trainer._params:
                if param.grad_req != "null":
                    param._tensor()._fresh_grad = False
        else:
            original_update(ignore_stale_grad)
        scaler.update_scale(overflow)

    trainer._update = _amp_update


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """Yield the loss times the current scale, for the backward; the
    trainer's rescale (``_scale``) divides the gradients by the scale at
    the update (ref: amp.py scale_loss). A trainer without a scaler gets
    the loss as it is."""
    if not hasattr(trainer, "_amp_loss_scaler"):
        yield loss
        return
    scale = trainer._amp_loss_scaler.loss_scale
    trainer._scale = trainer._amp_original_scale / scale
    if isinstance(loss, (list, tuple)):
        yield [_scaled(l, scale) for l in loss]
    else:
        yield _scaled(loss, scale)


def _scaled(loss, scale):
    out = loss * scale
    if isinstance(loss, autograd.Head) and isinstance(out, torch.Tensor):
        out = out.as_subclass(autograd.Head)   # backward() seeds ones
    return out


def unscale(optimizer_or_trainer):
    """Divide the gradients by the current loss scale in place and restore
    the trainer's own rescale, so that the next ``step()`` does not divide
    by the scale again (ref: amp.py unscale)."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise TypeError("optimizer_or_trainer does not have AMP "
                        "loss scaling enabled")
    with torch.no_grad():
        for param in optimizer_or_trainer._params:
            if param.grad_req != "null":
                param._grad_tensor().div_(scaler.loss_scale)
    optimizer_or_trainer._scale = optimizer_or_trainer._amp_original_scale


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  excluded_sym_names=None, cast_optional_params=False):
    """Cast a symbolic model's parameters to the target dtype, keeping the
    normalization parameters and every auxiliary state in float32 (ref:
    amp.py convert_model). The casts of the ops themselves come from the
    dispatch hook, so the conversion is a parameter-dtype policy only;
    ``sym`` comes back as it was."""
    excluded = set(excluded_sym_names or [])
    target = canonical_dtype(target_dtype)

    def keep_fp32(name):
        return name in excluded or name.endswith(_NORM_PARAM_SUFFIXES)

    new_args = {k: (v if keep_fp32(k) else v.astype(target))
                for k, v in arg_params.items()}
    return sym, new_args, dict(aux_params)


def convert_hybrid_block(block, target_dtype="bfloat16",
                         excluded_sym_names=None,
                         cast_optional_params=False):
    """Cast a Gluon block's floating parameters to the target dtype,
    keeping the normalization layers' in float32 (ref: amp.py
    convert_hybrid_block)."""
    target = canonical_dtype(target_dtype)
    excluded = set(excluded_sym_names or [])
    for name, param in block.collect_params().items():
        if name in excluded or name.endswith(_NORM_PARAM_SUFFIXES):
            continue
        if param._data is not None and \
                canonical_dtype(param.dtype).is_floating_point:
            param.cast(target)
    return block


def list_lp16_ops(target_dtype=None):
    return sorted(_active_lists["target"]) if _active_lists \
        else list(_lists.TARGET_DTYPE_OPS)


def list_fp32_ops(target_dtype=None):
    return sorted(_active_lists["fp32"]) if _active_lists \
        else list(_lists.FP32_OPS)


def list_widest_type_cast(target_dtype=None):
    return sorted(_active_lists["widest"]) if _active_lists \
        else list(_lists.WIDEST_TYPE_CASTS)
