"""Packed multi-tensor optimizer apply: the Hopper kernel and its plain
PyTorch version (counterpart of mxnet_tpu/pallas_kernels/optimizer_apply.py).

The fused train step's update phase (``gluon/fused_step.py``, behind
``MXTPU_FUSED_APPLY``) groups the trainable weights into
``parallel/overlap.bucket_plan``'s dtype-homogeneous, size-capped buckets
and applies the optimizer's ``step_fn`` math to each bucket in ONE kernel
launch (``csrc/optimizer_apply.cu``: SGD with or without momentum, or
Adam, with or without clip, bf16 or f32). The kernel's design note is in
its source.

Bitwise contract: ``step_fn`` is elementwise, so packing changes only the
shape the math runs over, never a rounding. Per-parameter lr and wd travel
as a per-parameter table the kernel indexes (the plain version spreads them
into per-element vectors, as the JAX module does); both hold the values the
per-parameter chain uses, rounded to the weight dtype where it rounds them.
For Adam, lr is ``step_lr``'s bias-corrected rate (float64 on the host,
then float32, then the weight's dtype). The results equal looping
``opt.step_fn`` per parameter bit for bit.

``packed_apply`` updates the weights and states IN PLACE (on the card the
kernel writes them where they live) and returns the same tensors. A CPU
tensor runs ``packed_apply_reference`` per bucket; a CUDA tensor launches
the kernel or raises. ``cost`` gives one launch's operations and bytes
(``kernels/_cost.py``).
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, getenv, weak_scalar
from ..parallel.overlap import bucket_plan
from . import _cost

__all__ = ["cost", "OPS", "enabled", "bucketize", "packed_apply", "packed_apply_reference",
           "LAUNCHES"]

# Kernel launches made by packed_apply in this process (one per bucket).
LAUNCHES = 0

_ENV = "MXTPU_FUSED_APPLY"


def enabled():
    """``MXTPU_FUSED_APPLY``: "0" (the default) is off, anything else on."""
    return getenv(_ENV, "0") != "0"


# The JAX module's name for the packing plan: the same function.
bucketize = bucket_plan


# f32 operations per element of each packed step, on the CUDA cores: SGD
# with momentum (rescale, wd*w, +g, *lr, momentum*m, -, +w), SGD without
# (rescale, wd*w, +g, *lr, -) and Adam (rescale, wd*w, +, b1*m, (1-b1)*g,
# +, (1-b2)*g, *g, b2*v, +, sqrt, +eps, lr*m, /, -).
OPS = {"sgd_momentum": 7, "sgd": 5, "adam": 15}
# element arrays read or written once (w, g, the states read; w and the
# states written) and bytes of per-tensor table entries
_ARRAYS = {"sgd_momentum": 5, "sgd": 3, "adam": 7}
_PER_TENSOR = {"sgd_momentum": 8, "sgd": 8, "adam": 48}


def cost(kind, n, tensors, dtype_bytes):
    """``(operations, bytes)`` of one launch of the ``kind`` step
    (``"sgd_momentum"``, ``"sgd"``, ``"adam"``) over ``n`` elements of
    ``tensors`` weights of ``dtype_bytes`` bytes."""
    return (OPS[kind] * n,
            dtype_bytes * _ARRAYS[kind] * n + _PER_TENSOR[kind] * tensors)


def _kind(opt):
    return ("sgd", "sgd_momentum", "adam")[_arity(opt)]


def packed_apply_reference(opt, w, g, state, lrv, wdv, rescale):
    """The packed apply without the kernel: the optimizer's own
    ``step_fn`` over one flat segment. ``w``, ``g`` and each state tensor
    are 1-D (``state`` None for momentum-free SGD, SGD's momentum, Adam's
    ``(m, v)``), ``lrv``/``wdv`` per-element float32 vectors. Returns
    ``(new_w, new_state)``."""
    return opt.step_fn(w, g, state, lrv, wdv, rescale)


def _cat(parts):
    parts = [p.reshape(-1) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _leaves(state):
    """A state's tensors: none, the one, or the tuple's."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [state]
    return list(state)


def _like(state, leaves):
    """``leaves`` in ``state``'s structure."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return leaves[0]
    return tuple(leaves)


def _arity(opt):
    """The state tensors ``opt.step_fn`` keeps per weight: Adam 2, SGD 1
    with momentum, else 0."""
    from ..optimizer.optimizer import Adam
    if isinstance(opt, Adam):
        return 2
    return int(getattr(opt, "momentum", 0.0) != 0.0)


def _check(opt, ws, gs, states, lrs, wds):
    n = len(ws)
    if not (len(gs) == len(states) == len(lrs) == len(wds) == n):
        raise ValueError("packed_apply: ws, gs, states, lrs, wds must have "
                         "one entry per parameter")
    if not opt.fused_apply_supported():
        raise MXNetError("packed_apply: %s has no packed form"
                         % type(opt).__name__)
    arity = _arity(opt)
    for w, g, st in zip(ws, gs, states):
        if g.shape != w.shape or g.dtype != w.dtype or g.device != w.device:
            raise ValueError("packed_apply: grad %s %s on %s for weight %s "
                             "%s on %s" % (tuple(g.shape), g.dtype, g.device,
                                           tuple(w.shape), w.dtype,
                                           w.device))
        leaves = _leaves(st)
        if len(leaves) != arity or (arity == 2) != isinstance(st, tuple) \
                or any(not isinstance(t, torch.Tensor) or t.shape != w.shape
                       or t.dtype != w.dtype or t.device != w.device
                       for t in leaves):
            raise ValueError("packed_apply: each state of %s must be %s, "
                             "shaped and typed like its weight"
                             % (type(opt).__name__,
                                ("None", "one tensor", "a tuple of two "
                                 "tensors")[arity]))


def packed_apply(opt, ws, gs, states, lrs, wds, rescale):
    """Apply ``opt.step_fn`` to every parameter with one launch per
    bucket, in place: ``ws[i]`` and the tensors of ``states[i]`` receive
    the new weight and state. Returns ``(ws, states)``.

    ``ws``/``gs``: weights and gradients (any shapes, mixed dtypes);
    ``states``: SGD's momentum tensors (None without momentum) or Adam's
    ``(m, v)`` tuples; ``lrs``/``wds``: per-parameter Python floats;
    ``rescale``: the gradient scale.
    """
    _check(opt, ws, gs, states, lrs, wds)
    for bucket in bucket_plan(ws):
        dev = ws[bucket[0]].device
        if dev.type not in ("cpu", "cuda"):
            raise MXNetError("packed_apply: no kernel for device %s" % dev)
        with _cost.launch("optimizer_apply", cost, _kind(opt),
                          sum(ws[i].numel() for i in bucket), len(bucket),
                          ws[bucket[0]].element_size(), tensor_core=False):
            if dev.type == "cpu":
                _apply_plain(opt, bucket, ws, gs, states, lrs, wds, rescale)
            else:
                _launch(opt, bucket, ws, gs, states, lrs, wds, rescale)
    return ws, states


def _apply_plain(opt, bucket, ws, gs, states, lrs, wds, rescale):
    sizes = [ws[i].numel() for i in bucket]
    vec = [torch.cat([torch.full((n,), float(v[i]), dtype=torch.float32)
                      for i, n in zip(bucket, sizes)]) for v in (lrs, wds)]
    leaves = [_leaves(states[i]) for i in bucket]
    st = _like(states[bucket[0]], [_cat([lv[k] for lv in leaves])
                                   for k in range(len(leaves[0]))])
    with torch.no_grad():
        nw, ns = packed_apply_reference(
            opt, _cat([ws[i] for i in bucket]), _cat([gs[i] for i in bucket]),
            st, vec[0], vec[1], rescale)
        new_leaves = _leaves(ns)
        off = 0
        for i, n, old in zip(bucket, sizes, leaves):
            ws[i].copy_(nw[off:off + n].view(ws[i].shape))
            for t, flat in zip(old, new_leaves):
                t.copy_(flat[off:off + n].view(t.shape))
            off += n


_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGS = {
    "sgd": [_P, _P, ctypes.c_int, ctypes.c_longlong, _F, _F, _F,
            ctypes.c_int, ctypes.c_int, _P],
    "adam": [_P, _P, ctypes.c_int, ctypes.c_longlong, _F, _F, _F, _F, _F,
             _F, _F, ctypes.c_int, _P]}


def _launch(opt, bucket, ws, gs, states, lrs, wds, rescale):
    """One kernel launch over ``bucket``; raises on what the kernel does
    not take (a dtype other than bf16/f32, a non-contiguous tensor,
    operands on two devices, an optimizer other than SGD and Adam)."""
    global LAUNCHES
    from . import _build
    from ..optimizer.optimizer import SGD, Adam

    if type(opt) not in (SGD, Adam):
        raise MXNetError("packed_apply: the kernel computes SGD's and "
                         "Adam's steps, not %s's" % type(opt).__name__)
    w0 = ws[bucket[0]]
    dt, dev = w0.dtype, w0.device
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError("packed_apply: the kernel takes bf16 or f32 "
                        "weights, got %s" % dt)
    per_vec = 16 // dt.itemsize
    ptrs, sizes, first = [[], [], [], []], [], []
    nvec = 0
    for i in bucket:
        w, g = ws[i], gs[i]
        st = _leaves(states[i])
        for t in [w, g] + st:
            if t.device != dev or t.dtype != dt or not t.is_contiguous():
                raise ValueError("packed_apply: every tensor of a bucket "
                                 "must be a contiguous %s tensor on %s"
                                 % (dt, dev))
        for col, t in zip(ptrs, [w, g] + st + [None] * (2 - len(st))):
            col.append(0 if t is None else t.data_ptr())
        sizes.append(w.numel())
        first.append(nvec)
        nvec += -(-w.numel() // per_vec)
    nseg = len(bucket)
    tab = torch.tensor(sum(ptrs, []) + sizes + first,
                       dtype=torch.int64).pin_memory().to(dev,
                                                          non_blocking=True)
    lrwd = torch.tensor([weak_scalar(float(lrs[i]), dt) for i in bucket]
                        + [weak_scalar(float(wds[i]), dt) for i in bucket],
                        dtype=torch.float32).pin_memory().to(
                            dev, non_blocking=True)
    clip = opt.clip_gradient
    rs = weak_scalar(float(rescale), dt)
    cl = 0.0 if clip is None else weak_scalar(float(clip), dt)
    suffix = "bf16" if dt == torch.bfloat16 else "f32"
    kind = "adam" if type(opt) is Adam else "sgd"
    fn = getattr(_build.load("optimizer_apply"),
                 "%s_apply_%s" % (kind, suffix))
    if fn.argtypes is None:
        fn.argtypes = _SIGS[kind]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "sgd":
            mom = opt.momentum
            err = fn(tab.data_ptr(), lrwd.data_ptr(), nseg, nvec, rs,
                     weak_scalar(float(mom), dt), cl, int(mom != 0.0),
                     int(clip is not None), stream)
        else:
            b1, b2 = opt.beta1, opt.beta2
            err = fn(tab.data_ptr(), lrwd.data_ptr(), nseg, nvec, rs,
                     *(weak_scalar(float(v), dt)
                       for v in (b1, 1 - b1, b2, 1 - b2, opt.epsilon)),
                     cl, int(clip is not None), stream)
    if err != 0:
        raise MXNetError("optimizer_apply kernel launch failed: cudaError "
                         "%d (%s, %d tensors, %d vectors, %s)"
                         % (err, kind, nseg, nvec, dt))
    LAUNCHES += 1
