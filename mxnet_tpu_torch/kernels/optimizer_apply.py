"""Packed multi-tensor optimizer apply: the Hopper kernel and its plain
PyTorch version (counterpart of mxnet_tpu/pallas_kernels/optimizer_apply.py).

The fused train step's update phase (``gluon/fused_step.py``, behind
``MXTPU_FUSED_APPLY``) groups the trainable weights into
``parallel/overlap.bucket_plan``'s dtype-homogeneous, size-capped buckets
and applies the optimizer's ``step_fn`` math to each bucket in ONE kernel
launch (``csrc/optimizer_apply.cu``, SGD with or without momentum and
clip, bf16 or f32). The kernel's design note is in its source.

Bitwise contract: ``step_fn`` is elementwise, so packing changes only the
shape the math runs over, never a rounding. Per-parameter lr and wd travel
as a per-parameter table the kernel indexes (the plain version spreads them
into per-element vectors, as the JAX module does); both hold the values the
per-parameter chain uses, rounded to the weight dtype where it rounds them.
The results equal looping ``opt.step_fn`` per parameter bit for bit.

``packed_apply`` updates the weights and states IN PLACE (on the card the
kernel writes them where they live) and returns the same tensors. A CPU
tensor runs ``packed_apply_reference`` per bucket; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, getenv, weak_scalar
from ..parallel.overlap import bucket_plan

__all__ = ["enabled", "bucketize", "packed_apply", "packed_apply_reference",
           "LAUNCHES"]

# Kernel launches made by packed_apply in this process (one per bucket).
LAUNCHES = 0

_ENV = "MXTPU_FUSED_APPLY"


def enabled():
    """``MXTPU_FUSED_APPLY``: "0" (the default) is off, anything else on."""
    return getenv(_ENV, "0") != "0"


# The JAX module's name for the packing plan: the same function.
bucketize = bucket_plan


def packed_apply_reference(opt, w, g, state, lrv, wdv, rescale):
    """The packed apply without the kernel: the optimizer's own
    ``step_fn`` over one flat segment. ``w``, ``g`` and ``state`` are 1-D
    (``state`` None for momentum-free SGD), ``lrv``/``wdv`` per-element
    float32 vectors. Returns ``(new_w, new_state)``."""
    return opt.step_fn(w, g, state, lrv, wdv, rescale)


def _cat(parts):
    parts = [p.reshape(-1) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _check(opt, ws, gs, states, lrs, wds):
    n = len(ws)
    if not (len(gs) == len(states) == len(lrs) == len(wds) == n):
        raise ValueError("packed_apply: ws, gs, states, lrs, wds must have "
                         "one entry per parameter")
    if not opt.fused_apply_supported():
        raise MXNetError("packed_apply: %s has no packed form"
                         % type(opt).__name__)
    mom = getattr(opt, "momentum", 0.0) != 0.0
    for w, g, st in zip(ws, gs, states):
        if g.shape != w.shape or g.dtype != w.dtype or g.device != w.device:
            raise ValueError("packed_apply: grad %s %s on %s for weight %s "
                             "%s on %s" % (tuple(g.shape), g.dtype, g.device,
                                           tuple(w.shape), w.dtype,
                                           w.device))
        if mom != (st is not None) or (st is not None and (
                st.shape != w.shape or st.dtype != w.dtype
                or st.device != w.device)):
            raise ValueError("packed_apply: each state must be a tensor "
                             "like its weight (None without momentum)")


def packed_apply(opt, ws, gs, states, lrs, wds, rescale):
    """Apply ``opt.step_fn`` to every parameter with one launch per
    bucket, in place: ``ws[i]`` and ``states[i]`` receive the new weight
    and state. Returns ``(ws, states)``.

    ``ws``/``gs``: weights and gradients (any shapes, mixed dtypes);
    ``states``: SGD's momentum tensors (None without momentum); ``lrs``/
    ``wds``: per-parameter Python floats; ``rescale``: the gradient scale.
    """
    _check(opt, ws, gs, states, lrs, wds)
    for bucket in bucket_plan(ws):
        dev = ws[bucket[0]].device
        if dev.type == "cpu":
            _apply_plain(opt, bucket, ws, gs, states, lrs, wds, rescale)
        elif dev.type == "cuda":
            _launch(opt, bucket, ws, gs, states, lrs, wds, rescale)
        else:
            raise MXNetError("packed_apply: no kernel for device %s" % dev)
    return ws, states


def _apply_plain(opt, bucket, ws, gs, states, lrs, wds, rescale):
    sizes = [ws[i].numel() for i in bucket]
    vec = [torch.cat([torch.full((n,), float(v[i]), dtype=torch.float32)
                      for i, n in zip(bucket, sizes)]) for v in (lrs, wds)]
    st = None if states[bucket[0]] is None \
        else _cat([states[i] for i in bucket])
    with torch.no_grad():
        nw, ns = packed_apply_reference(
            opt, _cat([ws[i] for i in bucket]), _cat([gs[i] for i in bucket]),
            st, vec[0], vec[1], rescale)
        off = 0
        for i, n in zip(bucket, sizes):
            ws[i].copy_(nw[off:off + n].view(ws[i].shape))
            if ns is not None:
                states[i].copy_(ns[off:off + n].view(ws[i].shape))
            off += n


_P = ctypes.c_void_p
_SIG = [_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]


def _launch(opt, bucket, ws, gs, states, lrs, wds, rescale):
    """One kernel launch over ``bucket``; raises on what the kernel does
    not take (a dtype other than bf16/f32, a non-contiguous tensor,
    operands on two devices, an optimizer other than SGD)."""
    global LAUNCHES
    from . import _build
    from ..optimizer.optimizer import SGD

    if type(opt) is not SGD:
        raise MXNetError("packed_apply: the kernel computes SGD's step, "
                         "not %s's" % type(opt).__name__)
    w0 = ws[bucket[0]]
    dt, dev = w0.dtype, w0.device
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError("packed_apply: the kernel takes bf16 or f32 "
                        "weights, got %s" % dt)
    per_vec = 16 // dt.itemsize
    ptrs, sizes, first = [[], [], []], [], []
    nvec = 0
    for i in bucket:
        w, g, st = ws[i], gs[i], states[i]
        for t in (w, g) + (() if st is None else (st,)):
            if t.device != dev or t.dtype != dt or not t.is_contiguous():
                raise ValueError("packed_apply: every tensor of a bucket "
                                 "must be a contiguous %s tensor on %s"
                                 % (dt, dev))
        ptrs[0].append(w.data_ptr())
        ptrs[1].append(g.data_ptr())
        ptrs[2].append(0 if st is None else st.data_ptr())
        sizes.append(w.numel())
        first.append(nvec)
        nvec += -(-w.numel() // per_vec)
    nseg = len(bucket)
    tab = torch.tensor(ptrs[0] + ptrs[1] + ptrs[2] + sizes + first,
                       dtype=torch.int64).pin_memory().to(dev,
                                                          non_blocking=True)
    lrwd = torch.tensor([weak_scalar(float(lrs[i]), dt) for i in bucket]
                        + [weak_scalar(float(wds[i]), dt) for i in bucket],
                        dtype=torch.float32).pin_memory().to(
                            dev, non_blocking=True)
    clip = opt.clip_gradient
    mom = opt.momentum
    fn = getattr(_build.load("optimizer_apply"),
                 "sgd_apply_bf16" if dt == torch.bfloat16 else "sgd_apply_f32")
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(tab.data_ptr(), lrwd.data_ptr(), nseg, nvec,
                 weak_scalar(float(rescale), dt),
                 weak_scalar(float(mom), dt),
                 0.0 if clip is None else weak_scalar(float(clip), dt),
                 int(mom != 0.0), int(clip is not None),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise MXNetError("optimizer_apply kernel launch failed: cudaError "
                         "%d (%d tensors, %d vectors, %s)"
                         % (err, nseg, nvec, dt))
    LAUNCHES += 1
