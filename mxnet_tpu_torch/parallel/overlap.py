"""Gradient buckets and their reduction (counterpart of
mxnet_tpu/parallel/overlap.py).

``bucket_plan(leaves)`` groups tensors into size-capped, dtype-homogeneous
buckets that keep the leaves' order (``MXTPU_ELASTIC_BUCKET_MB``, default
4 MiB). It is the one packing definition of the framework: the packed
optimizer apply (``kernels/optimizer_apply.py``) launches one kernel per
bucket, and the gradient reduction sends one message per bucket.

- ``tag_gradient_buckets(leaves, axis_name)`` wraps each bucket's leaves
  in an identity ``torch.autograd.Function``. Autograd runs its backward
  once every gradient of the bucket has been produced: it flattens them
  into one buffer and starts one ``all_reduce`` on it (``async_op``), in
  the middle of the backward, so that the reduction can run under the
  rest of it. The gradients returned are views of that buffer;
  ``wait_pending()`` waits for every reduction started on this thread
  (and divides by the axis's size for ``op="mean"``) and must run before
  the gradients are read.
- ``bucketed_reduce(leaves, axis_name)`` is the post-backward form: one
  flat collective per bucket, the reduced leaves returned.

A bucketed reduce computes the per-leaf reduction exactly: concatenation
batches messages and never mixes leaves, so the results equal a reduce of
each leaf bit for bit. ``axis_name=None`` keeps the bucket structure and
reduces nothing (the JAX package's GSPMD form, whose partitioner supplies
the reduction). ``bucket_plan`` counts ``overlap.buckets_planned`` and
``overlap.leaves_planned`` in the profiler.
"""
from __future__ import annotations

import threading

import torch

from .. import profiler as _profiler
from ..base import getenv

__all__ = ["bucket_plan", "tag_gradient_buckets", "bucketed_reduce",
           "default_bucket_bytes", "wait_pending"]


def default_bucket_bytes():
    """Size cap per bucket, from ``MXTPU_ELASTIC_BUCKET_MB`` (default 4
    MiB)."""
    mb = float(getenv("MXTPU_ELASTIC_BUCKET_MB", "4"))
    return max(1, int(mb * (1 << 20)))


def bucket_plan(leaves, bucket_bytes=None):
    """Group leaf indices into buckets: a list of index lists, each in
    leaf order. A bucket holds one dtype and at most ``bucket_bytes``
    bytes; a single leaf larger than the cap gets its own bucket.
    ``leaves`` are tensors (or anything with ``dtype`` and ``shape``)."""
    if bucket_bytes is None:
        bucket_bytes = default_bucket_bytes()
    plan = []
    cur, cur_bytes, cur_dtype = [], 0, None
    for i, leaf in enumerate(leaves):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        nbytes = n * leaf.dtype.itemsize
        if cur and (leaf.dtype != cur_dtype
                    or cur_bytes + nbytes > bucket_bytes):
            plan.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = leaf.dtype
    if cur:
        plan.append(cur)
    # host-side accounting of how the reduction was batched
    _profiler.account("overlap.buckets_planned", len(plan), emit=False)
    _profiler.account("overlap.leaves_planned", len(leaves), emit=False)
    return plan


_pending = threading.local()


def _flat(ts):
    ts = [t.reshape(-1) for t in ts]
    return torch.cat(ts) if len(ts) > 1 else ts[0].contiguous().clone()


def _split(flat, shapes):
    out, off = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= int(d)
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


def _check_op(op):
    if op not in ("sum", "mean"):
        raise ValueError("overlap reduce op must be 'sum' or 'mean', got %r"
                         % (op,))


def _reduce_flat(flat, axis_name, op):
    _check_op(op)
    if axis_name is None:
        return flat
    from .collectives import all_reduce
    return all_reduce(flat, axis_name, op)


def _works():
    """This thread's list of started reductions."""
    if not hasattr(_pending, "works"):
        _pending.works = []
    return _pending.works


def _start(flat, group, mean_of, works):
    """Start the reduction of ``flat`` over ``group`` in place and record
    it in ``works``; ``wait_pending`` finishes it (dividing by ``mean_of``
    where it is not None)."""
    from . import collectives as C
    C._fault()
    dist = C._dist()
    work = C._call("all_reduce", flat, group, lambda: dist.all_reduce(
        flat, op=dist.ReduceOp.SUM, group=group, async_op=True))
    works.append((work, flat, mean_of))


def wait_pending():
    """Wait for every bucket reduction started for markers this thread
    applied (then divide a mean's sums by the axis size, in place)."""
    works = _works()
    done, works[:] = list(works), []
    for work, flat, n in done:
        work.wait()
        if n is not None:
            flat.div_(n)


class _Tag(torch.autograd.Function):
    """Identity over one bucket; its backward starts the bucket's one
    reduction (see the module docstring). The axis is resolved, and the
    list of started reductions taken, in the forward's thread: autograd
    may run the backward on a thread of its own (a card's)."""

    @staticmethod
    def forward(ctx, axis_name, op, *xs):
        from . import collectives as C
        ctx.group, n = C._axis(axis_name) if axis_name is not None \
            else (None, 1)
        ctx.mean_of = n if op == "mean" else None
        ctx.works = _works()
        ctx.shapes = [x.shape for x in xs]
        ctx.set_materialize_grads(True)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        flat = _flat([c.contiguous() for c in cts])
        if ctx.group is not None:
            _start(flat, ctx.group, ctx.mean_of, ctx.works)
        return (None, None) + tuple(_split(flat, ctx.shapes))


def tag_gradient_buckets(leaves, axis_name, plan=None, bucket_bytes=None,
                         op="sum"):
    """``leaves`` wrapped in per-bucket reduction markers (the module
    docstring): use them in place of the leaves in the forward; the
    gradients with respect to the original leaves are reduced over
    ``axis_name``, one collective per bucket, once ``wait_pending()``
    returns."""
    _check_op(op)
    leaves = list(leaves)
    if plan is None:
        plan = bucket_plan(leaves, bucket_bytes)
    out = list(leaves)
    for bucket in plan:
        tagged = _Tag.apply(axis_name, op, *[leaves[i] for i in bucket])
        for i, t in zip(bucket, tagged):
            out[i] = t
    return out


def bucketed_reduce(leaves, axis_name, plan=None, bucket_bytes=None,
                    op="sum"):
    """Already-computed gradients reduced over ``axis_name``, one flat
    collective per bucket (the post-backward form)."""
    _check_op(op)
    leaves = list(leaves)
    if plan is None:
        plan = bucket_plan(leaves, bucket_bytes)
    out = list(leaves)
    for bucket in plan:
        group = [leaves[i] for i in bucket]
        red = _reduce_flat(_flat(group), axis_name, op)
        for i, t in zip(bucket, _split(red, [g.shape for g in group])):
            out[i] = t
    return out
