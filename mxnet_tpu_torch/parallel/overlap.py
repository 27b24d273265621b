"""Gradient buckets (counterpart of mxnet_tpu/parallel/overlap.py).

``bucket_plan(leaves)`` groups tensors into size-capped, dtype-homogeneous
buckets that keep the leaves' order (``MXTPU_ELASTIC_BUCKET_MB``, default
4 MiB). It is the one packing definition of the framework: the packed
optimizer apply (``kernels/optimizer_apply.py``) launches one kernel per
bucket. The collective markers of the JAX module
(``tag_gradient_buckets``, ``bucketed_reduce``) arrive with the multi-GPU
slice.
"""
from __future__ import annotations

from ..base import getenv

__all__ = ["bucket_plan", "default_bucket_bytes"]


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
    return plan
