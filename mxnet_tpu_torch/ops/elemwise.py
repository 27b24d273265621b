"""Elementwise ops on torch tensors (counterpart of the pieces of
mxnet_tpu/ops/elemwise.py that the ResNet path uses)."""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["rsqrt", "elemwise_add", "broadcast_mul"]


@register("rsqrt")
def rsqrt(x):
    return torch.rsqrt(x)


@register("elemwise_add")
def elemwise_add(lhs, rhs):
    return lhs + rhs


@register("broadcast_mul")
def broadcast_mul(lhs, rhs):
    return lhs * rhs
