"""Shape and dtype ops on torch tensors (counterpart of the pieces of
mxnet_tpu/ops/tensor.py that the ResNet path uses)."""
from __future__ import annotations

import torch

from ..base import canonical_dtype
from .registry import register

__all__ = ["reshape", "flatten", "transpose", "cast", "ones_like"]


def _infer_reshape(shape, target):
    """MXNet reshape codes 0 (copy this input dim) and -1 (infer)."""
    out = []
    for i, t in enumerate(target):
        if t == 0:
            out.append(shape[i])
        elif t >= -1:
            out.append(t)
        else:
            raise NotImplementedError("reshape code %d is not ported" % t)
    return out


@register("reshape", aliases=("Reshape",))
def reshape(x, shape=None):
    return x.reshape(_infer_reshape(tuple(x.shape), list(shape)))


@register("flatten", aliases=("Flatten",))
def flatten(x):
    return x.reshape(x.shape[0], -1)


@register("transpose")
def transpose(x, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(range(x.dim()))[::-1]
    return x.permute(*axes)


@register("cast", aliases=("Cast",))
def cast(x, dtype="float32"):
    return x.to(canonical_dtype(dtype))


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)

