"""Shape and dtype ops on torch tensors (counterpart of the pieces of
mxnet_tpu/ops/tensor.py that the ResNet path uses)."""
from __future__ import annotations

import torch

from ..base import canonical_dtype
from .registry import register

__all__ = ["reshape", "flatten", "transpose", "cast", "ones_like", "pick"]


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


@register("pick")
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """x's entries at ``index`` along ``axis`` (indices clipped into range,
    MXNet's default mode)."""
    ax = axis % x.dim()
    idx = torch.clamp(index.to(torch.int64), 0, x.shape[ax] - 1)
    out = torch.gather(x, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


def _reduce(fn):
    def _fn(x, axis=None, keepdims=False, exclude=False):
        if axis is None:
            axes = tuple(range(x.dim()))
        else:
            axes = {a % x.dim() for a in
                    (axis if isinstance(axis, (tuple, list)) else (axis,))}
            if exclude:
                axes = set(range(x.dim())) - axes
            axes = tuple(sorted(axes))
        if not axes:        # nothing to reduce (torch reads () as "all")
            return x
        return fn(x, dim=axes, keepdim=keepdims)
    return _fn


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))
register("mean")(_reduce(torch.mean))
