"""Shape, indexing, ordering, reduction and creation ops on torch tensors
(counterpart of mxnet_tpu/ops/tensor.py). Every name and alias the JAX
module registers is registered here, with the reference's reshape codes
(0, -1, -2, -3, -4 and ``reverse``).

Index outputs keep the JAX package's dtypes (``argmax``, ``argsort`` and
``topk`` give float32 unless ``dtype`` says otherwise), and ties keep its
order: ``jnp.argsort`` is stable, so the port sorts with ``stable=True``
and, like JAX, descends by flipping the ascending order; ``topk`` takes
the lower index first among equal values, as ``lax.top_k`` does. Ops
without a tensor input (``_zeros``, ``arange``, ...) build on the current
context.
"""
from __future__ import annotations

import builtins

import numpy as _np
import torch

from ..base import canonical_dtype
from ..context import as_device
from .registry import register

__all__ = ["infer_reshape", "reshape", "flatten", "transpose", "cast",
           "ones_like", "pick"]


# ---------------------------------------------------------------------------
# reshape & friends
# ---------------------------------------------------------------------------

def infer_reshape(src_shape, target):
    """MXNet reshape codes: 0 copy a dim, -1 infer one, -2 copy the rest,
    -3 merge two dims, -4 split one dim into the next two values (one of
    them may be -1)."""
    src = list(src_shape)
    out = []
    i = 0
    t = list(target)
    j = 0
    while j < len(t):
        d = t[j]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1 if i < len(src) else 0
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            d1, d2 = t[j + 1], t[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in src_shape:
            total *= d
        out[out.index(-1)] = total // builtins.max(known, 1)
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def reshape(x, shape=None, reverse=False):
    if reverse:
        rshape = infer_reshape(tuple(x.shape)[::-1], list(shape)[::-1])[::-1]
        return x.reshape(rshape)
    return x.reshape(infer_reshape(tuple(x.shape), list(shape)))


@register("flatten", aliases=("Flatten",))
def flatten(x):
    return x.reshape(x.shape[0], -1)


@register("transpose")
def transpose(x, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(range(x.dim()))[::-1]
    return x.permute(*axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(x, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)


@register("expand_dims")
def expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(tuple(axis) if isinstance(axis, (tuple, list))
                     else axis)


@register("broadcast_to")
def broadcast_to(x, shape=None):
    tgt = tuple(s if t == 0 else t for s, t in zip(x.shape, shape))
    return torch.broadcast_to(x, tgt)


@register("broadcast_like")
def broadcast_like(x, like, lhs_axes=None, rhs_axes=None):
    """With axes given, only those dims of ``x`` take ``like``'s sizes."""
    if lhs_axes is None and rhs_axes is None:
        return torch.broadcast_to(x, like.shape)
    if lhs_axes is None or rhs_axes is None:
        raise ValueError("broadcast_like needs both lhs_axes and rhs_axes "
                         "or neither")
    lhs_axes = (lhs_axes,) if isinstance(lhs_axes, int) else tuple(lhs_axes)
    rhs_axes = (rhs_axes,) if isinstance(rhs_axes, int) else tuple(rhs_axes)
    if len(lhs_axes) != len(rhs_axes) or not lhs_axes:
        raise ValueError("lhs_axes and rhs_axes must be equal-length and "
                         "non-empty, got %s vs %s" % (lhs_axes, rhs_axes))
    tgt = list(x.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la % x.dim()] = like.shape[ra % like.dim()]
    return torch.broadcast_to(x, tuple(tgt))


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(x, tuple(tgt))


@register("tile")
def tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register("repeat")
def repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("reverse", aliases=("flip",))
def reverse(x, axis=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, axis)


@register("concat", aliases=("Concat", "concatenate"))
def concat(*xs, dim=1):
    return torch.cat(xs, dim=dim)


@register("stack")
def stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


@register("split", aliases=("SliceChannel",))
def split(x, num_outputs=1, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise ValueError("split: axis %d of size %d is not divisible by "
                         "num_outputs=%d" % (axis, x.shape[axis],
                                             num_outputs))
    parts = torch.chunk(x, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


def _index_along(x, axis, idx):
    """``x``'s entries at positions ``idx`` (a list) along ``axis``."""
    return torch.index_select(
        x, axis, torch.tensor(idx, dtype=torch.int64, device=x.device))


def _slice_dim(x, axis, b, e, s):
    """numpy's ``x[..., b:e:s, ...]`` on ``axis`` (any step sign)."""
    if s is None or s > 0:
        idx = [builtins.slice(None)] * x.dim()
        idx[axis] = builtins.slice(b, e, s)
        return x[tuple(idx)]
    return _index_along(x, axis,
                        list(range(*builtins.slice(b, e, s).indices(
                            x.shape[axis]))))


@register("slice", aliases=("crop",))
def slice_op(x, begin=(), end=(), step=()):
    step = step or (None,) * len(begin)
    for a, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _slice_dim(x, a, b, e, s)
    return x


@register("slice_axis")
def slice_axis(x, axis=0, begin=0, end=None):
    idx = [builtins.slice(None)] * x.dim()
    idx[axis] = builtins.slice(begin, end)
    return x[tuple(idx)]


@register("slice_like")
def slice_like(x, like, axes=()):
    axes = tuple(axes) if axes else tuple(range(builtins.min(x.dim(),
                                                             like.dim())))
    idx = [builtins.slice(None)] * x.dim()
    for a in axes:
        idx[a] = builtins.slice(0, like.shape[a])
    return x[tuple(idx)]


def _pad_index(n, lo, hi, mode):
    """Source positions of a dim of size ``n`` padded by ``lo`` and ``hi``
    (numpy's ``edge`` and ``reflect``)."""
    out = []
    for i in range(-lo, n + hi):
        if mode == "edge":
            out.append(builtins.min(builtins.max(i, 0), n - 1))
        else:
            period = 2 * (n - 1) if n > 1 else 1
            j = i % period if n > 1 else 0
            out.append(j if j < n else period - j)
    return out


@register("pad", aliases=("Pad",))
def pad(x, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(x.dim())]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pw):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, mode="constant",
                                       value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode %r" % (mode,))
    for a, (lo, hi) in enumerate(pw):
        if lo or hi:
            x = _index_along(x, a, _pad_index(x.shape[a], lo, hi, mode))
    return x


@register("where")
def where(cond, x, y):
    return torch.where(cond.bool(), x, y)


@register("diag")
def diag(x, k=0, axis1=0, axis2=1):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=axis1, dim2=axis2)


@register("depth_to_space")
def depth_to_space(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w)
    y = y.permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(x, block_size=1):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

@register("take")
def take(a, indices, axis=0, mode="clip"):
    """``a``'s slices at ``indices`` along ``axis``: indices clipped into
    range (``clip``, the default), taken modulo the size (``wrap``), or
    checked (``raise``)."""
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "raise":
        if idx.numel() and (int(idx.min()) < -n or int(idx.max()) >= n):
            raise IndexError("take: index out of range for axis of size %d"
                             % n)
        idx = torch.remainder(idx, n)
    else:
        idx = torch.clamp(idx, 0, n - 1)
    axis = axis % a.dim()
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick")
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """x's entries at ``index`` along ``axis`` (indices clipped into range,
    MXNet's default mode; the reference ignores ``mode``)."""
    ax = axis % x.dim()
    idx = torch.clamp(index.to(torch.int64), 0, x.shape[ax] - 1)
    out = torch.gather(x, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


@register("one_hot")
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    dt = canonical_dtype(dtype)
    pos = torch.arange(depth, device=indices.device)
    oh = (indices.to(torch.int64).unsqueeze(-1) == pos).to(dt)
    return oh * (on_value - off_value) + off_value


@register("gather_nd")
def gather_nd(data, indices):
    return data[tuple(indices.to(torch.int64))]


@register("scatter_nd")
def scatter_nd(data, indices, shape=None):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.to(torch.int64)), data,
                         accumulate=True)


@register("Embedding", aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    return take(weight, data, axis=0, mode="clip")


@register("SequenceMask", aliases=("sequence_mask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=True,
                  value=0.0, axis=0):
    """Entries at or past each sequence's length take ``value``; data is
    (T, B, ...) with axis 0, (B, T, ...) with axis 1."""
    if not use_sequence_length or sequence_length is None:
        return data
    T = data.shape[axis]
    pos = torch.arange(T, device=data.device)
    if axis == 0:
        mask = pos[:, None] < sequence_length[None, :]
    else:
        mask = pos[None, :] < sequence_length[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=True,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        idx = [builtins.slice(None)] * data.dim()
        idx[axis] = -1
        return data[tuple(idx)]
    last = sequence_length.to(torch.int64) - 1
    if axis == 0:   # (T, B, ...)
        idx = last.reshape((1, -1) + (1,) * (data.dim() - 2))
        idx = idx.expand((1,) + tuple(data.shape[1:]))
        return torch.gather(data, 0, idx)[0]
    idx = last.reshape((-1, 1) + (1,) * (data.dim() - 2))
    idx = idx.expand((data.shape[0], 1) + tuple(data.shape[2:]))
    return torch.gather(data, 1, idx)[:, 0]


@register("SequenceReverse", aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=True,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    T = data.shape[0]
    pos = torch.arange(T, device=data.device)[:, None]
    L = sequence_length.to(torch.int64)[None, :]
    src = torch.where(pos < L, L - 1 - pos, pos)     # (T, B)
    src = src.reshape(src.shape + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, src.expand(data.shape))


# ---------------------------------------------------------------------------
# reductions & ordering
# ---------------------------------------------------------------------------

def _norm_axis(axis):
    """None for every axis (also an empty tuple, as the JAX package reads
    it), else an int or a tuple."""
    if axis is None:
        return None
    if isinstance(axis, int):
        return axis
    ax = tuple(axis)
    return ax if ax else None


def _dims(x, axis, exclude=False):
    """The dims a reduction over ``axis`` covers (sorted, non-negative)."""
    ax = _norm_axis(axis)
    if ax is None:
        return tuple(range(x.dim()))
    ax = {a % x.dim() for a in (ax if isinstance(ax, tuple) else (ax,))}
    if exclude:
        ax = set(range(x.dim())) - ax
    return tuple(sorted(ax))


def _int_acc(x):
    """JAX's accumulation dtype of an integer or bool sum/prod (int32)."""
    return torch.int32 if not x.is_floating_point() else None


def _reduce(fn, acc=False, to_float=False):
    def _fn(x, axis=None, keepdims=False, exclude=False):
        dims = _dims(x, axis, exclude)
        if to_float and not x.is_floating_point():
            x = x.float()
        if not dims:        # nothing to reduce (torch reads () as "all")
            return x
        if acc:
            return fn(x, dim=dims, keepdim=keepdims, dtype=_int_acc(x))
        return fn(x, dim=dims, keepdim=keepdims)
    return _fn


def _nanprod(x, dim, keepdim, dtype=None):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim, dtype)


def _prod(x, dim, keepdim, dtype=None):
    """torch.prod over several dims, one at a time, last first."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, d, keepdim=keepdim, dtype=dtype)
        dtype = None
    return x


register("sum", aliases=("sum_axis",))(_reduce(torch.sum, acc=True))
register("mean")(_reduce(torch.mean, to_float=True))
register("prod")(_reduce(_prod, acc=True))
register("nansum")(_reduce(torch.nansum, acc=True))
register("nanprod")(_reduce(_nanprod, acc=True))
register("max", aliases=("max_axis",))(_reduce(torch.amax))
register("min", aliases=("min_axis",))(_reduce(torch.amin))


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    dims = _dims(x, axis)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=dims, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=keepdims))


def _arg(fn):
    def _f(x, axis=None, keepdims=False):
        out = fn(x.reshape(-1) if axis is None else x,
                 dim=0 if axis is None else axis)
        if keepdims and axis is not None:
            out = out.unsqueeze(axis)
        return out.to(torch.float32)
    return _f


register("argmax")(_arg(torch.argmax))
register("argmin")(_arg(torch.argmin))


@register("argmax_channel")
def argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("cumsum")
def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    out = torch.cumsum(x, dim=axis, dtype=_int_acc(x))
    return out.to(canonical_dtype(dtype)) if dtype else out


def _sorted(x, axis):
    """Stable ascending sort along ``axis``: (values, int64 indices)."""
    return torch.sort(x, dim=axis, stable=True)


@register("sort")
def sort(x, axis=-1, is_ascend=True):
    out = _sorted(x, axis).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    out = _sorted(x, axis).indices
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(canonical_dtype(dtype))


@register("topk")
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (or, ``is_ascend``, smallest) entries along
    ``axis``: their indices, values, both, or a mask; the lower index
    first among equal values."""
    axis = axis % x.dim()
    moved = torch.movedim(x, axis, -1)
    idxs = torch.sort(moved, dim=-1, descending=not is_ascend,
                      stable=True).indices[..., :k]
    dt = canonical_dtype(dtype)
    values = torch.movedim(torch.gather(moved, -1, idxs), -1, axis)
    indices = torch.movedim(idxs, -1, axis).to(dt)
    if ret_typ == "indices":
        return indices
    if ret_typ == "value":
        return values
    if ret_typ == "both":
        return values, indices
    if ret_typ == "mask":
        pos = torch.arange(x.shape[axis], device=x.device)
        oh = (idxs.unsqueeze(-1) == pos).to(dt).sum(-2)
        return torch.movedim(oh, -1, axis)
    raise ValueError(ret_typ)


@register("shape_array")
def shape_array(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@register("size_array")
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int64, device=x.device)


@register("cast", aliases=("Cast",))
def cast(x, dtype="float32"):
    return x.to(canonical_dtype(dtype))


@register("amp_cast")
def amp_cast(x, dtype="bfloat16"):
    return x.to(canonical_dtype(dtype))


@register("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register("identity", aliases=("_copy", "BlockGrad_inner"))
def identity(x):
    return x


@register("stop_gradient", aliases=("BlockGrad",))
def stop_gradient(x):
    return x.detach()


@register("make_loss", aliases=("MakeLoss",))
def make_loss(x, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    return x


# -- creation: no tensor input, so on the current context --------------------

@register("_zeros")
def _zeros(shape=(), dtype="float32"):
    return torch.zeros(tuple(shape), dtype=canonical_dtype(dtype),
                       device=as_device())


@register("_ones")
def _ones(shape=(), dtype="float32"):
    return torch.ones(tuple(shape), dtype=canonical_dtype(dtype),
                      device=as_device())


def arange_values(start, stop, step, repeat, dtype, device):
    """``jnp.arange``'s values (numpy's ``arange`` in the target dtype;
    bf16 through float32), each repeated ``repeat`` times."""
    dt = canonical_dtype(dtype)
    np_dt = _np.float32 if dt == torch.bfloat16 else \
        torch.empty((), dtype=dt).numpy().dtype
    out = torch.from_numpy(_np.arange(start, stop, step, dtype=np_dt))
    out = out.to(device=device, dtype=dt)
    if repeat and int(repeat) > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("arange", aliases=("_arange",))
def arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
           dtype="float32"):
    return arange_values(start, stop, step, repeat, dtype, as_device())


@register("full", aliases=("_full",))
def full(shape=(), value=0.0, dtype="float32"):
    return torch.full(tuple(shape), value, dtype=canonical_dtype(dtype),
                      device=as_device())


@register("_full")
def _full(shape=(), dtype="float32", value=0.0):
    return torch.full(tuple(shape), value, dtype=canonical_dtype(dtype),
                      device=as_device())
