"""The global batch of a data-parallel step across processes.

Under ``ShardedTrainStep``'s default path on a mesh that spans a process
group (the JAX package's GSPMD step), every rank holds its rows of one
global batch, and the ops whose result depends on the whole batch see it
whole, as one device sees it in the JAX program:

- BatchNorm normalizes with the global batch's statistics
  (``ops.nn.batch_norm`` gives ``mean_fn()`` to the fused BatchNorm's
  ``across`` hook; the fused ResNet link's fold, ``global_moments``), so
  the moving statistics are the same on every rank;
- Dropout draws the global batch's mask from the generator every rank
  shares and keeps this rank's rows (``dropout_rows``).

``scope(group, world, index)`` marks such a step: ``group`` is the
data-parallel axis's process group, ``world`` its size and ``index`` this
rank's position in it. Outside a scope nothing here is active.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["scope", "active", "sum_over", "mean_fn", "global_moments",
           "dropout_rows"]

_state = threading.local()


@contextlib.contextmanager
def scope(group, world, index):
    """Ops inside the block see the global batch of ``world`` ranks."""
    prev = getattr(_state, "cur", None)
    _state.cur = (group, int(world), int(index))
    try:
        yield
    finally:
        _state.cur = prev


def active():
    """(group, world, index) of the enclosing scope, or None."""
    return getattr(_state, "cur", None)


def sum_over(t, group):
    """The sum of ``t`` over the group, differentiable."""
    from ..parallel.collectives import _AllReduceSum, _all_reduce_
    t = t.contiguous()
    if t.requires_grad and torch.is_grad_enabled():
        return _AllReduceSum.apply(t, group)
    return _all_reduce_(t.clone(), group, what="global batch statistics")


def mean_fn():
    """Inside a scope, the function giving the mean of a tensor over the
    group (``sum_over`` divided by the world); None elsewhere."""
    cur = active()
    if cur is None:
        return None
    group, world, _ = cur
    return lambda t: sum_over(t, group) / world


def global_moments(mean32, var32, group, world):
    """The global batch's f32 mean and variance from every rank's, over
    equal row counts (``batchnorm_fused.combine_moments``). With one rank
    they are the rank's own, bit for bit. Differentiable."""
    from ..kernels.batchnorm_fused import combine_moments
    return combine_moments(mean32, var32,
                           lambda t: sum_over(t, group) / world)


def dropout_rows(shape, draw, shared=False):
    """A Dropout mask of ``shape`` (this rank's rows first): inside a
    scope, ``draw`` makes the global batch's mask and this rank's rows are
    kept; elsewhere, or for a mask ``shared`` by every row, ``draw(shape)``."""
    cur = active()
    if cur is None or shared or not shape:
        return draw(shape)
    _, world, index = cur
    rows = shape[0]
    full = draw((rows * world,) + tuple(shape[1:]))
    return full[index * rows:(index + 1) * rows]
