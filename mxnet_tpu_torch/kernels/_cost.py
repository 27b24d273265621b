"""The modeled work of one step: its floating-point operations and bytes.

The JAX package reads a step's flops and bytes from XLA's
``cost_analysis()`` of the compiled program. PyTorch runs eagerly and has
no compiled program, so the port counts the work itself while one step
runs under :func:`counting`, a ``TorchDispatchMode``:

- ``flops``: the matrix products and convolutions, by
  ``torch.utils.flop_counter``'s formulas (2 x multiply-adds; a
  convolution's backward counts the input and the weight products it
  computes), plus the tensor-core work the port's kernels declare.
- ``vector_ops``: the element-wise operations the port's kernels declare
  (BatchNorm's moments and normalize, the packed optimizer apply, the
  2-bit codec, the NMS walk). They run on the CUDA cores, so they stay out
  of ``flops``, which is priced at the tensor peak.
- ``bytes``: every aten operator counts the bytes of its tensor operands
  and results once, views excepted (they move nothing). That is an upper
  estimate, with no fusion: a value one operator writes and the next reads
  counts twice, where XLA's post-fusion ``bytes accessed`` counts only what
  crosses the fused kernels' boundaries. A kernel of the port counts the
  bytes its ``cost()`` declares (each input read once, each output written
  once).

Each kernel wrapper opens :func:`launch` around its work, on the card and
on the CPU alike: its declared ``cost()`` is counted and nothing inside it
(the plain version's aten ops on the CPU, the allocations beside a launch
on the card) is counted again. So one step counts the same on the CPU and
on the card.

Nothing is counted, and :func:`launch` costs one global read, when no
:func:`counting` scope is open.
"""
from __future__ import annotations

import contextlib

__all__ = ["Counts", "counting", "launch"]

# the open Counts, or None. A global and not a thread-local: the autograd
# engine runs a CUDA backward on its own thread, and the dispatch mode
# follows it there.
_ACTIVE = None
_NULL = contextlib.nullcontext()


class Counts:
    """What one :func:`counting` scope saw."""

    def __init__(self):
        self.flops = 0.0
        self.vector_ops = 0.0
        self.bytes = 0.0
        self.kernels = {}   # kernel name -> launches counted
        self._depth = 0     # > 0 inside a kernel's launch scope


class _Launch:
    __slots__ = ("_c",)

    def __init__(self, c):
        self._c = c

    def __enter__(self):
        self._c._depth += 1

    def __exit__(self, *exc):
        self._c._depth -= 1


def launch(name, cost_fn, *args, tensor_core=True):
    """The scope of one kernel launch (or its plain version): counts
    ``cost_fn(*args)`` = ``(flops, bytes)`` as tensor-core flops or, with
    ``tensor_core=False``, as vector ops, and keeps what runs inside out of
    the count. ``cost_fn`` is called only while :func:`counting` is open."""
    c = _ACTIVE
    if c is None or c._depth:
        return _NULL
    c._depth += 1       # the cost's own ops (box_nms reads its data) too
    try:
        flops, nbytes = cost_fn(*args)
    finally:
        c._depth -= 1
    if tensor_core:
        c.flops += flops
    else:
        c.vector_ops += flops
    c.bytes += nbytes
    c.kernels[name] = c.kernels.get(name, 0) + 1
    return _Launch(c)


def _nbytes(objs, seen):
    import torch
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor) and id(o) not in seen:
            seen.add(id(o))
            total += o.numel() * o.element_size()
    return total


def _mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    class _CountMode(TorchDispatchMode):
        def __init__(self, counts):
            super().__init__()
            self.counts = counts

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            c = self.counts
            if c._depth or func.is_view:
                return out
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                c.flops += float(formula(*args, **kwargs, out_val=out))
            c.bytes += float(_nbytes(tree_leaves((args, kwargs)), set())
                             + _nbytes(tree_leaves(out), set()))
            return out

    return _CountMode


@contextlib.contextmanager
def counting():
    """Count the work of what runs inside; yields the :class:`Counts`.
    Not reentrant: an inner scope while one is open raises."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("kernels._cost.counting() is already open")
    counts = Counts()
    _ACTIVE = counts
    try:
        with _mode_class()(counts):
            yield counts
    finally:
        _ACTIVE = None
