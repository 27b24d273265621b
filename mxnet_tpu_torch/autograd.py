"""Recording, train/predict mode and gradients on torch autograd (counterpart
of mxnet_tpu/autograd.py).

``record()`` turns recording on (and torch's grad mode with it) and, by
default, training mode; blocks called outside recording run under
``torch.no_grad``. The graph is torch's own; this module keeps MXNet's
gradient conventions on top of it:

- ``grad_req``. A tracked leaf (a Parameter's tensor, or a tensor given to
  ``mark_variables``) carries its request. ``"write"`` overwrites the
  gradient at each backward (torch accumulates into ``.grad``, so a hook
  on the leaf drops the old gradient just before the new one lands),
  ``"add"`` accumulates, ``"null"`` takes no gradient. Each backward marks
  the leaf's gradient fresh (``_fresh_grad``), which ``Trainer`` reads.
- A non-scalar head. ``backward`` seeds ones for a head given no gradient,
  as MXNet does, and a block's output under recording is a ``Head`` whose
  ``.backward()`` does the same.
- ``Function``. A user's forward and backward on NDArrays ride a
  ``torch.autograd.Function``, so the graph stays torch's.
- NDArrays. ``backward``, ``grad`` and ``mark_variables`` take NDArray
  heads, head gradients and variables as well as tensors. An NDArray
  variable (``attach_grad``, ``mark_variables``) keeps its gradient in an
  NDArray of its own (``.grad``, or the one given to ``mark_variables``),
  which each backward rebinds to the new gradient (``_bind_grad``), as the
  JAX package's tape writes it.
"""
from __future__ import annotations

import threading
import time as _time
import weakref

import torch

from . import profiler as _profiler

__all__ = ["is_training", "set_training", "is_recording", "set_recording",
           "record", "pause", "train_mode", "predict_mode",
           "mark_variables", "backward", "grad", "deliver_grad", "Head",
           "Function", "get_symbol"]


class _State(threading.local):
    def __init__(self):
        self.training = False
        self.recording = False


_STATE = _State()
# Calls of grad() in progress. Process-wide, not per thread: torch runs the
# backward of CUDA tensors, and so the leaf hooks, on its own device threads.
_IN_GRAD = [0]


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(is_record):
    prev = _STATE.recording
    _STATE.recording = bool(is_record)
    return prev


def set_training(train_mode):
    prev = _STATE.training
    _STATE.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Scope guard flipping (recording, training); ``None`` leaves a flag
    as it is. Flipping recording flips torch's grad mode with it."""

    def __init__(self, is_record, train_mode):
        self._enter = (is_record, train_mode)
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training,
                      torch.is_grad_enabled())
        is_record, train_mode = self._enter
        if is_record is not None:
            _STATE.recording = bool(is_record)
            torch.set_grad_enabled(bool(is_record))
        if train_mode is not None:
            _STATE.training = bool(train_mode)
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training, grad_mode = self._prev
        torch.set_grad_enabled(grad_mode)
        return False


def record(train_mode=True):
    """Record operations for differentiation (training mode by default)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Stop recording inside a ``record()`` scope."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# -- gradient requests on leaves ----------------------------------------------

def _on_leaf_grad(ref):
    def hook(g):
        t = ref()
        if t is not None and not _IN_GRAD[0]:
            if getattr(t, "_grad_req", "write") == "write":
                t.grad = None            # the new gradient replaces the old
            else:
                holder = getattr(t, "_nd_grad", None)
                if holder is not None:   # "add" starts from the holder's
                    t.grad = holder._data
            t._fresh_grad = True
        return g
    return hook


def _deliver_nd_grad(t):
    """After accumulation: the NDArray that holds ``t``'s gradient takes
    the new one."""
    holder = getattr(t, "_nd_grad", None)
    if holder is not None and t.grad is not None:
        holder._data = t.grad


def _bind_grad(arr):
    """Make NDArray ``arr``'s tensor a leaf with request ``arr._grad_req``
    whose gradient lands in NDArray ``arr._grad``."""
    t = arr._data
    track(t, arr._grad_req)
    holder = arr._grad
    if holder._data.shape != t.shape or holder._data.dtype != t.dtype \
            or holder._data.device != t.device:
        holder._data = torch.zeros_like(t)
    t.grad = holder._data
    t._nd_grad = holder
    if not getattr(t, "_nd_hooked", False):
        t.register_post_accumulate_grad_hook(_deliver_nd_grad)
        t._nd_hooked = True


def deliver_grad(var, g):
    """Write gradient ``g`` into NDArray ``var``'s grad buffer as its
    grad_req says: "add" accumulates, otherwise it is written in the
    buffer's dtype. Without a buffer (grad_req "null") nothing happens."""
    holder = var._grad
    if holder is None:
        return
    g = _tensor(g)
    holder._data = holder._data + g if var._grad_req == "add" \
        else g.to(holder._data.dtype)
    var._data.grad = holder._data


def _tensor(x):
    """The tensor of an NDArray (else ``x`` itself)."""
    from .ndarray.ndarray import NDArray
    return x._data if isinstance(x, NDArray) else x


def track(tensor, grad_req):
    """Give leaf ``tensor`` MXNet's gradient request ``grad_req``
    ("write", "add" or "null"): sets ``requires_grad`` and, once per
    tensor, the hook that applies the request at each backward."""
    if grad_req not in ("write", "add", "null"):
        raise ValueError("grad_req must be 'write', 'add' or 'null', got %r"
                         % (grad_req,))
    tensor._grad_req = grad_req
    tensor.requires_grad_(grad_req != "null")
    if grad_req != "null" and not getattr(tensor, "_grad_tracked", False):
        tensor.register_hook(_on_leaf_grad(weakref.ref(tensor)))
        tensor._grad_tracked = True
    return tensor


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark leaves as variables: each gets ``gradients[i]`` as its gradient
    buffer and the request ``grad_reqs[i]``. Tensors or NDArrays; an
    NDArray gradient is rebound to each new gradient."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, (torch.Tensor, NDArray)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradient, req in zip(variables, gradients, grad_reqs):
        if isinstance(var, NDArray):
            var._grad_req = req
            var._data = var._data.detach()
            if req == "null":
                var._grad = None
            else:
                var._grad = gradient
                _bind_grad(var)
            continue
        track(var, req)
        var.grad = _tensor(gradient) if req != "null" else None


def _seeds(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(heads) != len(head_grads):
        raise ValueError("heads and head_grads must have the same length")
    heads = [_tensor(h) for h in heads]
    seeds = [torch.ones_like(h) if g is None else _tensor(g)
             for h, g in zip(heads, head_grads)]
    return heads, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the ``.grad`` of every tracked leaf they
    reach, honouring each leaf's grad_req. A head without a head gradient
    is seeded with ones, whatever its shape."""
    heads, seeds = _seeds(heads, head_grads)
    t0 = _time.perf_counter() if _profiler._LIVE else None
    torch.autograd.backward(heads, seeds, retain_graph=retain_graph)
    if t0 is not None:
        # the host span of the backward call: on the card the sweep's
        # kernels are queued, not finished, when it returns
        _profiler.record_op("autograd.backward",
                            (_time.perf_counter() - t0) * 1e6,
                            category="autograd", lane="autograd",
                            args={"heads": len(heads)})


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    instead of written into ``.grad`` (zeros for a variable the heads do
    not reach); NDArrays for NDArray variables."""
    from .ndarray.ndarray import NDArray, wrap
    single = not isinstance(variables, (list, tuple))
    if single:
        variables = [variables]
    as_nd = [isinstance(v, NDArray) for v in variables]
    variables = [_tensor(v) for v in variables]
    heads, seeds = _seeds(heads, head_grads)
    t0 = _time.perf_counter() if _profiler._LIVE else None
    _IN_GRAD[0] += 1         # the leaves' .grad stay as they are
    try:
        out = torch.autograd.grad(heads, variables, seeds,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
    finally:
        _IN_GRAD[0] -= 1
    if t0 is not None:
        _profiler.record_op("autograd.grad",
                            (_time.perf_counter() - t0) * 1e6,
                            category="autograd", lane="autograd",
                            args={"heads": len(heads),
                                  "variables": len(variables)})
    out = [torch.zeros_like(v) if g is None else g
           for g, v in zip(out, variables)]
    out = [wrap(g) if nd else g for g, nd in zip(out, as_nd)]
    return out[0] if single else out


class Head(torch.Tensor):
    """A block's output under recording: a plain tensor whose
    ``backward()`` takes MXNet's arguments and seeds ones for a non-scalar
    head. Operations on it give plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        backward([self], None if out_grad is None else [out_grad],
                 retain_graph=retain_graph)


class _FunctionNode(torch.autograd.Function):
    """Carries a user ``Function`` in torch's graph: its forward and
    backward run on NDArrays, outside recording."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray, wrap
        with pause():
            out = func.forward(*[wrap(t) for t in tensors])
        ctx.func = func
        func._single = isinstance(out, NDArray)
        outs = [out] if func._single else list(out)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray, wrap
        with pause():
            grads = ctx.func.backward(*[wrap(c) for c in cts])
        if isinstance(grads, NDArray):
            grads = [grads]
        return (None,) + tuple(_tensor(g) for g in grads)


def get_symbol(x):
    """The reference returns the recorded graph as a Symbol
    (python/mxnet/autograd.py:304). The tape here is torch's and holds no
    symbol graph, and the JAX package raises too: trace the block with a
    Symbol input instead (``net(mx.sym.var("data"))``)."""
    raise NotImplementedError(
        "get_symbol: trace the block with a Symbol input "
        "(net(mx.sym.var('data'))) instead")


class Function:
    """A user-defined differentiable function: subclass it, implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` on
    NDArrays, and keep what backward needs with ``save_for_backward``
    (read back as ``self.saved_tensors``). Under ``record()`` the call is
    one node of the graph, and backward gets the outputs' gradients (zeros
    for an output that reached no head). Given tensors instead of
    NDArrays, it returns tensors."""

    def __init__(self):
        self.saved_tensors = ()
        self._single = True

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, wrap
        as_nd = any(isinstance(x, NDArray) for x in inputs)
        tensors = [_tensor(x) for x in inputs]
        if is_recording():
            outs = _FunctionNode.apply(self, *tensors)
        else:
            with pause():
                out = self.forward(*[wrap(t) for t in tensors])
            self._single = isinstance(out, NDArray)
            outs = [o._data for o in ([out] if self._single else out)]
        outs = [wrap(o) if as_nd else o for o in outs]
        return outs[0] if self._single else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
