"""The ``nd.contrib`` namespace (counterpart of mxnet_tpu/ndarray/contrib.py):
the control-flow operators ``foreach``, ``while_loop`` and ``cond``,
``boolean_mask``, every registered ``_contrib_X`` op as ``X``
(``nd.contrib.quantized_conv``, ``nd.contrib.quantize_v2``, ...), and
``quantize`` / ``dequantize`` of ``contrib.quantization``, which take the
names first, as in the JAX package and the reference. Each op takes
tensors or NDArrays, and gives NDArrays for NDArrays, with ``out=``
written in place.

The control-flow operators are eager Python loops over NDArray ops, as the
reference's imperative versions are, so under ``autograd.record()`` each
step's ops join torch's graph and the stacked outputs are differentiable.
``while_loop`` and ``cond`` read their predicate on the host, one sync per
test.
"""
from ..contrib.quantization import quantize, dequantize
from ..ops import registry as _registry
from . import NDArray as _NDArray, boolean_mask  # noqa: F401
from . import concat as _concat, stack as _stack, zeros as _zeros
from .register import make_op as _make_op


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _truth(v):
    """A predicate's value on the host: an NDArray of one element, or
    anything ``bool`` takes."""
    return bool(v.asnumpy().item()) if isinstance(v, _NDArray) else bool(v)


def foreach(body, data, init_states):
    """Run ``body(data_t, states) -> (out, new_states)`` over axis 0 of
    ``data`` (an NDArray or a list of them); the outputs come back stacked
    along a new axis 0, with the last states."""
    single_data = isinstance(data, _NDArray)
    seqs = [data] if single_data else list(data)
    if not seqs:
        raise ValueError("foreach requires at least one input sequence")
    length = seqs[0].shape[0]
    for s in seqs[1:]:
        if s.shape[0] != length:
            raise ValueError(
                "foreach input sequences must share axis-0 length; got "
                "%d and %d" % (length, s.shape[0]))
    states = init_states
    outs = []
    for t in range(length):
        slices = [s[t] for s in seqs]
        out, states = body(slices[0] if single_data else slices, states)
        outs.append(out)
    if not outs:
        raise ValueError("foreach over empty data")
    if isinstance(outs[0], (list, tuple)):
        stacked = [_stack(*[o[i] for o in outs], axis=0)
                   for i in range(len(outs[0]))]
    else:
        stacked = _stack(*outs, axis=0)
    return stacked, states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``while cond(*loop_vars): step_out, loop_vars = func(*loop_vars)``,
    at most ``max_iterations`` times. Returns (outputs, last loop_vars):
    each output stacked along axis 0 and padded with zeros to
    ``max_iterations`` rows, as the reference's static output is."""
    if max_iterations is None:
        raise ValueError("max_iterations must be provided")
    loop_vars = _as_list(loop_vars)
    outs = []
    steps = 0
    while steps < max_iterations and _truth(cond(*loop_vars)):
        step_out, new_vars = func(*loop_vars)
        outs.append(_as_list(step_out))
        loop_vars = _as_list(new_vars)
        steps += 1
    if not outs:
        raise ValueError("while_loop ran zero steps (cond was false at "
                         "entry); outputs would have unknown shape")
    stacked = []
    for i in range(len(outs[0])):
        col = _stack(*[o[i] for o in outs], axis=0)
        if steps < max_iterations:
            pad = _zeros((max_iterations - steps,) + col.shape[1:],
                         ctx=col.context, dtype=col._data.dtype)
            col = _concat(col, pad, dim=0)
        stacked.append(col)
    return stacked, loop_vars


def cond(pred, then_func, else_func):
    """``then_func()`` if the scalar ``pred`` holds, else
    ``else_func()``."""
    return then_func() if _truth(pred) else else_func()


def _populate_contrib():
    g = globals()
    for name in _registry.list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if short not in g:
                g[short] = _make_op(_registry.get_op(name), short)


_populate_contrib()

__all__ = sorted(k for k in globals() if not k.startswith("_"))
