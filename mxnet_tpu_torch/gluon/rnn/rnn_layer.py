"""Fused recurrent layers (counterpart of mxnet_tpu/gluon/rnn/rnn_layer.py).

The parameters are registered per layer and direction under the
reference's names (``l0_i2h_weight``, ``r0_h2h_bias``, ...), so
checkpoints of either package load by name, then packed into the one
1-D vector that the fused ``RNN`` op (``ops/nn.py``) takes. The op does
each layer's input projection for the whole sequence in one product and
steps the recurrence in a loop under autograd.
"""
from __future__ import annotations

from ... import autograd
from ... import ndarray as nd
from ...ops.nn import _RNN_GATES as _GATES
from ..block import HybridBlock
from .rnn_cell import (RNNCell, LSTMCell, GRUCell, HybridSequentialRNNCell,
                       DropoutCell, nd_boundary, zeros_like_input)

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base of the fused recurrent layers."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 dtype="float32", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise ValueError(
                "Invalid layout %r; must be one of ['TNC', 'NTC']" % layout)
        if projection_size:
            raise NotImplementedError("LSTMP projection is not supported")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        self._gates = _GATES[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param(
                    "{}{}_i2h_weight".format(j, i), (ng * nh, ni),
                    i2h_weight_initializer, dtype)
                self._register_param(
                    "{}{}_h2h_weight".format(j, i), (ng * nh, nh),
                    h2h_weight_initializer, dtype)
                self._register_param(
                    "{}{}_i2h_bias".format(j, i), (ng * nh,),
                    i2h_bias_initializer, dtype)
                self._register_param(
                    "{}{}_h2h_bias".format(j, i), (ng * nh,),
                    h2h_bias_initializer, dtype)
            ni = nh * self._dir

    def _register_param(self, name, shape, init, dtype):
        p = self.params.get(name, shape=shape, init=init, dtype=dtype,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape and shape[1] else None,
            shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _shape_hint(self, x, *args):
        ni = x.shape[2] if self._layout == "TNC" else x.shape[-1]
        ng, nh = self._gates, self._hidden_size
        hints = {}
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                hints[getattr(self, "%s%d_i2h_weight" % (j, i))] = \
                    (ng * nh, ni)
                hints[getattr(self, "%s%d_h2h_weight" % (j, i))] = \
                    (ng * nh, nh)
                hints[getattr(self, "%s%d_i2h_bias" % (j, i))] = (ng * nh,)
                hints[getattr(self, "%s%d_h2h_bias" % (j, i))] = (ng * nh,)
            ni = nh * self._dir
        return hints

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """Initial recurrent states, one per ``state_info`` entry."""
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name="%sh0_%d" % (self.prefix, i), **info))
        return states

    def unfuse(self):
        """An equivalent stack of unfused cells, with parameters of its own
        under the same names (one direction only)."""
        get_cell = {
            "rnn_relu": lambda **kw: RNNCell(self._hidden_size,
                                             activation="relu", **kw),
            "rnn_tanh": lambda **kw: RNNCell(self._hidden_size,
                                             activation="tanh", **kw),
            "lstm": lambda **kw: LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = HybridSequentialRNNCell(prefix=self.prefix, params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                if self._dir == 2:
                    raise NotImplementedError(
                        "unfuse does not support bidirectional layers")
                stack.add(get_cell(prefix="l%d_" % i, input_size=ni))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(DropoutCell(self._dropout))
                ni = self._hidden_size
        return stack

    def __call__(self, inputs, states=None):
        if states is None:
            return super().__call__(inputs)
        return nd_boundary(super().__call__, inputs, states)

    def forward(self, inputs, states=None):
        """The output sequence alone when ``states`` is None (zero initial
        states), else ``(output, new_states)``."""
        skip_states = states is None
        batch_size = inputs.shape[self._layout.find("N")]
        self._infer_param_shapes(inputs)
        if skip_states:
            states = self.begin_state(batch_size,
                                      func=zeros_like_input(inputs))
        if not isinstance(states, (list, tuple)):
            states = [states]
        for st, info in zip(states, self.state_info(batch_size)):
            if list(st.shape) != list(info["shape"]):
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(tuple(st.shape))))
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _pack_params(self):
        """The fused op's 1-D vector: all weights layer-major (direction
        inner), then all biases."""
        ws, bs = [], []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                ws.append(getattr(self, "%s%d_i2h_weight" % (j, i))
                          ._tensor().reshape(-1))
                ws.append(getattr(self, "%s%d_h2h_weight" % (j, i))
                          ._tensor().reshape(-1))
                bs.append(getattr(self, "%s%d_i2h_bias" % (j, i))
                          ._tensor().reshape(-1))
                bs.append(getattr(self, "%s%d_h2h_bias" % (j, i))
                          ._tensor().reshape(-1))
        return nd.concat(*(ws + bs), dim=0)

    def _forward_kernel(self, inputs, states):
        if self._layout == "NTC":
            inputs = nd.swapaxes(inputs, 0, 1)
        out = nd.RNN(inputs, self._pack_params(), *states,
                     state_size=self._hidden_size,
                     num_layers=self._num_layers,
                     bidirectional=self._dir == 2, p=self._dropout,
                     state_outputs=True, mode=self._mode,
                     _training=autograd.is_training())
        if self._mode == "lstm":
            outputs, states = out[0], [out[1], out[2]]
        else:
            outputs, states = out[0], [out[1]]
        if self._layout == "NTC":
            outputs = nd.swapaxes(outputs, 0, 1)
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh or relu."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, dtype="float32", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation,
                         dtype=dtype, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM; states [h, c]."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, dtype="float32", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm",
                         projection_size=projection_size, dtype=dtype,
                         **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU, gates [r, z, n]."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", dtype=dtype, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
