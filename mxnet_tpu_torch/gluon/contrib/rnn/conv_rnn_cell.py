"""Convolutional recurrent cells (counterpart of
mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py): Conv1D/2D/3D RNN, LSTM and
GRU cells, made by ``_make``. Channels-first layouts (NCW, NCHW, NCDHW);
``conv_layout`` is accepted and not used, as in the JAX package."""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, dims):
    return (v,) * dims if isinstance(v, int) else tuple(v)


class _BaseConvRNNCell(HybridRecurrentCell):
    """The i2h and h2h convolutions over spatial states."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._dims = dims
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        assert all(k % 2 == 1 for k in self._h2h_kernel), \
            "h2h_kernel must be odd so the state keeps its spatial shape " \
            "(got %s)" % (h2h_kernel,)
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in zip(
            self._h2h_dilate, self._h2h_kernel))

        in_c = self._input_shape[0]
        spatial = self._input_shape[1:]
        out_spatial = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, d, k in zip(spatial, self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        self._state_shape = (hidden_channels,) + out_spatial

        ng = self._num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(ng * hidden_channels, in_c)
            + self._i2h_kernel, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(ng * hidden_channels, hidden_channels)
            + self._h2h_kernel, init=h2h_weight_initializer,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(ng * hidden_channels,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(ng * hidden_channels,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[-self._dims:]}] * self._n_states

    def _conv_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                      i2h_bias, h2h_bias):
        ng = self._num_gates
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel,
                            stride=(1,) * self._dims,
                            pad=self._i2h_pad, dilate=self._i2h_dilate,
                            num_filter=ng * self._hidden_channels)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel,
                            stride=(1,) * self._dims,
                            pad=self._h2h_pad, dilate=self._h2h_dilate,
                            num_filter=ng * self._hidden_channels)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    """out = act(conv(x) + conv(h))."""

    _gate_names = ("",)
    _n_states = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    """Convolutional LSTM (Shi et al. 2015)."""

    _gate_names = ("_i", "_f", "_c", "_o")
    _n_states = 2

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.Activation(slices[0], act_type="sigmoid")
        forget_gate = F.Activation(slices[1], act_type="sigmoid")
        in_transform = self._get_activation(F, slices[2], self._activation)
        out_gate = F.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c,
                                                 self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    """Convolutional GRU."""

    _gate_names = ("_r", "_z", "_o")
    _n_states = 1

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_o = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_o = F.split(h2h, num_outputs=3, axis=1)
        reset = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        new = self._get_activation(F, i2h_o + reset * h2h_o,
                                   self._activation)
        next_h = (1.0 - update) * new + update * states[0]
        return next_h, [next_h]


def _make(base, dims, name, default_act):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 conv_layout=None, activation=default_act, prefix=None,
                 params=None):
        base.__init__(self, input_shape=input_shape,
                      hidden_channels=hidden_channels,
                      i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                      i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                      h2h_dilate=h2h_dilate,
                      i2h_weight_initializer=i2h_weight_initializer,
                      h2h_weight_initializer=h2h_weight_initializer,
                      i2h_bias_initializer=i2h_bias_initializer,
                      h2h_bias_initializer=h2h_bias_initializer,
                      dims=dims, conv_layout=conv_layout,
                      activation=activation, prefix=prefix, params=params)

    cls = type(name, (base,), {"__init__": __init__,
                               "__doc__": "%dD %s"
                               % (dims, base.__doc__.splitlines()[0])})
    return cls


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell", "tanh")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell", "tanh")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell", "tanh")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell", "tanh")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell", "tanh")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell", "tanh")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell", "leaky")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell", "leaky")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell", "leaky")
