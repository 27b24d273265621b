"""Contrib recurrent cells (counterpart of
mxnet_tpu/gluon/contrib/rnn/rnn_cell.py): variational dropout and the
LSTM with a projected state."""
from __future__ import annotations

from ...rnn.rnn_cell import (HybridRecurrentCell, ModifierCell,
                             BidirectionalCell, SequentialRNNCell)

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """The same dropout mask at every step on the inputs, the first state
    and the outputs (Gal and Ghahramani 2016); ``reset()`` (each
    ``unroll``) draws new masks."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        assert not drop_states or not isinstance(
            base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support state dropout; apply it to " \
            "the cells underneath instead."
        assert not drop_states or not isinstance(
            base_cell, SequentialRNNCell) or not base_cell._bidirectional, \
            "Bidirectional SequentialRNNCell doesn't support state dropout"
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_input_masks(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(
                F.ones_like(states[0]), p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(
                F.ones_like(inputs), p=self.drop_inputs)

    def _initialize_output_mask(self, F, output):
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(
                F.ones_like(output), p=self.drop_outputs)

    def hybrid_forward(self, F, inputs, states):
        self._initialize_input_masks(F, inputs, states)
        if self.drop_states:
            # the first state only: common cells repeat their output there
            states = ([states[0] * self.drop_states_mask]
                      + list(states[1:]))
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = self.base_cell(inputs, states)
        self._initialize_output_mask(F, next_output)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def __repr__(self):
        return "VariationalDropoutCell(%s)" % self.base_cell.name


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projected hidden state (LSTMP, Sak et al. 2014); states
    [h_proj, c]."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _shape_hint(self, x, *args):
        h, p = self._hidden_size, self._projection_size
        return {self.i2h_weight: (4 * h, x.shape[-1]),
                self.h2h_weight: (4 * h, p),
                self.h2r_weight: (p, h),
                self.i2h_bias: (4 * h,), self.h2h_bias: (4 * h,)}

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        h = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * h)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * h)
        slices = F.split(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.Activation(slices[0], act_type="sigmoid")
        forget_gate = F.Activation(slices[1], act_type="sigmoid")
        in_transform = F.Activation(slices[2], act_type="tanh")
        out_gate = F.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.Activation(next_c, act_type="tanh")
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]

    def __repr__(self):
        return "LSTMPCell(%d -> %d)" % (self._hidden_size,
                                        self._projection_size)
