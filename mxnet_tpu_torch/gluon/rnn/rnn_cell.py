"""Recurrent cells (counterpart of mxnet_tpu/gluon/rnn/rnn_cell.py).

Each cell's step is a HybridBlock of registry ops; ``unroll`` steps it
over the sequence in a Python loop, under autograd. For long sequences
the fused layers of ``rnn_layer.py`` do the input projection of every
step in one product.

Gates as in the reference: LSTM [i, f, g, o], GRU [r, z, n] with
n = tanh(i2h_n + r * h2h_n).

A cell or an ``unroll`` called with NDArrays (inputs, states or lengths,
also inside lists) runs on their tensors and gives NDArrays back; called
with tensors it gives tensors. States made by ``begin_state`` inside
``unroll`` lie on the inputs' device, in their dtype.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...ndarray.ndarray import NDArray, wrap as _wrap
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


# -- the NDArray boundary --------------------------------------------------------

def _has_nd(v):
    if isinstance(v, NDArray):
        return True
    if isinstance(v, (list, tuple)):
        return any(_has_nd(x) for x in v)
    return False


def _tensors(v):
    """``v`` with every NDArray (also inside lists and tuples) replaced by
    its tensor."""
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (list, tuple)):
        return type(v)(_tensors(x) for x in v)
    return v


def _arrays(v):
    """``v`` with every tensor (also inside lists and tuples) wrapped as an
    NDArray."""
    if isinstance(v, torch.Tensor):
        return _wrap(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_arrays(x) for x in v)
    return v


def nd_boundary(call, *args, **kwargs):
    """``call(*args, **kwargs)`` on tensors; NDArrays back where any
    argument held one."""
    if not (_has_nd(args) or _has_nd(list(kwargs.values()))):
        return call(*args, **kwargs)
    return _arrays(call(*_tensors(args),
                        **{k: _tensors(v) for k, v in kwargs.items()}))


def zeros_like_input(x):
    """A ``begin_state`` func that makes zeros on ``x``'s device, in its
    dtype."""
    def func(shape, **kwargs):
        return torch.zeros(tuple(shape), dtype=x.dtype, device=x.device)
    return func


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """(inputs as a list of steps or one tensor, the time axis, the batch
    size)."""
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (list, tuple)):
        batch_size = inputs[0].shape[batch_axis]
        if merge:
            return nd.stack(*inputs, axis=axis), axis, batch_size
        return list(inputs), axis, batch_size
    batch_size = inputs.shape[batch_axis]
    if merge is False:
        seq = [nd.squeeze(x, axis=axis)
               for x in nd.split(inputs, num_outputs=inputs.shape[axis],
                                 axis=axis, squeeze_axis=False)]
        return seq, axis, batch_size
    return inputs, axis, batch_size


def _split_steps(x, length):
    return [nd.squeeze(s, axis=0) for s in
            nd.split(x, num_outputs=length, axis=0, squeeze_axis=False)]


def _mask_sequence_variable_length(data, length, valid_length, time_axis,
                                   merged):
    if merged:
        return nd.SequenceMask(data, sequence_length=valid_length,
                               use_sequence_length=True, axis=time_axis)
    outs = nd.SequenceMask(nd.stack(*data, axis=0),
                           sequence_length=valid_length,
                           use_sequence_length=True, axis=0)
    return _split_steps(outs, len(data))


class RecurrentCell(Block):
    """Base of the recurrent cells."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters, this cell's and its children's."""
        self._init_counter = -1
        self._counter = -1
        for _, cell in self._child_blocks():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states, one per ``state_info`` entry, made by ``func``
        (default ``nd.zeros``)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape=shape, **info, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell over ``length`` steps: (outputs, states). With
        ``valid_length`` (N,) each state is taken at its sample's last
        valid step and outputs past it are zero."""
        return nd_boundary(self._unroll, length, inputs, begin_state,
                           layout, merge_outputs, valid_length)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = begin_state or self.begin_state(
            batch_size=batch_size, func=zeros_like_input(inputs[0]))
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(
                outputs, length, valid_length, axis, False)
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        func = {"tanh": F.tanh, "relu": F.relu,
                "sigmoid": F.sigmoid, "softsign": F.softsign}.get(activation)
        if func is not None:
            return func(inputs)
        if activation == "leaky":
            return F.LeakyReLU(inputs, **kwargs)
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs)

    def __call__(self, inputs, states):
        if _has_nd(inputs) or _has_nd(states):
            return _arrays(self(_tensors(inputs), _tensors(states)))
        self._counter += 1
        return self._step(inputs, states)

    def _step(self, inputs, states):
        return Block.__call__(self, inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A recurrent cell whose step is a ``hybrid_forward``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x, *args):
        return HybridBlock.forward(self, x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _GatedCell(HybridRecurrentCell):
    """The four parameters of the cells whose projections are ``gates``
    times ``hidden_size`` wide."""

    _gates = 1

    def _register_params(self, hidden_size, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer):
        g = self._gates * hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(g, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(g, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def _shape_hint(self, x, *args):
        g = self._gates * self._hidden_size
        return {self.i2h_weight: (g, x.shape[-1]),
                self.h2h_weight: (g, self._hidden_size),
                self.i2h_bias: (g,), self.h2h_bias: (g,)}


class RNNCell(_GatedCell):
    """Elman RNN cell: h' = act(W_i2h x + b_i2h + W_h2h h + b_h2h)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self._register_params(hidden_size, input_size,
                              i2h_weight_initializer, h2h_weight_initializer,
                              i2h_bias_initializer, h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates [i, f, g, o]."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        self._register_params(hidden_size, input_size,
                              i2h_weight_initializer, h2h_weight_initializer,
                              i2h_bias_initializer, h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=4 * h)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * h)
        slices = F.split(i2h + h2h, num_outputs=4, axis=-1)
        rec = self._recurrent_activation
        in_gate = self._get_activation(F, slices[0], rec)
        forget_gate = self._get_activation(F, slices[1], rec)
        in_transform = self._get_activation(F, slices[2], self._activation)
        out_gate = self._get_activation(F, slices[3], rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates [r, z, n]."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        self._register_params(hidden_size, input_size,
                              i2h_weight_initializer, h2h_weight_initializer,
                              i2h_bias_initializer, h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=3 * h)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias, num_hidden=3 * h)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=-1)
        rec = self._recurrent_activation
        reset_gate = self._get_activation(F, i2h_r + h2h_r, rec)
        update_gate = self._get_activation(F, i2h_z + h2h_z, rec)
        next_h_tmp = self._get_activation(F, i2h_n + reset_gate * h2h_n,
                                          self._activation)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class _SequentialCellMixin:
    """The stack behaviour both sequential cells share."""

    def add(self, cell):
        self.register_child(cell)
        self._params.update(cell.collect_params())

    def state_info(self, batch_size=0):
        return _cells_state_info(self._cells(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells(), **kwargs)

    def _cells(self):
        return [c for _, c in self._child_blocks()]

    def _step(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return self._cells()[i]


class SequentialRNNCell(_SequentialCellMixin, RecurrentCell):
    """Cells applied in sequence at each step."""

    def forward(self, *args):
        raise NotImplementedError


class HybridSequentialRNNCell(_SequentialCellMixin, HybridRecurrentCell):
    """Cells applied in sequence at each step (hybrid)."""


class DropoutCell(HybridRecurrentCell):
    """Dropout on the input at each step."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert isinstance(rate, (int, float))
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base of the cells that wrap another cell; the parameters stay the
    base cell's."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def collect_params(self, select=None):
        return self.base_cell.collect_params(select)

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func or nd.zeros, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout on the outputs and states (Krueger et al. 2016)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Apply ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds the input to the base cell's output."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        if isinstance(outputs, (list, tuple)):
            inputs_l, _, _ = _format_sequence(length, inputs, layout, False)
            outputs = [o + i for o, i in zip(outputs, inputs_l)]
        else:
            merged, _, _ = _format_sequence(length, inputs, layout, True)
            outputs = outputs + merged
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward over the sequence, the
    outputs concatenated; only ``unroll`` runs it."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.l_cell = l_cell
        self.r_cell = r_cell
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix
        self._params.update(l_cell.collect_params())
        self._params.update(r_cell.collect_params())

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info([self.l_cell, self.r_cell], batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state([self.l_cell, self.r_cell], **kwargs)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if valid_length is None:
            reversed_inputs = list(reversed(inputs))
        else:
            # each sample reversed within its valid prefix, so the backward
            # cell sees its tokens first, not the padding
            rev = nd.SequenceReverse(nd.stack(*inputs, axis=0), valid_length,
                                     use_sequence_length=True)
            reversed_inputs = _split_steps(rev, length)
        begin_state = begin_state or self.begin_state(
            batch_size=batch_size, func=zeros_like_input(inputs[0]))

        n_l = len(self.l_cell.state_info(batch_size))
        l_outputs, l_states = self.l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = self.r_cell.unroll(
            length, inputs=reversed_inputs, begin_state=begin_state[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        else:
            rev = nd.SequenceReverse(nd.stack(*r_outputs, axis=0),
                                     valid_length, use_sequence_length=True)
            r_outputs = _split_steps(rev, length)
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
