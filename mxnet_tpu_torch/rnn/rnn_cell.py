"""The legacy symbolic RNN cells, ``mx.rnn`` (counterpart of
mxnet_tpu/rnn/rnn_cell.py), built on the port's Symbol graphs.

- A stepwise ``unroll`` builds one symbol graph, which the executor runs
  node by node on tensors.
- ``FusedRNNCell`` is one node of the registry's ``RNN`` op
  (``ops/nn.py``), whose recurrence loops over time under autograd.
- The reference leaves the batch dimension of initial states 0 and lets
  shape inference fill it. Inference here runs forward only, so
  ``unroll`` turns a constant begin state into a ``broadcast_like`` of
  the input, which carries the batch size.
"""
from __future__ import annotations

import warnings

from .. import initializer as init
from .. import ndarray
from .. import symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "BaseConvRNNCell", "ConvRNNCell",
           "ConvLSTMCell", "ConvGRUCell"]


def _context_of(v):
    """The context of an NDArray; None (the current context) for a host
    array."""
    return v.context if isinstance(v, ndarray.NDArray) else None


class RNNParams(object):
    """Weight-sharing container: name -> Variable, all prefixed."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize between a merged Symbol and a per-step list. Returns
    (inputs, t_axis)."""
    assert inputs is not None, \
        "unroll(inputs=None) is not supported; create input variables " \
        "outside unroll"
    t_axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else t_axis
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert len(inputs.list_outputs()) == 1, \
                "grouped symbols cannot be unrolled; pass list(inputs)"
            inputs = list(symbol.split(inputs, axis=in_axis,
                                       num_outputs=length, squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=t_axis) for i in inputs]
            inputs = symbol.concat(*inputs, dim=t_axis)
            in_axis = t_axis
    if isinstance(inputs, symbol.Symbol) and t_axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=t_axis, dim2=in_axis)
    return inputs, t_axis


_DEFERRED_STATE_OPS = ("_zeros", "_ones")


def _concretize_states(states, ref, ref_batch_axis):
    """Replace deferred-batch constant states (shape contains 0) with
    ``broadcast_like`` graphs deriving the batch size from ``ref``: shape
    inference runs forward only, so the batch dim must come from a symbol
    that has it."""
    out = []
    for st in states:
        if isinstance(st, (list, tuple)):
            out.append(_concretize_states(st, ref, ref_batch_axis))
            continue
        node = st._outputs[0][0]
        shape = tuple(node.attrs.get("shape") or ())
        if node.op in _DEFERRED_STATE_OPS and 0 in shape:
            if shape.count(0) != 1:
                raise ValueError("begin_state shape %s has more than one "
                                 "deferred dim" % (shape,))
            b_axis = shape.index(0)
            base_shape = tuple(1 if i == b_axis else d
                               for i, d in enumerate(shape))
            maker = symbol.zeros if node.op == "_zeros" else symbol.ones
            base = maker(shape=base_shape)
            st = symbol.broadcast_like(base, ref, lhs_axes=(b_axis,),
                                       rhs_axes=(ref_batch_axis,),
                                       name=node.name)
        out.append(st)
    return out


class BaseRNNCell(object):
    """Abstract stepwise RNN cell."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in getattr(self, "_cells", []):
            cell.reset()

    def __call__(self, inputs, states):
        """One time step: (output, new_states)."""
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial states. With the default ``func=symbol.zeros`` the
        batch dim stays deferred (0) until ``unroll`` concretizes it;
        pass ``func=symbol.Variable`` to feed states as inputs."""
        assert not self._modified, \
            "cannot call begin_state on a cell wrapped by a modifier; " \
            "call it on the modifier cell"
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if info is not None:
                kwargs.update(info)
            states.append(func(name=name, **kwargs))
        return states

    # -- fused<->per-gate weight translation --------------------------------
    def unpack_weights(self, args):
        """Split each fused i2h/h2h matrix into per-gate entries."""
        args = args.copy()
        gates = self._gate_names
        if not gates:
            return args
        h = self._num_hidden
        for grp in ("i2h", "h2h"):
            w = args.pop("%s%s_weight" % (self._prefix, grp))
            b = args.pop("%s%s_bias" % (self._prefix, grp))
            for j, gate in enumerate(gates):
                args["%s%s%s_weight" % (self._prefix, grp, gate)] = \
                    w[j * h:(j + 1) * h].copy()
                args["%s%s%s_bias" % (self._prefix, grp, gate)] = \
                    b[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights."""
        args = args.copy()
        gates = self._gate_names
        if not gates:
            return args
        for grp in ("i2h", "h2h"):
            ws, bs = [], []
            for gate in gates:
                ws.append(args.pop("%s%s%s_weight"
                                   % (self._prefix, grp, gate)))
                bs.append(args.pop("%s%s%s_bias" % (self._prefix, grp, gate)))
            args["%s%s_weight" % (self._prefix, grp)] = \
                ndarray.concatenate(ws)
            args["%s%s_bias" % (self._prefix, grp)] = ndarray.concatenate(bs)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll across time into one symbol graph."""
        self.reset()
        inputs, _ = _format_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = _concretize_states(begin_state, inputs[0], 0)
        outputs = []
        for t in range(length):
            output, states = self(inputs[t], states)
            outputs.append(output)
        outputs, _ = _format_sequence(length, outputs, layout, merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell: out = act(i2h + h2h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order [i, f, c, o]."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=init.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        gates = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * 4, name="%si2h" % name) \
            + symbol.FullyConnected(
                data=states[0], weight=self._hW, bias=self._hB,
                num_hidden=self._num_hidden * 4, name="%sh2h" % name)
        gi, gf, gc, go = symbol.SliceChannel(gates, num_outputs=4,
                                             name="%sslice" % name)
        in_gate = symbol.Activation(gi, act_type="sigmoid", name="%si" % name)
        forget = symbol.Activation(gf, act_type="sigmoid", name="%sf" % name)
        cand = symbol.Activation(gc, act_type="tanh", name="%sc" % name)
        out_gate = symbol.Activation(go, act_type="sigmoid",
                                     name="%so" % name)
        next_c = symbol.elemwise_add(forget * states[1], in_gate * cand,
                                     name="%sstate" % name)
        next_h = symbol.elemwise_mul(
            out_gate, symbol.Activation(next_c, act_type="tanh"),
            name="%sout" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """cuDNN-variant GRU, gate order [r, z, o]."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%s_i2h" % name)
        h2h = symbol.FullyConnected(data=prev, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%s_h2h" % name)
        ir, iz, inew = symbol.SliceChannel(i2h, num_outputs=3,
                                           name="%s_i2h_slice" % name)
        hr, hz, hnew = symbol.SliceChannel(h2h, num_outputs=3,
                                           name="%s_h2h_slice" % name)
        reset = symbol.Activation(ir + hr, act_type="sigmoid",
                                  name="%s_r_act" % name)
        update = symbol.Activation(iz + hz, act_type="sigmoid",
                                   name="%s_z_act" % name)
        cand = symbol.Activation(inew + reset * hnew, act_type="tanh",
                                 name="%s_h_act" % name)
        next_h = symbol.elemwise_add((1.0 - update) * cand, update * prev,
                                     name="%sout" % name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused cell: one node of the `RNN` op over a packed
    parameter vector, in place of per-step symbols."""

    _GATE_NAMES = {"rnn_relu": ("",), "rnn_tanh": ("",),
                   "lstm": ("_i", "_f", "_c", "_o"),
                   "gru": ("_r", "_z", "_o")}

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get(
            "parameters", init=init.FusedRNN(
                None, num_hidden, num_layers, mode, bidirectional,
                forget_bias))

    @property
    def state_info(self):
        ld = self._num_layers * (2 if self._bidirectional else 1)
        n_states = 2 if self._mode == "lstm" else 1
        return [{"shape": (ld, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n_states)]

    @property
    def _gate_names(self):
        return self._GATE_NAMES[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """Per-gate views into the packed vector, in the layout of
        ops/nn.py _rnn_unpack_params (weights layer-major, direction
        inner, then biases): cuDNN's."""
        args = {}
        gates = self._gate_names
        dirs = self._directions
        b = len(dirs)
        p = 0
        for layer in range(self._num_layers):
            isz = li if layer == 0 else b * lh
            for d in dirs:
                for grp, cols in (("i2h", isz), ("h2h", lh)):
                    for gate in gates:
                        name = "%s%s%d_%s%s_weight" % (self._prefix, d,
                                                       layer, grp, gate)
                        args[name] = arr[p:p + lh * cols].reshape((lh, cols))
                        p += lh * cols
        for layer in range(self._num_layers):
            for d in dirs:
                for grp in ("i2h", "h2h"):
                    for gate in gates:
                        name = "%s%s%d_%s%s_bias" % (self._prefix, d,
                                                     layer, grp, gate)
                        args[name] = arr[p:p + lh]
                        p += lh
        assert p == arr.size, "invalid fused parameter size"
        return args

    def unpack_weights(self, args):
        args = args.copy()
        packed = args.pop(self._parameter.name)
        host = packed.asnumpy() if isinstance(packed, ndarray.NDArray) \
            else packed
        ctx = _context_of(packed)
        from ..ops.nn import rnn_packed_input_size
        h = self._num_hidden
        num_input = rnn_packed_input_size(
            host.size, self._mode, h, self._num_layers,
            len(self._directions))
        for name, w in self._slice_weights(host, num_input, h).items():
            args[name] = ndarray.array(w.copy(), ctx=ctx)
        return args

    def pack_weights(self, args):
        # assembled in a host numpy buffer, placed on the weights' context
        # once at the end
        from ..ops.nn import rnn_packed_param_size
        args = args.copy()
        h = self._num_hidden
        w0 = args["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        total = rnn_packed_param_size(self._mode, w0.shape[1], h,
                                      self._num_layers,
                                      len(self._directions))
        import numpy as _np
        host = _np.zeros((total,), dtype=_np.dtype(_np.asarray(
            w0.asnumpy() if isinstance(w0, ndarray.NDArray) else w0).dtype))
        for name, w in self._slice_weights(host, w0.shape[1], h).items():
            v = args.pop(name)
            w[:] = v.asnumpy() if isinstance(v, ndarray.NDArray) else v
        args[self._parameter.name] = ndarray.array(host,
                                                   ctx=_context_of(w0))
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _format_sequence(length, inputs, layout, True)
        if axis == 1:
            warnings.warn("NTC layout detected. Consider using TNC for "
                          "FusedRNNCell for faster speed")
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        else:
            assert axis == 0, "unsupported layout %s" % layout
        if begin_state is None:
            begin_state = self.begin_state()
        # inputs is TNC here: batch rides axis 1
        states = _concretize_states(begin_state, inputs, 1)
        kwargs = {"state": states[0]}
        if self._mode == "lstm":
            kwargs["state_cell"] = states[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional,
                         p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **kwargs)
        if not self._get_next_state:
            outputs, states = rnn, []
        else:
            outs = list(rnn)
            for s in outs[1:]:
                s._set_attr(__layout__="LNC")
            outputs, states = outs[0], outs[1:]
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        outputs, _ = _format_sequence(length, outputs, layout, merge_outputs)
        return outputs, states

    def unfuse(self):
        """Equivalent stack of stepwise cells."""
        cell_of = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    cell_of("%sl%d_" % (self._prefix, i)),
                    cell_of("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(cell_of("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


def _cells_state_info(cells):
    return sum((c.state_info for c in cells), [])


def _cells_begin_state(cells, **kwargs):
    return sum((c.begin_state(**kwargs) for c in cells), [])


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "specify params for SequentialRNNCell or children, not both"
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified, \
            "cannot call begin_state on a modifier-wrapped cell"
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell), \
                "BidirectionalCell cannot be stepped"
            n = len(cell.state_info)
            inputs, sub = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(sub)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        last = len(self._cells) - 1
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=begin_state[p:p + n],
                layout=layout,
                merge_outputs=None if i < last else merge_outputs)
            p += n
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout-on-input cell."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        assert isinstance(dropout, (int, float)), \
            "dropout probability must be a number"
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _format_sequence(length, inputs, layout, merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            return self(inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Wraps a base cell to alter its behavior; parameters stay with the
    base cell."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, \
            "cannot call begin_state on a modifier-wrapped cell"
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout on outputs/states."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell does not support zoneout; unfuse() first"
        assert not isinstance(base_cell, BidirectionalCell), \
            "apply ZoneoutCell to the cells inside a BidirectionalCell"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev = self.prev_output
        if prev is None:
            prev = symbol.zeros_like(next_output)
        output = next_output
        if self.zoneout_outputs != 0.:
            output = symbol.where(mask(self.zoneout_outputs, next_output),
                                  next_output, prev)
        if self.zoneout_states != 0.:
            next_states = [
                symbol.where(mask(self.zoneout_states, ns), ns, os)
                for ns, os in zip(next_states, states)]
        self.prev_output = output
        return output, next_states


class ResidualCell(ModifierCell):
    """output = base(output) + input."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name="%s_plus_residual" % output.name)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        if merge_outputs is None:
            merge_outputs = isinstance(outputs, symbol.Symbol)
        inputs, _ = _format_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(
                outputs, inputs, name="%s_plus_residual" % outputs.name)
        else:
            outputs = [symbol.elemwise_add(o, i,
                                           name="%s_plus_residual" % o.name)
                       for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(BaseRNNCell):
    """Unrolls l_cell forward and r_cell backward, concatenating outputs."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params, \
                "specify params for BidirectionalCell or children, not both"
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell cannot be stepped; use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified, \
            "cannot call begin_state on a modifier-wrapped cell"
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _format_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = _concretize_states(begin_state, inputs[0], 0)
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout,
            merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, symbol.Symbol) \
                and isinstance(r_outputs, symbol.Symbol)
            if not merge_outputs:
                if isinstance(l_outputs, symbol.Symbol):
                    l_outputs = list(symbol.SliceChannel(
                        l_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
                if isinstance(r_outputs, symbol.Symbol):
                    r_outputs = list(symbol.SliceChannel(
                        r_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
        if merge_outputs:
            l_outputs = [l_outputs]
            r_outputs = [symbol.reverse(r_outputs, axis=axis)]
        else:
            r_outputs = list(reversed(r_outputs))
        outputs = []
        for i, (lo, ro) in enumerate(zip(l_outputs, r_outputs)):
            nm = "%sout" % self._output_prefix if merge_outputs \
                else "%st%d" % (self._output_prefix, i)
            outputs.append(symbol.concat(lo, ro, dim=1 + merge_outputs,
                                         name=nm))
        if merge_outputs:
            outputs = outputs[0]
        return outputs, [l_states, r_states]


class BaseConvRNNCell(BaseRNNCell):
    """Convolutional RNN base: i2h/h2h are convolutions over spatial
    state maps."""

    def __init__(self, input_shape, num_hidden, h2h_kernel, h2h_dilate,
                 i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                 i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer,
                 activation, prefix="", params=None, conv_layout="NCHW"):
        super().__init__(prefix=prefix, params=params)
        assert h2h_kernel[0] % 2 == 1 and h2h_kernel[1] % 2 == 1, \
            "h2h kernel dims must be odd, got %s" % str(h2h_kernel)
        self._h2h_kernel = h2h_kernel
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._h2h_dilate = h2h_dilate
        self._i2h_kernel = i2h_kernel
        self._i2h_stride = i2h_stride
        self._i2h_pad = i2h_pad
        self._i2h_dilate = i2h_dilate
        self._num_hidden = num_hidden
        self._input_shape = input_shape
        self._conv_layout = conv_layout
        self._activation = activation
        # state spatial dims = i2h conv output dims, batch deferred
        probe = symbol.Convolution(
            data=symbol.Variable("_probe_data"), num_filter=num_hidden,
            kernel=i2h_kernel, stride=i2h_stride, pad=i2h_pad,
            dilate=i2h_dilate, layout=conv_layout)
        out_shape = probe.infer_shape(_probe_data=input_shape)[1][0]
        self._state_shape = (0,) + tuple(out_shape[1:])
        self._iW = self.params.get("i2h_weight",
                                   init=i2h_weight_initializer)
        self._hW = self.params.get("h2h_weight",
                                   init=h2h_weight_initializer)
        self._iB = self.params.get("i2h_bias", init=i2h_bias_initializer)
        self._hB = self.params.get("h2h_bias", init=h2h_bias_initializer)

    @property
    def _num_gates(self):
        return len(self._gate_names)

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout},
                {"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def _conv_forward(self, inputs, states, name):
        i2h = symbol.Convolution(
            data=inputs, num_filter=self._num_hidden * self._num_gates,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate, weight=self._iW,
            bias=self._iB, layout=self._conv_layout, name="%si2h" % name)
        h2h = symbol.Convolution(
            data=states[0], num_filter=self._num_hidden * self._num_gates,
            kernel=self._h2h_kernel, stride=(1, 1), pad=self._h2h_pad,
            dilate=self._h2h_dilate, weight=self._hW, bias=self._hB,
            layout=self._conv_layout, name="%sh2h" % name)
        return i2h, h2h

    def __call__(self, inputs, states):
        raise NotImplementedError("BaseConvRNNCell is abstract")


class ConvRNNCell(BaseConvRNNCell):
    """Conv RNN cell."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer=None, h2h_bias_initializer=None,
                 activation="tanh", prefix="ConvRNN_", params=None,
                 conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         activation, prefix, params, conv_layout)

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class ConvLSTMCell(BaseConvRNNCell):
    """Conv LSTM (Shi et al. 2015)."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer=None, h2h_bias_initializer=None,
                 activation="tanh", prefix="ConvLSTM_", params=None,
                 forget_bias=1.0, conv_layout="NCHW"):
        if i2h_bias_initializer is None:
            i2h_bias_initializer = init.LSTMBias(forget_bias=forget_bias)
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         activation, prefix, params, conv_layout)

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        gates = i2h + h2h
        c_axis = self._conv_layout.find("C")
        gi, gf, gc, go = symbol.SliceChannel(gates, num_outputs=4,
                                             axis=c_axis,
                                             name="%sslice" % name)
        in_gate = symbol.Activation(gi, act_type="sigmoid",
                                    name="%si" % name)
        forget = symbol.Activation(gf, act_type="sigmoid",
                                   name="%sf" % name)
        cand = self._get_activation(gc, self._activation, name="%sc" % name)
        out_gate = symbol.Activation(go, act_type="sigmoid",
                                     name="%so" % name)
        next_c = symbol.elemwise_add(forget * states[1], in_gate * cand,
                                     name="%sstate" % name)
        next_h = symbol.elemwise_mul(
            out_gate, self._get_activation(next_c, self._activation),
            name="%sout" % name)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Conv GRU."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer=None, h2h_bias_initializer=None,
                 activation="tanh", prefix="ConvGRU_", params=None,
                 conv_layout="NCHW"):
        super().__init__(input_shape, num_hidden, h2h_kernel, h2h_dilate,
                         i2h_kernel, i2h_stride, i2h_pad, i2h_dilate,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         activation, prefix, params, conv_layout)

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        c_axis = self._conv_layout.find("C")
        ir, iz, inew = symbol.SliceChannel(i2h, num_outputs=3, axis=c_axis,
                                           name="%s_i2h_slice" % name)
        hr, hz, hnew = symbol.SliceChannel(h2h, num_outputs=3, axis=c_axis,
                                           name="%s_h2h_slice" % name)
        reset = symbol.Activation(ir + hr, act_type="sigmoid",
                                  name="%s_r_act" % name)
        update = symbol.Activation(iz + hz, act_type="sigmoid",
                                   name="%s_z_act" % name)
        cand = self._get_activation(inew + reset * hnew, self._activation,
                                    name="%s_h_act" % name)
        next_h = symbol.elemwise_add((1.0 - update) * cand,
                                     update * states[0],
                                     name="%sout" % name)
        return next_h, [next_h]
