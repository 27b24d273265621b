"""Checkpoint helpers of the legacy RNN package (counterpart of
mxnet_tpu/rnn/rnn.py): fused weights are unpacked to per-gate entries on
save, so checkpoints are readable and portable, and packed again on load,
which restores the `RNN` op's single parameter vector."""
from __future__ import annotations

import warnings

from ..model import load_checkpoint, save_checkpoint
from .rnn_cell import BaseRNNCell

__all__ = ["rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def rnn_unroll(cell, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC"):
    """Deprecated alias for cell.unroll."""
    warnings.warn("rnn_unroll is deprecated. Call cell.unroll directly.")
    return cell.unroll(length=length, inputs=inputs,
                       begin_state=begin_state, layout=layout)


def _as_cells(cells):
    return [cells] if isinstance(cells, BaseRNNCell) else list(cells)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """save_checkpoint with fused weights unpacked."""
    for cell in _as_cells(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """load_checkpoint with weights re-packed."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback that saves unpacked checkpoints."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
