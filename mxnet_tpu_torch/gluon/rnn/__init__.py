"""Gluon's recurrent API (counterpart of mxnet_tpu/gluon/rnn): the cells
of ``rnn_cell.py`` and the fused layers of ``rnn_layer.py``."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
from .rnn_cell import __all__ as _cell_all
from .rnn_layer import __all__ as _layer_all

__all__ = list(_cell_all) + list(_layer_all)
