"""Contrib recurrent cells (counterpart of mxnet_tpu/gluon/contrib/rnn)."""
from .rnn_cell import *        # noqa: F401,F403
from .conv_rnn_cell import *   # noqa: F401,F403
