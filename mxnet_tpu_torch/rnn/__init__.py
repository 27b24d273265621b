"""The legacy symbolic RNN API, ``mx.rnn`` (counterpart of
mxnet_tpu/rnn): symbolic cells (``rnn_cell.py``; ``FusedRNNCell`` is one
node of the fused ``RNN`` op), ``BucketSentenceIter`` (``io.py``) and the
checkpoint helpers (``rnn.py``)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
