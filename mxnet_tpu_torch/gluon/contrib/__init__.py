"""Gluon contrib (counterpart of mxnet_tpu/gluon/contrib). Ported so far:
``rnn``. The ``cnn``, ``data``, ``estimator`` and ``nn`` parts come with
the contrib slice."""
from . import rnn  # noqa: F401
