"""Parallel helpers and models (counterpart of mxnet_tpu/parallel). One
device so far: the bucket plan that the packed optimizer apply shares with
the gradient reduction of the multi-GPU slice, and the transformer LM's
single-device training step (``transformer``)."""
from . import overlap  # noqa: F401
from . import transformer  # noqa: F401
