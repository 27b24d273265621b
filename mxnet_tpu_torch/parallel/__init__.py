"""Parallel helpers (counterpart of mxnet_tpu/parallel). One device so far:
the bucket plan that the packed optimizer apply shares with the gradient
reduction of the multi-GPU slice."""
from . import overlap  # noqa: F401
