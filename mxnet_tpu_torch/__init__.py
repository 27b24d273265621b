"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference this port is held against;
this package imports none of it, and no JAX. Entry points run on the card
(``gpu(0)``) unless the caller passes a CPU context, and raise when no
CUDA device is present. Kernels of the JAX package written in Pallas for
the TPU are hand-written CUDA kernels here (``kernels/``, ``csrc/``),
built with nvcc at first use.

The ported slice is ResNet V1 inference: contexts, the op namespace,
Gluon blocks and layers, the model-zoo ResNets with the fused
BN->ReLU->conv3x3 kernel, and weight loading (``convert``).
"""
from . import base
from .base import MXNetError
from . import context
from .context import Context, cpu, gpu, current_context
from . import random
from . import autograd
from . import initializer
from . import ndarray
from . import kernels
from . import gluon
from . import convert

nd = ndarray
init = initializer

__all__ = ["base", "MXNetError", "context", "Context", "cpu", "gpu",
           "current_context", "random", "autograd",
           "initializer", "init", "ndarray", "nd", "kernels", "gluon",
           "convert"]
