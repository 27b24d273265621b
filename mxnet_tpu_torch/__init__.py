"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` is the reference this port is held against;
this package imports none of it, and no JAX. Entry points run on the card
(``gpu(0)``) unless the caller passes a CPU context, and raise when no
CUDA device is present. Kernels of the JAX package written in Pallas for
the TPU are hand-written CUDA kernels here (``kernels/``, ``csrc/``),
built with nvcc at first use.

The ported slices are ResNet V1 inference and its training step, the
transformer LM's training step, int8 inference, and the in-process
kvstore with 2-bit gradient compression: contexts, the op namespace,
autograd recording, Gluon blocks, layers and losses, the model-zoo
ResNets (with the fused BN->ReLU->conv3x3 kernel for serving and the
fused training-mode BatchNorm kernels, and fused training through the
conv_fused backward kernels), the SGD and Adam optimizers,
``gluon.Trainer`` and the fused train step ``gluon.train_step`` (with
the packed optimizer-apply kernel, SGD and Adam), ``kvstore``
(``mx.kv.create``: push, pull and update on kvstore in one process, with
2-bit compression on the codec kernels of ``kernels/compression.py``),
the matmul precision policy, weight loading (``convert``), and the
decoder-only transformer LM of ``parallel.transformer`` (RoPE, RMSNorm,
SwiGLU, chunked cross-entropy, per-layer recompute, SGD-momentum step)
on the flash-attention kernels (``kernels/flash_attention.py``), and
int8 quantization: ``contrib.quantization`` (calibration and
``quantize_net``) and the quantized operator family
(``ops/quantized.py``, exposed as ``nd.contrib.quantized_conv`` and the
rest), on the int8 matmul kernel (``kernels/quantized_matmul.py``).

Arrays: ``mx.nd.array(...)`` gives an ``NDArray`` (``ndarray/ndarray.py``)
over a tensor, with the JAX package's methods, operators and elementwise
and tensor op families, ``attach_grad``/``backward``, and the checkpoint
path (``nd.save``/``nd.load``, ``Block.save_parameters``/
``load_parameters``, ``ParameterDict.save``/``load``) in the reference's
``.params`` format.

Layers and models: every op of the JAX package's ``ops/nn.py`` (but the
fused ``RNN``), ``ops/linalg.py`` (``mx.nd.linalg``) and
``ops/random_ops.py`` (``mx.nd.random``, drawn from one generator per
device, ``random.py``), every ``gluon.nn`` layer, and the vision model
zoo's ``get_model`` names (ResNet V1 and V2, VGG, AlexNet, DenseNet,
SqueezeNet, Inception V3, MobileNet V1 and V2).
"""
from . import base
from .base import MXNetError
from . import context
from .context import Context, cpu, gpu, cpu_pinned, current_context
from .context import num_gpus
from . import random
from . import precision
from . import autograd
from . import initializer
from . import ndarray
from .ndarray import NDArray
from . import kernels
from . import parallel
from . import optimizer
from . import lr_scheduler
from . import kvstore
from . import gluon
from . import convert
from . import contrib
from .ndarray import contrib as _nd_contrib  # noqa: F401  (nd.contrib)

nd = ndarray
init = initializer
kv = kvstore


def seed(seed_state, ctx="all"):
    """Seed the port's random stream (``mx.random.seed``)."""
    random.seed(seed_state, ctx)


def waitall():
    """Wait for all work on the devices (``mx.nd.waitall``)."""
    nd.waitall()


__all__ = ["base", "MXNetError", "context", "Context", "cpu", "gpu",
           "cpu_pinned", "num_gpus", "current_context", "NDArray", "seed",
           "waitall", "random", "precision", "autograd",
           "initializer", "init", "ndarray", "nd", "kernels", "parallel",
           "optimizer", "lr_scheduler", "kvstore", "kv", "gluon", "convert",
           "contrib"]
