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

Layers and models: every op of the JAX package's ``ops/nn.py`` (the
fused ``RNN`` included), ``ops/linalg.py`` (``mx.nd.linalg``),
``ops/random_ops.py`` (``mx.nd.random``, drawn from one generator per
device, ``random.py``) and ``ops/misc_tail.py``, every ``gluon.nn``
layer, and the vision model zoo's ``get_model`` names (ResNet V1 and V2,
VGG, AlexNet, DenseNet, SqueezeNet, Inception V3, MobileNet V1 and V2).

Recurrent networks: ``gluon.rnn`` (the cells, ``unroll`` with valid
lengths, the modifier and bidirectional cells, the fused ``RNN``,
``LSTM`` and ``GRU`` layers), ``gluon.contrib.rnn`` (variational
dropout, LSTMP, the convolutional cells) and the legacy symbolic
``mx.rnn`` (cells, ``FusedRNNCell``, ``BucketSentenceIter``, the
checkpoint helpers), loaded at first use. No kernel of the repository
runs on this path: the recurrence is a loop of products and gate math
under autograd, as the JAX package's is a ``lax.scan``.

Training scripts: automatic mixed precision (``contrib.amp``: a cast
policy at the op dispatch point and a dynamic loss scaler), data loading
(``gluon.data``: datasets, samplers, vision transforms and datasets, the
``DataLoader``; ``io``: ``NDArrayIter`` and the file readers), metrics
accumulated on the device (``metric``), callbacks (``callback``) and
``gluon.utils`` (``split_and_load``, ``clip_global_norm``); the record-file
input path (``recordio``, ``io.ImageRecordIter`` on raw-pixel, JPEG and PNG
records, ``io.DevicePrefetchIter``, the record and folder datasets) and the
losses, initializers, ``autograd.Function``, ``gluon.Constant`` and
``nd.contrib`` control flow of the JAX package.

Images and detection: ``image`` (decoding, augmenters, ``ImageIter``),
``image_det`` (label-aware augmenters, ``ImageDetIter``; its names also
resolve from ``image``), the ``nd.image`` ops, and the box, anchor, ROI
and detection ops (``ops/extended.py``, ``ops/detection.py``; greedy NMS on
the ``box_nms`` kernel). Encoded images are OpenCV's (``cv2``), imported at
the first call that needs it and never by ``import mxnet_tpu_torch``.

The symbolic and Module API: ``mx.sym`` (``symbol/``: graphs of the
registry's ops, ``name.NameManager``/``Prefix`` and ``AttrScope`` scopes,
shape inference on meta tensors, ``sym.contrib`` control flow, the
reference's graph JSON), ``executor.Executor`` (the graph interpreted on
tensors under torch autograd), ``mx.mod`` (``Module``,
``BucketingModule``: ``fit``, ``score``, ``predict``), ``mx.model``
(``prefix-symbol.json`` + ``prefix-%04d.params`` checkpoints,
``FeedForward``), ``Predictor``, ``gluon.SymbolBlock`` (with
``HybridBlock.export`` and tracing by a Symbol input) and ``mx.jit``
(``CachedOp``). ``Module`` and ``Predictor`` run on ``gpu(0)`` unless
given a context. ``mx.operator`` (``CustomOp``, ``nd.Custom``,
``sym.Custom``) and ``symbol.subgraph`` (``partition``).

Observability: ``mx.profiler`` (trace lanes, the aggregate table,
latency histograms, ``/metrics``, a ``torch.profiler`` device session),
``mx.storage`` (device memory stats and the tagged allocation ledger),
``_debug`` (the always-on flight recorder, the step and memory watchdogs,
goodput, fault points, the lock-order tracer, the roofline join
``perfmodel`` and the training-health plane ``healthmon``), ``mx.monitor``
and ``mx.tensor_inspector``; ``gluon.compile_cache`` keeps the kernels'
builds in a persistent directory. Importing the package
starts no thread and no server; the flight recorder's crash hooks
(``sys.excepthook``, ``threading.excepthook``, SIGUSR2, ``faulthandler``)
are installed at import, as in the JAX package (``MXTPU_FLIGHTREC_HOOKS=0``
leaves them out).
"""
from . import base
from .base import MXNetError
from . import profiler
from . import storage
from . import context
from .context import Context, cpu, gpu, cpu_pinned, current_context
from .context import num_gpus
from . import random
from . import precision
from .precision import (set_matmul_precision, get_matmul_precision,
                        matmul_precision)
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
from . import metric
from . import callback
from . import io
from . import recordio
from . import image
from .ndarray import contrib as _nd_contrib  # noqa: F401  (nd.contrib)
from . import name
from . import attribute
from .attribute import AttrScope
from . import symbol
from . import executor
from . import model
from . import module
from . import jit
from . import predictor
from .predictor import Predictor
from . import operator
from . import monitor
from . import tensor_inspector

nd = ndarray
init = initializer
kv = kvstore
sym = symbol
mod = module


def seed(seed_state, ctx="all"):
    """Seed the port's random stream (``mx.random.seed``)."""
    random.seed(seed_state, ctx)


def waitall():
    """Wait for all work on the devices (``mx.nd.waitall``)."""
    nd.waitall()


def __getattr__(name):
    # the legacy symbolic RNN package loads at first use, as in the JAX
    # package
    if name == "rnn":
        import importlib
        mod = importlib.import_module(".rnn", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


__all__ = ["base", "MXNetError", "context", "Context", "cpu", "gpu",
           "cpu_pinned", "num_gpus", "current_context", "NDArray", "seed",
           "waitall", "random", "precision", "set_matmul_precision",
           "get_matmul_precision", "matmul_precision", "autograd",
           "initializer", "init", "ndarray", "nd", "kernels", "parallel",
           "optimizer", "lr_scheduler", "kvstore", "kv", "gluon", "convert",
           "contrib", "metric", "callback", "io", "recordio", "image",
           "name", "attribute", "AttrScope", "symbol", "sym", "executor",
           "model", "module", "mod", "jit", "predictor", "Predictor",
           "profiler", "storage", "operator", "monitor",
           "tensor_inspector"]
