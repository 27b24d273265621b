"""Gluon on ``torch.nn.Module``."""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import model_zoo  # noqa: F401
from . import fused_step  # noqa: F401
from .fused_step import train_step  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
