"""Gluon on ``torch.nn.Module``."""
from .parameter import Parameter, ParameterDict, \
    DeferredInitializationError  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from . import nn  # noqa: F401
from . import model_zoo  # noqa: F401
