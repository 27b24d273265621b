"""The op namespace handed to ``hybrid_forward`` as ``F``: a module of
plain functions on ``torch.Tensor`` (``F.Convolution``, ``F.BatchNorm``,
``F.transpose``, ...). The ``NDArray`` wrapper class is not ported yet;
tensors are ``torch.Tensor`` throughout."""
from .register import invoke, populate

populate(globals())

__all__ = ["invoke"]
