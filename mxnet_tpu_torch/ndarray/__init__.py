"""The op namespace handed to ``hybrid_forward`` as ``F``: a module of
plain functions on ``torch.Tensor`` (``F.Convolution``, ``F.BatchNorm``,
``F.transpose``, ...), and the optimizer update ops with the reference's
in-place ``out=`` convention (``nd.sgd_mom_update(w, g, m, lr=...,
out=w)``, ``optimizer_ops.py``), which take the place of the registry's
pure forms of the same names. The ``NDArray`` wrapper class is not ported
yet; tensors are ``torch.Tensor`` throughout."""
from .register import invoke, populate

populate(globals())

from .optimizer_ops import *  # noqa: E402,F401,F403

__all__ = ["invoke"]
