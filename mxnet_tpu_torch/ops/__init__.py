"""Registered ops of the port; importing this package fills the
registry."""
from . import registry  # noqa: F401
from .registry import register, get_op, list_ops, OpDef
from . import nn, tensor, elemwise, linalg, random_ops  # noqa: F401
from . import quantized, optimizer_ops  # noqa: F401
from . import ctc, extended, image, detection  # noqa: F401
from . import misc_tail  # noqa: F401

__all__ = ["register", "get_op", "list_ops", "OpDef"]
