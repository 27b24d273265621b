"""Model zoo of the port: ``vision`` and its ``get_model``."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
