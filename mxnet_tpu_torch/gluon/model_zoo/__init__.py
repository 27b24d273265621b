"""Model zoo of the port."""
from . import vision  # noqa: F401
