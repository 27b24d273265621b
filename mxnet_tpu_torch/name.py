"""Automatic naming scopes (counterpart of mxnet_tpu/name.py; ref:
python/mxnet/name.py NameManager/Prefix).

Symbol nodes take their automatic names through ``symbol._auto_name`` and
``symbol.register._scoped_name``; the innermost active ``NameManager``
(per thread) takes over that naming, as the reference's thread-local
NameManager stack does."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_current = threading.local()


def _stack():
    if not hasattr(_current, "stack"):
        _current.stack = []
    return _current.stack


class NameManager:
    """Gives ``hint%d`` names, one counter per hint."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        """``name`` if given, else a fresh name for ``hint``."""
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *args):
        _stack().pop()


class Prefix(NameManager):
    """A NameManager that puts ``prefix`` before every name, given or
    automatic."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    """The active NameManager, or None (the module-wide counters name)."""
    stack = _stack()
    return stack[-1] if stack else None
