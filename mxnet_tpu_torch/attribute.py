"""Attribute scopes for symbols (counterpart of mxnet_tpu/attribute.py;
ref: python/mxnet/attribute.py AttrScope): the nodes made inside
``with mx.AttrScope(key="value"):`` take its attributes, as
``ctx_group`` tags for ``group2ctx`` or a user's own node tags."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current", "apply"]

_current = threading.local()


def _stack():
    if not hasattr(_current, "stack"):
        _current.stack = []
    return _current.stack


class AttrScope:
    """A scope of string attributes."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("Attributes need to be strings")
        self._attr = kwargs

    def get(self, attr=None):
        """The scope's attributes with ``attr`` over them."""
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *args):
        _stack().pop()


def current():
    """The attributes of every active scope, the innermost winning."""
    merged = {}
    for scope in _stack():
        merged.update(scope._attr)
    return merged


def apply(attrs):
    """The scopes' attributes with ``attrs`` over them: the one place where
    node builders merge AttrScope state."""
    merged = current()
    if attrs:
        merged.update(attrs)
    return merged
