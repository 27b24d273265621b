"""Random state (counterpart of mxnet_tpu/random.py).

One explicit ``torch.Generator`` on the host carries the stream that
initializers draw from; ``seed()`` resets it. Nothing here touches torch's
global RNG, so user code that seeds ``torch.manual_seed`` is unaffected.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "generator", "replay"]


class _RngState(threading.local):
    def __init__(self):
        self.gen = torch.Generator(device="cpu")
        self.gen.manual_seed(0)


_STATE = _RngState()


def seed(seed_state, ctx="all"):
    """Set the seed of the port's generator (``ctx`` kept for API parity:
    there is one host stream)."""
    del ctx
    _STATE.gen.manual_seed(int(seed_state) & 0xFFFFFFFFFFFFFFFF)


def generator():
    """The host ``torch.Generator`` the initializers draw from."""
    return _STATE.gen


@contextlib.contextmanager
def replay(state):
    """Draw from a generator at ``state`` (a ``get_state()`` of this
    module's generator) inside the block, on this thread, and leave the
    thread's own stream as it was: a remat recompute draws the numbers
    its first run drew."""
    gen = torch.Generator(device="cpu")
    gen.set_state(state)
    prev, _STATE.gen = _STATE.gen, gen
    try:
        yield gen
    finally:
        _STATE.gen = prev
