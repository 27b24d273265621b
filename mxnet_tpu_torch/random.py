"""Random state (counterpart of mxnet_tpu/random.py).

Explicit ``torch.Generator``s, one per device: one on the host, which the
initializers draw from, and one on each CUDA device, made when first asked
for, which the random ops and Dropout draw from for tensors on that card.
``seed(s)`` seeds all of them (and every card generator made later);
``seed(s, ctx)`` seeds only the generator of that context. Nothing here
touches torch's global RNG, so user code that seeds ``torch.manual_seed``
is unaffected.

The JAX package draws through threefry keys; torch's generators (MT19937
on the host, Philox on a card) give other streams by design. What carries
over is the law of each draw and its reproducibility under a seed.

The state is per thread, as the JAX package's. ``get_state()`` snapshots
the thread's generators and ``replay(state)`` draws from such a snapshot
inside a block and leaves the thread's own streams as they were: a remat
recompute, maybe on another thread, draws the numbers (Dropout masks
included) its first run drew.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "generator", "get_state", "replay", "folded"]

_MASK = 0xFFFFFFFFFFFFFFFF


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0           # seed of the card generators made later
        self.host = torch.Generator(device="cpu")
        self.host.manual_seed(0)
        self.cards = {}         # CUDA device index -> torch.Generator


_STATE = _RngState()


def _card_index(device):
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def seed(seed_state, ctx="all"):
    """Seed the port's generators: every one (the host's, each card's, and
    the card generators made later) with ``ctx="all"``, else only the
    generator of ``ctx`` (a Context or a device), which raises for a GPU
    context with no CUDA device."""
    s = int(seed_state) & _MASK
    if isinstance(ctx, str) and ctx == "all":
        _STATE.seed = s
        _STATE.host.manual_seed(s)
        for gen in _STATE.cards.values():
            gen.manual_seed(s)
        return
    generator(ctx).manual_seed(s)


def generator(device=None):
    """The generator of ``device`` (None or the CPU: the host generator; a
    CUDA device or a GPU Context: that card's, made on first use and seeded
    with the seed ``seed()`` set last for all; ``meta``, where shape
    inference draws nothing: None)."""
    from .context import Context
    if device is None:
        return _STATE.host
    if isinstance(device, Context):
        device = device.device
    device = torch.device(device)
    if device.type == "cpu":
        return _STATE.host
    if device.type == "meta":
        return None
    if device.type != "cuda":
        raise ValueError("no generator for device %s" % device)
    idx = _card_index(device)
    gen = _STATE.cards.get(idx)
    if gen is None:
        gen = torch.Generator(device=torch.device("cuda", idx))
        gen.manual_seed(_STATE.seed)
        _STATE.cards[idx] = gen
    return gen


def get_state():
    """A snapshot of this thread's generators, for ``replay``."""
    return (_STATE.seed, _STATE.host.get_state(),
            {idx: g.get_state() for idx, g in _STATE.cards.items()})


@contextlib.contextmanager
def replay(state):
    """Draw from generators at ``state`` (a ``get_state()`` snapshot)
    inside the block, on this thread, and leave the thread's own generators
    as they were. A card generator the snapshot lacks is made inside the
    block as it was in the first run: seeded with the snapshot's seed."""
    seed_, host_state, cards = state
    host = torch.Generator(device="cpu")
    host.set_state(host_state)
    made = {}
    for idx, st in cards.items():
        gen = torch.Generator(device=torch.device("cuda", idx))
        gen.set_state(st)
        made[idx] = gen
    prev = (_STATE.seed, _STATE.host, _STATE.cards)
    _STATE.seed, _STATE.host, _STATE.cards = seed_, host, made
    try:
        yield host
    finally:
        _STATE.seed, _STATE.host, _STATE.cards = prev


@contextlib.contextmanager
def folded(device, index):
    """Draw, inside the block, from a fresh generator of ``device`` seeded
    by one draw of the host generator folded with ``index`` (the JAX
    package's ``fold_in`` of a key with a data-parallel index): ranks that
    share their generators' state draw different streams inside the block
    and the same ones after it, since each has made the same one host
    draw."""
    base = int(torch.randint(0, 1 << 62, (1,), generator=_STATE.host)[0])
    s = (base ^ ((int(index) + 1) * 0x9E3779B97F4A7C15)) & _MASK
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    prev_host, prev_cards = _STATE.host, _STATE.cards
    if device.type == "cuda":
        _STATE.cards = dict(prev_cards)
        _STATE.cards[_card_index(device)] = gen
    else:
        _STATE.host = gen
    try:
        yield gen
    finally:
        _STATE.host, _STATE.cards = prev_host, prev_cards
