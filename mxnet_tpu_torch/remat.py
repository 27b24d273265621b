"""Rematerialization for ``parallel.train.ShardedTrainStep(remat_policy=...)``
(counterpart of the JAX package's ``checkpoint_name`` tags, ops/nn.py
``_ckpt_name``, and its ``jax.checkpoint`` with
``save_only_these_names``).

A producer of a value the policy may keep runs inside
``checkpoint_name(name)``: the convolutions' outputs ("conv_out"), the max
pool's ("pool_out"), the BatchNorm statistics ("bn_stat") and the fused
BN->ReLU->conv3x3 op's output ("conv_out"). Under a policy, the forward
runs in non-reentrant ``torch.utils.checkpoint`` regions whose selective
checkpoint policy keeps the outputs of every op (not a view) dispatched
inside a tag of the policy's names and recomputes everything else in the
backward. The fused conv is one dispatcher op
(``kernels.conv_fused``, a ``torch.library`` custom op), so its kernel is
not launched again; an autograd Function that launches kernels (the
training BatchNorm) is replayed whole.

Regions. torch recomputes a region all at once, when the backward first
needs one of its tensors, so one region over the whole loss would bring
back every recomputed activation at the same moment, at the peak.
So ``HybridSequential`` makes each composite element (a residual unit)
and each run of consecutive leaf layers one region (``segmenting()``),
and the regions' inputs are kept besides the tagged values; a network
with no ``HybridSequential`` is one region. A region's recompute runs
with the training flag and the port's random state of its first run,
and drops the running-statistic updates its forward reports again (they
were collected once, by the first run).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["checkpoint_name", "policy", "scope", "segmenting", "region"]


class _State(threading.local):
    def __init__(self):
        self.tags = []          # open checkpoint_name scopes
        self.names = None       # the active policy's names
        self.in_region = False


_STATE = _State()


@contextlib.contextmanager
def checkpoint_name(name):
    """Tag the values the ops inside produce as ``name``."""
    _STATE.tags.append(name)
    try:
        yield
    finally:
        _STATE.tags.pop()


def policy(names):
    """The selective checkpoint policy: keep the outputs of non-view ops
    run inside a tag in ``names``, recompute every other op."""
    from torch.utils.checkpoint import CheckpointPolicy
    names = frozenset(names)

    def fn(ctx, op, *args, **kwargs):
        tags = _STATE.tags
        if tags and tags[-1] in names and not getattr(op, "is_view", False):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return fn


@contextlib.contextmanager
def scope(names, segmented=True):
    """Run a forward under the policy of ``names``; ``segmented`` lets
    ``HybridSequential`` open the regions."""
    prev = (_STATE.names, _STATE.in_region)
    _STATE.names = tuple(names)
    _STATE.in_region = not segmented
    try:
        yield
    finally:
        _STATE.names, _STATE.in_region = prev


def segmenting():
    """Whether a ``HybridSequential`` should run its elements as regions:
    a policy is active and no region is open."""
    return _STATE.names is not None and not _STATE.in_region


def region(fn, *args):
    """``fn(*args)`` as one checkpoint region under the active policy."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    from . import autograd
    from . import random as _random
    from .gluon.block import _AUX
    from .ops import global_batch
    names = _STATE.names
    training = autograd.is_training()
    rng = _random.get_state()
    batch = global_batch.active()
    runs = [0]

    def body(*a):
        runs[0] += 1
        prev = (_STATE.names, _STATE.in_region)
        _STATE.names, _STATE.in_region = names, True
        try:
            if runs[0] == 1:
                return fn(*a)
            # the backward's recompute, maybe on another thread: the first
            # run's modes, random state and global batch (a data-parallel
            # step's), its aux updates dropped
            prev_rec = autograd.set_recording(True)
            prev_train = autograd.set_training(training)
            _AUX.stack.append(None)
            try:
                with _random.replay(rng), (
                        global_batch.scope(*batch) if batch is not None
                        else contextlib.nullcontext()):
                    return fn(*a)
            finally:
                _AUX.stack.pop()
                autograd.set_training(prev_train)
                autograd.set_recording(prev_rec)
        finally:
            _STATE.names, _STATE.in_region = prev

    return checkpoint(
        body, *args, use_reentrant=False, preserve_rng_state=True,
        context_fn=lambda: create_selective_checkpoint_contexts(
            policy(names)))
