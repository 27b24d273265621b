"""Sharded training step on a one-device mesh (counterpart of
mxnet_tpu/parallel/train.py): gluon Block + loss + any registered
optimizer -> one training step.

    step = ShardedTrainStep(net, loss_fn, optimizer, strategy)
    loss = step(x, y)          # float; step.step(x, y) returns a tensor

A step computes the mean of ``loss_fn(block(x), y)``, its gradient with
respect to every parameter path of the block (``extract_params``, in
``sorted`` order, BatchNorm running statistics included, whose gradient
is zero), then ``optimizer.update_multi_precision(i, w, g, state)`` for
each path ``i`` in that order, and then writes the running-statistic
updates the forward reported (``functional_call`` collects them) over
those paths: the JAX package's step semantics, so that update counts and
per-index optimizer state match its. The parameters are the step's own
tensors on the mesh's device, updated in place; ``sync_to_block`` writes
them back into the block. ``donate`` has no effect (the update is in
place), and ``lower()`` has no counterpart in eager PyTorch.

``remat_policy="conv_outs"`` keeps only the values tagged "conv_out",
"pool_out" and "bn_stat" between the forward and the backward and
recomputes everything else (``remat.py``); any other string is a
comma-separated list of tag names.

One device: a mesh over several devices, and ``overlap_grads``, raise and
wait for the multi-process slice (M10 in ROADMAP.md); so does the JAX
step's compile-attribution probe for the observability slice (M9).
"""
from __future__ import annotations

import contextlib

import numpy as _np
import torch

from .. import autograd
from .. import remat
from ..gluon.block import _AUX
from ..gluon.nn import HybridSequential
from .sharding import data_parallel

__all__ = ["functional_call", "extract_params", "attach_params",
           "ShardedTrainStep"]

_CONV_OUTS = ("conv_out", "pool_out", "bn_stat")


def extract_params(block):
    """{structural path: tensor} of every parameter of a Block (the keys of
    ``_collect_params_with_prefix``)."""
    return {path: p.data()
            for path, p in block._collect_params_with_prefix().items()}


def attach_params(block, params):
    """Write a {path: tensor} dict back into the Block's parameters (in
    place, in each parameter's dtype)."""
    pmap = block._collect_params_with_prefix()
    with torch.no_grad():
        for path, t in params.items():
            pmap[path].data().copy_(t)


def _set(p, t):
    if p._owner is None:
        p._own = t
    else:
        p._registry()[p._owner[1]] = t


@contextlib.contextmanager
def _bound(block, params):
    """The block's parameters read ``params[path]`` inside the block (the
    tensors themselves, so that gradients reach them), then their own
    tensors again."""
    pmap = block._collect_params_with_prefix()
    originals = {path: pmap[path]._data for path in params}
    for path, t in params.items():
        _set(pmap[path], t)
    try:
        yield pmap
    finally:
        for path, t in originals.items():
            _set(pmap[path], t)


@contextlib.contextmanager
def _collecting(training):
    """Forward modes of a functional call: recording where torch's grad
    mode is on, ``training`` as given, and the running-statistic updates
    collected into the yielded list instead of written."""
    collected = []
    _AUX.stack.append(collected)
    prev_rec = autograd.set_recording(torch.is_grad_enabled())
    prev_train = autograd.set_training(training)
    try:
        yield collected
    finally:
        autograd.set_training(prev_train)
        autograd.set_recording(prev_rec)
        _AUX.stack.pop()


def _plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, torch.Tensor) else t


def _aux_by_path(pmap, collected):
    inv = {id(p): path for path, p in pmap.items()}
    aux = {}
    for p, new in collected:
        path = inv.get(id(p))
        if path is not None:
            aux[path] = new
    return aux


def functional_call(block, params, inputs, training=False, rng=None,
                    return_aux=False):
    """Run ``block`` as a function of ``(params, inputs)``: the block's
    parameters read ``params[path]`` during the call (differentiable in
    them where torch's grad mode is on), and are left as they were.
    Running-statistic updates are collected, not written: with
    ``return_aux`` they come back as ``{path: new value}``. ``rng``, a
    state of the port's random generator, replays that stream for the
    call."""
    pmap = block._collect_params_with_prefix()
    inputs = inputs if isinstance(inputs, (tuple, list)) else [inputs]
    replay = _random_replay(rng)
    with _bound(block, params), _collecting(training) as collected, replay:
        out = block(*inputs)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    res = tuple(_plain(o) for o in outs)
    res = res[0] if len(res) == 1 else res
    if return_aux:
        return res, _aux_by_path(pmap, collected)
    return res


def _random_replay(rng):
    if rng is None:
        return contextlib.nullcontext()
    from .. import random as _random
    return _random.replay(rng)


def _device_of(mesh):
    if mesh.size() != 1:
        raise NotImplementedError(
            "ShardedTrainStep: a mesh of %d devices; the port trains on one "
            "device so far, meshes over several wait for the multi-process "
            "slice (M10)" % mesh.size())
    return mesh.devices.flat[0]


def _to_tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(_np.ascontiguousarray(a)).to(device)


class ShardedTrainStep:
    """Training step of a (block, loss, optimizer) triple on a one-device
    mesh (see the module docstring).

    - the parameters are the step's own copies on the mesh's device
      (``strategy.param_sharding`` gives each its spec, which on one
      device places it whole);
    - optimizer state is created per path by
      ``create_state_multi_precision``, on that device;
    - running-statistic updates are applied after the optimizer's, over
      the same paths.
    """

    def __init__(self, block, loss_fn, optimizer, strategy=None, mesh=None,
                 donate=True, remat_policy=None, overlap_grads=False,
                 bucket_bytes=None):
        if strategy is None:
            if mesh is None:
                raise ValueError("need strategy or mesh")
            strategy = data_parallel(mesh)
        if overlap_grads:
            raise NotImplementedError(
                "ShardedTrainStep(overlap_grads=True): bucketed gradient "
                "collectives inside the backward need a mesh over several "
                "devices, which waits for the multi-process slice (M10)")
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.strategy = strategy
        self.mesh = strategy.mesh
        self.device = _device_of(self.mesh)
        self._remat_names = None
        if remat_policy:
            self._remat_names = _CONV_OUTS if remat_policy == "conv_outs" \
                else tuple(remat_policy.split(","))
        params = extract_params(block)
        self._param_paths = sorted(params)
        self._shardings = strategy.param_sharding(params)
        self.params = {}
        for k, v in params.items():
            t = v.detach().to(self.device, copy=True)
            self.params[k] = t.requires_grad_(t.is_floating_point())
        self.opt_states = {
            path: optimizer.create_state_multi_precision(i, self.params[path])
            for i, path in enumerate(self._param_paths)}
        self._segmented = any(isinstance(m, HybridSequential)
                              for m in block.modules())

    # -- the step ----------------------------------------------------------
    def _loss(self, x, y):
        def loss_of(x, y):
            out = _plain(self.block(x))
            out = out[0] if isinstance(out, tuple) else out
            return self.loss_fn(out, y).mean()
        if self._remat_names is None:
            return loss_of(x, y)
        with remat.scope(self._remat_names, segmented=self._segmented):
            if self._segmented:
                return loss_of(x, y)
            return remat.region(loss_of, x, y)

    def step(self, x, y):
        """One update; returns the loss as a device scalar (no host
        sync)."""
        x, y = self._placed(x, y)
        plist = [self.params[p] for p in self._param_paths]
        with _bound(self.block, self.params) as pmap:
            with torch.enable_grad(), _collecting(True) as collected:
                loss = self._loss(x, y)
            grads = iter(torch.autograd.grad(
                loss, [p for p in plist if p.requires_grad],
                allow_unused=True))
        grads = [next(grads) if p.requires_grad else None for p in plist]
        self._apply(grads, _aux_by_path(pmap, collected))
        return loss.detach()

    def _apply(self, grads, aux):
        """The update phase: the optimizer over every path in order (a
        zero gradient where there is none), then the running-statistic
        updates ``aux`` ({path: value}) over theirs."""
        with torch.no_grad():
            for i, (path, g) in enumerate(zip(self._param_paths, grads)):
                w = self.params[path]
                self.optimizer.update_multi_precision(
                    i, w, torch.zeros_like(w) if g is None else g,
                    self.opt_states[path])
            for path, new in aux.items():
                self.params[path].copy_(new)

    def _placed(self, x, y):
        return _to_tensor(x, self.device), _to_tensor(y, self.device)

    def place_batch(self, x, y):
        """The batch on the mesh's device (call once, then step on it)."""
        return self._placed(x, y)

    def __call__(self, x, y):
        return float(self.step(x, y))

    def lower(self, x, y):
        """The JAX step's ahead-of-time lowering: eager PyTorch builds no
        program to lower."""
        raise NotImplementedError(
            "ShardedTrainStep.lower: eager PyTorch has no lowered program "
            "(a non-goal of the port, ROADMAP.md)")

    def sync_to_block(self):
        """Copy the trained parameters back into the Block."""
        attach_params(self.block, self.params)
