"""Sharded training step (counterpart of mxnet_tpu/parallel/train.py):
gluon Block + loss + any registered optimizer -> one training step, on one
device or data-parallel across the ranks of a process group.

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
tensors on this rank's device, updated in place; ``sync_to_block`` writes
them back into the block. ``donate`` has no effect (the update is in
place), and ``lower()`` has no counterpart in eager PyTorch.

Data parallelism (a mesh that spans a process group, ``create_mesh()``
after ``initialize_distributed()``): every rank calls ``step(x, y)`` with
the same global batch, takes its rows (the strategy's batch spec over the
mesh) and holds every parameter whole. The two semantics of the JAX step
are kept:

- default (the JAX step's GSPMD program): BatchNorm normalizes with the
  global batch's statistics and Dropout draws the global batch's mask
  (``ops/global_batch.py``), so the moving statistics are the same on
  every rank; the loss and the gradients are the global batch's mean
  (each rank's mean scaled by its share, then summed over 'dp' by one
  collective per bucket, ``overlap.bucketed_reduce``);
- ``overlap_grads=True`` (the JAX step's ``shard_map`` program): the
  parameters pass through ``overlap.tag_gradient_buckets``, whose
  reductions (a mean over 'dp') start inside the backward; BatchNorm uses
  this rank's rows, the moving statistics are averaged over 'dp', and
  Dropout draws from a generator folded with the dp index
  (``random.folded``). It requires a pure data-parallel strategy
  (replicated parameters, the batch on 'dp'), with JAX's ``ValueError``
  otherwise.

Either way every rank applies the same update to the same parameters, so
they stay equal. A strategy whose rules split a parameter raises
(M10c); a mesh of several devices in one process raises, naming the
launcher.

``remat_policy="conv_outs"`` keeps only the values tagged "conv_out",
"pool_out" and "bn_stat" between the forward and the backward and
recomputes everything else (``remat.py``); any other string is a
comma-separated list of tag names.

The JAX step records its first call (trace, XLA compile and first run)
in the profiler's compile registry; here the first ``step()`` is recorded
the same way, as ``sharded_step:<remat policy or none>``: its wall time
holds the first-use kernel builds and cuDNN's plans.
"""
from __future__ import annotations

import contextlib
import time as _time

import numpy as _np
import torch

from .. import autograd
from .. import profiler as _profiler
from .. import random as _random
from .. import remat
from ..gluon.block import _AUX
from ..gluon.nn import HybridSequential
from ..ops import global_batch
from . import overlap as _overlap
from .collectives import _block, all_reduce, manual_axes
from .sharding import _SHARDED, data_parallel, splits

__all__ = ["functional_call", "extract_params", "attach_params",
           "ShardedTrainStep"]

_CONV_OUTS = ("conv_out", "pool_out", "bn_stat")


def extract_params(block):
    """{structural path: tensor} of every parameter of a Block (the keys of
    ``_collect_params_with_prefix``)."""
    return {path: p._tensor()
            for path, p in block._collect_params_with_prefix().items()}


def attach_params(block, params):
    """Write a {path: tensor} dict back into the Block's parameters (in
    place, in each parameter's dtype)."""
    pmap = block._collect_params_with_prefix()
    with torch.no_grad():
        for path, t in params.items():
            pmap[path]._tensor().copy_(t)


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
    ``random.get_state()`` snapshot, replays those streams for the call."""
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


def _to_tensor(a, device, rows=None):
    """``a`` on ``device``; with ``rows`` (a mesh and a batch spec) only
    this rank's rows, cut before the copy where ``a`` is elsewhere."""
    t = a if isinstance(a, torch.Tensor) \
        else torch.from_numpy(_np.ascontiguousarray(a))
    if rows is not None:
        t = _block(rows[0], rows[1], t)
    return t.to(device)


class ShardedTrainStep:
    """Training step of a (block, loss, optimizer) triple on one device or
    data-parallel across processes (see the module docstring).

    - the parameters are the step's own copies on this rank's device
      (``strategy.param_sharding`` gives each its spec, which must not
      split it);
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
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.strategy = strategy
        self.mesh = strategy.mesh
        params = extract_params(block)
        self._param_paths = sorted(params)
        self._shardings = strategy.param_sharding(params)
        split = [k for k, sh in self._shardings.items()
                 if splits(sh.spec, self.mesh)]
        self._overlap = bool(overlap_grads)
        if self._overlap and (strategy.batch_axes != ("dp",) or split):
            raise ValueError(
                "overlap_grads needs a pure data-parallel strategy "
                "(replicated params, batch on 'dp'); got %r" % (strategy,))
        if split:
            raise NotImplementedError(
                "ShardedTrainStep: %r splits %s: %s"
                % (strategy, split[0], _SHARDED))
        self.device = self.mesh.local_device()
        self._spans = self.mesh.distributed
        self._dp = self.mesh.size("dp") if "dp" in self.mesh.axis_names \
            else 1
        self._remat_names = None
        if remat_policy:
            self._remat_names = _CONV_OUTS if remat_policy == "conv_outs" \
                else tuple(remat_policy.split(","))
        self.params = {}
        for k, v in params.items():
            t = v.detach().to(self.device, copy=True)
            self.params[k] = t.requires_grad_(t.is_floating_point())
        self.opt_states = {
            path: optimizer.create_state_multi_precision(i, self.params[path])
            for i, path in enumerate(self._param_paths)}
        # the paths with a gradient, and their reduction buckets
        self._grad_idx = [i for i, p in enumerate(self._param_paths)
                          if self.params[p].requires_grad]
        self._plan = _overlap.bucket_plan(
            [self.params[self._param_paths[i]] for i in self._grad_idx],
            bucket_bytes) if self._spans or self._overlap else None
        self._segmented = any(isinstance(m, HybridSequential)
                              for m in block.modules())
        self._first = True      # the next step() is the first

    # -- the step ----------------------------------------------------------
    def _loss(self, x, y):
        share = 1.0 / self._dp if self._spans and not self._overlap \
            else None

        def loss_of(x, y):
            out = _plain(self.block(x))
            out = out[0] if isinstance(out, tuple) else out
            loss = self.loss_fn(out, y).mean()
            # the default path: this rank's part of the global mean
            return loss if share is None else loss * share
        if self._remat_names is None:
            return loss_of(x, y)
        with remat.scope(self._remat_names, segmented=self._segmented):
            if self._segmented:
                return loss_of(x, y)
            return remat.region(loss_of, x, y)

    def step(self, x, y):
        """One update; returns the loss as a device scalar (no host
        sync)."""
        if self._first:
            self._first = False
            t0 = _time.perf_counter()
            loss = self.step(x, y)
            _profiler.record_compile(
                "sharded_step:%s" % ("none" if self._remat_names is None
                                     else ",".join(self._remat_names)),
                key="%d params" % len(self._param_paths),
                dur_us=(_time.perf_counter() - t0) * 1e6)
            return loss
        x, y = self._local(x, y)
        with manual_axes(self.mesh):
            return self._step(x, y)

    def _step(self, x, y):
        plist = [self.params[p] for p in self._param_paths]
        bound = self.params
        if self._overlap:
            tagged = _overlap.tag_gradient_buckets(
                [plist[i] for i in self._grad_idx], "dp", plan=self._plan,
                op="mean")
            bound = dict(self.params)
            for i, t in zip(self._grad_idx, tagged):
                bound[self._param_paths[i]] = t
        with _bound(self.block, bound) as pmap:
            with torch.enable_grad(), _collecting(True) as collected, \
                    self._batch_scope():
                loss = self._loss(x, y)
            grads = iter(torch.autograd.grad(
                loss, [p for p in plist if p.requires_grad],
                allow_unused=True))
        grads = [next(grads) if p.requires_grad else None for p in plist]
        aux = _aux_by_path(pmap, collected)
        if self._overlap:
            _overlap.wait_pending()
            loss = all_reduce(loss.detach(), "dp", "mean")
            if aux:
                paths = sorted(aux)
                aux = dict(zip(paths, _overlap.bucketed_reduce(
                    [aux[p] for p in paths], "dp", op="mean")))
        elif self._spans:
            grads = self._reduce(grads)
            loss = all_reduce(loss.detach(), "dp")
        self._apply(grads, aux)
        return loss.detach()

    def _reduce(self, grads):
        """The default path's gradient sum over 'dp': one collective per
        bucket of the parameter plan (a parameter without a gradient
        takes zeros, as its update does)."""
        full = [grads[i] if grads[i] is not None
                else torch.zeros_like(self.params[self._param_paths[i]])
                for i in self._grad_idx]
        out = list(grads)
        for i, g in zip(self._grad_idx, _overlap.bucketed_reduce(
                full, "dp", plan=self._plan)):
            out[i] = g
        return out

    def _batch_scope(self):
        """The forward's view of the batch: the global batch on the default
        path across processes, a generator folded with the dp index on the
        overlap path, else this rank's (and only) batch."""
        if not self._spans:
            return contextlib.nullcontext()
        index = self.mesh.axis_index("dp")
        if self._overlap:
            return _random.folded(self.device, index)
        return global_batch.scope(self.mesh.group("dp"), self._dp, index)

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

    def _local(self, x, y):
        """This rank's rows of the global batch, on its device."""
        rows = (self.mesh, self.strategy.batch_spec()) if self._spans \
            else None
        return (_to_tensor(x, self.device, rows),
                _to_tensor(y, self.device, rows))

    def place_batch(self, x, y):
        """The global batch on this rank's device (call once, then step on
        it: each step takes its rows)."""
        return _to_tensor(x, self.device), _to_tensor(y, self.device)

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
