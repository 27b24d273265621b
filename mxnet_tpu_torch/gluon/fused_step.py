"""Fused train step (counterpart of mxnet_tpu/gluon/fused_step.py), on one
device.

    step = gluon.train_step(net, loss_fn, trainer)   # or trainer.fuse_step
    for x, y in batches:
        loss = step(x, y)                            # batch_size=x.shape[0]

One call computes ``loss_fn(block(data), label)``, the gradient of its sum
with respect to every trainable parameter, and the trainer's optimizer
update of all of them. It leaves the state the eager
``record``/``backward``/``Trainer.step`` triple leaves (weights, optimizer
state, gradients, update counts), bit for bit.

The JAX package traces the step into one donated, jitted XLA program, and
its machinery (signature-keyed compile cache, eager warming until a
signature repeats, donation, traced hyperparameters) exists to build and
replay that program. PyTorch runs eagerly: there is no trace to build or
replay, and the update writes the weights in place. So a step here is eager
autograd plus one update phase, and it is ``"fused"`` from the first
eligible call. What is fused is the update phase: with
``MXTPU_FUSED_APPLY`` on, every parameter whose state is packable goes
through ``kernels.optimizer_apply.packed_apply`` (one kernel launch per
dtype-homogeneous bucket of ``parallel.overlap.bucket_plan``); the others,
or all with it off, run the optimizer's ``step_fn_multi_precision`` one
parameter at a time.

A step the fused path cannot honour runs the eager triple instead, never a
crash, counted in ``stats()["fallbacks"]`` and named in ``last_mode``
(``"fallback:<reason>"``): the kill switch (``MXNET_GLUON_FUSED_STEP=0`` or
``set_fused_step(False)``: ``disabled``), an active ``autograd.record()``
scope (``recording-scope``), a trainer with a kvstore attached, whose
push and pull the step would bypass (``kvstore``), an optimizer without
the pure ``step_fn`` form (``optimizer:<Name>``), a trainer with an AMP
loss scaler attached (``amp.init_trainer``), whose overflow skip the fused
update would bypass (``amp-loss-scaler``), a block that was not
hybridized (``non-hybridized``), a parameter with ``grad_req="add"``
(``grad-req-add``), no trainable parameter (``no-trainable-params``) and a
parameter whose shape is not known yet (``deferred-init``: the eager step's
forward finishes it, later steps fuse).

``mesh``, ``rules`` and a ``bucket_bytes`` other than the default arrive
with the multi-GPU slice; the profiler, health-monitor, watchdog and
compile-cache hooks of the JAX step arrive with the observability slice.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import getenv
from ..kernels import optimizer_apply
from ..parallel.overlap import default_bucket_bytes

__all__ = ["FusedTrainStep", "train_step", "fused_step_enabled",
           "set_fused_step", "stats", "reset_stats"]

_ENABLED = getenv("MXNET_GLUON_FUSED_STEP", "1") not in ("0", "false", "off")
_STATS = {
    "hits": 0,       # steps that ran fused
    "fallbacks": 0,  # steps that ran the eager triple (see last_mode)
}


def fused_step_enabled():
    return _ENABLED


def set_fused_step(enabled):
    """Turn the fused train step on or off at run time (the env var
    ``MXNET_GLUON_FUSED_STEP`` sets the process default). Returns the
    previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def stats():
    """Snapshot of the fused-step counters (hits, fallbacks)."""
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def train_step(block, loss_fn, trainer, mesh=None, bucket_bytes=None,
               rules=None):
    """The fused training step of a (block, loss, trainer) triple:
    ``step(data, label, batch_size=...)`` computes ``loss_fn(block(data),
    label)``, backpropagates and applies the trainer's optimizer to every
    trainable parameter. With more than two positional arguments all but
    the last feed the block and the last is the label. Returns the
    per-sample loss (detached). The block must be hybridized to run fused
    (see the module docstring)."""
    return FusedTrainStep(trainer, loss_fn, block=block, mesh=mesh,
                          bucket_bytes=bucket_bytes, rules=rules)


def _adopt_state(state, new):
    """Write a step_fn's new state into the optimizer's state tensors in
    place (None, a tensor, or a tuple of them)."""
    if state is None or new is state:
        return
    if isinstance(state, torch.Tensor):
        state.copy_(new)
        return
    for s, n in zip(state, new):
        _adopt_state(s, n)


def _state_kind(w, st):
    """The structure of a packable state (None, one tensor, or a tuple of
    tensors, each like the weight ``w``), or None for one that is not."""
    def like(t):
        return isinstance(t, torch.Tensor) and t.shape == w.shape \
            and t.dtype == w.dtype
    if st is None:
        return "none"
    if like(st):
        return "tensor"
    if isinstance(st, tuple) and st and all(like(t) for t in st):
        return "tuple%d" % len(st)
    return None


class FusedTrainStep:
    """One training step: forward, backward of the summed loss, and one
    update phase (see the module docstring). Built by
    ``Trainer.fuse_step(loss_fn)`` (``loss_fn(*batch)`` returns the
    per-sample loss, usually a closure over the net) or
    ``gluon.train_step(block, loss_fn, trainer)``."""

    def __init__(self, trainer, loss_fn, block=None, mesh=None,
                 bucket_bytes=None, rules=None):
        if not callable(loss_fn):
            raise TypeError("loss_fn must be callable, got %r"
                            % type(loss_fn))
        if mesh is not None or rules is not None or (
                bucket_bytes is not None
                and bucket_bytes != default_bucket_bytes()):
            raise NotImplementedError(
                "train_step: mesh=, rules= and a custom bucket_bytes are the "
                "multi-GPU slice's (Slice E); the port trains on one device")
        self._trainer = trainer
        self._loss_fn = loss_fn
        self._block = block
        self.last_mode = None   # how the previous call executed

    def __call__(self, *args, batch_size=None, ignore_stale_grad=False):
        if batch_size is None:
            batch_size = int(args[0].shape[0]) \
                if args and args[0].dim() else 1
        mode = "error"
        try:
            loss, mode = self._dispatch(args, batch_size, ignore_stale_grad)
        finally:
            self.last_mode = mode
        return loss

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, args, batch_size, ignore_stale_grad):
        reason = self._fallback_reason()
        if reason is None:
            all_params, train_pos, indices = self._param_split()
            if not train_pos:
                reason = "no-trainable-params"
            elif any(p._data is None for p in all_params):
                reason = "deferred-init"
        if reason is not None:
            _STATS["fallbacks"] += 1
            return self._eager_step(args, batch_size, ignore_stale_grad), \
                "fallback:" + reason
        # the trainer's own updater creates the states, so the eager and
        # the fused steps share one state store
        tr = self._trainer
        states = [tr._updater.ensure_state(i, tr._params[i]._tensor())
                  for i in indices]
        loss = self._run(all_params, train_pos, indices, states, args,
                         batch_size)
        _STATS["hits"] += 1
        return loss, "fused"

    def _fallback_reason(self):
        if not _ENABLED:
            return "disabled"
        if autograd.is_recording():
            return "recording-scope"
        tr = self._trainer
        # the eager step()'s prologue, so that the check sees the attached
        # kvstore (both calls are idempotent)
        tr._prepare()
        if tr._kvstore is not None:
            return "kvstore"
        if not tr._optimizer.fused_step_supported():
            return "optimizer:" + type(tr._optimizer).__name__
        if hasattr(tr, "_amp_loss_scaler"):
            # amp.init_trainer wraps Trainer._update with the loss scaler's
            # overflow skip, which the fused update phase would bypass
            return "amp-loss-scaler"
        if self._block is not None and \
                not getattr(self._block, "_active", False):
            return "non-hybridized"
        for p in tr._params:
            if p.grad_req == "add":
                return "grad-req-add"
        return None

    def _param_split(self):
        """(all_params, trainable positions, trainer indices): the block's
        parameters (block form) and the trainer's; a position is trainable
        when the trainer owns it and its grad_req is not "null"."""
        tr = self._trainer
        if self._block is not None:
            all_params = self._block._all_params_list()
            known = {id(p) for p in all_params}
            all_params = all_params + [p for p in tr._params
                                       if id(p) not in known]
        else:
            all_params = list(tr._params)
        train_pos, indices = [], []
        for pos, p in enumerate(all_params):
            idx = tr._param2idx.get(p.name)
            if idx is not None and tr._params[idx] is p \
                    and p.grad_req != "null":
                train_pos.append(pos)
                indices.append(idx)
        return all_params, train_pos, indices

    def _run(self, all_params, train_pos, indices, states, args,
             batch_size):
        """One fused step: the update counts and hyperparameters exactly as
        the eager ``update()`` takes them (the counts roll back if the
        step fails), forward and backward, the update phase, then the
        gradients adopted into the parameters."""
        tr = self._trainer
        opt = tr._optimizer
        rescale = tr._scale / batch_size
        opt.rescale_grad = rescale
        prev_num = opt.num_update
        prev_counts = {i: opt._index_update_count.get(i) for i in indices}
        opt._update_count(list(indices))
        try:
            lrs = [opt.step_lr(i) for i in indices]
            wds = opt._get_wds(list(indices))
            ws = [all_params[pos]._tensor() for pos in train_pos]
            with autograd.record():
                loss = self._call(*args)
            # the gradient of sum(loss): backward's all-ones head seed;
            # contiguous, as the eager backward stores .grad
            grads = [g.contiguous() for g in autograd.grad([loss], ws)]
            self._update(opt, ws, grads, states, lrs, wds, rescale)
        except BaseException:
            opt.num_update = prev_num
            for i, c in prev_counts.items():
                if c is None:
                    opt._index_update_count.pop(i, None)
                else:
                    opt._index_update_count[i] = c
            raise
        for w, g in zip(ws, grads):
            w.grad = g
            w._fresh_grad = False   # consumed by this step's update
        return loss.detach()

    def _update(self, opt, ws, gs, states, lrs, wds, rescale):
        """The update phase: packed where ``_packed_apply_fn`` selects,
        else ``step_fn_multi_precision`` per parameter (which rounds its
        scalars to a half-precision weight's dtype itself). In place."""
        select = self._packed_apply_fn(opt)
        packed = select(ws, states) if select is not None else []
        with torch.no_grad():
            if packed:
                optimizer_apply.packed_apply(
                    opt, [ws[i] for i in packed], [gs[i] for i in packed],
                    [states[i] for i in packed], [lrs[i] for i in packed],
                    [wds[i] for i in packed], rescale)
            done = set(packed)
            for i, (w, g, st) in enumerate(zip(ws, gs, states)):
                if i in done:
                    continue
                nw, ns = opt.step_fn_multi_precision(w, g, st, lrs[i],
                                                     wds[i], rescale)
                w.copy_(nw)
                _adopt_state(st, ns)

    @staticmethod
    def _packed_apply_fn(opt):
        """The ``MXTPU_FUSED_APPLY`` selector, or None when the packed
        apply is off or the optimizer has no packed form
        (``Optimizer.fused_apply_supported``). The selector returns the
        positions whose update goes through ``packed_apply``: those whose
        state is None, one tensor or a tuple of tensors, each shaped and
        typed like the weight (SGD's momentum, Adam's ``(m, v)``; a
        multi-precision ``(master, state)`` pair stays per parameter), of
        one state structure."""
        if not (optimizer_apply.enabled() and opt.fused_apply_supported()):
            return None

        def select(ws, states):
            idx, kind = [], None
            for k, (w, st) in enumerate(zip(ws, states)):
                this = _state_kind(w, st)
                if this is None or kind not in (None, this):
                    continue
                kind = this
                idx.append(k)
            return idx
        return select

    # -- the eager path ----------------------------------------------------
    def _call(self, *args):
        if self._block is not None:
            if len(args) >= 2:
                return self._loss_fn(self._block(*args[:-1]), args[-1])
            return self._loss_fn(self._block(*args))
        return self._loss_fn(*args)

    def _eager_step(self, args, batch_size, ignore_stale_grad):
        """The eager triple: record, backward, ``Trainer.step``; every
        fallback takes it, so an ineligible step costs the eager time and
        nothing else."""
        with autograd.record():
            loss = self._call(*args)
        if not isinstance(loss, torch.Tensor):
            raise TypeError("loss_fn must return one loss tensor, got %r"
                            % type(loss))
        autograd.backward([loss])
        self._trainer.step(batch_size, ignore_stale_grad=ignore_stale_grad)
        return loss.detach()
