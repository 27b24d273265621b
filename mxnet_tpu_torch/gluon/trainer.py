"""Gluon Trainer: applies an Optimizer to a set of Parameters (counterpart of
mxnet_tpu/gluon/trainer.py), on one device.

``step(batch_size)`` sets ``rescale_grad = 1/batch_size``, reduces the
gradients and updates every parameter whose gradient is fresh. A parameter
whose gradient no backward has written since the last step raises, unless
``ignore_stale_grad``.

The reduction goes through a kvstore when the caller gives one, a
``KVStore`` object (``mx.kv.create(...)``), or a ``dist*`` string: then
every gradient is pushed and pulled back into ``param.grad()`` (through
the store's 2-bit compression, where it is set), or with
``update_on_kvstore=True`` the store's copy of the optimizer updates its
weights and the pull writes them into the parameters. A ``dist*`` string
creates that store, sets ``compression_params`` on it and updates on the
kvstore unless ``update_on_kvstore=False``, as the JAX package does: the
workers' gradients are summed across processes in the push. A kvstore
string ``None``, "local", "device" or "nccl" attaches no store and ignores
``compression_params`` and ``update_on_kvstore``: one device holds every
gradient whole.
"""
from __future__ import annotations

import time as _time

from .. import optimizer as opt
from .. import profiler as _profiler
from ..base import atomic_write
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict) or hasattr(params, "items"):
            params = [params[key] for key in sorted(list(params.keys()))]
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._reset_kvstore()

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an " \
                "Optimizer instance"
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    # -- kvstore -------------------------------------------------------------
    def _reset_kvstore(self):
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)

    def _init_kvstore(self):
        """Attach the caller's KVStore object or a ``dist*`` string's new
        store, if any (ref: trainer.py:169); another string attaches none
        (the module docstring)."""
        kvstore = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        kv = None
        if isinstance(kvstore, str) and kvstore.startswith("dist"):
            from .. import kvstore as kvs
            kv = kvs.create(kvstore)
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if update_on_kvstore is None:
                update_on_kvstore = True
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        elif kvstore is not None and not isinstance(kvstore, str):
            kv = kvstore
            if update_on_kvstore is None:
                update_on_kvstore = False
            if update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        else:
            update_on_kvstore = False
        self._kvstore = kv
        self._update_on_kvstore = bool(update_on_kvstore)
        self._kv_initialized = True

    def _init_params(self):
        """Initialize the store's key of every parameter that has its data
        (its index in this trainer)."""
        for param in self._params_to_init:
            if param._deferred_init is not None:
                continue
            if self._kvstore is not None and param._data is not None:
                self._kvstore.init(self._param2idx[param.name],
                                   param._tensor())
        self._params_to_init = [p for p in self._params_to_init
                                if p._deferred_init is not None]

    def _check_and_rescale_grad(self, scale):
        """Set the optimizer's gradient scale, before a kvstore pickles the
        optimizer (ref: trainer.py _check_and_rescale_grad)."""
        if self._update_on_kvstore and self._kv_initialized and \
                self._optimizer.rescale_grad != scale:
            raise UserWarning(
                "Possible change in the `batch_size` from previous "
                "`step` detected. Optimizer gradient normalizing factor "
                "will not change w.r.t new batch_size when "
                "update_on_kvstore=True and when distributed kvstore is "
                "used.")
        self._optimizer.rescale_grad = scale

    def _prepare(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()

    @property
    def learning_rate(self):
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One parameter update: rescale by 1/batch_size, reduce, apply
        (ref: trainer.py:305). A span in the profiler's ``gluon`` lane
        while the profiler or the flight recorder is live."""
        t0 = _time.perf_counter() if _profiler._LIVE else None
        self._check_and_rescale_grad(self._scale / batch_size)
        self._prepare()
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        if t0 is not None:
            _profiler.record_op(
                "gluon.Trainer.step", (_time.perf_counter() - t0) * 1e6,
                category="gluon", lane="gluon",
                args={"batch_size": batch_size,
                      "params": len(self._params)})

    def fuse_step(self, loss_fn, block=None, mesh=None, bucket_bytes=None,
                  rules=None):
        """A ``gluon.fused_step.FusedTrainStep`` running ``loss_fn``
        forward, the backward and this trainer's optimizer update as one
        step (see ``gluon.train_step``). ``loss_fn(*batch)`` returns the
        per-sample loss, usually a closure over the net; ``block`` names
        the net so that the step can check it. ``mesh`` (a data-parallel
        mesh across processes) runs it on each rank's rows with the
        gradients summed over 'dp' in buckets of ``bucket_bytes``;
        ``rules`` belongs to M10c."""
        from .fused_step import FusedTrainStep
        return FusedTrainStep(self, loss_fn, block=block, mesh=mesh,
                              bucket_bytes=bucket_bytes, rules=rules)

    def allreduce_grads(self):
        """The reduce half of ``step``, for a caller that updates with
        ``update()``: the push and pull through an attached kvstore;
        without one there is nothing to reduce (ref: trainer.py:334)."""
        self._prepare()
        assert not (self._kvstore and self._update_on_kvstore), \
            "allreduce_grads() when parameters are updated on kvstore " \
            "is not supported. Try setting `update_on_kvstore` to False " \
            "when creating trainer."
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One push of every gradient and one pull into the gradients (one
        pushpull into the weights with update on kvstore), keys in
        parameter order: the store then encodes every compressed gradient
        of the step with one codec call. The reference pushes key by key
        with a priority each; the in-process store has no queue to order,
        so the port ignores priority, and the values equal the per-key
        loop's (across processes too: each key's sum over the workers is
        formed alone)."""
        if self._kvstore is None:
            return
        live = [p for p in self._params if p.grad_req != "null"]
        if not live:
            return
        keys = [self._param2idx[p.name] for p in live]
        grads = [p._grad_tensor() for p in live]
        if self._update_on_kvstore:
            self._kvstore.pushpull(keys, grads,
                                   out=[p._tensor() for p in live])
        else:
            self._kvstore.push(keys, grads)
            self._kvstore.pull(keys, grads, ignore_sparse=False)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of ``step``, for gradients already reduced
        (ref: trainer.py:365)."""
        self._prepare()
        assert not (self._kvstore and self._update_on_kvstore), \
            "update() when parameters are updated on kvstore is not " \
            "supported. Try setting `update_on_kvstore` to False when " \
            "creating trainer."
        self._check_and_rescale_grad(self._scale / batch_size)
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        updates = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not getattr(param._tensor(), "_fresh_grad", True):
                if not ignore_stale_grad:
                    raise UserWarning(
                        "Gradient of Parameter `%s` on context %s has not "
                        "been updated by backward since last `step`. This "
                        "could mean a bug in your model that made it only "
                        "use a subset of the Parameters (Blocks) for this "
                        "iteration. If you are intentionally only using a "
                        "subset, call step with ignore_stale_grad=True to "
                        "suppress this warning" % (
                            param.name, param._tensor().device))
                continue    # a stale gradient is not applied again
            if self._kvstore and self._update_on_kvstore:
                # the store's pushpull applied this update already
                param._tensor()._fresh_grad = False
                continue
            updates.append((i, param._grad_tensor(), param._tensor()))
        if updates:
            i, g, w = zip(*updates)
            self._updater(list(i), list(g), list(w))
            # age the gradients only once the update ran: a raising update
            # leaves them fresh for a retried step
            for data in w:
                data._fresh_grad = False

    # -- optimizer state -----------------------------------------------------
    def save_states(self, fname):
        """Save the optimizer and its states (ref: trainer.py:436); with
        update on kvstore, the store's."""
        assert self._optimizer is not None
        self._prepare()
        if self._update_on_kvstore:
            assert not self._params_to_init, \
                "Cannot save trainer states when some parameters are not " \
                "yet initialized in kvstore."
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
        else:
            with atomic_write(fname) as fout:
                fout.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load what ``save_states`` saved (ref: trainer.py:465); the
        optimizer loaded takes this trainer's parameters again."""
        self._prepare()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())
            self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
