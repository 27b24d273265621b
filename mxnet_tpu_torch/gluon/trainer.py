"""Gluon Trainer: applies an Optimizer to a set of Parameters (counterpart of
mxnet_tpu/gluon/trainer.py), on one device.

``step(batch_size)`` sets ``rescale_grad = 1/batch_size``, reduces the
gradients (nothing to reduce on one device) and updates every parameter
whose gradient is fresh. A parameter whose gradient no backward has
written since the last step raises, unless ``ignore_stale_grad``.
Multi-device kvstores arrive with the multi-GPU slice.
"""
from __future__ import annotations

from .. import optimizer as opt
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


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
        if kvstore not in _LOCAL_KVSTORES or update_on_kvstore \
                or compression_params:
            raise NotImplementedError(
                "kvstore %r (update_on_kvstore=%r, compression %r): the port "
                "trains on one device; kvstore None, 'device' or 'local' "
                "only" % (kvstore, update_on_kvstore, compression_params))
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._param2idx[param.name] = i
            self._params.append(param)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)

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

    @property
    def learning_rate(self):
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One parameter update: rescale by 1/batch_size, reduce, apply."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def fuse_step(self, loss_fn, block=None, mesh=None, bucket_bytes=None,
                  rules=None):
        """A ``gluon.fused_step.FusedTrainStep`` running ``loss_fn``
        forward, the backward and this trainer's optimizer update as one
        step (see ``gluon.train_step``). ``loss_fn(*batch)`` returns the
        per-sample loss, usually a closure over the net; ``block`` names
        the net so that the step can check it. ``mesh``, ``rules`` and a
        ``bucket_bytes`` other than the default arrive with the multi-GPU
        slice."""
        from .fused_step import FusedTrainStep
        return FusedTrainStep(self, loss_fn, block=block, mesh=mesh,
                              bucket_bytes=bucket_bytes, rules=rules)

    def allreduce_grads(self):
        """The reduce half of ``step``, for a caller that updates with
        ``update()``. One device holds every gradient whole, so there is
        nothing to reduce; the multi-device reduction arrives with the
        multi-GPU slice."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update half of ``step``, for gradients already reduced."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        updates = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not getattr(param.data(), "_fresh_grad", True):
                if not ignore_stale_grad:
                    raise UserWarning(
                        "Gradient of Parameter `%s` on context %s has not "
                        "been updated by backward since last `step`. This "
                        "could mean a bug in your model that made it only "
                        "use a subset of the Parameters (Blocks) for this "
                        "iteration. If you are intentionally only using a "
                        "subset, call step with ignore_stale_grad=True to "
                        "suppress this warning" % (
                            param.name, param.data().device))
                continue    # a stale gradient is not applied again
            updates.append((i, param.grad(), param.data()))
        if updates:
            i, g, w = zip(*updates)
            self._updater(list(i), list(g), list(w))
            # age the gradients only once the update ran: a raising update
            # leaves them fresh for a retried step
            for data in w:
                data._fresh_grad = False
