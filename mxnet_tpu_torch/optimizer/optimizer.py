"""Optimizers (counterpart of mxnet_tpu/optimizer/optimizer.py): the
``Optimizer`` base, ``SGD`` and the ``Updater`` that owns per-index state.

``update(index, weight, grad, state)`` writes the new weight and state in
place, under ``torch.no_grad``, as elementwise PyTorch ops (the JAX package
runs the same chain in an XLA jit; no TPU kernel). ``step_fn`` is the pure
form of the same update, returning ``(new_weight, new_state)``.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "Updater", "create", "register",
           "get_updater"]


class Optimizer:
    """Base optimizer: learning rate, weight decay, gradient rescaling and
    clipping, per-parameter lr/wd multipliers (``param_dict[index]``'s
    ``lr_mult``/``wd_mult``) and the per-index update counts."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}
        self.param_dict = param_dict if param_dict else {}

    # -- registry -------------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    # -- state and update -----------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_learning_rate(self, lr):
        self.lr = lr

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            self._index_update_count[idx] = \
                self._index_update_count.get(idx, 0) + 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lr(self, index):
        p = self.param_dict.get(index)
        return self.lr * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)

    # -- pure step form -------------------------------------------------------
    def step_fn(self, weight, grad, state, lr, wd, rescale):
        """Pure update: ``(new_weight, new_state)``, the same arithmetic
        as ``update()``."""
        raise NotImplementedError(
            "%s does not define the pure step_fn form" % type(self).__name__)

    def fused_apply_supported(self):
        """Whether ``step_fn`` is elementwise, the property a packed
        multi-tensor apply needs. A flag only: the packed apply kernel is
        not ported."""
        return False

    def _preprocess_grad(self, grad, rescale, clip):
        g = grad * rescale
        if clip is not None:
            g = torch.clamp(g, -clip, clip)
        return g


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum:

        g = clip(rescale * grad)
        momentum 0:  w = w - lr * (g + wd * w)
        otherwise:   m = momentum * m - lr * (g + wd * w);  w = w + m
    """

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        g = self._preprocess_grad(grad, rescale, self.clip_gradient)
        if self.momentum == 0.0:
            return weight - lr * (g + wd * weight), state
        m2 = self.momentum * state - lr * (g + wd * weight)
        return weight + m2, m2

    def fused_apply_supported(self):
        return True

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            new_w, new_m = self.step_fn(weight, grad, state, lr, wd,
                                        self.rescale_grad)
            weight.copy_(new_w)
            if state is not None:
                state.copy_(new_m)


class Updater:
    """Applies an optimizer to indexed weights and owns their state."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state(i, w)
            self.optimizer.update(i, w, g, self.states[i])


def get_updater(optimizer):
    return Updater(optimizer)
