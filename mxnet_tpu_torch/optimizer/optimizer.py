"""Optimizers (counterpart of mxnet_tpu/optimizer/optimizer.py): the
``Optimizer`` base, ``SGD``, ``Adam`` and the ``Updater`` that owns
per-index state.

``update(index, weight, grad, state)`` writes the new weight and state in
place, under ``torch.no_grad``, as elementwise PyTorch ops (the JAX package
runs the same chain in an XLA jit; no TPU kernel). ``step_fn`` is the pure
form of the same update, returning ``(new_weight, new_state)``; the fused
train step (``gluon/fused_step.py``) calls it per parameter, and the packed
multi-tensor apply (``kernels/optimizer_apply.py``) runs its math over whole
buckets of parameters in one kernel launch.

Scalars follow the JAX package's weak typing: for a float16 or bfloat16
weight, ``lr``, ``wd``, ``rescale``, the momentum, Adam's betas and epsilon
and the clip bound are rounded to the weight's dtype before each op
(``base.weak_scalar``), so every op of the chain rounds exactly where the
reference's does.

An optimizer pickles (``KVStore.set_optimizer`` sends a pickled copy to the
store, ``Updater.get_states(dump_optimizer=True)`` saves one). Its
``param_dict`` pickles as each parameter's ``lr_mult`` and ``wd_mult``,
which is all the optimizer reads of it: a port ``Parameter`` lives in its
network's modules and would pickle the whole network.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from ..base import is_low_precision, weak_scalar

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "create", "register",
           "get_updater"]


class _Mults:
    """What a pickled optimizer keeps of a parameter: its lr and wd
    multipliers."""

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult


class Optimizer:
    """Base optimizer: learning rate, weight decay, gradient rescaling and
    clipping, per-parameter lr/wd multipliers (``param_dict[index]``'s
    ``lr_mult``/``wd_mult``), the per-index update counts, and
    ``multi_precision`` (a float32 master copy of each half-precision
    weight, stepped in float32)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, param_dict=None, multi_precision=False):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = 0
        self._index_update_count = {}
        self.param_dict = param_dict if param_dict else {}

    def __getstate__(self):
        state = self.__dict__.copy()
        state["param_dict"] = {k: _Mults(p.lr_mult, p.wd_mult)
                               for k, p in self.param_dict.items()}
        return state

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

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` and a half-precision weight: ``(master,
        state)``, the float32 master copy and the state created for it.
        Otherwise ``create_state``."""
        if self.multi_precision and is_low_precision(weight.dtype):
            master = weight.detach().to(torch.float32, copy=True)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        """``update``, on the float32 master copy where the state holds
        one; the weight then takes the master's value in its own dtype."""
        if self.multi_precision and is_low_precision(weight.dtype):
            master, base = state
            self.update(index, master, grad.to(torch.float32), base)
            with torch.no_grad():
                weight.copy_(master)
        else:
            self.update(index, weight, grad, state)

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

    def _get_wds(self, indices):
        return [self._get_wd(i) for i in indices]

    # -- pure step form -------------------------------------------------------
    def step_fn(self, weight, grad, state, lr, wd, rescale):
        """Pure update: ``(new_weight, new_state)``, the same arithmetic
        as ``update()``. ``lr``, ``wd`` and ``rescale`` are Python floats,
        or tensors (one value per element in the packed apply's plain
        version)."""
        raise NotImplementedError(
            "%s does not define the pure step_fn form" % type(self).__name__)

    def step_fn_multi_precision(self, weight, grad, state, lr, wd, rescale):
        """Pure counterpart of ``update_multi_precision``: where the state
        is ``(master, base)``, step the float32 master and return it cast
        to the weight's dtype, with the new ``(master, base)``."""
        if self.multi_precision and is_low_precision(weight.dtype):
            master, base = state
            new_master, new_base = self.step_fn(
                master, grad.to(torch.float32), base, lr, wd, rescale)
            return new_master.to(weight.dtype), (new_master, new_base)
        return self.step_fn(weight, grad, state, lr, wd, rescale)

    def fused_step_supported(self):
        """Whether this optimizer defines the pure ``step_fn`` form, which
        the fused train step needs."""
        return type(self).step_fn is not Optimizer.step_fn

    def fused_apply_supported(self):
        """Whether the packed multi-tensor apply
        (``kernels/optimizer_apply.py``, ``MXTPU_FUSED_APPLY``) has a CUDA
        kernel for this optimizer's ``step_fn``. The base says no."""
        return False

    def step_lr(self, index):
        """The learning rate ``step_fn`` receives for one weight this step
        (call after ``_update_count``)."""
        return self._get_lr(index)

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

    Every op rounds to the weight's dtype, with its scalars rounded there
    first (the module docstring).
    """

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        dt = weight.dtype
        lr, wd, rescale = (weak_scalar(v, dt) for v in (lr, wd, rescale))
        clip = self.clip_gradient
        g = self._preprocess_grad(
            grad, rescale, None if clip is None else weak_scalar(clip, dt))
        if self.momentum == 0.0:
            return weight - lr * (g + wd * weight), state
        m2 = weak_scalar(self.momentum, dt) * state - lr * (g + wd * weight)
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


def _sqrt(x):
    """The correctly rounded square root in ``x``'s dtype, on every device:
    taken in float64 and rounded once (for a square root that double
    rounding is exact for float32 and bf16). PyTorch's float32 ``sqrt`` on
    the CPU is not correctly rounded (about 0.6% of values one ulp off);
    JAX's and the CUDA kernel's ``__fsqrt_rn`` are."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


@register
class Adam(Optimizer):
    """Adam (ref: optimizer.py:1412; the JAX package's ``Adam``):

        g  = clip(rescale * grad) + wd * w
        m  = beta1 * m + (1 - beta1) * g
        v  = beta2 * v + (1 - beta2) * g * g
        w  = w - lr_t * m / (sqrt(v) + epsilon)

    with ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` for the weight's
    update count ``t``, computed on the host in float64 (``step_lr``). The
    state is the tuple ``(m, v)``. Every op rounds to the weight's dtype,
    with its scalars rounded there first (the module docstring); ``1 -
    beta1`` and ``1 - beta2`` are Python floats before they round, and ``(1
    - beta2) * g * g`` associates left to right.
    """

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        # lr is step_lr's bias-corrected rate, so the step count never
        # enters the arithmetic here
        dt = weight.dtype
        lr, wd, rescale = (weak_scalar(v, dt) for v in (lr, wd, rescale))
        clip = self.clip_gradient
        m, v = state
        g = self._preprocess_grad(
            grad, rescale, None if clip is None else weak_scalar(clip, dt)) \
            + wd * weight
        b1, b2 = self.beta1, self.beta2
        m2 = weak_scalar(b1, dt) * m + weak_scalar(1 - b1, dt) * g
        v2 = weak_scalar(b2, dt) * v + weak_scalar(1 - b2, dt) * g * g
        w2 = weight - lr * m2 / (_sqrt(v2) + weak_scalar(self.epsilon, dt))
        return w2, (m2, v2)

    def fused_apply_supported(self):
        return True

    def step_lr(self, index):
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        return self._get_lr(index) * math.sqrt(coef2) / coef1

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            new_w, (m2, v2) = self.step_fn(
                weight, grad, state, self.step_lr(index),
                self._get_wd(index), self.rescale_grad)
            weight.copy_(new_w)
            state[0].copy_(m2)
            state[1].copy_(v2)


class Updater:
    """Applies an optimizer to indexed weights and owns their state
    (ref: optimizer.py:1935; what ``KVStore.set_optimizer`` installs in the
    store)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def ensure_state(self, index, weight):
        """The state of ``index``, created on first use, or moved to the
        weight's device on first use after ``set_states``. The eager update
        and the fused train step both take it from here, so they share one
        state store."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = _to_device(self.states[index],
                                            weight.device)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            self.optimizer.update_multi_precision(
                i, w, g, self.ensure_state(i, w))

    def set_states(self, states):
        """Load ``get_states``' bytes: the states (host copies, moved to
        each weight's device at its next use) and, where they were dumped
        with it, the optimizer."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states = {k: _rehydrate(v) for k, v in self.states.items()}
        self.states_synced = dict.fromkeys(self.states, False)

    def get_states(self, dump_optimizer=False):
        """The states as bytes, every tensor copied to the host (numpy
        where numpy has its dtype, else a CPU tensor: bf16), with the
        optimizer too under ``dump_optimizer``."""
        dehydrated = {k: _dehydrate(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((dehydrated, self.optimizer))
        return pickle.dumps(dehydrated)


def _dehydrate(state):
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_dehydrate(s) for s in state)
    return state


def _rehydrate(state):
    if isinstance(state, np.ndarray):
        return torch.from_numpy(state.copy())
    if isinstance(state, (tuple, list)):
        return type(state)(_rehydrate(s) for s in state)
    return state


def _to_device(state, device):
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_device(s, device) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)
