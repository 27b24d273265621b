"""Optimizers (counterpart of mxnet_tpu/optimizer/optimizer.py): the
``Optimizer`` base, the seventeen registered update rules (``SGD``,
``Signum``, ``FTML``, ``LARS``, ``LBSGD``, ``DCASGD``, ``SGLD``, ``Adam``,
``AdamW``, ``AdaGrad``, ``AdaDelta``, ``RMSProp``, ``Adamax``, ``Nadam``,
``Ftrl``, ``NAG``, ``LAMB``), the trivial ``Test``, and the ``Updater``
that owns per-index state.

``update(index, weight, grad, state)`` writes the new weight and state in
place, under ``torch.no_grad``, as elementwise PyTorch ops (the JAX package
runs the same chain in an XLA jit; no TPU kernel), in the JAX package's
order of operations. ``step_fn`` is the pure form of the same update,
returning ``(new_weight, new_state)``; the fused train step
(``gluon/fused_step.py``) calls it per parameter, and the packed
multi-tensor apply (``kernels/optimizer_apply.py``) runs SGD's and Adam's
math over whole buckets of parameters in one kernel launch. SGD, Adam,
AdaGrad, RMSProp and NAG have it, as in the JAX package.

Scalars follow the JAX package's jitted updates. There ``lr``, ``wd``,
``rescale`` and the other per-step values are traced float32 scalars, and
the hyperparameters Python constants: both are weak types. So a value that
the JAX update computes from two traced scalars (Signum's ``1 - lr * (wd +
wd_lh)``, AdamW's ``lr * wd``, Nadam's ``1 - m_schedule``) is computed here
in float32 (``_f32``), and for a float16 or bfloat16 weight every scalar is
rounded to the weight's dtype before its op (``base.weak_scalar``), so
every op of the chain rounds where the reference's does. Square roots are
correctly rounded (``_sqrt``), as XLA's are.

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
from ..ndarray.ndarray import nd_io

__all__ = [
    "Optimizer", "SGD", "Signum", "FTML", "LARS", "LBSGD", "DCASGD", "NAG",
    "SGLD", "Adam", "AdamW", "AdaGrad", "AdaDelta", "RMSProp", "Adamax",
    "Nadam", "Ftrl", "LAMB", "Test", "Updater", "create", "register",
    "get_updater",
]


class _Mults:
    """What a pickled optimizer keeps of a parameter: its lr and wd
    multipliers."""

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult


def _f32(v):
    """``v`` as the float32 value a traced scalar of the JAX package's
    jitted update holds (a Python float that float32 represents exactly)."""
    return float(np.float32(v))


def _zeros(weight):
    return torch.zeros_like(weight, requires_grad=False)


def _sqrt(x):
    """The correctly rounded square root in ``x``'s dtype, on every device:
    taken in float64 and rounded once (for a square root that double
    rounding is exact for float32 and bf16). PyTorch's float32 ``sqrt`` on
    the CPU is not correctly rounded (about 0.6% of values one ulp off);
    JAX's and the CUDA kernel's ``__fsqrt_rn`` are."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


class Optimizer:
    """Base optimizer: learning rate (fixed or from ``lr_scheduler``),
    weight decay, gradient rescaling and clipping, per-parameter lr/wd
    multipliers (``param_dict[index]``'s ``lr_mult``/``wd_mult``, else
    ``set_lr_mult``/``set_wd_mult`` by index or by the name
    ``param_idx2name`` gives it), the per-index update counts (starting at
    ``begin_num_update``), and ``multi_precision`` (a float32 master copy
    of each half-precision weight, stepped in float32)."""

    opt_registry = {}

    def __init_subclass__(cls, **kwargs):
        # every optimizer's update and create_state take NDArrays too (the
        # weight and states written in place, NDArray states created)
        super().__init_subclass__(**kwargs)
        for name in ("update", "create_state"):
            if name in cls.__dict__:
                setattr(cls, name, nd_io(cls.__dict__[name]))

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        # sym and aggregate_num are accepted for parity: updates run one
        # weight at a time (the packed path is MXTPU_FUSED_APPLY)
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._all_index_update_counts = {0: {}}
        self._index_update_count = self._all_index_update_counts[0]
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise TypeError("param_idx2name should be a dict of param "
                            "indexes to names")
        self.idx2name = param_idx2name.copy()
        self.param_dict = param_dict if param_dict else {}
        self.lr_mult = {}
        self.wd_mult = {}

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

    @nd_io
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

    @nd_io
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

    # -- schedule and multipliers ---------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined. "
                "Note that set_learning_rate can mutate the value of the "
                "learning rate of the optimizer only when the LRScheduler "
                "of the optimizer is undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        """Learning-rate multipliers by index or by parameter name."""
        self.lr_mult = {}
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight-decay multipliers by index or by name; every named
        parameter that is not a ``_weight`` or a ``_gamma`` (biases, beta)
        gets 0 first."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def set_current_context(self, device_id):
        if device_id not in self._all_index_update_counts:
            self._all_index_update_counts[device_id] = {}
        self._index_update_count = self._all_index_update_counts[device_id]

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lrs(self, indices):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        lrs = [lr for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                lrs[i] *= self.param_dict[index].lr_mult
            elif index in self.lr_mult:
                lrs[i] *= self.lr_mult[index]
            elif index in self.idx2name:
                lrs[i] *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lrs

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wds(self, indices):
        wds = [self.wd for _ in indices]
        for i, index in enumerate(indices):
            if index in self.param_dict:
                wds[i] *= self.param_dict[index].wd_mult
            elif index in self.wd_mult:
                wds[i] *= self.wd_mult[index]
            elif index in self.idx2name:
                wds[i] *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wds

    def _get_wd(self, index):
        return self._get_wds([index])[0]

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

    def _grad(self, grad, dt, rescale=None):
        """``_preprocess_grad`` with this optimizer's rescale (or
        ``rescale``) and clip, both rounded as weak scalars of ``dt``."""
        clip = self.clip_gradient
        return self._preprocess_grad(
            grad, weak_scalar(self.rescale_grad if rescale is None
                              else rescale, dt),
            None if clip is None else weak_scalar(clip, dt))


register = Optimizer.register
create = Optimizer.create_optimizer


def _write(pairs):
    """Write each ``(tensor, new value)`` in place, outside the graph."""
    with torch.no_grad():
        for t, new in pairs:
            t.copy_(new)


@register
class Test(Optimizer):
    """The reference's trivial test optimizer: ``w = w + rescale * grad``,
    and the state takes the new weight."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        new = weight + grad * weak_scalar(self.rescale_grad, weight.dtype)
        _write([(weight, new), (state, new)])


@register
class SGD(Optimizer):
    """SGD with optional momentum:

        g = clip(rescale * grad)
        momentum 0:  w = w - lr * (g + wd * w)
        otherwise:   m = momentum * m - lr * (g + wd * w);  w = w + m

    Every op rounds to the weight's dtype, with its scalars rounded there
    first (the module docstring).
    """

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        # a row-sparse gradient's lazy update; every gradient here is dense
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        dt = weight.dtype
        lr, wd = weak_scalar(lr, dt), weak_scalar(wd, dt)
        g = self._grad(grad, dt, rescale)
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


@register
class Signum(Optimizer):
    """Sign-of-gradient SGD (ref: optimizer.py:934):

        g = clip(rescale * grad)
        momentum 0:  w = (1 - lr * (wd + wd_lh)) * w - lr * sign(g)
        otherwise:   m = momentum * m - (1 - momentum) * (g + wd * w)
                     w = (1 - lr * wd_lh) * w + lr * sign(m)
    """

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        mom, lr32 = self.momentum, np.float32(lr)
        with torch.no_grad():
            g = self._grad(grad, dt)
            if mom == 0.0:
                keep = _f32(1 - lr32 * (np.float32(wd)
                                        + np.float32(self.wd_lh)))
                _write([(weight, weak_scalar(keep, dt) * weight
                         - weak_scalar(lr, dt) * torch.sign(g))])
                return
            m2 = weak_scalar(mom, dt) * state - weak_scalar(1 - mom, dt) \
                * (g + weak_scalar(wd, dt) * weight)
            keep = _f32(1 - lr32 * np.float32(self.wd_lh))
            w2 = weak_scalar(keep, dt) * weight \
                + weak_scalar(lr, dt) * torch.sign(m2)
            _write([(weight, w2), (state, m2)])


@register
class FTML(Optimizer):
    """Follow the moving leader (ref: optimizer.py:1005). The state is
    ``(d, v, z)``; ``t`` is the weight's update count:

        g = clip(rescale * grad) + wd * w
        v = beta2 * v + (1 - beta2) * g * g
        d' = (1 - beta1^t) / lr * (sqrt(v / (1 - beta2^t)) + epsilon)
        z = beta1 * z + (1 - beta1) * g - (d' - beta1 * d) * w
        w = -z / d';  d = d'
    """

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))  # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = np.float32(self._index_update_count[index])
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        dt = weight.dtype
        d, v, z = state

        def s(x):
            return weak_scalar(x, dt)
        one = np.float32(1)
        c1 = _f32((one - np.float32(b1) ** t) / np.float32(lr))
        c2 = _f32(one - np.float32(b2) ** t)
        with torch.no_grad():
            g = self._grad(grad, dt) + s(wd) * weight
            v2 = s(b2) * v + s(1 - b2) * g * g
            d2 = s(c1) * (_sqrt(v2 / s(c2)) + s(eps))
            sigma = d2 - s(b1) * d
            z2 = s(b1) * z + s(1 - b1) * g - sigma * weight
            _write([(weight, -z2 / d2), (d, d2), (v, v2), (z, z2)])


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (ref: optimizer.py:788). A weight
    whose name (``param_idx2name``) ends in gamma, beta or bias keeps the
    rate; any other takes ``eta * |w| / (|g| + wd * |w| + epsilon)`` times
    it where both norms are positive (norms of float32 squares).
    ``momentum_correction`` scales the momentum by the ratio of this
    update's rate to the one before."""

    def __init__(self, momentum=0.0, lars_eta=0.001, lars_epsilon=0,
                 momentum_correction=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lars_eta = lars_eta
        self.lars_epsilon = lars_epsilon
        self.momentum_correction = momentum_correction
        self.last_lr = None
        self.cur_lr = None

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    @staticmethod
    def _l2norm(v):
        return torch.sqrt(torch.sum((v * v).to(torch.float32)))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom = self.momentum
        if self.momentum_correction and self.last_lr is not None \
                and self.last_lr != 0:
            mom = mom * (lr / self.last_lr)
        self.last_lr, self.cur_lr = self.cur_lr if self.cur_lr is not None \
            else lr, lr
        name = self.idx2name.get(index, str(index))
        dt = weight.dtype
        with torch.no_grad():
            g = self._grad(grad, dt)
            if name.endswith(("gamma", "beta", "bias")):
                scaled_lr = weak_scalar(lr, dt)
            else:
                w_norm, g_norm = self._l2norm(weight), self._l2norm(g)
                ratio = torch.where(
                    (w_norm > 0) & (g_norm > 0),
                    _f32(self.lars_eta) * w_norm
                    / (g_norm + _f32(wd) * w_norm
                       + _f32(self.lars_epsilon)),
                    torch.ones_like(w_norm))
                scaled_lr = _f32(lr) * ratio
            upd = scaled_lr * (g + weak_scalar(wd, dt) * weight)
            if state is None:
                _write([(weight, weight - upd)])
                return
            m2 = weak_scalar(mom, dt) * state + upd
            _write([(weight, weight - m2), (state, m2)])


@register
class LBSGD(Optimizer):
    """Large-batch SGD (ref: optimizer.py:1061): SGD whose rate is scaled
    by a warmup multiplier (``warmup_strategy`` linear, power2 or sqrt over
    ``warmup_epochs * updates_per_epoch`` updates up to ``batch_scale``), or
    with "lars" by LARS's ratio of the weight's and gradient's norms."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        strategy = self.warmup_strategy
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            mult = maxmult
        elif nwup <= 1:
            mult = 1.0
        elif strategy == "linear":
            mult = 1.0 + (maxmult - 1) * nup / nwup
        elif strategy == "power2":
            mult = 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        elif strategy == "sqrt":
            mult = 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        else:
            mult = 1.0
        return mult

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        if self.warmup_strategy == "lars":
            with torch.no_grad():
                w_norm = float(torch.linalg.vector_norm(weight.float()))
                g_norm = float(torch.linalg.vector_norm(
                    (grad * weak_scalar(self.rescale_grad, dt)).float()))
            if w_norm > 0 and g_norm > 0:
                self.lbmult = w_norm / (g_norm + wd * w_norm + 1e-9) * 0.001
            else:
                self.lbmult = 1.0
        else:
            self.lbmult = self._get_lbmult(self.num_update)
        lr = lr * self.lbmult
        with torch.no_grad():
            g = self._grad(grad, dt)
            step = weak_scalar(lr, dt) * (g + weak_scalar(wd, dt) * weight)
            if self.momentum == 0.0:
                _write([(weight, weight - step)])
                return
            m2 = weak_scalar(self.momentum, dt) * state - step
            _write([(weight, weight + m2), (state, m2)])


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD (ref: optimizer.py:1236). The state is
    ``(momentum or None, previous weight)``:

        g = clip(rescale * grad)
        c = g + wd * w + lamda * g * g * (w - w_prev)
        m = momentum * m - lr * c   (-lr * c without momentum)
        w_prev = w;  w = w + m
    """

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone()
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros(weight), prev)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        m, prev = state
        with torch.no_grad():
            g = self._grad(grad, dt)
            comp = g + weak_scalar(wd, dt) * weight \
                + weak_scalar(self.lamda, dt) * g * g * (weight - prev)
            if m is None:
                m2 = weak_scalar(-lr, dt) * comp
            else:
                m2 = weak_scalar(self.momentum, dt) * m \
                    - weak_scalar(lr, dt) * comp
            new_w = weight + m2
            pairs = [(prev, weight), (weight, new_w)]
            if m is not None:
                pairs.append((m, m2))
            _write(pairs)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (ref: optimizer.py:1342):

        w = w - lr / 2 * (clip(rescale * grad) + wd * w) + sqrt(lr) * noise

    with standard normal noise drawn in float32 from the port's random
    generator (``random.generator()``: reproducible with ``random.seed``,
    the same values on the CPU and the card) and cast to the weight's
    dtype. The JAX package draws it from its own key stream, which torch
    cannot reproduce."""

    def update(self, index, weight, grad, state):
        from .. import random as _random
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        noise = torch.randn(tuple(weight.shape), generator=_random.generator(),
                            dtype=torch.float32).to(weight.device, dt)
        lr32 = np.float32(lr)
        with torch.no_grad():
            g = self._grad(grad, dt)
            new_w = weight - weak_scalar(_f32(lr32 / np.float32(2)), dt) \
                * (g + weak_scalar(wd, dt) * weight) \
                + noise * weak_scalar(_f32(np.sqrt(lr32)), dt)
            _write([(weight, new_w)])


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
        return (_zeros(weight), _zeros(weight))

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        # lr is step_lr's bias-corrected rate, so the step count never
        # enters the arithmetic here
        dt = weight.dtype
        lr, wd = weak_scalar(lr, dt), weak_scalar(wd, dt)
        m, v = state
        g = self._grad(grad, dt, rescale) + wd * weight
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


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (ref: contrib adamw):

        g = clip(rescale * grad)
        m = beta1 * m + (1 - beta1) * g;  v = beta2 * v + (1 - beta2) * g * g
        w = w - lr_t * m / (sqrt(v) + epsilon) - lr * wd * w

    with Adam's bias-corrected ``lr_t`` (float64 on the host) and ``lr *
    wd`` in float32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr * math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1 ** t)
        b1, b2, dt = self.beta1, self.beta2, weight.dtype
        m, v = state

        def s(x):
            return weak_scalar(x, dt)
        with torch.no_grad():
            g = self._grad(grad, dt)
            m2 = s(b1) * m + s(1 - b1) * g
            v2 = s(b2) * v + s(1 - b2) * g * g
            decay = s(_f32(np.float32(lr) * np.float32(wd)))
            w2 = weight - s(lr_t) * m2 / (_sqrt(v2) + s(self.epsilon)) \
                - decay * weight
            _write([(weight, w2), (m, m2), (v, v2)])


@register
class AdaGrad(Optimizer):
    """AdaGrad (ref: optimizer.py:1520):

        g = clip(rescale * grad) + wd * w
        h = h + g * g;  w = w - lr * g / (sqrt(h) + eps)
    """

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        dt = weight.dtype
        g = self._grad(grad, dt, rescale) + weak_scalar(wd, dt) * weight
        h2 = state + g * g
        return weight - weak_scalar(lr, dt) * g / (
            _sqrt(h2) + weak_scalar(self.float_stable_eps, dt)), h2

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            w2, h2 = self.step_fn(weight, grad, state, self._get_lr(index),
                                  self._get_wd(index), self.rescale_grad)
            _write([(weight, w2), (state, h2)])


@register
class AdaDelta(Optimizer):
    """AdaDelta (ref: optimizer.py:1635); no learning rate. The state is
    ``(acc_g, acc_delta)``:

        g = clip(rescale * grad) + wd * w
        acc_g = rho * acc_g + (1 - rho) * g * g
        delta = sqrt(acc_delta + epsilon) / sqrt(acc_g + epsilon) * g
        acc_delta = rho * acc_delta + (1 - rho) * delta * delta
        w = w - delta
    """

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd, dt, rho = self._get_wd(index), weight.dtype, self.rho
        acc_g, acc_delta = state

        def s(x):
            return weak_scalar(x, dt)
        with torch.no_grad():
            g = self._grad(grad, dt) + s(wd) * weight
            ag2 = s(rho) * acc_g + s(1 - rho) * g * g
            delta = _sqrt(acc_delta + s(self.epsilon)) \
                / _sqrt(ag2 + s(self.epsilon)) * g
            ad2 = s(rho) * acc_delta + s(1 - rho) * delta * delta
            _write([(weight, weight - delta), (acc_g, ag2),
                    (acc_delta, ad2)])


@register
class RMSProp(Optimizer):
    """RMSProp (ref: optimizer.py:1553), Hinton's form, or Graves' with
    ``centered`` (state ``(n, g, delta)``):

        g = clip(rescale * grad) + wd * w
        n = (1 - gamma1) * g * g + gamma1 * n
        plain:     w = w - lr * g / sqrt(n + epsilon)
        centered:  gbar = (1 - gamma1) * g + gamma1 * gbar
                   delta = gamma2 * delta - lr * g / sqrt(n - gbar^2 + eps)
                   w = w + delta
        then w clipped to [-clip_weights, clip_weights] where that is set.
    """

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        dt = weight.dtype

        def s(x):
            return weak_scalar(x, dt)
        g1, eps, clip_w = self.gamma1, self.epsilon, self.clip_weights
        g = self._grad(grad, dt, rescale) + s(wd) * weight
        if not self.centered:
            n2 = s(1 - g1) * g * g + s(g1) * state
            w2 = weight - s(lr) * g / _sqrt(n2 + s(eps))
            new_state = n2
        else:
            n, gbar, delta = state
            n2 = s(1 - g1) * g * g + s(g1) * n
            gb2 = s(1 - g1) * g + s(g1) * gbar
            d2 = s(self.gamma2) * delta \
                - s(lr) * g / _sqrt(n2 - gb2 * gb2 + s(eps))
            w2 = weight + d2
            new_state = (n2, gb2, d2)
        if clip_w is not None:
            w2 = torch.clamp(w2, -s(clip_w), s(clip_w))
        return w2, new_state

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            w2, new = self.step_fn(weight, grad, state, self._get_lr(index),
                                   self._get_wd(index), self.rescale_grad)
            if self.centered:
                _write([(weight, w2)] + list(zip(state, new)))
            else:
                _write([(weight, w2), (state, new)])


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm (ref: optimizer.py:1688):

        g = clip(rescale * grad) + wd * w
        m = beta1 * m + (1 - beta1) * g;  u = max(beta2 * u, |g|)
        w = w - lr / (1 - beta1^t) * m / (u + 1e-8)
    """

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr / (1. - self.beta1 ** t)
        b1, b2, dt = self.beta1, self.beta2, weight.dtype
        m, u = state

        def s(x):
            return weak_scalar(x, dt)
        with torch.no_grad():
            g = self._grad(grad, dt) + s(wd) * weight
            m2 = s(b1) * m + s(1 - b1) * g
            u2 = torch.maximum(s(b2) * u, torch.abs(g))
            w2 = weight - s(lr_t) * m2 / (u2 + s(1e-8))
            _write([(weight, w2), (m, m2), (u, u2)])


@register
class Nadam(Optimizer):
    """Nesterov Adam (ref: optimizer.py:1742). The momentum schedule
    ``m_schedule`` is the optimizer's, multiplied at every update of any
    weight, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        b1, b2, dt = self.beta1, self.beta2, weight.dtype
        mom_t = b1 * (1. - 0.5 * 0.96 ** (t * self.schedule_decay))
        mom_t_1 = b1 * (1. - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * mom_t
        m_sched_next = self.m_schedule * mom_t_1
        one = np.float32(1)
        m, v = state

        def s(x):
            return weak_scalar(x, dt)
        with torch.no_grad():
            g = self._grad(grad, dt) + s(wd) * weight
            g_prime = g / s(_f32(one - np.float32(self.m_schedule)))
            m2 = s(b1) * m + s(1. - b1) * g
            m2_prime = m2 / s(_f32(one - np.float32(m_sched_next)))
            v2 = s(b2) * v + s(1. - b2) * g * g
            v2_prime = v2 / s(1. - b2 ** t)
            m_bar = s(_f32(one - np.float32(mom_t))) * g_prime \
                + s(mom_t_1) * m2_prime
            w2 = weight - s(lr) * m_bar / (_sqrt(v2_prime) + s(self.epsilon))
            _write([(weight, w2), (m, m2), (v, v2)])


@register
class Ftrl(Optimizer):
    """FTRL-proximal (ref: optimizer.py Ftrl). The state is ``(z, n)``:

        g = clip(rescale * grad)
        z = z + g - (sqrt(n + g * g) - sqrt(n)) / lr * w;  n = n + g * g
        w = (sign(z) * lamda1 - z) / ((beta + sqrt(n)) / lr + wd)
            where |z| > lamda1, else 0
    """

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))   # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        dt = weight.dtype
        z, n = state

        def s(x):
            return weak_scalar(x, dt)
        l1 = s(self.lamda1)
        with torch.no_grad():
            g = self._grad(grad, dt)
            sigma = (_sqrt(n + g * g) - _sqrt(n)) / s(lr)
            z2 = z + g - sigma * weight
            n2 = n + g * g
            w2 = torch.where(
                torch.abs(z2) > l1,
                (torch.sign(z2) * l1 - z2)
                / ((s(self.beta) + _sqrt(n2)) / s(lr) + s(wd)),
                torch.zeros_like(z2)).to(dt)
            _write([(weight, w2), (z, z2), (n, n2)])


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (ref: optimizer.py:1285):

        momentum 0:  w = w - lr * (clip(rescale * grad) + wd * w)
        otherwise:   g = clip(rescale * grad) + wd * w
                     m = momentum * m + g;  w = w - lr * (g + momentum * m)
    """

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def step_fn(self, weight, grad, state, lr, wd, rescale):
        dt = weight.dtype
        lr, wd = weak_scalar(lr, dt), weak_scalar(wd, dt)
        g = self._grad(grad, dt, rescale)
        if state is None:
            return weight - lr * (g + wd * weight), None
        mom = weak_scalar(self.momentum, dt)
        g = g + wd * weight
        m2 = mom * state + g
        return weight - lr * (g + mom * m2), m2

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            w2, m2 = self.step_fn(weight, grad, state, self._get_lr(index),
                                  self._get_wd(index), self.rescale_grad)
            _write([(weight, w2)] + ([] if state is None else [(state, m2)]))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (LAMB; ref: optimizer_op.cc
    lamb_update_phase1/2):

        g = clip(rescale * grad)
        m = beta1 * m + (1 - beta1) * g;  v = beta2 * v + (1 - beta2) * g * g
        r = m' / (sqrt(v') + epsilon) + wd * w   (m', v' bias-corrected
                                                 with bias_correction)
        w = w - lr * ratio * r,  ratio = |w| / |r| where both are positive
    |w| clamped to [lower_bound, upper_bound] where those are set; norms in
    float32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        b1, b2, dt = self.beta1, self.beta2, weight.dtype
        m, v = state

        def s(x):
            return weak_scalar(x, dt)
        with torch.no_grad():
            g = self._grad(grad, dt)
            m2 = s(b1) * m + s(1 - b1) * g
            v2 = s(b2) * v + s(1 - b2) * g * g
            mhat, vhat = m2, v2
            if self.bias_correction:
                mhat, vhat = m2 / s(1 - b1 ** t), v2 / s(1 - b2 ** t)
            r = mhat / (_sqrt(vhat) + s(self.epsilon)) + s(wd) * weight
            w_norm = torch.linalg.vector_norm(weight.to(torch.float32))
            r_norm = torch.linalg.vector_norm(r.to(torch.float32))
            if self.lower_bound is not None:
                w_norm = torch.clamp_min(w_norm, self.lower_bound)
            if self.upper_bound is not None:
                w_norm = torch.clamp_max(w_norm, self.upper_bound)
            ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                                torch.ones_like(w_norm)).to(dt)
            w2 = weight - (s(lr) * ratio) * r
            _write([(weight, w2), (m, m2), (v, v2)])


# the reference's deprecated alias
ccSGD = SGD


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
            # the allocation ledger's 'opt_state' tag, at creation
            from .. import storage as _storage
            _storage.ledger_register_tree(self.states[index], "opt_state",
                                          site="opt_state[%s]" % (index,))
        elif not self.states_synced.get(index, True):
            self.states[index] = _to_device(self.states[index],
                                            weight.device)
            self.states_synced[index] = True
        return self.states[index]

    @nd_io
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
