"""Optimizer update ops: the pure registry forms (counterpart of
mxnet_tpu/ops/optimizer_ops.py; the reference's kernels are in
src/operator/optimizer_op-inl.h, contrib/adamw.cc and multi_lars.cc).

Each op returns every updated tensor (``sgd_mom_update`` returns
``(new_weight, new_mom)``) and writes none of its inputs: the JAX package's
dataflow contract. ``nd.sgd_mom_update(..., out=w)`` and the rest
(``ndarray/optimizer_ops.py``) give back the reference's in-place calling
convention on top of these. Elementwise PyTorch ops, in the JAX forms'
order; hyperparameters are Python scalars, rounded to a half-precision
operand's dtype before their op as JAX's weak types are
(``base.weak_scalar``). The ``multi_*`` forms take interleaved groups
(``w, g[, state...]`` per weight) and return all new weights, then all
new states group by group; the ``preloaded_multi_*`` forms take the
per-weight ``lrs`` and ``wds`` as two trailing tensors.
"""
from __future__ import annotations

import torch

from ..base import weak_scalar
from .registry import register

__all__ = []


def _s(v, ref):
    return weak_scalar(v, ref.dtype)


def _sqrt(x):
    """Correctly rounded square root (float64, rounded once), as XLA's."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _clip(g, c):
    if c is not None and c >= 0:
        return torch.clamp(g, -_s(c, g), _s(c, g))
    return g


@register("sgd_update", input_names=("weight", "grad"))
def sgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """ref: optimizer_op-inl.h:382 SGDKernel."""
    g = _clip(_s(rescale_grad, grad) * grad, clip_gradient)
    return _s(1.0 - lr * wd, weight) * weight - _s(lr, g) * g


@register("sgd_mom_update",
          input_names=("weight", "grad", "mom"), num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """ref: optimizer_op-inl.h:600 SGDMomKernel -> (new_w, new_mom)."""
    g = _clip(_s(rescale_grad, grad) * grad, clip_gradient)
    new_m = _s(momentum, mom) * mom - _s(lr * wd, weight) * weight \
        - _s(lr, g) * g
    return weight + new_m, new_m


@register("mp_sgd_update",
          input_names=("weight", "grad", "weight32"), num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr=None, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """ref: optimizer_op-inl.h MP_SGDKernel -> (new_w, new_w32)."""
    g = _clip(rescale_grad * grad.to(torch.float32), clip_gradient)
    new_w32 = (1.0 - lr * wd) * weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update",
          input_names=("weight", "grad", "mom", "weight32"), num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=None, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """ref: optimizer_op-inl.h MP_SGDMomKernel -> (new_w, new_mom,
    new_w32)."""
    g = _clip(rescale_grad * grad.to(torch.float32), clip_gradient)
    new_m = momentum * mom - lr * wd * weight32 - lr * g
    new_w32 = weight32 + new_m
    return new_w32.to(weight.dtype), new_m, new_w32


@register("nag_mom_update",
          input_names=("weight", "grad", "mom"), num_outputs=2)
def nag_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum (ref: optimizer_op-inl.h:1060 NAGMomKernel)
    -> (new_w, new_mom)."""
    g = _clip(_s(rescale_grad, grad) * grad, clip_gradient) \
        + _s(wd, weight) * weight
    m_scaled = _s(momentum, mom) * mom
    new_m = m_scaled - _s(lr, g) * g
    new_w = weight - m_scaled + _s(momentum + 1.0, new_m) * new_m
    return new_w, new_m


@register("mp_nag_mom_update",
          input_names=("weight", "grad", "mom", "weight32"), num_outputs=3)
def mp_nag_mom_update(weight, grad, mom, weight32, lr=None, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """ref: optimizer_op-inl.h MP_NAGMomKernel -> (new_w, new_mom,
    new_w32)."""
    g = _clip(rescale_grad * grad.to(torch.float32), clip_gradient) \
        + wd * weight32
    m_scaled = momentum * mom
    new_m = m_scaled - lr * g
    new_w32 = weight32 - m_scaled + (momentum + 1.0) * new_m
    return new_w32.to(weight.dtype), new_m, new_w32


@register("adam_update",
          input_names=("weight", "grad", "mean", "var"), num_outputs=3)
def adam_update(weight, grad, mean, var, lr=None, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """ref: optimizer_op-inl.h:1302 AdamUpdateKernel (no bias correction:
    the Python optimizer folds it into lr) -> (new_w, new_mean,
    new_var)."""
    g = _clip(grad * _s(rescale_grad, grad) + _s(wd, weight) * weight,
              clip_gradient)
    new_m = _s(beta1, mean) * mean + _s(1.0 - beta1, g) * g
    new_v = _s(beta2, var) * var + _s(1.0 - beta2, g) * g * g
    new_w = weight - _s(lr, new_m) * new_m / (_sqrt(new_v)
                                              + _s(epsilon, new_v))
    return new_w, new_m, new_v


@register("rmsprop_update", input_names=("weight", "grad", "n"), num_outputs=2)
def rmsprop_update(weight, grad, n, lr=None, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """ref: optimizer_op-inl.h:1717 RMSPropUpdateKernel -> (new_w,
    new_n)."""
    g = _clip(_s(rescale_grad, grad) * grad + _s(wd, weight) * weight,
              clip_gradient)
    new_n = _s(1.0 - gamma1, g) * g * g + _s(gamma1, n) * n
    new_w = _clip(weight - _s(lr, g) * g / _sqrt(new_n + _s(epsilon, n)),
                  clip_weights)
    return new_w, new_n


@register("rmspropalex_update",
          input_names=("weight", "grad", "n", "g", "delta"), num_outputs=4)
def rmspropalex_update(weight, grad, n, g, delta, lr=None, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Graves' RMSProp (ref: optimizer_op-inl.h:1619) -> (new_w, new_n,
    new_g, new_delta)."""
    gr = _clip(_s(rescale_grad, grad) * grad + _s(wd, weight) * weight,
               clip_gradient)
    new_n = _s(1.0 - gamma1, gr) * gr * gr + _s(gamma1, n) * n
    new_g = _s(1.0 - gamma1, gr) * gr + _s(gamma1, g) * g
    new_d = _s(gamma2, delta) * delta - _s(lr, gr) * gr / _sqrt(
        new_n - new_g * new_g + _s(epsilon, n))
    new_w = _clip(weight + new_d, clip_weights)
    return new_w, new_n, new_g, new_d


@register("ftrl_update",
          input_names=("weight", "grad", "z", "n"), num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=None, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """ref: optimizer_op-inl.h:1797 FTRLKernel -> (new_w, new_z, new_n)."""
    g = _clip(_s(rescale_grad, grad) * grad, clip_gradient)
    new_z = z + g - (_sqrt(n + g * g) - _sqrt(n)) / _s(lr, n) * weight
    new_n = n + g * g
    new_w = torch.where(
        torch.abs(new_z) <= _s(lamda1, new_z), torch.zeros_like(weight),
        (torch.sign(new_z) * _s(lamda1, new_z) - new_z)
        / ((_s(beta, new_n) + _sqrt(new_n)) / _s(lr, new_n)
           + _s(wd, new_n)))
    return new_w, new_z, new_n


@register("ftml_update",
          input_names=("weight", "grad", "d", "v", "z"), num_outputs=4)
def ftml_update(weight, grad, d, v, z, lr=None, t=1, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """ref: optimizer_op-inl.h:1214 FTMLKernel -> (new_w, new_d, new_v,
    new_z)."""
    g = _clip(_s(rescale_grad, grad) * grad + _s(wd, weight) * weight,
              clip_grad)
    t = float(t)
    new_v = _s(beta2, v) * v + _s(1.0 - beta2, g) * g * g
    d_t = _s((1.0 - beta1 ** t) / lr, v) * (
        _sqrt(new_v / _s(1.0 - beta2 ** t, v)) + _s(epsilon, v))
    sigma = d_t - _s(beta1, d) * d
    new_z = _s(beta1, z) * z + _s(1.0 - beta1, g) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("signsgd_update", input_names=("weight", "grad"))
def signsgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """ref: optimizer_op-inl.h:1998 SignSGDKernel."""
    return _s(1.0 - lr * wd, weight) * weight \
        - _s(lr, grad) * torch.sign(grad)


@register("signum_update",
          input_names=("weight", "grad", "mom"), num_outputs=2)
def signum_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """ref: optimizer_op-inl.h:2066 SignumKernel -> (new_w, new_mom)."""
    g = _clip(_s(rescale_grad, grad) * grad, clip_gradient)
    new_m = _s(momentum, mom) * mom \
        - _s((1.0 - momentum) * wd, weight) * weight \
        - _s(1.0 - momentum, g) * g
    return _s(1.0 - lr * wd_lh, weight) * weight \
        + _s(lr, new_m) * torch.sign(new_m), new_m


@register("adamw_update",
          input_names=("weight", "grad", "mean", "var"), num_outputs=3)
def adamw_update(weight, grad, mean, var, rescale_grad=1.0, lr=None,
                 eta=None, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 clip_gradient=-1.0):
    """Decoupled weight decay Adam (ref: contrib/adamw.cc _adamw_update;
    ``rescale_grad`` a scalar or a one-element tensor) -> (new_w,
    new_mean, new_var)."""
    g = _clip(grad * _rescale(rescale_grad, grad), clip_gradient)
    new_m = _s(beta1, mean) * mean + _s(1.0 - beta1, g) * g
    new_v = _s(beta2, var) * var + _s(1.0 - beta2, g) * g * g
    new_w = weight - _s(eta, weight) * (
        _s(lr, new_m) * new_m / (_sqrt(new_v) + _s(epsilon, new_v))
        + _s(wd, weight) * weight)
    return new_w, new_m, new_v


def _rescale(r, ref):
    if isinstance(r, torch.Tensor):
        return r.to(ref.dtype)
    return _s(r, ref)


@register("mp_adamw_update",
          input_names=("weight", "grad", "mean", "var", "weight32"),
          num_outputs=4)
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad=1.0,
                    lr=None, eta=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
                    wd=0.0, clip_gradient=-1.0):
    """ref: contrib/adamw.cc _mp_adamw_update -> (new_w, new_mean,
    new_var, new_w32)."""
    g32 = grad.to(torch.float32)
    g = _clip(g32 * _rescale(rescale_grad, g32), clip_gradient)
    new_m = beta1 * mean + (1.0 - beta1) * g
    new_v = beta2 * var + (1.0 - beta2) * g * g
    new_w32 = weight32 - eta * (lr * new_m / (_sqrt(new_v) + epsilon)
                                + wd * weight32)
    return new_w32.to(weight.dtype), new_m, new_v, new_w32


@register("lamb_update_phase1",
          input_names=("weight", "grad", "mean", "var"), num_outputs=3)
def lamb_update_phase1(weight, grad, mean, var, lr=None, beta1=0.9,
                       beta2=0.999, epsilon=1e-6, t=1,
                       bias_correction=True, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """ref: optimizer_op.cc lamb_update_phase1 -> (g_out, new_mean,
    new_var)."""
    g = _clip(_s(rescale_grad, grad) * grad, clip_gradient)
    new_m = _s(beta1, mean) * mean + _s(1.0 - beta1, g) * g
    new_v = _s(beta2, var) * var + _s(1.0 - beta2, g) * g * g
    mh, vh = new_m, new_v
    if bias_correction:
        t = float(t)
        mh = new_m / _s(1.0 - beta1 ** t, new_m)
        vh = new_v / _s(1.0 - beta2 ** t, new_v)
    return mh / (_sqrt(vh) + _s(epsilon, vh)) + _s(wd, weight) * weight, \
        new_m, new_v


@register("lamb_update_phase2", input_names=("weight", "g", "r1", "r2"))
def lamb_update_phase2(weight, g, r1, r2, lr=None, lower_bound=-1.0,
                       upper_bound=-1.0):
    """ref: optimizer_op.cc lamb_update_phase2."""
    r1v, r2v = r1, r2
    if lower_bound is not None and lower_bound >= 0:
        r1v = torch.clamp_min(r1v, lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1v = torch.clamp_max(r1v, upper_bound)
    ratio = torch.where((r1v > 0) & (r2v > 0), r1v / r2v,
                        torch.ones_like(r1v))
    return weight - _s(lr, weight) * ratio * g


@register("sparse_adagrad_update", aliases=("group_adagrad_update",),
          input_names=("weight", "grad", "history"), num_outputs=2)
def sparse_adagrad_update(weight, grad, history, lr=None, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad with accumulated history (ref: optimizer_op.cc
    _sparse_adagrad_update, dense; contrib group_adagrad shares it)
    -> (new_w, new_history)."""
    g = _clip(_s(rescale_grad, grad) * grad, clip_gradient)
    new_h = history + g * g
    new_w = weight - _s(lr, weight) * (
        g / (_sqrt(new_h) + _s(epsilon, new_h)) + _s(wd, weight) * weight)
    return new_w, new_h


@register("multi_lars",
          input_names=("lrs", "weights_sum_sq", "grads_sum_sq", "wds"))
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-8, rescale_grad=1.0):
    """LARS trust-ratio learning rates (ref: contrib/multi_lars.cc)."""
    wn = _sqrt(weights_sum_sq)
    gn = _sqrt(grads_sum_sq) * rescale_grad
    ratio = torch.where((wn > 0) & (gn > 0),
                        eta * wn / (gn + wds * wn + eps), torch.ones_like(wn))
    return lrs * ratio


def _norm_list(v, n):
    if isinstance(v, (tuple, list)):
        return list(v)
    return [v] * n


def _multi_pure(single, n_per, n_states, data, num_weights, lrs, wds,
                kwargs):
    """A single update over interleaved groups of ``n_per`` tensors: all
    new weights, then all new state tensors group by group."""
    num_weights = int(num_weights)
    lrs = _norm_list(lrs, num_weights)
    wds = _norm_list(wds, num_weights)
    new_ws, new_states = [], []
    for i in range(num_weights):
        group = data[i * n_per:(i + 1) * n_per]
        res = single(*group, lr=lrs[i], wd=wds[i], **kwargs)
        if n_states:
            new_ws.append(res[0])
            new_states.extend(res[1:])
        else:
            new_ws.append(res)
    return tuple(new_ws) + tuple(new_states)


def _multi_nout(states_per_weight):
    """A multi-tensor op's output count in a graph: each weight and its
    states."""
    def count(attrs):
        return int(attrs.get("num_weights", 1)) * (1 + states_per_weight)
    return count


@register("multi_sgd_update", num_outputs=_multi_nout(0))
def multi_sgd_update(*data, lrs=None, wds=None, num_weights=1,
                     rescale_grad=1.0, clip_gradient=-1.0):
    """ref: optimizer_op.cc multi_sgd_update: (w, g) x N -> new weights."""
    return _multi_pure(sgd_update, 2, 0, data, num_weights, lrs, wds,
                       dict(rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient))


@register("multi_sgd_mom_update", num_outputs=_multi_nout(1))
def multi_sgd_mom_update(*data, lrs=None, wds=None, num_weights=1,
                         momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0):
    """ref: optimizer_op.cc multi_sgd_mom_update: (w, g, mom) x N ->
    (new_w x N, new_mom x N)."""
    return _multi_pure(sgd_mom_update, 3, 1, data, num_weights, lrs, wds,
                       dict(momentum=momentum, rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient))


@register("multi_mp_sgd_update", num_outputs=_multi_nout(1))
def multi_mp_sgd_update(*data, lrs=None, wds=None, num_weights=1,
                        rescale_grad=1.0, clip_gradient=-1.0):
    """ref: optimizer_op.cc multi_mp_sgd_update: (w, g, w32) x N ->
    (new_w x N, new_w32 x N)."""
    return _multi_pure(mp_sgd_update, 3, 1, data, num_weights, lrs, wds,
                       dict(rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient))


@register("multi_mp_sgd_mom_update", num_outputs=_multi_nout(2))
def multi_mp_sgd_mom_update(*data, lrs=None, wds=None, num_weights=1,
                            momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0):
    """ref: optimizer_op.cc multi_mp_sgd_mom_update: (w, g, mom, w32) x N
    -> (new_w x N, (new_mom, new_w32) x N)."""
    return _multi_pure(mp_sgd_mom_update, 4, 2, data, num_weights, lrs,
                       wds, dict(momentum=momentum,
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient))


def _preloaded_pure(multi, data, num_weights, kwargs):
    # the trailing two tensors are the preloaded lrs and wds vectors
    lrs, wds = data[-2], data[-1]
    num_weights = int(num_weights)
    return multi(*data[:-2], lrs=[float(lrs[i]) for i in range(num_weights)],
                 wds=[float(wds[i]) for i in range(num_weights)],
                 num_weights=num_weights, **kwargs)


@register("preloaded_multi_sgd_update", num_outputs=_multi_nout(0))
def preloaded_multi_sgd_update(*data, num_weights=1, rescale_grad=1.0,
                               clip_gradient=-1.0):
    """ref: optimizer_op.cc preloaded_multi_sgd_update."""
    return _preloaded_pure(multi_sgd_update, data, num_weights,
                           dict(rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient))


@register("preloaded_multi_sgd_mom_update", num_outputs=_multi_nout(1))
def preloaded_multi_sgd_mom_update(*data, num_weights=1, momentum=0.0,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    """ref: optimizer_op.cc preloaded_multi_sgd_mom_update."""
    return _preloaded_pure(multi_sgd_mom_update, data, num_weights,
                           dict(momentum=momentum,
                                rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient))


@register("preloaded_multi_mp_sgd_update", num_outputs=_multi_nout(1))
def preloaded_multi_mp_sgd_update(*data, num_weights=1, rescale_grad=1.0,
                                  clip_gradient=-1.0):
    """ref: optimizer_op.cc preloaded_multi_mp_sgd_update."""
    return _preloaded_pure(multi_mp_sgd_update, data, num_weights,
                           dict(rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient))


@register("preloaded_multi_mp_sgd_mom_update", num_outputs=_multi_nout(2))
def preloaded_multi_mp_sgd_mom_update(*data, num_weights=1, momentum=0.0,
                                      rescale_grad=1.0,
                                      clip_gradient=-1.0):
    """ref: optimizer_op.cc preloaded_multi_mp_sgd_mom_update."""
    return _preloaded_pure(multi_mp_sgd_mom_update, data, num_weights,
                           dict(momentum=momentum,
                                rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient))
