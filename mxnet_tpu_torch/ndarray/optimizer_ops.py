"""Optimizer update ops with the reference's in-place calling convention
(counterpart of mxnet_tpu/ndarray/optimizer_ops.py): ``nd.sgd_update(w,
g, lr=..., out=w)`` and the rest.

Each wrapper runs the pure registry form (``ops/optimizer_ops.py``), then
writes the new state tensors (momentum, mean and var, n, z, ...) into the
state tensors it was given, in place and in their own dtype, and returns
the new weight, written into ``out`` where one is given. The ``mp_*``
forms write the new weight into ``weight`` itself when no ``out`` is
given, as the JAX package's do. Each takes tensors or NDArrays (then
its result is an NDArray: ``out``, or the weight it wrote); the writes
happen outside the autograd graph.
"""
from __future__ import annotations

import torch

from ..ops import optimizer_ops as _pure
from .ndarray import nd_io

__all__ = [
    "sgd_update", "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
    "nag_mom_update", "mp_nag_mom_update", "adam_update", "rmsprop_update",
    "rmspropalex_update", "ftrl_update", "ftml_update", "signsgd_update",
    "signum_update", "adamw_update", "mp_adamw_update",
    "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
    "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
    "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
    "preloaded_multi_mp_sgd_mom_update", "multi_lars",
    "sparse_adagrad_update", "group_adagrad_update", "lamb_update_phase1",
    "lamb_update_phase2",
]


def _assign(dst, src):
    """dst <- src in dst's dtype, in place."""
    with torch.no_grad():
        dst.copy_(src)
    return dst


def _deliver(out, new_w):
    return new_w if out is None else _assign(out, new_w)


def _writeback(states, new_vals):
    for st, new in zip(states, new_vals):
        _assign(st, new)


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, out=None, **kw):
    new_w = _pure.sgd_update(weight, grad, lr=lr, wd=wd,
                             rescale_grad=rescale_grad,
                             clip_gradient=clip_gradient)
    return _deliver(out, new_w)


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   out=None, **kw):
    new_w, new_m = _pure.sgd_mom_update(
        weight, grad, mom, lr=lr, momentum=momentum, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    _writeback([mom], [new_m])
    return _deliver(out, new_w)


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True, out=None, **kw):
    new_w, new_w32 = _pure.mp_sgd_update(
        weight, grad, weight32, lr=lr, wd=wd, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient)
    _assign(weight32, new_w32)
    return _deliver(out if out is not None else weight, new_w)


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True, out=None, **kw):
    new_w, new_m, new_w32 = _pure.mp_sgd_mom_update(
        weight, grad, mom, weight32, lr=lr, momentum=momentum, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    _writeback([mom, weight32], [new_m, new_w32])
    return _deliver(out if out is not None else weight, new_w)


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None, **kw):
    new_w, new_m = _pure.nag_mom_update(
        weight, grad, mom, lr=lr, momentum=momentum, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    _writeback([mom], [new_m])
    return _deliver(out, new_w)


def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      out=None, **kw):
    new_w, new_m, new_w32 = _pure.mp_nag_mom_update(
        weight, grad, mom, weight32, lr=lr, momentum=momentum, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    _writeback([mom, weight32], [new_m, new_w32])
    return _deliver(out if out is not None else weight, new_w)


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, out=None, **kw):
    new_w, new_m, new_v = _pure.adam_update(
        weight, grad, mean, var, lr=lr, beta1=beta1, beta2=beta2,
        epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient)
    _writeback([mean, var], [new_m, new_v])
    return _deliver(out, new_w)


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0,
                   out=None, **kw):
    new_w, new_n = _pure.rmsprop_update(
        weight, grad, n, lr=lr, gamma1=gamma1, epsilon=epsilon, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient,
        clip_weights=clip_weights)
    _writeback([n], [new_n])
    return _deliver(out, new_w)


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, out=None,
                       **kw):
    new_w, new_n, new_g, new_d = _pure.rmspropalex_update(
        weight, grad, n, g, delta, lr=lr, gamma1=gamma1, gamma2=gamma2,
        epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient, clip_weights=clip_weights)
    _writeback([n, g, delta], [new_n, new_g, new_d])
    return _deliver(out, new_w)


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, out=None, **kw):
    new_w, new_z, new_n = _pure.ftrl_update(
        weight, grad, z, n, lr=lr, lamda1=lamda1, beta=beta, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    _writeback([z, n], [new_z, new_n])
    return _deliver(out, new_w)


def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                out=None, **kw):
    new_w, new_d, new_v, new_z = _pure.ftml_update(
        weight, grad, d, v, z, lr=lr, t=t, beta1=beta1, beta2=beta2,
        epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
        clip_grad=clip_grad)
    _writeback([d, v, z], [new_d, new_v, new_z])
    return _deliver(out, new_w)


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None, **kw):
    new_w = _pure.signsgd_update(weight, grad, lr=lr, wd=wd,
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
    return _deliver(out, new_w)


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0,
                  out=None, **kw):
    new_w, new_m = _pure.signum_update(
        weight, grad, mom, lr=lr, momentum=momentum, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient, wd_lh=wd_lh)
    _writeback([mom], [new_m])
    return _deliver(out, new_w)


def adamw_update(weight, grad, mean, var, rescale_grad, lr, eta,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 clip_gradient=-1.0, out=None, **kw):
    """``rescale_grad`` is a tensor input in the reference (adamw.cc); a
    scalar or a tensor is taken."""
    new_w, new_m, new_v = _pure.adamw_update(
        weight, grad, mean, var, rescale_grad=rescale_grad, lr=lr, eta=eta,
        beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
        clip_gradient=clip_gradient)
    _writeback([mean, var], [new_m, new_v])
    return _deliver(out, new_w)


def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad, lr,
                    eta, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    clip_gradient=-1.0, out=None, **kw):
    new_w, new_m, new_v, new_w32 = _pure.mp_adamw_update(
        weight, grad, mean, var, weight32, rescale_grad=rescale_grad,
        lr=lr, eta=eta, beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
        clip_gradient=clip_gradient)
    _writeback([mean, var, weight32], [new_m, new_v, new_w32])
    return _deliver(out if out is not None else weight, new_w)


def lamb_update_phase1(weight, grad, mean, var, lr=None, beta1=0.9,
                       beta2=0.999, epsilon=1e-6, t=1, bias_correction=True,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       out=None, **kw):
    g_out, new_m, new_v = _pure.lamb_update_phase1(
        weight, grad, mean, var, lr=lr, beta1=beta1, beta2=beta2,
        epsilon=epsilon, t=t, bias_correction=bias_correction, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    _writeback([mean, var], [new_m, new_v])
    return _deliver(out, g_out)


def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0, out=None, **kw):
    new_w = _pure.lamb_update_phase2(weight, g, r1, r2, lr=lr,
                                     lower_bound=lower_bound,
                                     upper_bound=upper_bound)
    return _deliver(out, new_w)


def sparse_adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0, out=None,
                          **kw):
    """The row-sparse update on a dense gradient (ref: optimizer_op.cc
    _sparse_adagrad_update)."""
    new_w, new_h = _pure.sparse_adagrad_update(
        weight, grad, history, lr=lr, epsilon=epsilon, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    _writeback([history], [new_h])
    return _deliver(out, new_w)


group_adagrad_update = sparse_adagrad_update  # ref: contrib/optimizer_op.cc


def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-8, rescale_grad=1.0, out=None, **kw):
    new_lrs = _pure.multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds,
                               eta=eta, eps=eps, rescale_grad=rescale_grad)
    return _deliver(out, new_lrs)


# -- multi-tensor variants ---------------------------------------------------

def _multi(update_fn, n_per, data, kwargs, num_weights, lrs, wds):
    """``update_fn`` (a wrapper above: states written in place) over
    interleaved groups of ``n_per`` tensors; the new weights."""
    lrs = [float(x) for x in (lrs if isinstance(lrs, (tuple, list))
                              else [lrs] * num_weights)]
    wds = [float(x) for x in (wds if isinstance(wds, (tuple, list))
                              else [wds] * num_weights)]
    return tuple(update_fn(*data[i * n_per:(i + 1) * n_per], lr=lrs[i],
                           wd=wds[i], **kwargs)
                 for i in range(num_weights))


def _deliver_multi(out, res):
    if out is None:
        return res
    outs = out if isinstance(out, (tuple, list)) else [out]
    for o, r in zip(outs, res):
        if o is not None and o is not r:
            _assign(o, r)
    return tuple(outs) if len(outs) > 1 else outs[0]


def multi_sgd_update(*data, lrs=None, wds=None, num_weights=1,
                     rescale_grad=1.0, clip_gradient=-1.0, out=None, **kw):
    """(weight, grad) x num_weights, interleaved."""
    res = _multi(sgd_update, 2, data,
                 dict(rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient),
                 int(num_weights), lrs, wds)
    return _deliver_multi(out, res)


def multi_sgd_mom_update(*data, lrs=None, wds=None, num_weights=1,
                         momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, out=None, **kw):
    """(weight, grad, mom) x num_weights."""
    res = _multi(sgd_mom_update, 3, data,
                 dict(momentum=momentum, rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient),
                 int(num_weights), lrs, wds)
    return _deliver_multi(out, res)


def multi_mp_sgd_update(*data, lrs=None, wds=None, num_weights=1,
                        rescale_grad=1.0, clip_gradient=-1.0, out=None,
                        **kw):
    """(weight, grad, weight32) x num_weights."""
    res = _multi(mp_sgd_update, 3, data,
                 dict(rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient),
                 int(num_weights), lrs, wds)
    return _deliver_multi(out, res)


def multi_mp_sgd_mom_update(*data, lrs=None, wds=None, num_weights=1,
                            momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0, out=None, **kw):
    """(weight, grad, mom, weight32) x num_weights."""
    res = _multi(mp_sgd_mom_update, 4, data,
                 dict(momentum=momentum, rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient),
                 int(num_weights), lrs, wds)
    return _deliver_multi(out, res)


def _preloaded(update_multi, data, num_weights, kwargs, out):
    # the trailing two tensors are the preloaded lrs and wds vectors
    lrs = data[-2].detach().cpu().tolist()
    wds = data[-1].detach().cpu().tolist()
    return update_multi(*data[:-2], lrs=lrs, wds=wds,
                        num_weights=num_weights, out=out, **kwargs)


def preloaded_multi_sgd_update(*data, num_weights=1, rescale_grad=1.0,
                               clip_gradient=-1.0, out=None, **kw):
    return _preloaded(multi_sgd_update, data, int(num_weights),
                      dict(rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient), out)


def preloaded_multi_sgd_mom_update(*data, num_weights=1, momentum=0.0,
                                   rescale_grad=1.0, clip_gradient=-1.0,
                                   out=None, **kw):
    return _preloaded(multi_sgd_mom_update, data, int(num_weights),
                      dict(momentum=momentum, rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient), out)


def preloaded_multi_mp_sgd_update(*data, num_weights=1, rescale_grad=1.0,
                                  clip_gradient=-1.0, out=None, **kw):
    return _preloaded(multi_mp_sgd_update, data, int(num_weights),
                      dict(rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient), out)


def preloaded_multi_mp_sgd_mom_update(*data, num_weights=1, momentum=0.0,
                                      rescale_grad=1.0, clip_gradient=-1.0,
                                      out=None, **kw):
    return _preloaded(multi_mp_sgd_mom_update, data, int(num_weights),
                      dict(momentum=momentum, rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient), out)



for _name in __all__:
    globals()[_name] = nd_io(globals()[_name])
