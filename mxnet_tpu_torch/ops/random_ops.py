"""Random sampling ops (counterpart of mxnet_tpu/ops/random_ops.py).

Each op draws from the port's generator of the device it runs on
(``random.generator(device)``): the ``random_*`` ops on ``ctx`` (default:
the current context, the card), the ``sample_*`` ops, ``shuffle`` and
``bernoulli`` on their input's device. ``key`` may name a
``torch.Generator`` on that device to draw from instead; torch's global RNG
is never used. The JAX package draws through threefry keys, so the streams
differ from its by design; the shapes, dtypes, the broadcasting of the
``sample_*`` parameters and the law of each draw are its.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import canonical_dtype
from ..context import as_device
from .registry import register

__all__ = ["random_uniform", "random_normal", "random_gamma",
           "random_exponential", "random_poisson",
           "random_negative_binomial",
           "random_generalized_negative_binomial", "random_randint",
           "sample_uniform", "sample_normal", "sample_gamma",
           "sample_multinomial", "shuffle", "bernoulli"]


def _dt(dtype):
    return canonical_dtype(dtype if dtype and dtype != "None" else None)


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _gen(key, device):
    return key if key is not None else _random.generator(device)


def _float(dt):
    """The dtype to draw a float law in: ``dt`` when it is a float type
    torch samples in, else float32."""
    return dt if dt.is_floating_point else torch.float32


def _std_gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one per entry of the float32 ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


@register("random_uniform", aliases=("uniform", "_random_uniform"))
def random_uniform(key=None, low=0.0, high=1.0, shape=(), dtype="float32",
                   ctx=None):
    dev = as_device(ctx)
    dt = _dt(dtype)
    u = torch.rand(_shape(shape), generator=_gen(key, dev), device=dev,
                   dtype=_float(dt))
    return (low + u * (high - low)).to(dt)


@register("random_normal", aliases=("normal", "_random_normal", "randn"))
def random_normal(key=None, loc=0.0, scale=1.0, shape=(), dtype="float32",
                  ctx=None):
    dev = as_device(ctx)
    dt = _dt(dtype)
    z = torch.randn(_shape(shape), generator=_gen(key, dev), device=dev,
                    dtype=_float(dt))
    return (loc + scale * z).to(dt)


@register("random_gamma", aliases=("_random_gamma",))
def random_gamma(key=None, alpha=1.0, beta=1.0, shape=(), dtype="float32",
                 ctx=None):
    dev = as_device(ctx)
    a = torch.full(_shape(shape), float(alpha), device=dev)
    return (_std_gamma(a, _gen(key, dev)) * beta).to(_dt(dtype))


@register("random_exponential", aliases=("_random_exponential",))
def random_exponential(key=None, lam=1.0, shape=(), dtype="float32",
                       ctx=None):
    dev = as_device(ctx)
    e = torch.empty(_shape(shape), device=dev).exponential_(
        1.0, generator=_gen(key, dev))
    return (e / lam).to(_dt(dtype))


@register("random_poisson", aliases=("_random_poisson",))
def random_poisson(key=None, lam=1.0, shape=(), dtype="float32", ctx=None):
    dev = as_device(ctx)
    rate = torch.full(_shape(shape), float(lam), device=dev)
    return torch.poisson(rate, generator=_gen(key, dev)).to(_dt(dtype))


@register("random_negative_binomial",
          aliases=("_random_negative_binomial",))
def random_negative_binomial(key=None, k=1, p=1.0, shape=(), dtype="float32",
                             ctx=None):
    """NB(k, p) as Poisson(Gamma(k, (1 - p) / p)), the JAX package's
    form."""
    dev = as_device(ctx)
    gen = _gen(key, dev)
    a = torch.full(_shape(shape), float(k), device=dev)
    lam = _std_gamma(a, gen) * ((1 - p) / p)
    return torch.poisson(lam, generator=gen).to(_dt(dtype))


@register("random_generalized_negative_binomial",
          aliases=("_random_generalized_negative_binomial",))
def random_generalized_negative_binomial(key=None, mu=1.0, alpha=1.0,
                                         shape=(), dtype="float32",
                                         ctx=None):
    dev = as_device(ctx)
    gen = _gen(key, dev)
    shp = _shape(shape)
    if alpha <= 0:
        return torch.poisson(torch.full(shp, float(mu), device=dev),
                             generator=gen).to(_dt(dtype))
    a = torch.full(shp, 1.0 / alpha, device=dev)
    lam = _std_gamma(a, gen) * (mu * alpha)
    return torch.poisson(lam, generator=gen).to(_dt(dtype))


@register("random_randint", aliases=("randint", "_random_randint"))
def random_randint(key=None, low=0, high=1, shape=(), dtype="int32",
                   ctx=None):
    dev = as_device(ctx)
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_gen(key, dev), device=dev,
                         dtype=_dt(dtype))


def _params_shape(p, shape):
    """The draw's shape (the parameters' shape, then ``shape``) and the
    index that broadcasts a parameter over the trailing ``shape``."""
    shp = tuple(p.shape) + _shape(shape)
    return shp, (Ellipsis,) + (None,) * (len(shp) - p.dim())


@register("sample_uniform")
def sample_uniform(low, high, key=None, shape=(), dtype="float32"):
    shp, ex = _params_shape(low, shape)
    dt = _dt(dtype)
    u = torch.rand(shp, generator=_gen(key, low.device), device=low.device,
                   dtype=_float(dt))
    return (low[ex] + u * (high - low)[ex]).to(dt)


@register("sample_normal")
def sample_normal(mu, sigma, key=None, shape=(), dtype="float32"):
    shp, ex = _params_shape(mu, shape)
    dt = _dt(dtype)
    z = torch.randn(shp, generator=_gen(key, mu.device), device=mu.device,
                    dtype=_float(dt))
    return (mu[ex] + z * sigma[ex]).to(dt)


@register("sample_gamma")
def sample_gamma(alpha, beta, key=None, shape=(), dtype="float32"):
    shp, ex = _params_shape(alpha, shape)
    a = torch.broadcast_to(alpha[ex].float(), shp).contiguous()
    g = _std_gamma(a, _gen(key, alpha.device))
    return (g * beta[ex]).to(_dt(dtype))


@register("sample_multinomial", aliases=("multinomial",
                                         "_sample_multinomial"))
def sample_multinomial(data, key=None, shape=(), get_prob=False,
                       dtype="int32"):
    """``shape`` draws (one if empty) from each distribution over the last
    axis of ``data``; with ``get_prob`` also each draw's log-probability
    under the normalized ``data``."""
    shp = _shape(shape)
    nsamp = math.prod(shp) if shp else 1
    k = data.shape[-1]
    probs = torch.clamp(data.float(), min=1e-37).reshape(-1, k)
    draws = torch.multinomial(probs, nsamp, replacement=True,
                              generator=_gen(key, data.device))
    out_shape = tuple(data.shape[:-1]) + shp
    samples = draws.reshape(out_shape).to(_dt(dtype))
    if get_prob:
        logp = torch.log_softmax(torch.log(probs), dim=-1)
        lp = torch.gather(logp, 1, draws).reshape(out_shape)
        return samples, lp
    return samples


@register("shuffle", aliases=("_shuffle",))
def shuffle(data, key=None):
    """``data`` with its first axis permuted."""
    perm = torch.randperm(data.shape[0], generator=_gen(key, data.device),
                          device=data.device)
    return data[perm]


@register("bernoulli")
def bernoulli(p, key=None, dtype="float32"):
    """One Bernoulli(p) draw per entry of ``p``."""
    pf = p.float() if torch.is_tensor(p) \
        else torch.tensor(float(p), device=as_device(None))
    return torch.bernoulli(pf, generator=_gen(key, pf.device)) \
        .to(_dt(dtype))
