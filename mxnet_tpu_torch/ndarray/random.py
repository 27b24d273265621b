"""``mx.nd.random`` (counterpart of mxnet_tpu/ndarray/random.py): the random
ops of ``ops/random_ops.py`` behind the NDArray boundary. Each draw lands on
``ctx`` (default: the current context, the card), or on the device of the
NDArray parameters of a ``sample_*`` form, and comes back as an NDArray."""
from __future__ import annotations

from ..context import current_context
from .ndarray import NDArray, wrap as _wrap
from .register import invoke_by_name as _inv, _deliver

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "randint", "shuffle"]


def _draw(name, ctx, out, **kw):
    """The op ``name`` drawn on ``ctx`` as an NDArray (into ``out``)."""
    ctx = ctx if ctx is not None else current_context()
    res = _wrap(_inv(name, ctx=ctx, **kw), ctx=ctx)
    return res if out is None else _deliver(out, res, name)


def _sample(name, out, *params, **kw):
    res = _inv(name, *params, **kw)
    return res if out is None else _deliver(out, res, name)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    if isinstance(low, NDArray):
        return _sample("sample_uniform", out, low, high, shape=shape,
                       dtype=dtype)
    return _draw("random_uniform", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    if isinstance(loc, NDArray):
        return _sample("sample_normal", out, loc, scale, shape=shape,
                       dtype=dtype)
    return _draw("random_normal", ctx, out, loc=loc, scale=scale,
                 shape=shape, dtype=dtype)


def randn(*shape, **kwargs):
    return normal(shape=shape, **kwargs)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    if isinstance(alpha, NDArray):
        return _sample("sample_gamma", out, alpha, beta, shape=shape,
                       dtype=dtype)
    return _draw("random_gamma", ctx, out, alpha=alpha, beta=beta,
                 shape=shape, dtype=dtype)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("random_exponential", ctx, out, lam=1.0 / scale,
                 shape=shape, dtype=dtype)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    return _draw("random_poisson", ctx, out, lam=lam, shape=shape,
                 dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None):
    return _draw("random_negative_binomial", ctx, out, k=k, p=p,
                 shape=shape, dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None):
    return _draw("random_generalized_negative_binomial", ctx, out, mu=mu,
                 alpha=alpha, shape=shape, dtype=dtype)


def multinomial(data, shape=None, get_prob=False, dtype="int32", out=None,
                **kw):
    return _sample("sample_multinomial", out, data, shape=shape,
                   get_prob=get_prob, dtype=dtype)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    return _draw("random_randint", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def shuffle(data, out=None, **kw):
    return _sample("shuffle", out, data)
