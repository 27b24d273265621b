"""``mx.sym.random`` namespace (counterpart of mxnet_tpu/symbol/random.py; ref:
python/mxnet/symbol/random.py — generated there from the same registry as
nd.random; same here).

Scalar hyperparameters become node attrs (`_random_*` ops); Symbol
hyperparameters switch to the per-element `_sample_*` form, mirroring
the reference's dispatch."""
from __future__ import annotations

from .register import create_symbol_op
from .symbol import Symbol

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "randint", "shuffle"]


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _dist(scalar_op, sample_op, params, shape, dtype, name=None):
    """params: ordered (name, value) hyperparameters."""
    if any(isinstance(v, Symbol) for _, v in params):
        return create_symbol_op(sample_op, [v for _, v in params],
                                {"shape": _shape(shape), "dtype": dtype},
                                name=name)
    attrs = {k: v for k, v in params}
    attrs.update({"shape": _shape(shape), "dtype": dtype})
    return create_symbol_op(scalar_op, [], attrs, name=name)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", name=None, **kw):
    return _dist("random_uniform", "sample_uniform",
                 [("low", low), ("high", high)], shape, dtype, name)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", name=None, **kw):
    return _dist("random_normal", "sample_normal",
                 [("loc", loc), ("scale", scale)], shape, dtype, name)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", name=None, **kw):
    return normal(loc=loc, scale=scale, shape=shape or None, dtype=dtype,
                  name=name)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", name=None, **kw):
    return _dist("random_gamma", "sample_gamma",
                 [("alpha", alpha), ("beta", beta)], shape, dtype, name)


def exponential(scale=1.0, shape=None, dtype="float32", name=None, **kw):
    return _dist("random_exponential", "sample_exponential",
                 [("lam", 1.0 / scale if not isinstance(scale, Symbol)
                   else 1.0 / scale)], shape, dtype, name)


def poisson(lam=1.0, shape=None, dtype="float32", name=None, **kw):
    return _dist("random_poisson", "sample_poisson", [("lam", lam)],
                 shape, dtype, name)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", name=None,
                      **kw):
    return _dist("random_negative_binomial", "sample_negative_binomial",
                 [("k", k), ("p", p)], shape, dtype, name)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", name=None, **kw):
    return _dist("random_generalized_negative_binomial",
                 "sample_generalized_negative_binomial",
                 [("mu", mu), ("alpha", alpha)], shape, dtype, name)


def multinomial(data, shape=None, get_prob=False, dtype="int32", name=None,
                **kw):
    return create_symbol_op("sample_multinomial", [data],
                            {"shape": _shape(shape), "get_prob": get_prob,
                             "dtype": dtype}, name=name)


def randint(low, high, shape=None, dtype="int32", name=None, **kw):
    return _dist("random_randint", "random_randint",
                 [("low", low), ("high", high)], shape, dtype, name)


def shuffle(data, name=None, **kw):
    return create_symbol_op("shuffle", [data], {}, name=name)
