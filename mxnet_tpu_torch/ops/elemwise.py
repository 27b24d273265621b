"""Elementwise ops on torch tensors (counterpart of
mxnet_tpu/ops/elemwise.py): binary arithmetic with numpy broadcasting,
comparisons and logical ops, unary math, ``add_n``, ``clip`` and the
activation-like ops, and the ``_*_scalar`` forms. Every name and alias
the JAX module registers is registered here.

Types follow JAX's promotion with 64-bit types off. A Python scalar on
either side is weakly typed: it takes the tensor's dtype where that can
hold it (a bf16 tensor and 0.1 give bf16, with 0.1 rounded to bf16 first,
``base.weak_scalar``), an integer tensor and a float scalar give float32.
Comparisons return 1.0/0.0 in the operands' dtype (float32 for bool), as
the reference does.
"""
from __future__ import annotations

import torch

from ..base import weak_scalar
from .registry import VARIADIC, register

__all__ = ["add_n", "reciprocal", "rsqrt", "rcbrt", "sigmoid",
           "hard_sigmoid", "relu", "softsign", "softrelu", "clip",
           "smooth_l1"]


def _scalar_dtype(t, s):
    """The dtype of tensor ``t`` combined with Python scalar ``s`` (JAX's
    weak typing, int64 and float64 narrowed)."""
    dt = torch.result_type(t, s)
    if dt == torch.int64 and t.dtype != torch.int64:
        return torch.int32
    if dt == torch.float64 and t.dtype != torch.float64:
        return torch.float32
    return dt


def _w(v, x):
    """Python scalar ``v`` as an operand of an op on tensor ``x`` (rounded
    to a half-precision dtype first, ``base.weak_scalar``)."""
    return weak_scalar(v, x.dtype)


def _operands(a, b):
    """``a`` and ``b`` as tensors of JAX's result dtype where one of them
    is a Python scalar; two tensors are left to torch, whose promotion
    agrees with JAX's on the dtypes the port holds."""
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if ta and tb:
        return a, b
    if not (ta or tb):
        return torch.as_tensor(a), torch.as_tensor(b)
    t, s = (a, b) if ta else (b, a)
    dt = _scalar_dtype(t, s)
    t = t if t.dtype == dt else t.to(dt)
    st = torch.tensor(weak_scalar(s, dt), dtype=dt, device=t.device)
    return (t, st) if ta else (st, t)


def _binary(fn):
    def op(lhs, rhs):
        a, b = _operands(lhs, rhs)
        return fn(a, b)
    op.__name__ = getattr(fn, "__name__", "op")
    return op


def _mod(a, b):
    # jnp.mod takes the divisor's sign: torch.remainder, not fmod
    return torch.remainder(a, b)


def _power(a, b):
    return torch.pow(a, b)


_BINARY = {
    "add": torch.add,
    "subtract": torch.sub,
    "multiply": torch.mul,
    "divide": torch.true_divide,
    "mod": _mod,
    "power": _power,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
    "arctan2": torch.atan2,
}

# The symbol front end's input names of these ops, as the JAX package
# reads them off jnp's functions: its ufuncs take *args (every positional
# Symbol an input); divide, power, mod, hypot and arctan2 name theirs x1
# and x2, which are no input names, so their nodes take no Symbol inputs.
_JNP_UFUNCS = ("add", "subtract", "multiply", "maximum", "minimum")

for _name, _fn in _BINARY.items():
    register(_name, input_names=VARIADIC if _name in _JNP_UFUNCS else (),
             aliases=("broadcast_" + _name,
                      *(("elemwise_" + _name,) if _name in
                        ("add", "subtract", "multiply", "divide") else ()),
                      *(("broadcast_sub", "elemwise_sub")
                        if _name == "subtract" else ()),
                      *(("broadcast_mul", "elemwise_mul")
                        if _name == "multiply" else ()),
                      *(("broadcast_div", "elemwise_div")
                        if _name == "divide" else ()),
                      *(("broadcast_pow", "_power")
                        if _name == "power" else ())))(_binary(_fn))


def _float_if_int(fn):
    """``fn`` on an integer or bool tensor computes in float32, as jnp
    promotes it (hypot, arctan2 and true division)."""
    def op(a, b):
        if not (a.is_floating_point() or b.is_floating_point()):
            a, b = a.float(), b.float()
        return fn(a, b)
    return op


for _name in ("hypot", "arctan2"):
    register(_name, aliases=("broadcast_" + _name,), input_names=())(
        _binary(_float_if_int(_BINARY[_name])))

_COMPARE = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}


def _mk_cmp(f):
    def _cmp(a, b):
        a, b = _operands(a, b)
        dt = torch.promote_types(a.dtype, b.dtype)
        return f(a, b).to(torch.float32 if dt == torch.bool else dt)
    return _cmp


for _name, _fn in _COMPARE.items():
    register(_name, aliases=("broadcast_" + _name,))(_mk_cmp(_fn))


# ---------------------------------------------------------------------------
# unary math
# ---------------------------------------------------------------------------

def _cbrt(x):
    if not x.is_floating_point():
        x = x.float()
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _logical_not(x):
    out = torch.logical_not(x)
    return out if x.dtype == torch.bool else out.to(x.dtype)


def _float_unary(fn):
    """``fn`` computes in float32 on an integer tensor (jnp promotes)."""
    def op(x):
        return fn(x if x.is_floating_point() else x.float())
    return op


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "rint": torch.round,          # half to even, as jnp.rint
    "round": torch.round,         # jnp.round rounds half to even too
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "cbrt": _cbrt,
    "negative": torch.neg,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": _float_unary(torch.rad2deg),
    "radians": _float_unary(torch.deg2rad),
    "erf": torch.erf,
    "erfinv": _float_unary(torch.erfinv),
    "gammaln": _float_unary(torch.lgamma),
    "logical_not": _logical_not,
}

# Input names where the op is a torch builtin (no signature to read): the
# JAX package's, read off jnp's functions (x; round's a; negative, a
# ufunc, variadic).
_UNARY_INPUTS = {"round": ("a",), "negative": VARIADIC}

for _name, _fn in _UNARY.items():
    # "gamma" is the JAX package's alias of gammaln, kept as it is
    register(_name, aliases=(("gamma",) if _name == "gammaln" else ()),
             input_names=_UNARY_INPUTS.get(_name, ("x",)))(_fn)


@register("add_n", aliases=("ElementWiseSum", "elemwise_sum"))
def add_n(*xs):
    """Variadic sum, left to right."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register("reciprocal")
def reciprocal(x):
    return 1.0 / x


@register("rsqrt")
def rsqrt(x):
    return torch.rsqrt(x)


@register("rcbrt")
def rcbrt(x):
    return 1.0 / _cbrt(x)


@register("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register("hard_sigmoid")
def hard_sigmoid(x, alpha=0.2, beta=0.5):
    return torch.clamp(_w(alpha, x) * x + _w(beta, x), 0.0, 1.0)


@register("relu")
def relu(x):
    return torch.relu(x)


@register("softsign")
def softsign(x):
    return x / (1.0 + torch.abs(x))


@register("softrelu")
def softrelu(x):
    """log(1 + exp(x)), stable: jax.nn.softplus's logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


@register("clip")
def clip(x, a_min=None, a_max=None):
    lo = None if a_min is None else _w(a_min, x)
    hi = None if a_max is None else _w(a_max, x)
    return torch.clamp(x, lo, hi)


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, _w(0.5 * s2, x) * x * x,
                       absx - _w(0.5 / s2, x))


# scalar forms (the reference's _plus_scalar and the rest)
def _scalar_op(fn):
    def op(x, scalar):
        a, b = _operands(x, scalar)
        return fn(a, b)
    return op


for _sname, _sfn, _dflt in (
        ("_plus_scalar", torch.add, 0.0),
        ("_minus_scalar", torch.sub, 0.0),
        ("_rminus_scalar", lambda a, b: b - a, 0.0),
        ("_mul_scalar", torch.mul, 1.0),
        ("_div_scalar", torch.true_divide, 1.0),
        ("_rdiv_scalar", lambda a, b: b / a, 1.0),
        ("_power_scalar", torch.pow, 1.0),
        ("_rpower_scalar", lambda a, b: torch.pow(b, a), 1.0),
        ("_mod_scalar", torch.remainder, 1.0),
        ("_maximum_scalar", torch.maximum, 0.0),
        ("_minimum_scalar", torch.minimum, 0.0)):
    def _mk_scalar(f, default):
        g = _scalar_op(f)

        def op(x, scalar=default):
            return g(x, scalar)
        return op
    register(_sname)(_mk_scalar(_sfn, _dflt))


# scalar comparisons: 1.0/0.0 in the input's dtype (float32 for bool)
for _cname, _cfn in (("_equal_scalar", torch.eq),
                     ("_not_equal_scalar", torch.ne),
                     ("_greater_scalar", torch.gt),
                     ("_greater_equal_scalar", torch.ge),
                     ("_lesser_scalar", torch.lt),
                     ("_lesser_equal_scalar", torch.le)):
    def _mk_cmp_scalar(f):
        def _cmp(x, scalar=0.0):
            dt = torch.float32 if x.dtype == torch.bool else x.dtype
            a, b = _operands(x, scalar)
            return f(a, b).to(dt)
        return _cmp
    register(_cname)(_mk_cmp_scalar(_cfn))
