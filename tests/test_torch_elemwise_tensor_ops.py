"""Every op name that the JAX package's ``ops/elemwise.py`` and
``ops/tensor.py`` register, held against the port's op of that name on the
same numpy inputs.

The names come from running each JAX module's source with a ``register``
that records what it registers (name, aliases, ``no_grad``) and the
function it was given, so the reference is the module's own function even
where a later module re-registers the name, and a name the port lacks
fails here. Each case runs the port through ``mx.nd.<name>`` on NDArrays
(tensors for the ops without an input) and the JAX function on jnp
arrays, in float32 and, where the op takes float data, in bf16; for the
differentiable ops also the gradient against ``jax.vjp``, in float32.

Tolerances, each relative to the largest magnitude of the JAX result:
- elementwise math, float32: 1e-6 (a few ulps of two libms), ``ELEM_F32``;
  ``gammaln`` (and its alias ``gamma``) 4e-6, ``LOOSER``;
- reductions, float32: 1e-5 (summation order), ``REDUCE_F32``;
- shape, index, ordering and creation ops: bit for bit (0);
- bf16: 2**-7, one bf16 ulp (both compute in float32 and round), and two
  ulps for reductions, ``BF16``;
- gradients, float32: 1e-5, ``GRAD_F32``.
Dtypes must agree exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry as treg

ELEM_F32 = 1e-6
REDUCE_F32 = 1e-5
GRAD_F32 = 1e-5
BF16 = {"elem": 2.0 ** -7, "reduce": 2.0 ** -6, "exact": 0.0}
# float32 functions whose two implementations differ by more than ELEM_F32
# at the largest output: lgamma (2.05e-6 measured)
LOOSER = {"gammaln": 4e-6}


def _capture(modname):
    """[(name, aliases, no_grad, fn)] that module ``modname`` registers,
    in order, read by running its source with a recording ``register``
    (the JAX registry itself is left as it is)."""
    mod = importlib.import_module(modname)
    got = []

    def fake(name, no_grad=False, aliases=(), **_):
        def deco(fn):
            got.append((name, tuple(aliases), no_grad, fn))
            return fn
        return deco

    real = jreg.register
    jreg.register = fake
    try:
        with open(mod.__file__) as f:
            src = f.read()
        ns = {"__name__": modname + "._capture", "__file__": mod.__file__,
              "__package__": mod.__package__}
        exec(compile(src, mod.__file__, "exec"), ns)
    finally:
        jreg.register = real
    return got


def _names():
    out = []
    for short, modname in (("elemwise", "mxnet_tpu.ops.elemwise"),
                           ("tensor", "mxnet_tpu.ops.tensor")):
        for name, aliases, no_grad, fn in _capture(modname):
            for n in (name,) + aliases:
                out.append((short, n, name, no_grad, fn))
    # a later registration of a name replaces the earlier one, as in the
    # registry (tensor.py registers "_full" twice)
    last = {}
    for entry in out:
        last[(entry[0], entry[1])] = entry
    return list(last.values())


NAMES = _names()


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


# -- inputs --------------------------------------------------------------------

def U(rs, shape, lo=-2.0, hi=2.0):
    return rs.uniform(lo, hi, shape).astype("float32")


def I(rs, shape, hi=3):
    """Integer values held as float32 (ties for orderings and compares)."""
    return rs.randint(0, hi, shape).astype("float32")


def A(values):
    return np.asarray(values, dtype="float32")


class Spec:
    """Cases of one op: ``make(rs)`` gives [(args, kwargs)]; ``kind``
    picks the tolerance; ``idx`` names the args that are index data (never
    cast to bf16, never differentiated); ``bf16`` whether the op takes
    bf16 data; ``grad`` whether to hold the gradient (default: not
    ``no_grad``)."""

    def __init__(self, make, kind="elem", idx=(), bf16=True, grad=None):
        self.make, self.kind, self.idx = make, kind, tuple(idx)
        self.bf16, self.grad = bf16, grad


def _bin(lo=-2.0, hi=2.0, lo2=None, hi2=None):
    lo2 = lo if lo2 is None else lo2
    hi2 = hi if hi2 is None else hi2
    return Spec(lambda rs: [((U(rs, (3, 4), lo, hi), U(rs, (4,), lo2, hi2)),
                             {}),
                            ((U(rs, (2, 3), lo, hi), U(rs, (2, 3), lo2,
                                                       hi2)), {})])


def _cmp():
    return Spec(lambda rs: [((I(rs, (3, 4)), I(rs, (4,))), {}),
                            ((I(rs, (2, 5)), I(rs, (2, 5))), {})])


def _un(lo=-2.0, hi=2.0, **kw):
    return Spec(lambda rs: [((U(rs, (3, 5), lo, hi),), {})], **kw)


def _scal(lo=-2.0, hi=2.0, scalar=1.7):
    return Spec(lambda rs: [((U(rs, (3, 4), lo, hi),), {"scalar": scalar})])


def _red(**kw):
    def make(rs):
        x = U(rs, (2, 3, 4), 0.5, 1.5)
        return [((x,), {}), ((x,), {"axis": 1}),
                ((x,), {"axis": (0, 2), "keepdims": True}),
                ((x,), {"axis": 1, "exclude": True})]
    return Spec(make, kind="reduce", **kw)


def _seq(fn_kwargs):
    def make(rs):
        out = []
        for axis in fn_kwargs:
            shape = (4, 3, 2) if axis == 0 else (3, 4, 2)
            kw = {"use_sequence_length": True, "axis": axis}
            if axis == 0 and "value" in fn_kwargs[axis]:
                kw["value"] = -1.0
            out.append(((U(rs, shape), A([1, 4, 2])), kw))
        out.append(((U(rs, (4, 3, 2)),), {"use_sequence_length": False}))
        return out
    return Spec(make, kind="exact", idx=(1,))


SPECS = {
    # elemwise: binary
    "add": _bin(), "subtract": _bin(), "multiply": _bin(),
    "divide": _bin(lo2=0.5, hi2=2.0), "maximum": _bin(), "minimum": _bin(),
    "hypot": _bin(), "arctan2": _bin(),
    "power": _bin(0.5, 2.0, -1.5, 1.5),
    "mod": _bin(-5.0, 5.0, 0.6, 1.9),
    "equal": _cmp(), "not_equal": _cmp(), "greater": _cmp(),
    "greater_equal": _cmp(), "lesser": _cmp(), "lesser_equal": _cmp(),
    "logical_and": _cmp(), "logical_or": _cmp(), "logical_xor": _cmp(),
    # elemwise: unary
    "abs": _un(), "sign": _un(), "floor": _un(), "ceil": _un(),
    "trunc": _un(), "fix": _un(), "rint": _un(), "round": _un(),
    "exp": _un(), "expm1": _un(), "log": _un(0.1, 5.0),
    "log2": _un(0.1, 5.0), "log10": _un(0.1, 5.0), "log1p": _un(-0.5, 3.0),
    "sqrt": _un(0.1, 5.0), "square": _un(), "cbrt": _un(0.2, 3.0),
    "negative": _un(), "sin": _un(), "cos": _un(), "tan": _un(-1.2, 1.2),
    "arcsin": _un(-0.9, 0.9), "arccos": _un(-0.9, 0.9), "arctan": _un(),
    "sinh": _un(), "cosh": _un(), "tanh": _un(),
    "arcsinh": _un(), "arccosh": _un(1.1, 3.0), "arctanh": _un(-0.9, 0.9),
    "degrees": _un(), "radians": _un(), "erf": _un(),
    "erfinv": _un(-0.9, 0.9), "gammaln": _un(0.5, 3.0),
    "logical_not": Spec(lambda rs: [((I(rs, (3, 4)),), {})]),
    "add_n": Spec(lambda rs: [((U(rs, (3, 4)), U(rs, (3, 4)),
                                U(rs, (3, 4))), {})]),
    "reciprocal": _un(0.3, 3.0), "rsqrt": _un(0.3, 3.0),
    "rcbrt": _un(0.3, 3.0), "sigmoid": _un(), "hard_sigmoid": _un(-4, 4),
    "relu": _un(), "softsign": _un(), "softrelu": _un(-5, 5),
    "clip": Spec(lambda rs: [((U(rs, (3, 5)),),
                              {"a_min": -0.5, "a_max": 0.7})]),
    "smooth_l1": Spec(lambda rs: [((U(rs, (3, 5)),), {"scalar": 1.5})]),
    "_plus_scalar": _scal(), "_minus_scalar": _scal(),
    "_rminus_scalar": _scal(), "_mul_scalar": _scal(),
    "_div_scalar": _scal(), "_rdiv_scalar": _scal(0.3, 3.0),
    "_power_scalar": _scal(0.3, 3.0), "_rpower_scalar": _scal(),
    "_mod_scalar": _scal(-5.0, 5.0), "_maximum_scalar": _scal(scalar=0.3),
    "_minimum_scalar": _scal(scalar=0.3),
    "_equal_scalar": Spec(lambda rs: [((I(rs, (3, 4)),),
                                       {"scalar": 1.0})]),
    "_not_equal_scalar": Spec(lambda rs: [((I(rs, (3, 4)),),
                                           {"scalar": 1.0})]),
    "_greater_scalar": Spec(lambda rs: [((I(rs, (3, 4)),),
                                         {"scalar": 1.0})]),
    "_greater_equal_scalar": Spec(lambda rs: [((I(rs, (3, 4)),),
                                               {"scalar": 1.0})]),
    "_lesser_scalar": Spec(lambda rs: [((I(rs, (3, 4)),), {"scalar": 1.0})]),
    "_lesser_equal_scalar": Spec(lambda rs: [((I(rs, (3, 4)),),
                                              {"scalar": 1.0})]),
    # tensor: shapes
    "reshape": Spec(lambda rs: [((U(rs, (2, 3, 4)),), {"shape": s})
                                for s in ((0, -1), (-1, 4), (-2,),
                                          (-3, 4), (-4, 1, 2, 0, 4),
                                          (6, -1))]
                    + [((U(rs, (2, 3, 4)),), {"shape": (-1, 12),
                                              "reverse": True})],
                    kind="exact"),
    "flatten": Spec(lambda rs: [((U(rs, (2, 3, 4)),), {})], kind="exact"),
    "transpose": Spec(lambda rs: [((U(rs, (2, 3, 4)),), {"axes": (1, 0, 2)}),
                                  ((U(rs, (2, 3, 4)),), {})], kind="exact"),
    "swapaxes": Spec(lambda rs: [((U(rs, (2, 3, 4)),),
                                  {"dim1": 0, "dim2": 2})], kind="exact"),
    "expand_dims": Spec(lambda rs: [((U(rs, (2, 3)),), {"axis": 1}),
                                    ((U(rs, (2, 3)),), {"axis": -1})],
                        kind="exact"),
    "squeeze": Spec(lambda rs: [((U(rs, (2, 1, 3, 1)),), {}),
                                ((U(rs, (2, 1, 3, 1)),), {"axis": 1})],
                    kind="exact"),
    "broadcast_to": Spec(lambda rs: [((U(rs, (1, 3)),), {"shape": (4, 0)})],
                         kind="exact"),
    "broadcast_like": Spec(lambda rs: [((U(rs, (1, 3)), U(rs, (4, 3))), {}),
                                       ((U(rs, (1, 3)), U(rs, (5, 2))),
                                        {"lhs_axes": 0, "rhs_axes": 0})],
                           kind="exact", idx=(1,)),
    "broadcast_axis": Spec(lambda rs: [((U(rs, (1, 3, 1)),),
                                        {"axis": (0, 2), "size": (4, 2)})],
                           kind="exact"),
    "tile": Spec(lambda rs: [((U(rs, (2, 3)),), {"reps": (2, 1)}),
                             ((U(rs, (2, 3)),), {"reps": (3,)})],
                 kind="exact"),
    "repeat": Spec(lambda rs: [((U(rs, (2, 3)),), {"repeats": 2, "axis": 1}),
                               ((U(rs, (2, 3)),), {"repeats": 3})],
                   kind="exact"),
    "reverse": Spec(lambda rs: [((U(rs, (2, 3, 4)),), {"axis": 1}),
                                ((U(rs, (2, 3, 4)),), {"axis": (0, 2)})],
                    kind="exact"),
    "concat": Spec(lambda rs: [((U(rs, (2, 3)), U(rs, (2, 2))), {"dim": 1}),
                               ((U(rs, (2, 3)), U(rs, (1, 3))), {"dim": 0})],
                   kind="exact"),
    "stack": Spec(lambda rs: [((U(rs, (2, 3)), U(rs, (2, 3))), {"axis": 1})],
                  kind="exact"),
    "split": Spec(lambda rs: [((U(rs, (2, 6)),), {"num_outputs": 3,
                                                   "axis": 1}),
                              ((U(rs, (4, 3)),), {"num_outputs": 2,
                                                   "axis": 0,
                                                   "squeeze_axis": False}),
                              ((U(rs, (2, 3)),), {"num_outputs": 2,
                                                   "axis": 0,
                                                   "squeeze_axis": True})],
                  kind="exact"),
    "slice": Spec(lambda rs: [((U(rs, (4, 5)),), {"begin": (0, 1),
                                                   "end": (3, 4)}),
                              ((U(rs, (4, 5)),), {"begin": (None, 4),
                                                   "end": (None, 0),
                                                   "step": (1, -2)}),
                              ((U(rs, (4, 5)),), {"begin": (-3,),
                                                   "end": (None,)})],
                  kind="exact"),
    "slice_axis": Spec(lambda rs: [((U(rs, (4, 5)),), {"axis": 1, "begin": 1,
                                                        "end": 3}),
                                   ((U(rs, (4, 5)),), {"axis": 0,
                                                        "begin": -2,
                                                        "end": None})],
                       kind="exact"),
    "slice_like": Spec(lambda rs: [((U(rs, (4, 5)), U(rs, (2, 3))), {}),
                                   ((U(rs, (4, 5)), U(rs, (2, 3))),
                                    {"axes": (1,)})],
                       kind="exact", idx=(1,)),
    "pad": Spec(lambda rs: [((U(rs, (1, 2, 3, 4)),),
                             {"mode": m, "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                              "constant_value": 0.5})
                            for m in ("constant", "edge", "reflect")],
                kind="exact"),
    "where": Spec(lambda rs: [((I(rs, (3, 4), 2), U(rs, (3, 4)),
                                U(rs, (3, 4))), {})], kind="exact", idx=(0,)),
    "diag": Spec(lambda rs: [((U(rs, (3, 4)),), {"k": 1}),
                             ((U(rs, (4,)),), {"k": -1}),
                             ((U(rs, (2, 3, 3)),), {"axis1": 1, "axis2": 2})],
                 kind="exact"),
    "depth_to_space": Spec(lambda rs: [((U(rs, (1, 8, 2, 3)),),
                                        {"block_size": 2})], kind="exact"),
    "space_to_depth": Spec(lambda rs: [((U(rs, (1, 2, 4, 6)),),
                                        {"block_size": 2})], kind="exact"),
    # tensor: indexing
    "take": Spec(lambda rs: [((U(rs, (5, 3)), A([[0, 4], [7, -1]])),
                              {"mode": m, "axis": 0})
                             for m in ("clip", "wrap")]
                 + [((U(rs, (2, 5)), A([1, 3, 3])), {"axis": 1})],
                 kind="exact", idx=(1,)),
    "pick": Spec(lambda rs: [((U(rs, (3, 4)), A([0, 3, 5])), {"axis": 1}),
                             ((U(rs, (3, 4)), A([2, 0, 1, 2])),
                              {"axis": 0, "keepdims": True})],
                 kind="exact", idx=(1,)),
    "one_hot": Spec(lambda rs: [((A([0, 2, 5, 1]),), {"depth": 4}),
                                ((A([[1, 3]]),), {"depth": 4, "on_value": 2.0,
                                                  "off_value": -1.0})],
                    kind="exact", idx=(0,), bf16=False),
    "gather_nd": Spec(lambda rs: [((U(rs, (3, 4)), A([[0, 2, 2], [1, 3, 3]])),
                                   {})], kind="exact", idx=(1,)),
    "scatter_nd": Spec(lambda rs: [((U(rs, (3,)), A([[0, 1, 0], [2, 3, 2]])),
                                    {"shape": (2, 4)})],
                       kind="reduce", idx=(1,)),
    "Embedding": Spec(lambda rs: [((A([[0, 4, 1], [2, 2, 9]]), U(rs, (5, 4))),
                                   {"input_dim": 5, "output_dim": 4})],
                      kind="exact", idx=(0,)),
    "SequenceMask": _seq({0: {"value"}, 1: set()}),
    "SequenceLast": _seq({0: set(), 1: set()}),
    "SequenceReverse": _seq({0: set()}),
    # tensor: reductions and ordering
    "sum": _red(), "mean": _red(), "prod": _red(), "nansum": _red(),
    "nanprod": _red(), "max": _red(), "min": _red(),
    "norm": Spec(lambda rs: [((U(rs, (3, 4)),), {}),
                             ((U(rs, (3, 4)),), {"ord": 1, "axis": 1}),
                             ((U(rs, (3, 4)),), {"axis": 0,
                                                 "keepdims": True})],
                 kind="reduce"),
    "argmax": Spec(lambda rs: [((I(rs, (3, 4), 5),), {"axis": 1}),
                               ((I(rs, (3, 4), 5),), {"axis": 0,
                                                      "keepdims": True}),
                               ((U(rs, (3, 4)),), {})], kind="exact"),
    "argmin": Spec(lambda rs: [((I(rs, (3, 4), 5),), {"axis": 1}),
                               ((U(rs, (3, 4)),), {})], kind="exact"),
    "argmax_channel": Spec(lambda rs: [((I(rs, (2, 3, 4), 5),), {})],
                           kind="exact"),
    "cumsum": Spec(lambda rs: [((U(rs, (3, 4)),), {"axis": 1}),
                               ((U(rs, (3, 4)),), {})], kind="reduce"),
    "sort": Spec(lambda rs: [((U(rs, (3, 5)),), {}),
                             ((U(rs, (3, 5)),), {"axis": 0,
                                                 "is_ascend": False})],
                 kind="exact"),
    "argsort": Spec(lambda rs: [((I(rs, (3, 6)),), {}),
                                ((I(rs, (3, 6)),), {"is_ascend": False}),
                                ((I(rs, (4, 3)),), {"axis": 0})],
                    kind="exact"),
    "topk": Spec(lambda rs: [((I(rs, (3, 6)),), {"k": 3, "ret_typ": r,
                                                 "is_ascend": asc})
                             for r in ("indices", "value", "both", "mask")
                             for asc in (False, True)]
                 + [((I(rs, (5, 3)),), {"axis": 0, "k": 2})],
                 kind="exact"),
    "shape_array": Spec(lambda rs: [((U(rs, (2, 3, 4)),), {})],
                        kind="exact"),
    "size_array": Spec(lambda rs: [((U(rs, (2, 3, 4)),), {})], kind="exact"),
    # tensor: casts, copies, gradient stops, creation
    "cast": Spec(lambda rs: [((U(rs, (3, 4)),), {"dtype": d})
                             for d in ("float16", "int32", "bfloat16")],
                 kind="exact"),
    "amp_cast": Spec(lambda rs: [((U(rs, (3, 4)),), {})], kind="exact"),
    "zeros_like": Spec(lambda rs: [((U(rs, (3, 4)),), {})], kind="exact"),
    "ones_like": Spec(lambda rs: [((U(rs, (3, 4)),), {})], kind="exact"),
    "identity": Spec(lambda rs: [((U(rs, (3, 4)),), {})], kind="exact"),
    "stop_gradient": Spec(lambda rs: [((U(rs, (3, 4)),), {})], kind="exact"),
    "make_loss": Spec(lambda rs: [((U(rs, (3, 4)),), {})], kind="exact"),
    "_zeros": Spec(lambda rs: [((), {"shape": (2, 3)}),
                               ((), {"shape": (4,), "dtype": "int32"})],
                   kind="exact", bf16=False),
    "_ones": Spec(lambda rs: [((), {"shape": (2, 3)}),
                              ((), {"shape": (4,), "dtype": "float16"})],
                  kind="exact", bf16=False),
    "arange": Spec(lambda rs: [((), {"start": 1.0, "stop": 7.0, "step": 1.5,
                                     "repeat": 2}),
                               ((), {"start": 0, "stop": 5, "step": 1,
                                     "dtype": "int32"}),
                               ((), {"start": 0.0, "stop": 1.0,
                                     "step": 0.1})],
                   kind="exact", bf16=False),
    "full": Spec(lambda rs: [((), {"shape": (2, 3), "value": 2.5}),
                             ((), {"shape": (3,), "value": 7,
                                   "dtype": "int32"})],
                 kind="exact", bf16=False),
    "_full": Spec(lambda rs: [((), {"shape": (2, 3), "value": 2.5}),
                              ((), {"shape": (3,), "value": 7,
                                    "dtype": "int32"})],
                  kind="exact", bf16=False),
}


# -- running both sides --------------------------------------------------------

def _np_out(o):
    a = np.asarray(o.asnumpy() if isinstance(o, mx.nd.NDArray) else o)
    return a


def _as_list(o):
    return list(o) if isinstance(o, (tuple, list)) else [o]


def _tol(spec, canon, dtype):
    if dtype == "bfloat16":
        return BF16[spec.kind]
    if spec.kind == "exact":
        return 0.0
    if spec.kind == "reduce":
        return REDUCE_F32
    return LOOSER.get(canon, ELEM_F32)


def _compare(got, want, tol, what):
    got, want = _as_list(got), _as_list(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = _np_out(g), np.asarray(w)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        assert str(g.dtype) == str(w.dtype), (what, g.dtype, w.dtype)
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        if tol == 0.0:
            assert np.array_equal(g64, w64, equal_nan=True), (what, g, w)
        else:
            scale = max(np.abs(w64).max(initial=0.0), 1e-30)
            err = np.abs(g64 - w64).max(initial=0.0)
            assert err <= tol * scale, (what, err, tol * scale)


def _inputs(spec, args, dtype):
    """(jnp args, port args): float data in ``dtype``, index data float32."""
    jargs, targs = [], []
    for i, a in enumerate(args):
        dt = "float32" if i in spec.idx else dtype
        jargs.append(jnp.asarray(a, dtype=dt))
        targs.append(mx.nd.array(a, dtype=dt))
    return jargs, targs


def _port_call(name, targs, kwargs):
    # the registry op itself: nd.full and nd.concatenate are the creation
    # functions of those names, as in the JAX package
    return mx.nd.imperative_invoke(name, *targs, **kwargs)


def _grad_check(name, jfn, spec, args, kwargs, what):
    """float32 gradient of sum(out * cot) against jax.vjp, for the float
    data arguments."""
    diff = [i for i in range(len(args)) if i not in spec.idx]
    if not diff:
        return
    jargs = [jnp.asarray(a) for a in args]

    def f(*xs):
        full = list(jargs)
        for i, x in zip(diff, xs):
            full[i] = x
        return jfn(*full, **kwargs)

    jout, vjp = jax.vjp(f, *[jargs[i] for i in diff])
    if not jnp.issubdtype(jnp.asarray(_as_list(jout)[0]).dtype,
                          jnp.floating):
        return
    rs = np.random.RandomState(11)
    cots = [np.asarray(rs.uniform(-1, 1, np.shape(o))).astype(
        np.asarray(o).dtype) for o in _as_list(jout)]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots)
                 if isinstance(jout, (tuple, list)) else jnp.asarray(cots[0]))

    xs = [mx.nd.array(a) for a in args]
    for i in diff:
        xs[i].attach_grad()
    with mx.autograd.record():
        out = mx.nd.imperative_invoke(name, *xs, **kwargs)
    heads = _as_list(out)
    if heads[0]._data.requires_grad:      # else every gradient stays 0
        mx.autograd.backward(heads, [mx.nd.array(c) for c in cots])
    for i, jg in zip(diff, jgrads):
        _compare(xs[i].grad, jg, GRAD_F32, what + " grad %d" % i)


@pytest.mark.parametrize("module,name,canon,no_grad,jfn", NAMES,
                         ids=["%s-%s" % (m, n) for m, n, *_ in NAMES])
def test_port_op_matches_jax(module, name, canon, no_grad, jfn):
    assert name in treg.list_ops(), name
    assert treg.get_op(name) is treg.get_op(canon)     # the same aliases
    spec = SPECS[canon]
    rs = np.random.RandomState(sum(map(ord, canon)))
    cases = spec.make(rs)
    for dtype in ("float32", "bfloat16") if spec.bf16 else ("float32",):
        for n, (args, kwargs) in enumerate(cases):
            what = "%s %s case %d" % (name, dtype, n)
            jargs, targs = _inputs(spec, args, dtype)
            want = jfn(*jargs, **kwargs)
            got = _port_call(name, targs, kwargs)
            _compare(got, want, _tol(spec, canon, dtype), what)
    want_grad = (not no_grad) if spec.grad is None else spec.grad
    if want_grad:
        for n, (args, kwargs) in enumerate(cases):
            if args:
                _grad_check(name, jfn, spec, args, kwargs,
                            "%s case %d" % (name, n))


def test_every_jax_name_has_a_case():
    """The table covers both JAX modules' names (a name added to either
    module fails here until it is ported and given a case), and so do the
    tables of ``ops/nn.py``, ``ops/linalg.py`` and ``ops/random_ops.py``
    in their own test files: every name of theirs, aliases included, is
    in the port's registry."""
    canon = {c for _, _, c, _, _ in NAMES}
    assert canon <= set(SPECS), sorted(canon - set(SPECS))
    assert len({n for _, n, *_ in NAMES}) >= 190
    assert torch.is_tensor(mx.nd.relu(torch.ones(2)))   # tensors stay
    nn_t = importlib.import_module("test_torch_nn_ops")
    linalg_t = importlib.import_module("test_torch_linalg")
    random_t = importlib.import_module("test_torch_random")
    tables = (("mxnet_tpu.ops.nn", set(nn_t.SPECS), set(nn_t.LEFT_OUT)),
              ("mxnet_tpu.ops.linalg", set(linalg_t.SPECS), set()),
              ("mxnet_tpu.ops.random_ops",
               set(random_t.LAWS) | random_t.OWN_TESTS, set()))
    for modname, cases, left in tables:
        got = _capture(modname)
        names = {n for name, aliases, _, _ in got
                 for n in (name,) + aliases if name not in left}
        assert names <= set(treg.list_ops()), \
            (modname, sorted(names - set(treg.list_ops())))
        jcanon = {name for name, *_ in got} - left
        assert jcanon <= cases, (modname, sorted(jcanon - cases))
    assert set(nn_t.LEFT_OUT) == set()
