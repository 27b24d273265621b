"""The port's NDArray (mxnet_tpu_torch/ndarray/ndarray.py) held against the
JAX package's on the same numpy inputs: every method and operator, with
an NDArray or a Python scalar on either side and the in-place forms;
basic, advanced and boolean indexing and assignment; the creation
functions, properties and context moves; value semantics; attach_grad,
backward and autograd.grad; and JAX's type promotion with Python scalars.

Tolerances: element-wise results equal exactly or within 1e-6 of the
largest |JAX| value (``ELEM``), reductions within 1e-5 (``REDUCE``),
shape, index and ordering results and gradients of gathers bit for bit;
other gradients within 1e-5 (``GRAD``). Dtypes must agree exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx

ELEM = 1e-6
REDUCE = 1e-5
GRAD = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    # JAX's current context pinned to cpu(0) as well: a test file run
    # earlier in the same process can leave it elsewhere
    # (test_runtime_shims.py leaves cpu(1))
    with mx.cpu(), mxj.cpu():
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(t, j, tol=0.0, what=""):
    """Port result ``t`` against JAX result ``j`` (NDArrays, tuples of
    them, or Python values)."""
    if isinstance(j, (tuple, list)):
        assert isinstance(t, (tuple, list)) and len(t) == len(j), what
        for a, b in zip(t, j):
            _same(a, b, tol, what)
        return
    if not hasattr(j, "asnumpy") and not isinstance(j, np.ndarray):
        assert t == j or (isinstance(j, float) and abs(t - j) <= tol), \
            (what, t, j)
        return
    assert isinstance(t, mx.nd.NDArray), (what, type(t))
    a, b = _np(t), _np(j)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert str(a.dtype) == str(b.dtype), (what, a.dtype, b.dtype)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    if tol == 0.0:
        assert np.array_equal(a64, b64, equal_nan=True), (what, a, b)
    else:
        scale = max(np.abs(b64).max(initial=0.0), 1e-30)
        assert np.abs(a64 - b64).max(initial=0.0) <= tol * scale, what


def _pair(a, dtype=None):
    return mx.nd.array(a, dtype=dtype), mxj.nd.array(a, dtype=dtype)


def _x(seed=0, shape=(3, 4), lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype("float32")


# -- methods ---------------------------------------------------------------------

METHODS = [
    ("reshape", lambda x, nd: x.reshape((4, 3)), 0.0),
    ("reshape_args", lambda x, nd: x.reshape(2, -1), 0.0),
    ("reshape_codes", lambda x, nd: x.reshape((-1, 0)), 0.0),
    ("reshape_like", lambda x, nd: x.reshape_like(nd.zeros((2, 6))), 0.0),
    ("expand_dims", lambda x, nd: x.expand_dims(1), 0.0),
    ("squeeze", lambda x, nd: x.reshape((3, 1, 4)).squeeze(), 0.0),
    ("transpose", lambda x, nd: x.transpose(), 0.0),
    ("transpose_axes", lambda x, nd: x.reshape((3, 2, 2)).transpose(
        (2, 0, 1)), 0.0),
    ("T", lambda x, nd: x.T, 0.0),
    ("swapaxes", lambda x, nd: x.swapaxes(0, 1), 0.0),
    ("flatten", lambda x, nd: x.reshape((3, 2, 2)).flatten(), 0.0),
    ("flip", lambda x, nd: x.flip(1), 0.0),
    ("tile", lambda x, nd: x.tile((2, 1)), 0.0),
    ("repeat", lambda x, nd: x.repeat(2, axis=0), 0.0),
    ("broadcast_to", lambda x, nd: x[0:1].broadcast_to((5, 4)), 0.0),
    ("broadcast_like", lambda x, nd: x[0:1].broadcast_like(nd.zeros((2, 4))),
     0.0),
    ("slice", lambda x, nd: x.slice((0, 1), (2, 3)), 0.0),
    ("slice_axis", lambda x, nd: x.slice_axis(1, 1, 3), 0.0),
    ("take", lambda x, nd: x.take(nd.array([2, 0, 5])), 0.0),
    ("one_hot", lambda x, nd: nd.array([0, 2, 1]).one_hot(3), 0.0),
    ("pick", lambda x, nd: x.pick(nd.array([0, 3, 1])), 0.0),
    ("clip", lambda x, nd: x.clip(-0.5, 0.5), 0.0),
    ("abs", lambda x, nd: x.abs(), 0.0),
    ("sign", lambda x, nd: x.sign(), 0.0),
    ("sqrt", lambda x, nd: x.abs().sqrt(), ELEM),
    ("square", lambda x, nd: x.square(), ELEM),
    ("exp", lambda x, nd: x.exp(), ELEM),
    ("log", lambda x, nd: x.abs().log(), ELEM),
    ("sigmoid", lambda x, nd: x.sigmoid(), ELEM),
    ("tanh", lambda x, nd: x.tanh(), ELEM),
    ("relu", lambda x, nd: x.relu(), 0.0),
    ("softmax", lambda x, nd: x.softmax(), ELEM),
    ("log_softmax", lambda x, nd: x.log_softmax(axis=0), ELEM),
    ("sum", lambda x, nd: x.sum(), REDUCE),
    ("sum_axis", lambda x, nd: x.sum(axis=1, keepdims=True), REDUCE),
    ("mean", lambda x, nd: x.mean(axis=0), REDUCE),
    ("prod", lambda x, nd: x.prod(axis=1), REDUCE),
    ("max", lambda x, nd: x.max(axis=1), 0.0),
    ("min", lambda x, nd: x.min(), 0.0),
    ("norm", lambda x, nd: x.norm(), REDUCE),
    ("argmax", lambda x, nd: x.argmax(axis=1), 0.0),
    ("argmin", lambda x, nd: x.argmin(), 0.0),
    ("argsort", lambda x, nd: x.argsort(), 0.0),
    ("sort", lambda x, nd: x.sort(is_ascend=False), 0.0),
    ("topk", lambda x, nd: x.topk(k=2), 0.0),
    ("topk_both", lambda x, nd: x.topk(axis=0, k=2, ret_typ="both"), 0.0),
    ("dot", lambda x, nd: x.dot(x.T), REDUCE),
    ("dot_fn", lambda x, nd: nd.dot(x, x, transpose_b=True), REDUCE),
    ("zeros_like", lambda x, nd: x.zeros_like(), 0.0),
    ("ones_like", lambda x, nd: x.ones_like(), 0.0),
    ("astype", lambda x, nd: x.astype("float16"), 0.0),
    ("astype_int", lambda x, nd: x.astype("int32"), 0.0),
    ("copy", lambda x, nd: x.copy(), 0.0),
    ("detach", lambda x, nd: x.detach(), 0.0),
    ("as_in_context", lambda x, nd: x.as_in_context(mx_ctx(nd)), 0.0),
    ("copyto_ctx", lambda x, nd: x.copyto(mx_ctx(nd)), 0.0),
    ("iter", lambda x, nd: tuple(x), 0.0),
    ("concatenate", lambda x, nd: nd.concatenate([x, x], axis=1), 0.0),
    ("asnumpy", lambda x, nd: x.asnumpy(), 0.0),
    ("asscalar", lambda x, nd: x[1, 2].asscalar(), 0.0),
    ("item", lambda x, nd: float(x.sum(axis=(0, 1)).item()), 1e-5),
    ("float", lambda x, nd: float(x[0, 0]), 0.0),
    ("int", lambda x, nd: int(x[0, 0] * 10), 0.0),
    ("bool", lambda x, nd: bool(x[0, 0] > 0), 0.0),
    ("len", lambda x, nd: len(x), 0.0),
    ("shape", lambda x, nd: x.shape, 0.0),
    ("size", lambda x, nd: x.size, 0.0),
    ("ndim", lambda x, nd: x.ndim, 0.0),
    ("dtype", lambda x, nd: str(x.dtype), 0.0),
    ("nbytes", lambda x, nd: x.nbytes, 0.0),
    ("stype", lambda x, nd: x.stype, 0.0),
    ("context", lambda x, nd: str(x.context), 0.0),
    ("wait_to_read", lambda x, nd: x.wait_to_read(), 0.0),
    ("tostype", lambda x, nd: x.tostype("default"), 0.0),
    ("array_protocol", lambda x, nd: np.asarray(x), 0.0),
]


def mx_ctx(nd):
    return (mx if nd is mx.nd else mxj).cpu()


@pytest.mark.parametrize("name,fn,tol", METHODS, ids=[m[0] for m in METHODS])
def test_method_matches_jax(name, fn, tol):
    x = _x(1)
    t, j = _pair(x)
    got, want = fn(t, mx.nd), fn(j, mxj.nd)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        return
    _same(got, want, tol, name)


# -- operators -------------------------------------------------------------------

BINOPS = [
    ("add", lambda a, b: a + b, ELEM), ("sub", lambda a, b: a - b, ELEM),
    ("mul", lambda a, b: a * b, ELEM), ("div", lambda a, b: a / b, ELEM),
    ("mod", lambda a, b: a % b, ELEM), ("pow", lambda a, b: a ** b, ELEM),
    ("eq", lambda a, b: a == b, 0.0), ("ne", lambda a, b: a != b, 0.0),
    ("gt", lambda a, b: a > b, 0.0), ("ge", lambda a, b: a >= b, 0.0),
    ("lt", lambda a, b: a < b, 0.0), ("le", lambda a, b: a <= b, 0.0),
]


@pytest.mark.parametrize("side", ["nd_nd", "nd_scalar", "scalar_nd",
                                  "nd_broadcast", "nd_numpy"])
@pytest.mark.parametrize("name,op,tol", BINOPS, ids=[b[0] for b in BINOPS])
def test_operator_matches_jax(name, op, tol, side):
    a = _x(2, lo=0.5, hi=2.0)
    b = _x(3, lo=0.5, hi=2.0)
    if name in ("eq", "ne", "gt", "ge", "lt", "le"):
        a, b = np.round(a), np.round(b)        # ties
    ta, ja = _pair(a)
    tb, jb = _pair(b)
    if side == "nd_nd":
        got, want = op(ta, tb), op(ja, jb)
    elif side == "nd_scalar":
        got, want = op(ta, 1.5), op(ja, 1.5)
    elif side == "scalar_nd":
        got, want = op(1.5, ta), op(1.5, ja)
    elif side == "nd_broadcast":
        tb, jb = _pair(b[0])
        got, want = op(ta, tb), op(ja, jb)
    else:
        got, want = op(ta, b), op(ja, b)
    _same(got, want, tol, name + " " + side)


def test_unary_operators_and_none_compare():
    t, j = _pair(_x(4))
    _same(-t, -j)
    _same(abs(t), abs(j))
    assert (t == None) is (j == None) is False  # noqa: E711
    assert (t != None) is (j != None) is True  # noqa: E711
    assert hash(t) != hash(mx.nd.array(_x(4)))


@pytest.mark.parametrize("op", ["iadd", "isub", "imul", "idiv"])
@pytest.mark.parametrize("rhs", ["scalar", "nd"])
def test_inplace_operators_match_jax(op, rhs):
    t, j = _pair(_x(5))
    r = 0.75 if rhs == "scalar" else None
    tr, jr = _pair(_x(6, lo=0.5, hi=1.5))
    ident = id(t)
    for x, other in ((t, r if r is not None else tr),
                     (j, r if r is not None else jr)):
        if op == "iadd":
            x += other
        elif op == "isub":
            x -= other
        elif op == "imul":
            x *= other
        else:
            x /= other
    assert id(t) == ident
    _same(t, j, ELEM, op)


# -- type promotion with Python scalars (JAX's weak types) -------------------

PROMOTIONS = [
    ("int32+1.5", "int32", lambda a: a + 1.5),
    ("int32*2", "int32", lambda a: a * 2),
    ("int32/2", "int32", lambda a: a / 2),
    ("bf16+2.0", "bfloat16", lambda a: a + 2.0),
    ("bf16*0.1", "bfloat16", lambda a: a * 0.1),
    ("0.1-bf16", "bfloat16", lambda a: 0.1 - a),
    ("f16+1.5", "float16", lambda a: a + 1.5),
    ("f16>0.3", "float16", lambda a: a > 0.3),
    ("int32==1.0", "int32", lambda a: a == 1.0),
]


@pytest.mark.parametrize("name,dtype,fn", PROMOTIONS,
                         ids=[p[0] for p in PROMOTIONS])
def test_scalar_promotion_matches_jax(name, dtype, fn):
    a = np.array([[0.3, 1.0, 2.7], [-1.2, 5.5, 1.0]])
    t, j = _pair(a, dtype)
    _same(fn(t), fn(j), 0.0, name)


def test_array_array_promotion_matches_jax():
    a = _x(7)
    for d1, d2 in (("float16", "bfloat16"), ("int32", "float32"),
                   ("int32", "float16"), ("bfloat16", "float32"),
                   ("uint8", "int8")):
        t1, j1 = _pair(np.abs(a) * 3, d1)
        t2, j2 = _pair(np.abs(a) * 2, d2)
        _same(t1 + t2, j1 + j2, 0.0, d1 + "+" + d2)
        _same(t1 * t2, j1 * j2, 0.0, d1 + "*" + d2)


# -- indexing ------------------------------------------------------------------------

KEYS = [
    ("int", lambda nd: 1), ("neg_int", lambda nd: -1),
    ("slice", lambda nd: slice(1, 3)),
    ("step", lambda nd: slice(None, None, 2)),
    ("neg_step", lambda nd: slice(None, None, -1)),
    ("tuple", lambda nd: (1, slice(0, 3))),
    ("tuple_neg_step", lambda nd: (slice(3, 0, -2), slice(None, None, -1))),
    ("newaxis", lambda nd: (None, 1)),
    ("ellipsis", lambda nd: (Ellipsis, 2)),
    ("list", lambda nd: [0, 2]),
    ("nd_int", lambda nd: nd.array([2, 0, 1], dtype="int32")),
    ("nd_float", lambda nd: nd.array([2, 0])),
    ("nd_tuple", lambda nd: (nd.array([0, 1], dtype="int32"),
                             nd.array([3, 2], dtype="int32"))),
    ("bool_mask", lambda nd: nd.array(np.array([[1, 0, 1, 1], [0, 0, 1, 0],
                                               [1, 1, 0, 0]], bool))),
    ("bool_rows", lambda nd: nd.array(np.array([True, False, True]))),
]


@pytest.mark.parametrize("name,key", KEYS, ids=[k[0] for k in KEYS])
def test_getitem_matches_jax(name, key):
    t, j = _pair(_x(8))
    _same(t[key(mx.nd)], j[key(mxj.nd)], 0.0, name)


@pytest.mark.parametrize("value", ["scalar", "nd", "numpy"])
@pytest.mark.parametrize("name,key", KEYS, ids=[k[0] for k in KEYS])
def test_setitem_matches_jax(name, key, value):
    t, j = _pair(_x(9))
    shape = j[key(mxj.nd)].shape
    v = np.random.RandomState(10).uniform(-1, 1, shape).astype("float32")
    if value == "scalar":
        tv = jv = 0.25
    elif value == "nd":
        tv, jv = _pair(v)
    else:
        tv = jv = v
    t[key(mx.nd)] = tv
    j[key(mxj.nd)] = jv
    _same(t, j, 0.0, name)


def test_setitem_whole_and_dtype_cast():
    t, j = _pair(_x(11), "int32")
    t[:] = 2.7
    j[:] = 2.7
    _same(t, j)


# -- creation, properties, contexts -----------------------------------------------

CREATION = [
    ("zeros", lambda nd, c: nd.zeros((2, 3), ctx=c)),
    ("zeros_int", lambda nd, c: nd.zeros(4, ctx=c, dtype="int32")),
    ("ones", lambda nd, c: nd.ones((2, 3), ctx=c, dtype="float16")),
    ("full", lambda nd, c: nd.full((2, 2), 3.5, ctx=c)),
    ("empty", lambda nd, c: nd.empty((3,), ctx=c).zeros_like()),
    ("arange", lambda nd, c: nd.arange(1, 8, 1.5, ctx=c)),
    ("arange_repeat", lambda nd, c: nd.arange(4, repeat=2, ctx=c)),
    ("arange_int", lambda nd, c: nd.arange(0, 6, 2, ctx=c, dtype="int32")),
    ("eye", lambda nd, c: nd.eye(3, 4, 1, ctx=c)),
    ("linspace", lambda nd, c: nd.linspace(0, 1, 7, ctx=c)),
    ("linspace_open", lambda nd, c: nd.linspace(0, 1, 5, endpoint=False,
                                                ctx=c)),
    ("array_f64", lambda nd, c: nd.array(np.arange(3.0), ctx=c)),
    ("array_i64", lambda nd, c: nd.array(np.arange(3), ctx=c)),
    ("array_list", lambda nd, c: nd.array([[1, 2], [3, 4]], ctx=c)),
    ("array_bf16", lambda nd, c: nd.array([0.1, 1.7], ctx=c,
                                          dtype="bfloat16")),
    ("array_bool", lambda nd, c: nd.array(np.array([True, False]), ctx=c)),
    ("array_of_nd", lambda nd, c: nd.array(nd.ones((2,), ctx=c), ctx=c)),
    ("unique", lambda nd, c: nd.unique(nd.array([3, 1, 3, 2], ctx=c))),
]


@pytest.mark.parametrize("name,fn", CREATION, ids=[c[0] for c in CREATION])
def test_creation_matches_jax(name, fn):
    t = fn(mx.nd, mx.cpu())
    j = fn(mxj.nd, mxj.cpu())
    _same(t, j, ELEM if "linspace" in name else 0.0, name)
    assert str(t.context) == str(j.context) == "cpu(0)"


def test_bf16_asnumpy_is_ml_dtypes_bf16_as_in_jax():
    t, j = _pair([0.1, 1.7, -3.3], "bfloat16")
    a, b = t.asnumpy(), j.asnumpy()
    assert a.dtype == b.dtype and str(a.dtype) == "bfloat16"
    assert np.array_equal(a.astype(np.float32), b.astype(np.float32))


def test_placement_failure_raises_instead_of_falling_back():
    """JAX's creation functions fall back to a host array when placement
    fails; the port raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: mx.nd.zeros((2,), ctx=mx.gpu(0)),
                 lambda: mx.nd.array([1.0], ctx=mx.gpu(0)),
                 lambda: mx.nd.array([1.0], ctx=mx.cpu_pinned()),
                 lambda: mx.nd.ones((2,)).as_in_context(mx.gpu(0))):
        with pytest.raises(mx.MXNetError):
            make()
    assert mx.num_gpus() == 0
    assert mx.cpu_pinned(0) == mx.Context("cpu_pinned", 0)


def test_top_level_exports():
    for name in ("NDArray", "seed", "waitall", "num_gpus", "cpu_pinned"):
        assert hasattr(mx, name) and hasattr(mxj, name), name
    for name in ("NDArray", "array", "zeros", "ones", "full", "empty",
                 "arange", "eye", "linspace", "save", "load", "waitall",
                 "concatenate", "imperative_invoke", "boolean_mask",
                 "unique", "dot"):
        assert hasattr(mx.nd, name), name
    mx.seed(3)
    mx.waitall()
    mx.nd.waitall()
    assert mx.nd.NDArray is mx.NDArray
    # tensors in give tensors out: F inside hybrid_forward is unchanged
    assert torch.is_tensor(mx.nd.relu(torch.ones(2)))
    _same(mx.nd.imperative_invoke("relu", mx.nd.array([-1.0, 2.0])),
          mxj.nd.imperative_invoke("relu", mxj.nd.array([-1.0, 2.0])))


def test_out_argument_writes_in_place():
    t, j = _pair(_x(12))
    to, jo = _pair(np.zeros((3, 4), "float32"))
    r1 = mx.nd.exp(t, out=to)
    r2 = mxj.nd.exp(j, out=jo)
    assert r1 is to and r2 is jo
    _same(to, jo, ELEM)
    with pytest.raises(ValueError):
        mx.nd.exp(t, out=mx.nd.zeros((2,)))


def test_dlpack_round_trip():
    t = mx.nd.array(_x(13))
    back = torch.from_dlpack(t)
    assert np.array_equal(back.numpy(), t.asnumpy())
    assert t.__dlpack_device__() == back.__dlpack_device__()


# -- value semantics ---------------------------------------------------------------

def test_copies_keep_their_values_after_writes():
    """``copy``, ``copyto``, ``detach`` and op results keep their values
    when the source is then written (``+=``, ``[0] =``), in both."""
    for nd in (mx.nd, mxj.nd):
        a = nd.array(_x(14))
        b = a.copy()
        c = nd.zeros((3, 4))
        a.copyto(c)
        d = a.detach()
        e = a.reshape((12,))
        f = a[1]
        before = a.asnumpy()
        a += 1
        a[0] = 5
        for y in (b, c, d):
            assert np.array_equal(y.asnumpy(), before)
        assert np.array_equal(e.asnumpy(), before.reshape(12))
        assert np.array_equal(f.asnumpy(), before[1])
        assert np.array_equal(a.asnumpy()[0], np.full(4, 5, "float32"))


def _dense_pair():
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as tnn
    w = _x(15, (2, 3))
    nets = []
    for nn_, nd in ((tnn, mx.nd), (jnn, mxj.nd)):
        net = nn_.Dense(2, in_units=3)
        if nd is mx.nd:
            net.initialize(ctx=mx.cpu())
        else:
            net.initialize()
        net.weight.set_data(nd.array(w))
        net.bias.set_data(nd.zeros((2,)))
        nets.append(net)
    return nets


def test_parameter_data_writes_reach_the_parameter():
    """``p.data()[:] = v`` and ``p.data() += g`` change the parameter, as
    JAX's Parameter hands out its one NDArray; copies taken before stay."""
    tnet, jnet = _dense_pair()
    g = _x(16, (2, 3))
    for net, nd in ((tnet, mx.nd), (jnet, mxj.nd)):
        keep = net.weight.data().copy()
        view = net.weight.data()
        assert net.weight.data() is view
        net.weight.data()[:] = nd.array(g)
        w = net.weight.data()
        w += 0.5
        w[0, 1] = 7.0
        net.weight.data()[:, 2] *= 2
        assert not np.array_equal(keep.asnumpy(), net.weight.data().asnumpy())
    _same(tnet.weight.data(), jnet.weight.data())
    x = _x(17, (4, 3))
    _same(tnet(mx.nd.array(x)), jnet(mxj.nd.array(x)), ELEM)
    # what was read from the view is a copy
    tk = tnet.weight.data().copy()
    tr = tnet.weight.data().reshape((6,))
    tnet.weight.data()[:] = 0
    assert tk.asnumpy().any() and tr.asnumpy().any()
    assert not tnet.weight._tensor().any()
    assert type(tnet.weight.data()).__name__ == "_ParamArray"
    assert isinstance(tnet.weight.data(), mx.nd.NDArray)
    assert tnet.weight.list_data()[0] is tnet.weight.data()


# -- autograd ------------------------------------------------------------------------

def _grad_run(pkg, req, seed=18, steps=2, head_grad=False):
    nd = pkg.nd
    x = nd.array(_x(seed))
    x.attach_grad(req)
    for _ in range(steps):
        with pkg.autograd.record():
            y = (x * x + nd.sin(x)).sum(axis=1) * 2.0
        if head_grad:
            y.backward(nd.array(np.array([1.0, -2.0, 0.5], "float32")))
        else:
            y.backward()
    return x.grad


@pytest.mark.parametrize("req", ["write", "add"])
@pytest.mark.parametrize("head_grad", [False, True])
def test_attach_grad_matches_jax(req, head_grad):
    _same(_grad_run(mx, req, head_grad=head_grad),
          _grad_run(mxj, req, head_grad=head_grad), GRAD, req)


def test_grad_handle_taken_before_backward_sees_the_new_gradient():
    for pkg in (mx, mxj):
        x = pkg.nd.array(_x(19))
        x.attach_grad()
        g = x.grad
        with pkg.autograd.record():
            y = (x * 3).sum()
        y.backward()
        assert np.allclose(g.asnumpy(), 3.0)
        x.grad[:] = 0
        assert not x.grad.asnumpy().any()


def test_attach_grad_add_accumulates_after_a_write_through_grad():
    outs = []
    for pkg in (mx, mxj):
        x = pkg.nd.array(_x(20))
        x.attach_grad("add")
        for i in range(3):
            with pkg.autograd.record():
                y = (x * (i + 1.0)).sum()
            y.backward()
            if i == 0:
                x.grad[:] = 10.0
        outs.append(x.grad)
    _same(outs[0], outs[1], GRAD)


def test_autograd_grad_and_mark_variables_match_jax():
    res = []
    for pkg in (mx, mxj):
        nd = pkg.nd
        x = nd.array(_x(21))
        w = nd.array(_x(22, (4, 2)))
        gx, gw = nd.zeros((3, 4)), nd.zeros((4, 2))
        pkg.autograd.mark_variables([x, w], [gx, gw])
        with pkg.autograd.record():
            y = nd.dot(x, w).tanh()
        grads = pkg.autograd.grad(y, [x, w],
                                  head_grads=[nd.ones((3, 2)) * 0.5])
        with pkg.autograd.record():
            y = nd.dot(x, w).tanh()
        pkg.autograd.backward([y])
        res.append((grads, gx, gw))
    _same(list(res[0][0]), list(res[1][0]), GRAD, "grad")
    _same(res[0][1], res[1][1], GRAD, "marked x")
    _same(res[0][2], res[1][2], GRAD, "marked w")


def test_getitem_gradient_matches_jax():
    outs = []
    for pkg in (mx, mxj):
        nd = pkg.nd
        x = nd.array(_x(23))
        x.attach_grad()
        with pkg.autograd.record():
            y = x[nd.array([2, 0, 2], dtype="int32")] * 2 + x[1:, ::2].sum()
        y.backward()
        outs.append(x.grad)
    _same(outs[0], outs[1], 0.0)


def test_boolean_mask_and_its_gradient_match_jax():
    outs = []
    mask = np.array([1, 0, 1], "float32")
    for pkg in (mx, mxj):
        nd = pkg.nd
        x = nd.array(_x(24))
        x.attach_grad()
        with pkg.autograd.record():
            y = nd.boolean_mask(x, nd.array(mask))
            z = (y * y).sum()
        z.backward()
        outs.append((y, x.grad))
    _same(outs[0][0], outs[1][0])
    _same(outs[0][1], outs[1][1], GRAD)


def test_ops_outside_record_build_no_graph_and_inplace_on_recorded_raises():
    x = mx.nd.array(_x(25))
    x.attach_grad()
    y = x * 2
    assert not y._data.requires_grad
    with mx.autograd.record():
        z = x * 2
        with pytest.raises(RuntimeError):
            z += 1
    x += 1                       # a variable stays a variable
    with mx.autograd.record():
        (x * 4).sum().backward()
    assert np.allclose(x.grad.asnumpy(), 4.0)


# -- the NDArray boundary: optimizers, update ops, kvstore, blocks ------------

def test_optimizer_update_and_updater_take_ndarrays_as_jax():
    outs = []
    for pkg in (mx, mxj):
        nd = pkg.nd
        opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3)
        w, g = nd.array(_x(30)), nd.array(_x(31))
        st = opt.create_state(0, w)
        assert isinstance(st, nd.NDArray)
        opt.update(0, w, g, st)
        opt.update_multi_precision(0, w, g, st)
        w2 = nd.array(_x(32))
        upd = pkg.optimizer.get_updater(pkg.optimizer.Adam(
            learning_rate=0.01))
        upd(3, g, w2)
        upd(3, g, w2)
        outs.append((w, st, w2))
    for a, b in zip(outs[0], outs[1]):
        _same(a, b, ELEM)


def test_update_ops_take_ndarrays_with_out_in_place():
    outs = []
    for pkg in (mx, mxj):
        nd = pkg.nd
        w, g, m = nd.array(_x(33)), nd.array(_x(34)), nd.zeros((3, 4))
        keep = w.copy()
        r = nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9, wd=1e-3,
                              out=w)
        assert r is w
        r2 = nd.sgd_update(keep, g, lr=0.1)
        assert isinstance(r2, nd.NDArray)
        outs.append((w, m, r2, keep))
    for a, b in zip(outs[0], outs[1]):
        _same(a, b, ELEM)


def test_kvstore_takes_ndarrays_as_jax():
    outs = []
    for pkg in (mx, mxj):
        nd = pkg.nd
        kv = pkg.kv.create("local")
        kv.init([3, 5], [nd.ones((2, 3)), nd.zeros((4,))])
        kv.push(3, [nd.array(_x(35, (2, 3))), nd.array(_x(36, (2, 3)))])
        o = nd.zeros((2, 3))
        assert kv.pull(3, out=o) is o
        olist = [nd.zeros((4,)), nd.zeros((4,))]
        kv.pushpull(5, nd.array(_x(37, (4,))), out=olist)
        outs.append((o, olist[0], olist[1]))
    for a, b in zip(outs[0], outs[1]):
        _same(a, b, ELEM)


def test_block_fed_ndarrays_trains_as_fed_tensors():
    """A net called with NDArrays returns NDArrays with the tensor call's
    bits, and a Trainer step from NDArray data gives the tensor step's
    weights."""
    from mxnet_tpu_torch.gluon import nn as tnn
    x = _x(38, (6, 3))
    y = np.array([0, 1, 1, 0, 1, 1], "float32")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    nets = []
    for as_nd in (False, True):
        net = tnn.HybridSequential()
        net.add(tnn.Dense(5, in_units=3, activation="relu"))
        net.add(tnn.Dense(2, in_units=5))
        net.initialize(ctx=mx.cpu())
        rs = np.random.RandomState(39)
        for _, p in sorted(net._collect_params_with_prefix().items()):
            p.set_data(rs.randn(*p.shape).astype("float32"))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        xs = mx.nd.array(x) if as_nd else torch.from_numpy(x)
        ys = mx.nd.array(y) if as_nd else torch.from_numpy(y)
        for _ in range(2):
            with mx.autograd.record():
                out = net(xs)
                loss = loss_fn(out, ys)
            assert isinstance(out, mx.nd.NDArray) is as_nd
            assert isinstance(loss, mx.nd.NDArray) is as_nd
            loss.backward()
            tr.step(6)
        nets.append(net)
    for k, p in nets[0]._collect_params_with_prefix().items():
        q = nets[1]._collect_params_with_prefix()[k]
        assert torch.equal(p._tensor(), q._tensor()), k
        assert torch.equal(p._grad_tensor(), q._grad_tensor()), k
    got = nets[1](mx.nd.array(x))
    assert np.array_equal(got.asnumpy(),
                          nets[1](torch.from_numpy(x)).numpy())
    g = nets[1][0].weight.grad()
    assert isinstance(g, mx.nd.NDArray)
    assert np.array_equal(g.asnumpy(), nets[1][0].weight._grad_tensor()
                          .numpy())


@pytest.mark.parametrize("op", ["stop_gradient", "identity", "reshape",
                                "cast", "slice_axis", "transpose"])
def test_op_results_of_a_parameter_view_are_copies(op):
    """An op on ``p.data()`` that torch answers with a view or an alias
    (detach, identity, reshape, a no-op cast, a slice) still gives a value
    that later writes to the parameter leave alone, as in JAX."""
    tnet, jnet = _dense_pair()
    kw = {"reshape": {"shape": (6,)}, "cast": {"dtype": "float32"},
          "slice_axis": {"axis": 1, "begin": 0, "end": 2},
          "transpose": {}}.get(op, {})
    res = []
    for net, nd in ((tnet, mx.nd), (jnet, mxj.nd)):
        r = getattr(nd, op)(net.weight.data(), **kw)
        net.weight.data()[:] = 3.0
        res.append(r)
    _same(res[0], res[1])


def test_bf16_without_ml_dtypes_gives_exact_float32(monkeypatch, tmp_path):
    """Where ml_dtypes does not import, a bf16 array's asnumpy() is a
    float32 array of the same values, its dtype torch's, and nd.save
    writes the same bytes."""
    from mxnet_tpu_torch.ndarray import ndarray as nda
    vals = np.array([0.1, 1.7, -3.3, 1e-8], "float32")
    t, j = _pair(vals, "bfloat16")
    f1 = str(tmp_path / "a.params")
    mx.nd.save(f1, {"b": t})
    monkeypatch.setattr(nda, "_ml_dtypes", None)
    a = t.asnumpy()
    assert a.dtype == np.float32
    assert np.array_equal(a, j.asnumpy().astype(np.float32))
    assert t.dtype == torch.bfloat16
    assert mx.nd.array(vals, dtype="bfloat16").dtype == torch.bfloat16
    f2 = str(tmp_path / "b.params")
    mx.nd.save(f2, {"b": t})
    with open(f1, "rb") as x, open(f2, "rb") as y:
        assert x.read() == y.read()
