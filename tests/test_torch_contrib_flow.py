"""``autograd.Function``, the ``nd.contrib`` control flow (``foreach``,
``while_loop``, ``cond``), ``gluon.Constant`` and the ParameterDict
additions, the ``ops/extended.py`` names, ``Context.empty_cache`` and
``NDArray.wait_to_write``, against the JAX package on the CPU.

Values and gradients are f32 on both sides from the same numpy inputs, the
port's through torch autograd and JAX's through its own tape; they agree
within 1e-6 of the largest magnitude (the same arithmetic, elementwise).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx

RTOL = 1e-6


def _close(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= RTOL * max(np.abs(j).max(), 1e-30)


def _run(pkg, fn, *arrays):
    """``fn(pkg, *vars)`` under recording with a gradient attached to each
    input; (outputs as numpy, input gradients as numpy). The head is
    sum(out * (1 + position))."""
    ctx = mx.cpu() if pkg is mx else None
    xs = [pkg.nd.array(a, ctx=ctx) if ctx else pkg.nd.array(a)
          for a in arrays]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        outs = fn(pkg, *xs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        head = None
        for k, o in enumerate(outs):
            term = (o * (k + 1.0)).sum()
            head = term if head is None else head + term
    head.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def _same_run(fn, *arrays):
    with mx.cpu():
        t = _run(mx, fn, *arrays)
    j = _run(mxj, fn, *arrays)
    for a, b in zip(t[0] + t[1], j[0] + j[1]):
        _close(a, b)
    return t


def _fn_class(pkg):
    class ScaledSigmoid(pkg.autograd.Function):
        """y = sigmoid(x) * w with a hand-written backward; two outputs."""

        def forward(self, x, w):
            y = 1.0 / (1.0 + pkg.nd.exp(-x))
            self.save_for_backward(y, w)
            return y * w, y

        def backward(self, dout, dy):
            y, w = self.saved_tensors
            dsig = (dout * w + dy) * y * (1.0 - y)
            return dsig, (dout * y).sum(axis=0)
    return ScaledSigmoid


def test_autograd_function_matches_jax():
    rs = np.random.RandomState(0)
    x, w = rs.randn(3, 4).astype("f4"), rs.randn(4).astype("f4")
    out = _same_run(lambda pkg, a, b: list(_fn_class(pkg)()(a, b)), x, w)
    np.testing.assert_allclose(out[0][1], 1 / (1 + np.exp(-x)), rtol=1e-6)


def test_autograd_function_single_output_and_unrecorded():
    class Double(mx.autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return dy * 2
    with mx.cpu():
        x = mx.nd.array([1.0, 2.0])
        y = Double()(x)                      # outside record: no graph
        assert isinstance(y, mx.nd.NDArray)
        np.testing.assert_array_equal(y.asnumpy(), [2, 4])
        x.attach_grad()
        with mx.autograd.record():
            z = Double()(x) * x
        z.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), [4, 8])
    t = torch.tensor([1.0, 3.0], requires_grad=True)
    with mx.autograd.record():
        y = Double()(t)
    assert isinstance(y, torch.Tensor)
    y.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), [2, 2])


def test_foreach_matches_jax():
    rs = np.random.RandomState(1)
    data, s0 = rs.randn(5, 3).astype("f4"), rs.randn(3).astype("f4")

    def fn(pkg, d, s):
        def body(x, states):
            h = pkg.nd.tanh(x + states[0])
            return [h, h * 2], [h]
        outs, states = pkg.nd.contrib.foreach(body, d, [s])
        return [outs[0], outs[1], states[0]]
    _same_run(fn, data, s0)

    def fn2(pkg, a, b):            # two sequences, one output
        outs, st = pkg.nd.contrib.foreach(
            lambda xs, s: (xs[0] * xs[1] + s, xs[0] + s), [a, b], a[0])
        return [outs, st]
    _same_run(fn2, data, rs.randn(5, 3).astype("f4"))
    with mx.cpu(), pytest.raises(ValueError):
        mx.nd.contrib.foreach(lambda x, s: (x, s),
                              [mx.nd.zeros((2, 1)), mx.nd.zeros((3, 1))], 0)


@pytest.mark.parametrize("max_iterations", [3, 4, 7])
def test_while_loop_matches_jax(max_iterations):
    """Early exit (4 steps of 7: the outputs padded with zeros) and the
    cap (3 steps of 3)."""
    rs = np.random.RandomState(2)
    x0 = rs.rand(2).astype("f4")

    def fn(pkg, x):
        i0 = pkg.nd.zeros((1,), ctx=mx.cpu()) if pkg is mx \
            else pkg.nd.zeros((1,))
        outs, (i, x_last) = pkg.nd.contrib.while_loop(
            lambda i, v: i < 4,
            lambda i, v: ([v * v, v + i], [i + 1, v * 1.5]),
            [i0, x], max_iterations=max_iterations)
        return [outs[0], outs[1], x_last]
    out = _same_run(fn, x0)
    steps = min(4, max_iterations)
    assert out[0][0].shape == (max_iterations, 2)
    assert (out[0][0][steps:] == 0).all()
    with mx.cpu():
        with pytest.raises(ValueError):
            mx.nd.contrib.while_loop(lambda v: v < 0, lambda v: ([v], [v]),
                                     [mx.nd.ones((1,))], max_iterations=3)
        with pytest.raises(ValueError):
            mx.nd.contrib.while_loop(lambda v: v < 0, lambda v: ([v], [v]),
                                     [mx.nd.ones((1,))])


@pytest.mark.parametrize("flag", [1.0, 0.0])
def test_cond_matches_jax(flag):
    rs = np.random.RandomState(3)
    x = rs.randn(4).astype("f4")

    def fn(pkg, v):
        p = pkg.nd.array([flag], ctx=mx.cpu()) if pkg is mx \
            else pkg.nd.array([flag])
        return pkg.nd.contrib.cond(p, lambda: v * v, lambda: v * 3.0)
    _same_run(fn, x)
    assert mx.nd.contrib.cond(False, lambda: 1, lambda: 2) == 2


def test_constant_never_learns():
    with mx.cpu():
        val = np.arange(6, dtype=np.float64).reshape(2, 3)
        c = mx.gluon.Constant("const", val)
        assert c.grad_req == "null" and c.dtype == torch.float32
        w = mx.gluon.Parameter("w", shape=(2, 3))
        c.initialize(default_init=mx.init.One())    # its value wins
        w.initialize(init=mx.init.One())
        np.testing.assert_array_equal(c.data().asnumpy(), val)
        trainer = mx.gluon.Trainer([w, c], "sgd", {"learning_rate": 0.5})
        with mx.autograd.record():
            loss = (w.data() * c.data()).sum()
        loss.backward()
        trainer.step(1)
        np.testing.assert_array_equal(c.data().asnumpy(), val)
        np.testing.assert_allclose(w.data().asnumpy(), 1 - 0.5 * val)
        with pytest.raises(mx.MXNetError):
            c.grad()
        ci = mx.gluon.Constant("ci", np.array([1, 2], np.int64))
        ci.initialize()
        assert ci.dtype == torch.int32
        np.testing.assert_array_equal(ci.data().asnumpy(), [1, 2])
    jc = mxj.gluon.Constant("const", val)
    jc.initialize()
    np.testing.assert_array_equal(jc.data().asnumpy(), val)
    assert str(jc.data().dtype) == "float32"


def test_parameter_dict_get_constant_setattr_reset_ctx():
    with mx.cpu():
        pd = mx.gluon.ParameterDict("net_")
        c = pd.get_constant("c", [1.0, 2.0])
        assert pd.get_constant("c") is c and c.name == "net_c"
        with pytest.raises(KeyError):
            pd.get_constant("missing")
        pd.get("w", shape=(2,))
        pd.initialize(mx.init.Zero())
        pd.setattr("grad_req", "null")
        assert all(p.grad_req == "null" for p in pd.values())
        assert not pd["net_w"]._tensor().requires_grad
        pd.setattr("grad_req", "write")
        assert pd["net_w"]._tensor().requires_grad
        pd.setattr("lr_mult", 0.1)
        assert pd["net_w"].lr_mult == 0.1
        pd.reset_ctx(mx.cpu())
        assert pd["net_w"].list_ctx() == [mx.cpu()]
        np.testing.assert_array_equal(pd["net_c"].data().asnumpy(), [1, 2])
        d = mx.gluon.Parameter("d", shape=(0, 3), allow_deferred_init=True)
        d.initialize(ctx=mx.cpu())
        d.reset_ctx(mx.cpu(1))
        assert d._deferred_init[1] == torch.device("cpu")
    jpd = mxj.gluon.ParameterDict("net_")
    jc = jpd.get_constant("c", [1.0, 2.0])
    assert jc.name == "net_c" and jc.grad_req == "null"


def test_extended_names():
    from mxnet_tpu_torch.ops import registry as treg
    from mxnet_tpu.ops import registry as jreg
    aliases = ["BatchNorm_v1", "Convolution_v1", "Pooling_v1",
               "CuDNNBatchNorm", "SyncBatchNorm", "_contrib_SyncBatchNorm",
               "_contrib_SparseEmbedding"]
    for name in aliases:
        assert name in treg.list_ops() and name in jreg.list_ops()
    assert treg.get_op("BatchNorm_v1") is treg.get_op("BatchNorm")
    assert treg.get_op("_contrib_SparseEmbedding") is treg.get_op("Embedding")
    assert callable(mx.nd.contrib.SyncBatchNorm)
    rs = np.random.RandomState(4)
    a = rs.randn(3, 4).astype("f4")
    b = rs.randn(5).astype("f4")
    bad = a.copy()
    bad[1, 2] = np.inf
    with mx.cpu():
        T = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
             (("a", a), ("b", b), ("bad", bad))}
    J = {k: mxj.nd.array(v) for k, v in (("a", a), ("b", b), ("bad", bad))}
    for args in (("a",), ("bad",)):
        t = mx.nd.all_finite(*[T[k] for k in args])
        j = mxj.nd.all_finite(*[J[k] for k in args])
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    for args in (("a", "b"), ("a", "bad")):
        t = mx.nd.multi_all_finite(*[T[k] for k in args], num_arrays=2)
        j = mxj.nd.multi_all_finite(*[J[k] for k in args], num_arrays=2)
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    t = mx.nd.multi_sum_sq(T["a"], T["b"], num_arrays=2)
    j = mxj.nd.multi_sum_sq(J["a"], J["b"], num_arrays=2)
    for x, y in zip(t, j):
        _close(x.asnumpy(), y.asnumpy())
    h = torch.from_numpy(a).to(torch.bfloat16)
    f = torch.from_numpy(b)
    for narrow in (False, True):
        outs = treg.get_op("amp_multicast").fn(h, f, num_outputs=2,
                                               cast_narrow=narrow)
        want = torch.bfloat16 if narrow else torch.float32
        assert [o.dtype for o in outs] == [want, want]


def test_empty_cache_and_wait_to_write():
    with mx.cpu():
        mx.cpu().empty_cache()               # nothing cached on the host
        x = mx.nd.ones((2, 2))
        assert x.wait_to_write() is x and x.wait_to_read() is x
    assert mxj.cpu().empty_cache() is None
