"""The port's initializers against the JAX package's, on the CPU.

Deterministic fills (Zero, One, Constant, Bilinear, LSTMBias, FusedRNN
over a deterministic inner initializer, ``Mixed``'s pattern dispatch, an
``InitDesc``'s ``__init__`` override, the name-suffix dispatch) equal
JAX's exactly, and ``dumps``/``create`` round-trip to JAX's specs. The
random ones draw from the port's torch generator, not JAX's numpy stream,
so they are held to their law: Xavier (each ``rnd_type`` and
``factor_type``) and MSRAPrelu have the exact bound or sigma from the fans,
every uniform draw lies within the bound and the largest reaches 99% of
it, and the sample mean and variance lie within SIGMAS standard errors of
the law's; Orthogonal's rows (or columns) are orthonormal times ``scale``
within 1e-5.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx

SIGMAS = 5.0


def _both(jinit, tinit, name, shape):
    j = np.zeros(shape, np.float32)
    t = np.zeros(shape, np.float32)
    jinit(name, j)
    tinit(name, t)
    return t, j


@pytest.mark.parametrize("name", ["fc_weight", "fc_bias", "bn_gamma",
                                  "bn_beta", "bn_running_mean",
                                  "bn_running_var", "bn_moving_mean",
                                  "bn_moving_var", "x_moving_inv_var",
                                  "x_moving_avg"])
@pytest.mark.parametrize("cls,args", [("Zero", ()), ("One", ()),
                                      ("Constant", (2.5,)),
                                      ("Constant", ([[1, 2], [3, 4]],))])
def test_deterministic_fills_and_dispatch(cls, args, name):
    t, j = _both(getattr(mxj.init, cls)(*args), getattr(mx.init, cls)(*args),
                 name, (2, 2))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (2, 3, 5, 5), (3, 1, 4, 6),
                                   (2, 2, 7, 3)])
def test_bilinear_exact(shape):
    t, j = _both(mxj.init.Bilinear(), mx.init.Bilinear(), "up_weight", shape)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("forget_bias", [1.0, 0.0, 2.5])
def test_lstm_bias_exact(forget_bias):
    t, j = _both(mxj.init.LSTMBias(forget_bias),
                 mx.init.LSTMBias(forget_bias), "lstm_i2h_weight", (20,))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mode,bidir,layers", [("lstm", False, 2),
                                               ("gru", True, 1),
                                               ("rnn_tanh", True, 2)])
def test_fused_rnn_exact_over_a_constant(mode, bidir, layers):
    from mxnet_tpu.ops.nn import rnn_packed_param_size
    h, isz = 3, 5
    ndir = 2 if bidir else 1
    size = rnn_packed_param_size(mode, isz, h, layers, ndir)
    kw = dict(num_hidden=h, num_layers=layers, mode=mode,
              bidirectional=bidir, forget_bias=0.75)
    t, j = _both(mxj.init.FusedRNN(mxj.init.Constant(0.3), **kw),
                 mx.init.FusedRNN(mx.init.Constant(0.3), **kw),
                 "rnn_parameters", (size,))
    np.testing.assert_array_equal(t, j)
    with pytest.raises(ValueError):
        mx.init.FusedRNN(mx.init.One(), **kw)._init_weight(
            "p", torch.zeros(size + 1))


def test_mixed_pattern_dispatch():
    pats = [".*bias", ".*gamma", ".*"]
    jm = mxj.init.Mixed(pats, [mxj.init.Constant(-1.0), mxj.init.One(),
                               mxj.init.Constant(0.5)])
    tm = mx.init.Mixed(pats, [mx.init.Constant(-1.0), mx.init.One(),
                              mx.init.Constant(0.5)])
    for name in ("d_bias", "bn_gamma", "bn_running_var", "conv_weight"):
        t, j = _both(jm, tm, name, (3,))
        np.testing.assert_array_equal(t, j)
        j2, t2 = np.zeros(3, np.float32), torch.zeros(3)
        jm._init_weight_dispatch(name, j2)
        tm._init_weight_dispatch(name, t2)
        np.testing.assert_array_equal(t2.numpy(), j2)
    with pytest.raises(ValueError):
        mx.init.Mixed(["^a$"], [mx.init.One()])("b", np.zeros(1, np.float32))


def test_init_desc_override_and_ndarray_target():
    spec = mx.init.Constant(7.0).dumps()
    assert spec == mxj.init.Constant(7.0).dumps()
    tdesc = mx.init.InitDesc("conv_bias", attrs={"__init__": spec})
    jdesc = mxj.init.InitDesc("conv_bias", attrs={"__init__": spec})
    assert tdesc == "conv_bias" and tdesc.attrs == jdesc.attrs
    t, j = _both(mxj.init.Zero(), mx.init.Zero(), jdesc, (4,))
    t2 = np.zeros(4, np.float32)
    mx.init.Zero()(tdesc, t2)
    np.testing.assert_array_equal(t2, j)
    assert (j == 7.0).all()
    with mx.cpu():
        arr = mx.nd.zeros((2, 3))
        mx.init.Constant(1.5)("w_weight", arr)
        assert (arr.asnumpy() == 1.5).all()


@pytest.mark.parametrize("init", [
    ("Xavier", {"rnd_type": "gaussian", "factor_type": "in",
                "magnitude": 2}),
    ("Uniform", {"scale": 0.2}), ("Normal", {"sigma": 0.3}),
    ("Orthogonal", {"scale": 1.1, "rand_type": "normal"}),
    ("MSRAPrelu", {"factor_type": "out", "slope": 0.1}),
    ("LSTMBias", {"forget_bias": 2.0}), ("Bilinear", {}), ("Zero", {}),
    ("Constant", {"value": 3})])
def test_dumps_create_round_trip(init):
    cls, kw = init
    t, j = getattr(mx.init, cls)(**kw), getattr(mxj.init, cls)(**kw)
    assert t.dumps() == j.dumps()
    back = mx.init.create(t.dumps())
    assert type(back) is type(t) and back._kwargs == t._kwargs
    assert type(mx.init.create(cls.lower())) is type(t)
    assert mx.init.get(cls.lower()).__class__ is type(t)


def test_registry_names_and_register():
    for name in ("zero", "zeros", "one", "ones", "constant", "uniform",
                 "normal", "orthogonal", "xavier", "msraprelu", "bilinear",
                 "lstmbias", "fusedrnn"):
        assert type(mx.init.get(name)).__name__.lower() == \
            type(mxj.init.get(name)).__name__.lower()
    with pytest.raises(KeyError):
        mx.init.get("no_such_init")

    @mx.init.register
    class HalfInit(mx.init.Initializer):
        def _init_weight(self, _, arr):
            arr.fill_(0.5)
    t = np.zeros(3, np.float32)
    mx.init.create("halfinit")("w_weight", t)
    assert (t == 0.5).all()


def _uniform_law(w, bound):
    """Within [-bound, bound], reaching 99% of it; mean and variance of
    U(-b, b) within SIGMAS standard errors."""
    n = w.size
    assert np.abs(w).max() <= bound * (1 + 1e-6)
    assert np.abs(w).max() >= 0.99 * bound
    assert abs(w.mean()) <= SIGMAS * bound / math.sqrt(3 * n)
    var = bound ** 2 / 3
    assert abs((w.astype(np.float64) ** 2).mean() - var) <= \
        SIGMAS * math.sqrt(4 / 45) * bound ** 2 / math.sqrt(n)


def _normal_law(w, sigma):
    n = w.size
    assert abs(w.mean()) <= SIGMAS * sigma / math.sqrt(n)
    assert abs((w.astype(np.float64) ** 2).mean() - sigma ** 2) <= \
        SIGMAS * math.sqrt(2) * sigma ** 2 / math.sqrt(n)


SHAPE = (64, 32, 3, 3)


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
def test_xavier_by_law(rnd_type, factor_type):
    mx.random.seed(3)
    w = np.zeros(SHAPE, np.float32)
    mx.init.Xavier(rnd_type, factor_type, 2.5)("conv_weight", w)
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = math.sqrt(2.5 / factor)
    if rnd_type == "uniform":
        _uniform_law(w, scale)
    else:
        _normal_law(w, scale)
    with pytest.raises(ValueError):
        mx.init.Xavier()("b_weight", np.zeros(5, np.float32))


def test_msra_prelu_by_law():
    mx.random.seed(4)
    w = np.zeros((128, 96), np.float32)
    mx.init.MSRAPrelu("in", 0.25)("fc_weight", w)
    _normal_law(w, math.sqrt(2.0 / (1 + 0.25 ** 2) / 96))


@pytest.mark.parametrize("shape", [(16, 8, 2), (8, 32), (32, 8)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_rows_orthonormal(shape, rand_type):
    mx.random.seed(5)
    w = np.zeros(shape, np.float32)
    mx.init.Orthogonal(1.3, rand_type)("fc_weight", w)
    m = w.reshape(shape[0], -1).astype(np.float64)
    g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    np.testing.assert_allclose(g, 1.3 ** 2 * np.eye(g.shape[0]), atol=1e-5)


def test_net_initialize_by_name():
    """``net.initialize("xavier")``: weights of the default Xavier's law,
    biases zero, as in the JAX package; a Mixed default too."""
    with mx.cpu():
        mx.random.seed(6)
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Conv2D(48, 3, in_channels=16),
                mx.gluon.nn.Dense(40, in_units=300))
        net.initialize("xavier")
        conv_w = net[0].weight.data().asnumpy()
        _uniform_law(conv_w, math.sqrt(3.0 / ((16 * 9 + 48 * 9) / 2)))
        _uniform_law(net[1].weight.data().asnumpy(),
                     math.sqrt(3.0 / ((300 + 40) / 2)))
        assert (net[0].bias.data().asnumpy() == 0).all()
        net2 = mx.gluon.nn.Dense(4, in_units=3)
        net2.initialize(mx.init.Mixed([".*bias", ".*"],
                                      [mx.init.One(), mx.init.Constant(2)]))
        jnet2 = mxj.gluon.nn.Dense(4, in_units=3)
        jnet2.initialize(mxj.init.Mixed([".*bias", ".*"], [
            mxj.init.One(), mxj.init.Constant(2)]))
        for p in ("weight", "bias"):
            np.testing.assert_array_equal(
                getattr(net2, p).data().asnumpy(),
                getattr(jnet2, p).data().asnumpy())
        assert (net2.weight.data().asnumpy() == 2).all()
        net3 = mx.gluon.nn.Dense(4, in_units=3,
                                 weight_initializer=mx.init.Xavier())
        net3.initialize(mx.init.Constant(9))
        assert np.abs(net3.weight.data().asnumpy()).max() <= \
            math.sqrt(3.0 / 3.5)
    jnet = mxj.gluon.nn.Dense(40, in_units=300)
    jnet.initialize("xavier")
    assert np.abs(jnet.weight.data().asnumpy()).max() <= \
        math.sqrt(3.0 / 170) * (1 + 1e-6)
