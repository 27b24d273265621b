"""The port's AMP (``contrib.amp``) held against the JAX package's on the
CPU.

- The three op lists are JAX's, and the widest-type cast promotes as
  ``jnp.promote_types`` does.
- The cast hook acts at the dispatch point on both routes: NDArrays given
  to ``mx.nd`` ops and the tensors a Gluon net runs on. A narrow NHWC
  ResNet V1 (fuse=False) under ``amp.init()`` hands every Convolution,
  BatchNorm and FullyConnected the dtypes JAX's hook gives it (each
  Convolution bfloat16, each BatchNorm float32), recorded where the port's
  ops receive their arguments.
- Loss and gradients of that net: in predict mode (the running
  statistics, so no batch-statistics cancellation) the loss within 1e-4
  relative and every gradient within 2e-2 of its largest magnitude, a few
  bfloat16 steps (2^-8 each); in training mode (batch 4, where the
  BatchNorm backward cancels) the loss within 5e-3 relative and each
  gradient's gap to JAX within 3 times the gap between JAX's AMP and
  float32 gradients, i.e. no larger than AMP's own rounding makes it.
- ``fuse=True`` under AMP: the forward as JAX's; JAX's CPU fallback
  backward raises TypeError (bfloat16 activations against its float32
  cotangent), and its kernel's form (interpret mode) differentiates, so
  the port's fused link is held to that form.
- ``LossScaler``: the scale sequence over clean and overflow steps
  (``scale_window`` 2) as JAX's, and the weights after each step within
  ``DENSE_RTOL``; a skipped
  step leaves weights and momentum bit for bit and fires no stale-gradient
  check; ``unscale`` divides once; ``convert_hybrid_block`` and
  ``convert_model`` give JAX's per-parameter dtypes; custom op lists do
  not outlive ``_reset``; the fused step falls back with
  ``fallback:amp-loss-scaler``.

JAX's BatchNorm runs its Pallas kernel in interpret mode
(``MXTPU_FUSED_BN=interpret``), so both sides use single-pass statistics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.contrib.amp import lists as jlists
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.ndarray import register as jreg
from mxnet_tpu.pallas_kernels import conv_fused as jconv
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.contrib.amp import amp as tamp_mod
from mxnet_tpu_torch.contrib.amp import lists as tlists
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import conv_fused as tconv
from mxnet_tpu_torch.ndarray import register as tregister
from mxnet_tpu_torch.ops import registry as treg

NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
WATCHED = ("Convolution", "BatchNorm", "FullyConnected")
PREDICT_LOSS_RTOL = 1e-4
PREDICT_GRAD_RTOL = 2e-2
TRAIN_LOSS_RTOL = 5e-3
TRAIN_SPREAD = 3.0
FUSED_RTOL = 2e-2
# Weights of an SGD Dense under AMP after a few steps, relative to the
# largest: the bfloat16 FullyConnected's gradients may differ by a
# bfloat16 step (2^-8) between the two packages' summation orders.
DENSE_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_BN", "interpret")
    with mx.cpu():
        yield
    jamp._reset()
    tamp._reset()


def _both_init(**kw):
    jamp.init(**kw)
    tamp.init(**kw)


def _pair(fuse=False):
    layers, channels = NARROW
    jnet = jres.ResNetV1(jres.BottleneckV1, layers, channels, classes=10,
                         thumbnail=True, layout="NHWC", fuse=fuse)
    jnet.initialize()
    jnet(mxj.nd.array(np.zeros((1, 3, 32, 32), "float32")))
    jp = jnet._collect_params_with_prefix()
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jp.items()}, seed=3)
    for k, p in jp.items():
        p.set_data(mxj.nd.array(arrays[k]))
    net = tres.ResNetV1(tres.BottleneckV1, layers, channels, classes=10,
                        thumbnail=True, layout="NHWC", fuse=fuse)
    net.initialize(ctx=mx.cpu())
    convert.load_numpy_params(net, arrays)
    return jnet, net, arrays


def _batch():
    x = np.random.RandomState(1).rand(4, 3, 32, 32).astype("float32")
    y = np.random.RandomState(2).randint(0, 10, (4,)).astype("float32")
    return x, y


def _jax_step(jnet, x, y, train=True):
    with mxj.autograd.record(train_mode=train):
        loss = jloss.SoftmaxCrossEntropyLoss()(jnet(mxj.nd.array(x)),
                                               mxj.nd.array(y))
    loss.backward()
    return loss.asnumpy()


def _port_step(net, x, y, train=True):
    with autograd.record(train_mode=train):
        loss = tloss.SoftmaxCrossEntropyLoss()(net(mx.nd.array(x)),
                                               mx.nd.array(y))
    loss.backward()
    return loss.asnumpy()


def _grads(net):
    return {k: p.grad().asnumpy().astype(np.float64)
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def _dtype_name(v):
    return str(v.dtype).replace("torch.", "")


# -- the lists and the promotion ----------------------------------------------

def test_lists_are_jax_lists():
    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "WIDEST_TYPE_CASTS"):
        assert getattr(tlists.symbol, name) == getattr(jlists.symbol, name)
    assert tamp.list_lp16_ops() == jamp.list_lp16_ops()
    assert tamp.list_fp32_ops() == jamp.list_fp32_ops()
    assert tamp.list_widest_type_cast() == jamp.list_widest_type_cast()
    _both_init()
    assert tamp.list_lp16_ops() == jamp.list_lp16_ops()
    assert tamp.list_fp32_ops() == jamp.list_fp32_ops()
    assert tamp.list_widest_type_cast() == jamp.list_widest_type_cast()


FLOATS = ("bfloat16", "float16", "float32", "float64")


@pytest.mark.parametrize("a", FLOATS)
@pytest.mark.parametrize("b", FLOATS)
def test_widest_promotion_is_jax_promote_types(a, b):
    want = str(jnp.promote_types(jnp.dtype(a), jnp.dtype(b)))
    got = tamp_mod._promote(getattr(torch, a), getattr(torch, b))
    assert str(got).replace("torch.", "") == want


# -- the hook on both routes ---------------------------------------------------

def test_policy_on_ndarrays_and_tensors_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8).astype("float32")
    w = rs.randn(16, 8).astype("float32")
    _both_init()
    jout = mxj.nd.FullyConnected(mxj.nd.array(x), mxj.nd.array(w), None,
                                 num_hidden=16, no_bias=True)
    out = mx.nd.FullyConnected(mx.nd.array(x), mx.nd.array(w), None,
                               num_hidden=16, no_bias=True)
    assert str(jout.dtype) == "bfloat16"
    assert _dtype_name(out._data) == "bfloat16"
    np.testing.assert_array_equal(out.asnumpy().astype(np.float32),
                                  jout.asnumpy().astype(np.float32))
    assert str(mxj.nd.softmax(jout).dtype) == "float32"
    assert _dtype_name(mx.nd.softmax(out)._data) == "float32"
    # a tensor through F (the route inside a Gluon net)
    tout = mx.nd.FullyConnected(torch.from_numpy(x), torch.from_numpy(w),
                                None, num_hidden=16, no_bias=True)
    assert isinstance(tout, torch.Tensor) and tout.dtype == torch.bfloat16
    assert mx.nd.softmax(tout).dtype == torch.float32
    # widest cast: bf16 + f32 -> f32; bf16 + bf16 stays
    a16 = mxj.nd.array(np.ones((2, 2), "float32")).astype("bfloat16")
    b32 = mxj.nd.array(np.ones((2, 2), "float32"))
    t16 = mx.nd.array(np.ones((2, 2), "float32")).astype("bfloat16")
    u32 = mx.nd.array(np.ones((2, 2), "float32"))
    assert str((a16 + b32).dtype) == "float32"
    assert _dtype_name((t16 + u32)._data) == "float32"
    assert _dtype_name((t16 + t16)._data) == "bfloat16"
    assert mx.nd.add(t16._data, u32._data).dtype == torch.float32


def test_gluon_net_op_dtypes_match_jax(monkeypatch):
    """Every Convolution, BatchNorm and FullyConnected of the narrow
    ResNet gets the argument dtypes JAX's hook gives it, recorded where
    the port's op functions receive them; their outputs: Convolution and
    FullyConnected bfloat16, BatchNorm float32."""
    jnet, net, _ = _pair()
    x, y = _batch()
    _both_init()
    jrec = []
    jhook = jreg._amp_cast_hook

    def jrecording(name, args, kwargs):
        a, k = jhook(name, args, kwargs)
        if name in WATCHED:
            jrec.append((name, [str(v.dtype) for v in list(a)
                                + list(k.values())
                                if isinstance(v, mxj.nd.NDArray)]))
        return a, k
    monkeypatch.setattr(jreg, "_amp_cast_hook", jrecording)
    rec, outs = [], []
    for name in WATCHED:
        op = treg.get_op(name)
        tregister._takes_training(op)   # read the real signature first

        def recording(*a, _fn=op.fn, _name=name, **k):
            rec.append((_name, [_dtype_name(v) for v in list(a)
                                + list(k.values())
                                if isinstance(v, torch.Tensor)]))
            out = _fn(*a, **k)
            first = out[0] if isinstance(out, (tuple, list)) else out
            outs.append((_name, _dtype_name(first)))
            return out
        monkeypatch.setattr(op, "fn", recording)
    _jax_step(jnet, x, y)
    _port_step(net, x, y)
    assert len(rec) == 34 and rec == jrec
    assert sum(n == "Convolution" for n, _ in rec) == 17
    assert sum(n == "BatchNorm" for n, _ in rec) == 16
    for name, dts in rec:
        want = {"Convolution": "bfloat16", "FullyConnected": "bfloat16",
                "BatchNorm": "float32"}[name]
        assert set(dts) == {want}, (name, dts)
    assert {(n, d) for n, d in outs} == {
        ("Convolution", "bfloat16"), ("FullyConnected", "bfloat16"),
        ("BatchNorm", "float32")}


# -- loss and gradients --------------------------------------------------------

def test_predict_mode_loss_and_grads_match_jax():
    jnet, net, _ = _pair()
    x, y = _batch()
    _both_init()
    ref = _jax_step(jnet, x, y, train=False)
    got = _port_step(net, x, y, train=False)
    np.testing.assert_allclose(got, ref, rtol=PREDICT_LOSS_RTOL)
    jg, tg = _grads(jnet), _grads(net)
    assert set(jg) == set(tg)
    for k in jg:
        scale = np.abs(jg[k]).max()
        assert np.abs(tg[k] - jg[k]).max() <= PREDICT_GRAD_RTOL * scale, k
    for p in net.collect_params().values():
        if p.grad_req != "null":
            assert p._grad_tensor().dtype == torch.float32


def test_train_mode_within_amp_rounding_of_jax():
    jnet, net, arrays = _pair()
    x, y = _batch()
    jf32, _, _ = _pair()
    for k, p in jf32._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(arrays[k]))
    _jax_step(jf32, x, y)               # float32: AMP not on yet
    _both_init()
    ref = _jax_step(jnet, x, y)
    got = _port_step(net, x, y)
    np.testing.assert_allclose(got, ref, rtol=TRAIN_LOSS_RTOL)
    jg, tg, fg = _grads(jnet), _grads(net), _grads(jf32)
    for k in jg:
        gap = np.abs(tg[k] - jg[k]).max()
        spread = np.abs(jg[k] - fg[k]).max()
        assert gap <= TRAIN_SPREAD * spread, (k, gap, spread)


def test_fused_net_forward_matches_jax_under_amp():
    jnet, net, _ = _pair(fuse=True)
    x, y = _batch()
    _both_init()
    for train in (False, True):
        with mxj.autograd.record(train_mode=train):
            ref = jloss.SoftmaxCrossEntropyLoss()(
                jnet(mxj.nd.array(x)), mxj.nd.array(y)).asnumpy()
        with autograd.record(train_mode=train):
            got = tloss.SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(x)), mx.nd.array(y)).asnumpy()
        np.testing.assert_allclose(got, ref, rtol=TRAIN_LOSS_RTOL)


def test_fused_link_grads_under_amp_match_jax_kernel():
    """The fused link with AMP's dtypes (x bfloat16 from a bfloat16
    Convolution, s and b float32, w a float32 parameter): JAX's CPU
    fallback cannot differentiate it, its kernel form can; the port's
    gradients match the kernel form's within FUSED_RTOL of each largest
    magnitude (bfloat16 dx, float32 ds, db, dw)."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 5, 16).astype(np.float32)
    s = (rs.rand(16) + 0.5).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    w = (rs.randn(3, 3, 16, 24) * 0.1).astype(np.float32)
    dy = rs.randn(2, 6, 5, 24).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jdy = jnp.asarray(dy, jnp.bfloat16)

    def jfn(interpret):
        def f(x_, s_, b_, w_):
            out = jconv.fused_scale_relu_conv3x3(x_, s_, b_, w_,
                                                 interpret=interpret)
            return jnp.sum(out.astype(jnp.float32)
                           * jdy.astype(jnp.float32))
        return jax.grad(f, argnums=(0, 1, 2, 3))
    with pytest.raises(TypeError):
        jfn(False)(jx, jnp.asarray(s), jnp.asarray(b), jnp.asarray(w))
    ref = jfn(True)(jx, jnp.asarray(s), jnp.asarray(b), jnp.asarray(w))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ts, tb, tw = (torch.from_numpy(a).requires_grad_() for a in (s, b, w))
    out = tconv.fused_scale_relu_conv3x3(tx, ts, tb, tw)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(dy).to(torch.bfloat16))
    for got, want in zip((tx, ts, tb, tw), ref):
        assert _dtype_name(got.grad) == str(want.dtype)
        g = got.grad.float().numpy()
        r = np.asarray(want.astype(jnp.float32))
        assert np.abs(g - r).max() <= FUSED_RTOL * np.abs(r).max()


# -- the loss scaler and the trainer ------------------------------------------

def _dense_pair(seed=0, units=(4, 8)):
    jnet = jnn.Dense(units[0], in_units=units[1])
    jnet.initialize()
    net = tnn.Dense(units[0], in_units=units[1])
    net.initialize(ctx=mx.cpu())
    rs = np.random.RandomState(seed)
    w = rs.randn(units[0], units[1]).astype("float32")
    b = rs.randn(units[0]).astype("float32")
    jnet.weight.set_data(mxj.nd.array(w))
    jnet.bias.set_data(mxj.nd.array(b))
    convert.load_numpy_params(net, {"weight": w, "bias": b})
    return jnet, net


def _trainers(jnet, net, opt):
    jtr = mxj.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    jamp.init_trainer(jtr)
    tamp.init_trainer(tr)
    return jtr, tr


def test_scale_sequence_and_weights_match_jax():
    _both_init()
    jnet, net = _dense_pair()
    jtr, tr = _trainers(jnet, net, {"learning_rate": 0.1, "momentum": 0.9})
    for t in (jtr, tr):
        t._amp_loss_scaler = type(t._amp_loss_scaler)(
            init_scale=8.0, scale_window=2)
    rs = np.random.RandomState(1)
    x = rs.randn(4, 8).astype("float32")
    y = rs.randn(4, 4).astype("float32")
    overflow = [False, False, False, True, False, False, True, True,
                False, False, False]
    jscales, scales = [], []
    for bad in overflow:
        with mxj.autograd.record():
            with jamp.scale_loss(jloss.L2Loss()(jnet(mxj.nd.array(x)),
                                                mxj.nd.array(y)),
                                 jtr) as sl:
                pass
        sl.backward()
        with autograd.record():
            with tamp.scale_loss(tloss_l2(net(mx.nd.array(x)),
                                          mx.nd.array(y)), tr) as tl:
                pass
        tl.backward()
        if bad:
            g = jnet.weight.grad()
            g._data = g._data.at[0, 1].set(jnp.nan)
            net.weight._grad_tensor()[0, 1] = float("inf")
        jtr.step(4)
        tr.step(4)
        jscales.append(jtr._amp_loss_scaler.loss_scale)
        scales.append(tr._amp_loss_scaler.loss_scale)
        for jp, p in ((jnet.weight, net.weight), (jnet.bias, net.bias)):
            want = jp.data().asnumpy()
            assert np.abs(p.data().asnumpy() - want).max() <= \
                DENSE_RTOL * np.abs(want).max()
    assert scales == jscales
    assert scales == [8.0, 16.0, 16.0, 8.0, 8.0, 16.0, 8.0, 4.0, 4.0, 8.0,
                      8.0]


def tloss_l2(pred, label):
    """JAX's gluon.loss.L2Loss, which the port's gluon.loss lacks: half the
    squared error, averaged over the non-batch axis."""
    return mx.nd.mean(0.5 * mx.nd.square(label - pred), axis=1)


def test_overflow_skip_keeps_bits_and_no_stale_error():
    _both_init()
    _, net = _dense_pair(2)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    tamp.init_trainer(tr)
    x = mx.nd.array(np.random.RandomState(3).randn(4, 8).astype("float32"))

    def backward():
        with autograd.record():
            with tamp.scale_loss(net(x).sum(), tr) as sl:
                pass
        sl.backward()
    backward()
    tr.step(4)                      # a clean step makes momentum nonzero
    w0 = {k: p._tensor().clone() for k, p in
          net.collect_params().items()}
    states = [s.clone() for s in tr._updater.states.values()]
    s0 = tr._amp_loss_scaler.loss_scale
    backward()
    net.bias._grad_tensor()[1] = float("-inf")
    tr.step(4)
    assert tr._amp_loss_scaler.loss_scale == s0 / 2
    for k, p in net.collect_params().items():
        assert torch.equal(p._tensor(), w0[k]), k
        assert not getattr(p._tensor(), "_fresh_grad", True)
    for a, b in zip(tr._updater.states.values(), states):
        assert torch.equal(a, b)
    backward()
    tr.step(4)                      # no stale-gradient error, weights move
    assert not torch.equal(net.weight._tensor(), w0[net.weight.name])


def test_unscale_divides_once_as_jax():
    _both_init()
    jnet, net = _dense_pair(4, (2, 2))
    jtr, tr = _trainers(jnet, net, {"learning_rate": 1.0})
    x = np.ones((1, 2), "float32")
    with mxj.autograd.record():
        with jamp.scale_loss(jnet(mxj.nd.array(x)).sum(), jtr) as jl:
            pass
    jl.backward()
    with autograd.record():
        with tamp.scale_loss(net(mx.nd.array(x)).sum(), tr) as tl:
            pass
    tl.backward()
    jamp.unscale(jtr)
    tamp.unscale(tr)
    g = net.weight.grad().asnumpy().copy()
    np.testing.assert_array_equal(g, jnet.weight.grad().asnumpy())
    w0 = net.weight.data().asnumpy().copy()
    jtr.step(1)
    tr.step(1)
    delta = np.abs(w0 - net.weight.data().asnumpy()).max()
    assert abs(delta - np.abs(g).max()) < 1e-5
    np.testing.assert_array_equal(net.weight.data().asnumpy(),
                                  jnet.weight.data().asnumpy())
    with pytest.raises(TypeError):
        tamp.unscale(mx.gluon.Trainer(net.collect_params(), "sgd"))


def _mixed(pkg, nn_):
    net = nn_.HybridSequential()
    net.add(nn_.Conv2D(8, 3, in_channels=3), nn_.BatchNorm(in_channels=8),
            nn_.Dense(4, in_units=8), nn_.LayerNorm(in_channels=4))
    return net


def test_convert_hybrid_block_dtypes_match_jax():
    jnet, net = _mixed(mxj, jnn), _mixed(mx, tnn)
    jnet.initialize()
    net.initialize(ctx=mx.cpu())
    jamp.convert_hybrid_block(jnet, excluded_sym_names=[])
    tamp.convert_hybrid_block(net, excluded_sym_names=[])
    want = {k: str(p.data().dtype) for k, p in
            jnet._collect_params_with_prefix().items()}
    got = {k: _dtype_name(p._tensor()) for k, p in
           net._collect_params_with_prefix().items()}
    assert got == want
    assert "bfloat16" in got.values() and "float32" in got.values()


def test_convert_model_dtypes_match_jax():
    names = ["conv0_weight", "conv0_bias", "bn0_gamma", "bn0_beta",
             "fc_weight", "fc_bias", "ln_gamma"]
    aux = ["bn0_moving_mean", "bn0_moving_var"]
    rs = np.random.RandomState(0)
    vals = {n: rs.randn(3, 2).astype("float32") for n in names + aux}
    jargs = {n: mxj.nd.array(vals[n]) for n in names}
    jaux = {n: mxj.nd.array(vals[n]) for n in aux}
    targs = {n: mx.nd.array(vals[n]) for n in names}
    taux = {n: mx.nd.array(vals[n]) for n in aux}
    for kw in ({}, {"excluded_sym_names": ["fc_weight"]}):
        _, ja, jx = jamp.convert_model("sym", jargs, jaux, **kw)
        sym, ta, tx = tamp.convert_model("sym", targs, taux, **kw)
        assert sym == "sym"
        assert {k: _dtype_name(v._data) for k, v in ta.items()} == \
            {k: str(v.dtype) for k, v in ja.items()}
        assert {k: _dtype_name(v._data) for k, v in tx.items()} == \
            {k: str(v.dtype) for k, v in jx.items()}


def test_custom_op_lists_do_not_leak():
    tamp.init(target_precision_ops=["my_custom_op"],
              fp32_ops=["my_fp32_op"],
              conditional_fp32_ops=[("my_cond_op", "act_type", ["x"])])
    jamp.init(target_precision_ops=["my_custom_op"],
              fp32_ops=["my_fp32_op"],
              conditional_fp32_ops=[("my_cond_op", "act_type", ["x"])])
    assert tamp.list_lp16_ops() == jamp.list_lp16_ops()
    assert tamp.list_fp32_ops() == jamp.list_fp32_ops()
    assert "my_custom_op" in tamp.list_lp16_ops()
    assert "my_cond_op" in tamp.list_fp32_ops()
    tamp._reset()
    tamp.init()
    assert "my_custom_op" not in tamp.list_lp16_ops()
    assert "my_fp32_op" not in tamp.list_fp32_ops()
    assert "my_custom_op" not in tlists.symbol.TARGET_DTYPE_OPS
    tamp.init(target_precision_ops=["other"])       # already on: no-op
    assert "other" not in tamp.list_lp16_ops()


def test_fused_step_falls_back_with_a_scaler_as_jax():
    _both_init()
    jnet, net = _dense_pair(6)
    jnet.hybridize()
    net.hybridize()
    jtr, tr = _trainers(jnet, net, {"learning_rate": 0.1})
    rs = np.random.RandomState(7)
    x = rs.randn(4, 8).astype("float32")
    y = rs.randn(4, 4).astype("float32")
    jstep = mxj.gluon.train_step(jnet, jloss.L2Loss(), jtr)
    step = mx.gluon.train_step(net, tloss_l2, tr)
    jstep(mxj.nd.array(x), mxj.nd.array(y))
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    assert jstep.last_mode == "fallback:amp-loss-scaler"
    assert step.last_mode == "fallback:amp-loss-scaler"
    assert torch.isfinite(loss).all()
    want = jnet.weight.data().asnumpy()
    assert np.abs(net.weight.data().asnumpy() - want).max() <= \
        DENSE_RTOL * np.abs(want).max()
