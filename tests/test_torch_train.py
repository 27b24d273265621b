"""The port's training path held against the JAX package on the CPU: the
loss and its ops, the SGD update, MXNet's gradient conventions (grad_req,
stale gradients, a non-scalar head), and two training steps of a narrow
ResNet V1 (NHWC, fuse=False) from the same weights and batch.

The JAX side runs its BatchNorm through its Pallas kernel in interpret mode
(``MXTPU_FUSED_BN=interpret``), so both packages use the kernel's
single-pass statistics. Float32 throughout; the tolerances are stated per
test.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import tensor as jtensor
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import tensor as ttensor

NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype("float32")


def _labels(n, classes, seed=1):
    return np.random.RandomState(seed).randint(0, classes, (n,)) \
        .astype("float32")


# -- loss and its ops ---------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 1, 0])
def test_log_softmax_and_pick_match_jax(axis):
    x = _rand(4, 6, 5, scale=4.0)
    idx = np.random.RandomState(2).randint(-1, 7, (4, 6, 5)).sum(
        axis=axis).astype("float32")           # out-of-range: clipped
    _out = tnn.log_softmax(torch.from_numpy(x), axis=axis)
    ref = jnn.log_softmax(jnp.asarray(x), axis=axis)
    np.testing.assert_allclose(_out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    for keepdims in (True, False):
        out = ttensor.pick(_out, torch.from_numpy(idx), axis=axis,
                           keepdims=keepdims)
        want = jtensor.pick(ref, jnp.asarray(idx), axis=axis,
                            keepdims=keepdims)
        assert tuple(out.shape) == tuple(want.shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"sparse_label": False},
                                {"weight": 0.5}, {"from_logits": True}])
def test_softmax_cross_entropy_matches_jax(kw):
    pred = _rand(5, 7, scale=3.0)
    label = _labels(5, 7)
    if kw.get("sparse_label") is False:
        label = np.eye(7, dtype="float32")[label.astype(int)]
    sw = np.random.RandomState(3).rand(5, 1).astype("float32")
    for sample_weight in (None, sw):
        args = [pred, label] + ([] if sample_weight is None
                                else [sample_weight])
        with mx.cpu():
            out = tloss.SoftmaxCrossEntropyLoss(**kw)(
                *map(torch.from_numpy, args))
        ref = jloss.SoftmaxCrossEntropyLoss(**kw)(
            *map(mxj.nd.array, args)).asnumpy()
        assert tuple(out.shape) == ref.shape == (5,)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [{"axis": 0, "exclude": True},
                                {"axis": (1, 2)}, {"axis": None},
                                {"axis": 1, "keepdims": True},
                                {"axis": -1, "exclude": True}])
def test_mean_and_sum_match_jax(kw):
    x = _rand(3, 4, 5)
    for name in ("mean", "sum"):
        out = getattr(mx.nd, name)(torch.from_numpy(x), **kw)
        ref = getattr(mxj.nd, name)(mxj.nd.array(x), **kw).asnumpy()
        assert tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_mean_over_no_axes_is_identity():
    """A (B,) loss term: excluding the batch axis leaves nothing to reduce
    (torch would read an empty dim list as "all")."""
    v = torch.from_numpy(_rand(3))
    assert torch.equal(mx.nd.mean(v, axis=0, exclude=True), v)


# -- the SGD update -----------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("wd,clip", [(0.0, None), (1e-2, None),
                                     (1e-2, 0.05)])
def test_sgd_update_matches_jax(momentum, wd, clip):
    """Three updates of one weight, within 1e-6 relative: the same
    elementwise chain in both packages."""
    kw = dict(learning_rate=0.1, momentum=momentum, wd=wd,
              clip_gradient=clip, rescale_grad=0.25)
    w0 = _rand(6, 5)
    jo, to = jopt.create("sgd", **kw), topt.create("sgd", **kw)
    jw, tw = mxj.nd.array(w0), torch.from_numpy(w0.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for i in range(3):
        g = _rand(6, 5, seed=10 + i)
        jo.update(0, jw, mxj.nd.array(g), js)
        to.update(0, tw, torch.from_numpy(g), ts)
        np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
        if momentum:
            np.testing.assert_allclose(ts.numpy(), js.asnumpy(), rtol=1e-6,
                                       atol=1e-7)
    assert to.num_update == jo.num_update == 3
    new_w, new_s = to.step_fn(torch.from_numpy(w0), torch.from_numpy(w0),
                              ts, 0.1, wd, 0.25)
    assert new_w.shape == (6, 5) and to.fused_apply_supported()


# -- gradient conventions -----------------------------------------------------

def _dense(grad_req="write"):
    with mx.cpu():
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
    net.weight.grad_req = grad_req
    return net


def test_grad_req_write_add_null():
    x = torch.from_numpy(_rand(2, 4))
    for req in ("write", "add", "null"):
        net = _dense(req)
        grads = []
        for scale in (1.0, 3.0):
            with autograd.record():
                y = net(x) * scale
            autograd.backward(y)
            if req != "null":
                grads.append(net.weight.grad().clone())
        if req == "write":
            assert torch.allclose(grads[1], 3.0 * grads[0])
        elif req == "add":
            assert torch.allclose(grads[1], 4.0 * grads[0])
        else:
            assert not net.weight.data().requires_grad
            with pytest.raises(mx.MXNetError):
                net.weight.grad()
        assert torch.allclose(net.bias.grad(), torch.full((3,), 6.0))
        net.collect_params().zero_grad()
        assert not net.bias.grad().any()


def test_non_scalar_head_seeds_ones():
    net = _dense()
    x = torch.from_numpy(_rand(2, 4))
    with autograd.record():
        y = net(x)
    assert isinstance(y, autograd.Head) and y.shape == (2, 3)
    y.backward()
    np.testing.assert_allclose(net.weight.grad().numpy(),
                               np.tile(x.numpy().sum(0), (3, 1)), rtol=1e-6)
    z = y * 2
    assert type(z) is torch.Tensor          # ops give plain tensors


def test_autograd_grad_and_mark_variables():
    x = torch.from_numpy(_rand(3))
    buf = torch.zeros(3)
    autograd.mark_variables([x], [buf], "add")
    with autograd.record():
        y = x * x
    autograd.backward(y)
    autograd.backward(x * 1.0)
    np.testing.assert_allclose(x.grad.numpy(), 2 * x.detach().numpy() + 1,
                               rtol=1e-6)
    before = x.grad.clone()
    with autograd.record():
        y = (x * x * x).sum()
    g = autograd.grad(y, x)
    np.testing.assert_allclose(g.numpy(), 3 * x.detach().numpy() ** 2,
                               rtol=1e-6)
    assert torch.equal(x.grad, before)      # grad() leaves .grad alone


def test_record_and_pause_scopes():
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording() and not autograd.is_training()
            assert not torch.is_grad_enabled()
        with autograd.record(train_mode=False):
            assert autograd.is_recording() and not autograd.is_training()
    assert not autograd.is_recording()


def test_trainer_stale_gradient():
    net = _dense()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    x = torch.from_numpy(_rand(2, 4))
    with autograd.record():
        y = net(x)
    y.backward()
    w0 = net.weight.data().detach().clone()
    trainer.step(2)
    assert not torch.equal(net.weight.data(), w0)
    with pytest.raises(UserWarning):
        trainer.step(2)                     # no backward since the step
    w1 = net.weight.data().detach().clone()
    trainer.step(2, ignore_stale_grad=True)  # skipped, not re-applied
    assert torch.equal(net.weight.data(), w1)


def test_trainer_rejects_distributed_kvstore():
    net = _dense()
    with pytest.raises(NotImplementedError):
        mx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")


def test_precision_policy_sets_both_tf32_switches():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        with mx.precision.matmul_precision("float32"):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            assert mx.precision.get_matmul_precision() == "float32"
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == saved
        prev = mx.precision.set_matmul_precision("default")
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        mx.precision.set_matmul_precision(prev)
        with pytest.raises(ValueError):
            mx.precision.set_matmul_precision("bfloat16x9")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_recording_a_fused_net_raises():
    """The fused conv kernel has no backward yet, so recording through a
    fuse=True net raises on the CPU too, in predict mode as in training;
    serving outside recording still runs."""
    layers, channels = NARROW
    net = tres.ResNetV1(tres.BottleneckV1, layers, channels, classes=10,
                        thumbnail=True, layout="NHWC", fuse=True)
    net.initialize(ctx=mx.cpu())
    x = torch.rand(2, 3, 16, 16)
    net(x)
    for train_mode in (False, True):
        with pytest.raises((mx.MXNetError, NotImplementedError)):
            with autograd.record(train_mode=train_mode):
                net(x)
    with autograd.record(train_mode=False):
        with pytest.raises(mx.MXNetError):
            net(x)
    with autograd.predict_mode():
        assert net(x).shape == (2, 10)


# -- two training steps of a narrow ResNet ------------------------------------

def test_narrow_resnet_trains_like_jax(monkeypatch):
    """ResNetV1 bottleneck [1,1,1,1] x [16..256], NHWC, fuse=False, f32,
    batch 4 of 32x32, SGD lr 0.01 momentum 0.9, two steps from the same
    weights. Per step: the loss within 1e-5 relative, every gradient
    within 1e-4 of its largest magnitude, every parameter and running
    statistic after the step within 1e-5 of its largest magnitude."""
    monkeypatch.setenv("MXTPU_FUSED_BN", "interpret")
    layers, channels = NARROW
    x = np.random.RandomState(1).rand(4, 3, 32, 32).astype("float32")
    y = _labels(4, 10, seed=2)
    jnet = jres.ResNetV1(jres.BottleneckV1, layers, channels, classes=10,
                         thumbnail=True, layout="NHWC", fuse=False)
    jnet.initialize()
    jnet(mxj.nd.array(np.zeros_like(x)))
    jp = jnet._collect_params_with_prefix()
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jp.items()}, seed=3)
    for k, p in jp.items():
        p.set_data(mxj.nd.array(arrays[k]))
    net = tres.ResNetV1(tres.BottleneckV1, layers, channels, classes=10,
                        thumbnail=True, layout="NHWC", fuse=False)
    net.initialize(ctx=mx.cpu())
    convert.load_numpy_params(net, arrays)
    tp = net._collect_params_with_prefix()
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    jtrainer = mxj.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    jl, tl = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        with mxj.autograd.record():
            jloss_v = jl(jnet(mxj.nd.array(x)), mxj.nd.array(y))
        jloss_v.backward()
        with autograd.record():
            loss = tl(net(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        ref = jloss_v.asnumpy()
        np.testing.assert_allclose(loss.detach().numpy(), ref, rtol=1e-5)
        for k, p in tp.items():
            if p.grad_req == "null":
                continue
            g, gr = p.grad().numpy(), jp[k].grad().asnumpy()
            assert np.abs(g - gr).max() <= 1e-4 * np.abs(gr).max(), k
        jtrainer.step(4)
        trainer.step(4)
        for k, p in tp.items():
            w, wr = p.data().detach().numpy(), jp[k].data().asnumpy()
            assert np.abs(w - wr).max() <= 1e-5 * np.abs(wr).max(), k
    moved = tp["features.1.0.body.1.running_mean"].data()
    assert not torch.allclose(moved, torch.from_numpy(
        arrays["features.1.0.body.1.running_mean"]))


def test_loaded_weights_do_not_alias_the_arrays():
    """Training updates parameters in place; the numpy arrays they were
    loaded from stay as they were."""
    net = tres.ResNetV1(tres.BottleneckV1, *NARROW, classes=10,
                        thumbnail=True, layout="NHWC", fuse=False)
    net.initialize(ctx=mx.cpu())
    shapes = convert.param_shapes(net)      # deferred: dims of 0
    net(torch.zeros(1, 3, 8, 8))
    arrays = convert.random_numpy_params(convert.param_shapes(net))
    fresh = tres.ResNetV1(tres.BottleneckV1, *NARROW, classes=10,
                          thumbnail=True, layout="NHWC", fuse=False)
    fresh.initialize(ctx=mx.cpu())
    assert convert.param_shapes(fresh) == shapes
    convert.load_numpy_params(fresh, arrays)  # stores from the arrays
    saved = {k: a.copy() for k, a in arrays.items()}
    trainer = mx.gluon.Trainer(fresh.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    with autograd.record():
        loss = tloss.SoftmaxCrossEntropyLoss()(
            fresh(torch.rand(2, 3, 8, 8)), torch.tensor([1.0, 2.0]))
    loss.backward()
    trainer.step(2)
    assert all(np.array_equal(arrays[k], saved[k]) for k in arrays)
    w = fresh._collect_params_with_prefix()["features.0.weight"].data()
    assert not np.array_equal(w.detach().numpy(),
                              arrays["features.0.weight"])
