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


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("clip", [None, 0.05])
def test_sgd_update_bf16_matches_jax_bitwise(momentum, clip):
    """Three bf16 updates equal the JAX package's SGD.update bit for bit.
    JAX's weak typing rounds lr, wd, rescale, the momentum and the clip
    bound to bf16 before each op; the port rounds them the same way
    (PyTorch alone would keep them at f32 op precision, and 1355 of 4096
    momentum values came out different)."""
    kw = dict(learning_rate=0.01, momentum=momentum, wd=1e-4,
              clip_gradient=clip, rescale_grad=1.0 / 128)
    jo, to = jopt.create("sgd", **kw), topt.create("sgd", **kw)
    rs = np.random.RandomState(5)
    w0 = rs.randn(4096).astype("float32")
    jw = mxj.nd.array(w0).astype("bfloat16")
    tw = torch.from_numpy(w0).bfloat16()
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for _ in range(3):
        g = (rs.randn(4096) * 30).astype("float32")
        jo.update(0, jw, mxj.nd.array(g).astype("bfloat16"), js)
        to.update(0, tw, torch.from_numpy(g).bfloat16(), ts)
        assert np.array_equal(tw.view(torch.int16).numpy(),
                              np.asarray(jw._data).view(np.int16))
        if momentum:
            assert np.array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js._data).view(np.int16))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_multi_precision_matches_jax_bitwise(momentum):
    """multi_precision=True: a bf16 weight steps on its f32 master copy and
    takes the master's value rounded to bf16. Over three updates against
    the JAX package's update_multi_precision the bf16 weight is equal bit
    for bit and the f32 master and momentum within the f32 update's bound
    (test_sgd_update_matches_jax: XLA may contract the f32 chain into
    FMAs); the pure step_fn_multi_precision equals the in-place update bit
    for bit."""
    kw = dict(learning_rate=0.01, momentum=momentum, wd=1e-4,
              rescale_grad=1.0 / 128, multi_precision=True)
    jo, to = jopt.create("sgd", **kw), topt.create("sgd", **kw)
    rs = np.random.RandomState(8)
    w0 = rs.randn(2048).astype("float32")
    jw = mxj.nd.array(w0).astype("bfloat16")
    tw = torch.from_numpy(w0).bfloat16()
    js = jo.create_state_multi_precision(0, jw)
    ts = to.create_state_multi_precision(0, tw)
    pw, ps = tw.clone(), to.create_state_multi_precision(0, tw)
    for _ in range(3):
        g = (rs.randn(2048) * 30).astype("float32")
        tg = torch.from_numpy(g).bfloat16()
        jo.update_multi_precision(0, jw, mxj.nd.array(g).astype("bfloat16"),
                                  js)
        to.update_multi_precision(0, tw, tg, ts)
        pw, ps = to.step_fn_multi_precision(pw, tg, ps, 0.01, 1e-4, 1.0 / 128)
        assert np.array_equal(tw.view(torch.int16).numpy(),
                              np.asarray(jw._data).view(np.int16))
        assert torch.equal(pw, tw)
        for t, p, j in zip((ts[0], ts[1]), (ps[0], ps[1]), (js[0], js[1])):
            if j is None:
                assert t is None and p is None
                continue
            np.testing.assert_allclose(t.numpy(), np.asarray(j._data),
                                       rtol=1e-6, atol=1e-7)
            assert torch.equal(p, t)


def test_batchnorm_running_statistics_bf16_match_jax():
    """A bf16 BatchNorm moves its running statistics with the momentum
    rounded as JAX's weak typing rounds it: bit for bit with the JAX
    layer (single-pass statistics on both sides)."""
    x = (np.random.RandomState(6).randn(8, 5, 5, 16) * 2 + 1) \
        .astype("float32")
    rs = np.random.RandomState(7)
    stats = {"running_mean": rs.randn(16).astype("float32"),
             "running_var": (rs.rand(16) + 0.5).astype("float32")}
    jbn = mxj.gluon.nn.BatchNorm(axis=-1, in_channels=16)
    jbn.initialize()
    tbn = mx.gluon.nn.BatchNorm(axis=-1, in_channels=16)
    tbn.initialize(ctx=mx.cpu())
    for bn, setp in ((jbn, mxj.nd.array), (tbn, torch.from_numpy)):
        for k, v in stats.items():
            getattr(bn, k).set_data(setp(v))
        bn.cast("bfloat16")
    with mxj.autograd.record():
        jbn(mxj.nd.array(x).astype("bfloat16"))
    with autograd.record():
        tbn(torch.from_numpy(x).bfloat16())
    for k in stats:
        got = getattr(tbn, k)._tensor().detach()
        want = np.asarray(getattr(jbn, k).data()._data)
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16)), k


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
                grads.append(net.weight._grad_tensor().clone())
        if req == "write":
            assert torch.allclose(grads[1], 3.0 * grads[0])
        elif req == "add":
            assert torch.allclose(grads[1], 4.0 * grads[0])
        else:
            assert not net.weight._tensor().requires_grad
            with pytest.raises(mx.MXNetError):
                net.weight._grad_tensor()
        assert torch.allclose(net.bias._grad_tensor(), torch.full((3,), 6.0))
        net.collect_params().zero_grad()
        assert not net.bias._grad_tensor().any()


def test_non_scalar_head_seeds_ones():
    net = _dense()
    x = torch.from_numpy(_rand(2, 4))
    with autograd.record():
        y = net(x)
    assert isinstance(y, autograd.Head) and y.shape == (2, 3)
    y.backward()
    np.testing.assert_allclose(net.weight._grad_tensor().numpy(),
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
    w0 = net.weight._tensor().detach().clone()
    trainer.step(2)
    assert not torch.equal(net.weight._tensor(), w0)
    with pytest.raises(UserWarning):
        trainer.step(2)                     # no backward since the step
    w1 = net.weight._tensor().detach().clone()
    trainer.step(2, ignore_stale_grad=True)  # skipped, not re-applied
    assert torch.equal(net.weight._tensor(), w1)


def test_trainer_rejects_distributed_kvstore(monkeypatch):
    """A dist_sync string attaches that store, updating on it by default
    (one process: one worker); dist_async, the asynchronous server, is
    rejected, naming M10b."""
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    net = _dense()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    tr._prepare()
    assert tr._kvstore.type == "dist_sync" and tr._update_on_kvstore
    assert tr._kvstore.num_workers == 1
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_async")
    with pytest.raises(NotImplementedError, match="M10b"):
        tr._prepare()


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
    """Recording through a fuse=True net no longer raises: it trains, now
    that the fused conv has a backward, in training mode (batch
    statistics folded into the kernel's scale and bias, running statistics
    moved) and in predict mode (running statistics folded; gradients still
    reach every weight, gamma and beta through the fused link's backward);
    serving outside recording runs the same kernel route."""
    layers, channels = NARROW
    net = tres.ResNetV1(tres.BottleneckV1, layers, channels, classes=10,
                        thumbnail=True, layout="NHWC", fuse=True)
    net.initialize(ctx=mx.cpu())
    x = torch.rand(2, 3, 16, 16)
    y = torch.tensor([1.0, 7.0])
    net(x)
    params = net._collect_params_with_prefix()
    rm = params["features.1.0.body.1.running_mean"]
    for train_mode in (True, False):
        before = rm._tensor().clone()
        net.collect_params().zero_grad()
        with autograd.record(train_mode=train_mode):
            loss = tloss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward()
        for k in ("features.1.0.body.3.weight", "features.1.0.body.1.gamma",
                  "features.1.0.body.1.beta", "features.1.0.body.0.weight"):
            assert params[k]._grad_tensor().abs().sum() > 0, (train_mode, k)
        assert torch.equal(rm._tensor(), before) is not train_mode
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
            g, gr = p._grad_tensor().numpy(), jp[k].grad().asnumpy()
            assert np.abs(g - gr).max() <= 1e-4 * np.abs(gr).max(), k
        jtrainer.step(4)
        trainer.step(4)
        for k, p in tp.items():
            w, wr = p._tensor().detach().numpy(), jp[k].data().asnumpy()
            assert np.abs(w - wr).max() <= 1e-5 * np.abs(wr).max(), k
    moved = tp["features.1.0.body.1.running_mean"]._tensor()
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
    w = fresh._collect_params_with_prefix()["features.0.weight"]._tensor()
    assert not np.array_equal(w.detach().numpy(),
                              arrays["features.0.weight"])


def _narrow_pair(fuse, arrays=None):
    """The JAX and the port's narrow NHWC ResNet, with the same weights
    (from numpy seed 3 unless given)."""
    layers, channels = NARROW
    jnet = jres.ResNetV1(jres.BottleneckV1, layers, channels, classes=10,
                         thumbnail=True, layout="NHWC", fuse=fuse)
    jnet.initialize()
    jnet(mxj.nd.array(np.zeros((1, 3, 32, 32), "float32")))
    jp = jnet._collect_params_with_prefix()
    if arrays is None:
        arrays = convert.random_numpy_params(
            {k: p.shape for k, p in jp.items()}, seed=3)
    for k, p in jp.items():
        p.set_data(mxj.nd.array(arrays[k]))
    net = tres.ResNetV1(tres.BottleneckV1, layers, channels, classes=10,
                        thumbnail=True, layout="NHWC", fuse=fuse)
    net.initialize(ctx=mx.cpu())
    convert.load_numpy_params(net, arrays)
    return jnet, net, arrays


def _state(net, jax_side=False):
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        if jax_side:
            out[k] = (p.data().asnumpy(), None if p.grad_req == "null"
                      else p.grad().asnumpy())
        else:
            out[k] = (p._tensor().detach().numpy().copy(),
                      None if p.grad_req == "null"
                      else p._grad_tensor().numpy().copy())
    return out


def _within(got, want, what):
    """The bounds of test_narrow_resnet_trains_like_jax: gradients within
    1e-4 and parameters/running statistics within 1e-5 of the largest
    magnitude."""
    for k, (w, g) in got.items():
        wr, gr = want[k]
        assert np.abs(w - wr).max() <= 1e-5 * np.abs(wr).max(), (what, k)
        if gr is not None:
            assert np.abs(g - gr).max() <= 1e-4 * np.abs(gr).max(), (what, k)


def test_narrow_fused_resnet_trains_like_jax(monkeypatch):
    """fuse=True on both sides, two steps through gluon.train_step with
    MXTPU_FUSED_APPLY=1 (the port fused from the first step, the JAX step
    warming eagerly then compiled), f32, batch 4 of 32x32, SGD lr 0.01
    momentum 0.9. The bounds of test_narrow_resnet_trains_like_jax: loss
    within 1e-5 relative, gradients within 1e-4 and parameters and running
    statistics within 1e-5 of the largest magnitude. The port's fuse=True
    run also matches its own fuse=False run (eager Trainer) within them."""
    monkeypatch.setenv("MXTPU_FUSED_BN", "interpret")
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1")
    x = np.random.RandomState(1).rand(4, 3, 32, 32).astype("float32")
    y = _labels(4, 10, seed=2)
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    jnet, net, arrays = _narrow_pair(True)
    _, plain, _ = _narrow_pair(False, arrays)
    jnet.hybridize()
    net.hybridize()
    jstep = mxj.gluon.train_step(
        jnet, jloss.SoftmaxCrossEntropyLoss(),
        mxj.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt)))
    step = mx.gluon.train_step(
        net, tloss.SoftmaxCrossEntropyLoss(),
        mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt)))
    ptrainer = mx.gluon.Trainer(plain.collect_params(), "sgd", dict(opt))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(2):
        ref = jstep(mxj.nd.array(x), mxj.nd.array(y)).asnumpy()
        loss = step(xt, yt)
        assert step.last_mode == "fused"
        with autograd.record():
            ploss = tloss.SoftmaxCrossEntropyLoss()(plain(xt), yt)
        ploss.backward()
        ptrainer.step(4)
        np.testing.assert_allclose(loss.numpy(), ref, rtol=1e-5)
        np.testing.assert_allclose(ploss.detach().numpy(), ref, rtol=1e-5)
        got = _state(net)
        _within(got, _state(jnet, jax_side=True), "jax")
        _within(got, _state(plain), "fuse=False")
    assert jstep.last_mode == "compile"


def test_bn_fold_gradient_matches_jax():
    """The training-mode fold of the fused link (batch_moments recorded on
    the tape, exact_sq's split point detached, rsqrt) against jax.grad
    through the JAX package's _fused_bn_fold: s, b and the statistics
    within 1e-6, the gradients of a weighted sum of s and b within 1e-5 of
    their largest magnitude, f32."""
    import jax
    rs = np.random.RandomState(4)
    y = (rs.randn(3, 5, 4, 12) * 2 + 0.5).astype("float32")
    g = (rs.rand(12) + 0.5).astype("float32")
    bt = (rs.randn(12) * 0.1).astype("float32")
    a, c = rs.randn(2, 12).astype("float32")
    jfold = jres._fused_opdefs()[0].fn
    tfold = tres._fused_opdefs()[0].fn

    def jloss_fn(y_, g_, b_):
        s, b, _, _ = jfold(y_, g_, b_, eps=1e-5)
        return jnp.sum(s * a + b * c)

    jouts = jfold(jnp.asarray(y), jnp.asarray(g), jnp.asarray(bt), eps=1e-5)
    jgrads = jax.grad(jloss_fn, argnums=(0, 1, 2))(
        jnp.asarray(y), jnp.asarray(g), jnp.asarray(bt))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (y, g, bt)]
    touts = tfold(*leaves, eps=1e-5)
    (touts[0] * torch.from_numpy(a) + touts[1] * torch.from_numpy(c)) \
        .sum().backward()
    for o, r in zip(touts, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-6, atol=1e-6)
    for t, r in zip(leaves, jgrads):
        r = np.asarray(r)
        assert np.abs(t.grad.numpy() - r).max() <= 1e-5 * np.abs(r).max()
