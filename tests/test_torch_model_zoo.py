"""The port's vision model zoo held against the JAX package's on the CPU.

- ``get_model`` takes the JAX package's 34 names, raises ValueError for an
  unknown one, and for ``pretrained=True`` an exception of the type JAX
  raises (RuntimeError; the port's MXNetError is one).
- Every name builds with JAX's structural parameter keys and shapes, so
  ``convert.load_numpy_params`` carries any zoo model's weights across.
- Each family at the smallest size its architecture admits, batch 1
  (224x224; Inception V3 at 299; ResNet-18 V2 in NCHW and NHWC): the same
  weights from numpy seed 3 (He-scaled, ``convert.random_numpy_params``)
  and the same image give eval-mode logits within 1e-5 of the largest
  |logit|.
- A narrow ResNet V2 (bottleneck, one unit per stage, widths 16-256) in
  NHWC takes one step through ``gluon.train_step`` with
  ``MXTPU_FUSED_APPLY=1`` like the JAX package's eager step, within
  ``tests/test_torch_train.py``'s bounds (loss 1e-5 relative, gradients
  1e-4 and parameters and running statistics 1e-5 of their largest
  magnitude), but for one gradient (``WIDER``): the stem BatchNorm's gamma,
  a sum of dy * x_hat over 4 x 16 x 16 rows that cancels to about 1% of
  its terms. Both float32 results differ from the port's float64 one by
  4.7e-4 (port) and 5.4e-4 (JAX) of its largest magnitude, so it is held
  to 2e-3. Its BatchNorms take the training BatchNorm's plain versions
  on the CPU, as its kernels on the card: each forward runs the statistics
  and apply once per BatchNorm, and the backward runs once per BatchNorm
  but the one on the image, which has no parameter to train and no input
  gradient to give.

The JAX side runs hybridized (one jitted graph), which is quicker here
than its op-by-op eager form.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import batchnorm_fused as BNF

NAMES = sorted(jvision._models)
LOGIT_RTOL = 1e-5
FAMILIES = [("mobilenet0.25", 224, {}), ("mobilenetv2_0.25", 224, {}),
            ("squeezenet1.1", 224, {}), ("vgg11", 224, {}),
            ("alexnet", 224, {}), ("densenet121", 224, {}),
            ("inceptionv3", 299, {}), ("resnet18_v2", 224, {}),
            ("resnet18_v2", 224, {"layout": "NHWC"})]
NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
GRAD_RTOL = 1e-4
WIDER = {"features.2.gamma": 2e-3}


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def test_get_model_takes_jax_names():
    assert len(NAMES) == 34
    assert sorted(tvision._models) == NAMES
    assert mx.gluon.model_zoo.get_model is tvision.get_model
    for pkg in (jvision, tvision):
        with pytest.raises(ValueError):
            pkg.get_model("resnet1337_v9")


@pytest.mark.parametrize("name", NAMES)
def test_pretrained_raises_as_jax(name):
    with pytest.raises(Exception) as jexc:
        jvision.get_model(name, pretrained=True)
    with pytest.raises(Exception) as texc:
        tvision.get_model(name, pretrained=True)
    assert isinstance(texc.value, type(jexc.value)), (texc.value, jexc.value)
    assert isinstance(texc.value, RuntimeError)


@pytest.mark.parametrize("name", NAMES)
def test_structural_keys_and_shapes_match_jax(name):
    """The same structural parameter names, with the same shapes where
    construction fixes them (0 where the first forward decides)."""
    jnet = jvision.get_model(name, classes=7)
    net = tvision.get_model(name, classes=7)
    jshapes = {k: tuple(p.shape) for k, p in
               jnet._collect_params_with_prefix().items()}
    assert convert.param_shapes(net) == jshapes


@pytest.mark.parametrize("name,size,kw", FAMILIES,
                         ids=["%s%s" % (n, "-" + k["layout"] if k else "")
                              for n, _, k in FAMILIES])
def test_family_logits_match_jax(name, size, kw):
    x = np.random.RandomState(0).rand(1, 3, size, size).astype("float32")
    jnet = jvision.get_model(name, classes=10, **kw)
    jnet.initialize()
    jnet.infer_shape(mxj.nd.array(x))
    jp = jnet._collect_params_with_prefix()
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jp.items()}, seed=3)
    for k, p in jp.items():
        p.set_data(mxj.nd.array(arrays[k]))
    jnet.hybridize()
    ref = jnet(mxj.nd.array(x)).asnumpy()
    net = tvision.get_model(name, classes=10, **kw)
    net.initialize(ctx=mx.cpu())
    convert.load_numpy_params(net, arrays)
    out = net(mx.nd.array(x)).asnumpy()
    assert out.shape == ref.shape == (1, 10)
    scale = np.abs(ref).max()
    assert scale > 0.05, scale          # the weights give non-trivial logits
    assert np.abs(out - ref).max() <= LOGIT_RTOL * scale


def _v2_pair():
    x = np.zeros((1, 3, 32, 32), "float32")
    jnet = jres.ResNetV2(jres.BottleneckV2, *NARROW, classes=10,
                         layout="NHWC")
    jnet.initialize()
    jnet.infer_shape(mxj.nd.array(x))
    jp = jnet._collect_params_with_prefix()
    arrays = convert.random_numpy_params(
        {k: p.shape for k, p in jp.items()}, seed=3)
    for k, p in jp.items():
        p.set_data(mxj.nd.array(arrays[k]))
    jnet.hybridize()
    net = tres.ResNetV2(tres.BottleneckV2, *NARROW, classes=10,
                        layout="NHWC")
    net.initialize(ctx=mx.cpu())
    convert.load_numpy_params(net, arrays)
    return jnet, net


def _counting(monkeypatch):
    counts = {}
    for name in ("stats_reference", "apply_reference",
                 "bwd_reduce_reference", "bwd_dx_reference"):
        real = getattr(BNF, name)

        def wrapped(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(BNF, name, wrapped)
    return counts


def test_narrow_resnet_v2_nhwc_trains_like_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_BN", "interpret")
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1")
    x = np.random.RandomState(1).rand(4, 3, 32, 32).astype("float32")
    y = np.random.RandomState(2).randint(0, 10, (4,)).astype("float32")
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    jnet, net = _v2_pair()
    jtrainer = mxj.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    net.hybridize()
    step = mx.gluon.train_step(
        net, tloss.SoftmaxCrossEntropyLoss(),
        mx.gluon.Trainer(net.collect_params(), "sgd", dict(opt)))
    jl = jloss.SoftmaxCrossEntropyLoss()
    jp, tp = jnet._collect_params_with_prefix(), \
        net._collect_params_with_prefix()
    counts = _counting(monkeypatch)
    n_bn = sum(k.endswith("running_var") for k in tp)
    assert n_bn == 1 + 1 + 3 * 4 + 1
    for it in range(1):
        with mxj.autograd.record():
            jloss_v = jl(jnet(mxj.nd.array(x)), mxj.nd.array(y))
        jloss_v.backward()
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        assert step.last_mode == "fused"
        np.testing.assert_allclose(loss.numpy(), jloss_v.asnumpy(),
                                   rtol=1e-5)
        for k, p in tp.items():
            if p.grad_req == "null":
                continue
            g, gr = p._grad_tensor().numpy(), jp[k].grad().asnumpy()
            tol = WIDER.get(k, GRAD_RTOL)
            assert np.abs(g - gr).max() <= tol * np.abs(gr).max(), k
        jtrainer.step(4)
        for k, p in tp.items():
            w, wr = p._tensor().detach().numpy(), jp[k].data().asnumpy()
            assert np.abs(w - wr).max() <= 1e-5 * np.abs(wr).max(), k
        want = {"stats_reference": n_bn, "apply_reference": n_bn,
                "bwd_reduce_reference": n_bn - 1,
                "bwd_dx_reference": n_bn - 1}
        assert counts == {k: (it + 1) * n for k, n in want.items()}, counts
    # the image's BatchNorm has neither scale nor shift to train
    assert tp["features.0.gamma"].grad_req == "null"
    assert tp["features.0.beta"].grad_req == "null"
    moved = tp["features.0.running_mean"]._tensor()
    assert not torch.equal(moved, torch.zeros(3))


def test_resnet50_v2_nhwc_batchnorm_count():
    """ResNet-50 V2: 51 BatchNorms (the image's, the stem's, three per
    bottleneck unit over 16 units, and the last), all channels-last in
    NHWC, the image's over C = 3."""
    net = tvision.get_model("resnet50_v2", layout="NHWC")
    bns = [m for m in net.modules() if isinstance(m, mx.gluon.nn.BatchNorm)]
    assert len(bns) == 51
    assert all(b._axis == -1 for b in bns)
    first = net.features[0]
    assert isinstance(first, mx.gluon.nn.BatchNorm)
    assert not first._scale and not first._center
    assert tres.resnet50_v2(layout="NHWC")._layout == "NHWC"
