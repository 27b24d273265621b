"""The port's Gluon layers (``gluon/nn``) held against the JAX package's
on the CPU, and ``Block.summary``.

Each case builds the layer in both packages, runs the JAX one once to
finish its deferred shapes, draws every parameter from a numpy seed
(uniform in [-1, 1]; gamma-like ones in [0.5, 1.5]) and loads the values
into both (``convert.load_numpy_params`` on the port side, by the
structural names both produce). Then the forward outside training and the
gradients of sum(out * cot) with respect to the input and every
parameter, under ``autograd.record()`` in both.

Tolerances, relative to the largest magnitude of the JAX result: the
forward in float32 1e-5, the gradients 1e-5, and 1e-4 for the
normalization layers (their gradients subtract means of products over the
normalized axes, in another summation order).
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert

F32 = 1e-5
GRAD = 1e-5
GRAD_NORM = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _seq(nn):
    net = nn.Sequential()
    net.add(nn.Dense(5, in_units=4), nn.Activation("tanh"),
            nn.Dense(3, in_units=5))
    return net


def _hseq(nn):
    # a rate of 0 keeps Dropout the identity under record() too: the two
    # packages' masks come from different generators
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, groups=2, activation="relu"),
            nn.BatchNorm(), nn.Dropout(0.0), nn.GlobalAvgPool2D(),
            nn.Flatten())
    return net


# name -> (constructor given the nn module, input shape, index input,
#          gradient bound)
CASES = {
    "Sequential": (_seq, (3, 4), False, GRAD),
    "HybridSequential+Dropout": (_hseq, (2, 4, 5, 5), False, GRAD_NORM),
    "InstanceNorm": (lambda nn: nn.InstanceNorm(), (2, 3, 4, 5), False,
                     GRAD_NORM),
    "InstanceNorm-scale": (lambda nn: nn.InstanceNorm(scale=True,
                                                      epsilon=1e-3),
                           (2, 3, 6), False, GRAD_NORM),
    "LayerNorm": (lambda nn: nn.LayerNorm(), (3, 4, 5), False, GRAD_NORM),
    "LayerNorm-axis1": (lambda nn: nn.LayerNorm(axis=1, center=False),
                        (3, 4, 5), False, GRAD_NORM),
    "GroupNorm": (lambda nn: nn.GroupNorm(num_groups=2), (2, 4, 3, 3),
                  False, GRAD_NORM),
    "Embedding": (lambda nn: nn.Embedding(10, 4), (3, 5), True, GRAD),
    "Lambda-name": (lambda nn: nn.Lambda("tanh"), (3, 4), False, GRAD),
    "Lambda-fn": (lambda nn: nn.Lambda(lambda x: x * 2 + 1), (3, 4), False,
                  GRAD),
    "HybridLambda-name": (lambda nn: nn.HybridLambda("sigmoid"), (3, 4),
                          False, GRAD),
    "HybridLambda-fn": (lambda nn: nn.HybridLambda(lambda x: x * x),
                        (3, 4), False, GRAD),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.1), (3, 4), False, GRAD),
    "PReLU": (lambda nn: nn.PReLU(), (2, 3, 4), False, GRAD),
    "ELU": (lambda nn: nn.ELU(0.5), (3, 4), False, GRAD),
    "SELU": (lambda nn: nn.SELU(), (3, 4), False, GRAD),
    "GELU": (lambda nn: nn.GELU(), (3, 4), False, GRAD),
    "Swish": (lambda nn: nn.Swish(1.5), (3, 4), False, GRAD),
    "Conv1D": (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1),
               (2, 3, 9), False, GRAD),
    "Conv1D-NWC": (lambda nn: nn.Conv1D(4, 3, dilation=2, layout="NWC",
                                        use_bias=False),
                   (2, 9, 3), False, GRAD),
    "Conv3D": (lambda nn: nn.Conv3D(3, 2, activation="relu"),
               (1, 2, 4, 5, 5), False, GRAD),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(
        3, 3, strides=2, output_padding=1), (2, 4, 5), False, GRAD),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), (2, 4, 5, 5), False,
        GRAD),
    "Conv2DTranspose-NHWC": (lambda nn: nn.Conv2DTranspose(
        4, 2, strides=2, groups=2, layout="NHWC"), (2, 3, 3, 4), False,
        GRAD),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(2, 2, strides=2),
                        (1, 3, 3, 3, 3), False, GRAD),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2, 1), (2, 3, 9), False, GRAD),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(ceil_mode=True),
                  (1, 2, 5, 5, 5), False, GRAD),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, padding=1,
                                          count_include_pad=False),
                  (2, 3, 10), False, GRAD),
    "AvgPool2D": (lambda nn: nn.AvgPool2D(3, 2, 1, ceil_mode=True),
                  (2, 3, 8, 9), False, GRAD),
    "AvgPool2D-NHWC": (lambda nn: nn.AvgPool2D(2, layout="NHWC"),
                       (2, 6, 6, 3), False, GRAD),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(2), (1, 2, 4, 4, 6), False, GRAD),
    "GlobalMaxPool1D": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 7), False,
                        GRAD),
    "GlobalMaxPool2D": (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 4, 5),
                        False, GRAD),
    "GlobalMaxPool3D": (lambda nn: nn.GlobalMaxPool3D(), (1, 2, 3, 4, 5),
                        False, GRAD),
    "GlobalAvgPool1D": (lambda nn: nn.GlobalAvgPool1D(), (2, 3, 7), False,
                        GRAD),
    "GlobalAvgPool2D-NHWC": (lambda nn: nn.GlobalAvgPool2D(layout="NHWC"),
                             (2, 4, 5, 3), False, GRAD),
    "GlobalAvgPool3D": (lambda nn: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 5),
                        False, GRAD),
    "ReflectionPad2D": (lambda nn: nn.ReflectionPad2D(2), (2, 3, 5, 6),
                        False, GRAD),
}


def _values(shapes, seed):
    rs = np.random.RandomState(seed)
    out = {}
    for k in sorted(shapes):
        lo, hi = (0.5, 1.5) if k.rsplit(".", 1)[-1] in (
            "gamma", "running_var", "alpha") else (-1.0, 1.0)
        out[k] = rs.uniform(lo, hi, shapes[k]).astype("float32")
    return out


def _within(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, (what, err, tol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    make, shape, index, gtol = CASES[case]
    rs = np.random.RandomState(sum(map(ord, case)))
    x = rs.randint(0, 10, shape).astype("float32") if index \
        else rs.uniform(-2, 2, shape).astype("float32")
    jnet, net = make(mxj.gluon.nn), make(mx.gluon.nn)
    jnet.initialize()
    jnet(mxj.nd.array(x))
    jp = jnet._collect_params_with_prefix()
    tp = net._collect_params_with_prefix()
    assert set(jp) == set(tp), case
    arrays = _values({k: p.shape for k, p in jp.items()}, 3)
    for k, p in jp.items():
        p.set_data(mxj.nd.array(arrays[k]))
    net.initialize(ctx=mx.cpu())
    convert.load_numpy_params(net, arrays)
    want = jnet(mxj.nd.array(x)).asnumpy()
    got = net(mx.nd.array(x))
    assert isinstance(got, mx.nd.NDArray)
    _within(got.asnumpy(), want, F32, case)

    cot = rs.uniform(-1, 1, want.shape).astype("float32")
    jx, tx = mxj.nd.array(x), mx.nd.array(x)
    if not index:
        jx.attach_grad()
        tx.attach_grad()
    with mxj.autograd.record():
        jl = (jnet(jx) * mxj.nd.array(cot)).sum()
    jl.backward()
    with mx.autograd.record():
        tl = (net(tx) * mx.nd.array(cot)).sum()
    tl.backward()
    if not index:
        _within(tx.grad.asnumpy(), jx.grad.asnumpy(), gtol, case + " dx")
    for k, p in tp.items():
        if p.grad_req == "null":
            assert jp[k].grad_req == "null", (case, k)
            continue
        _within(p.grad().asnumpy(), jp[k].grad().asnumpy(), gtol,
                "%s d%s" % (case, k))


def test_every_jax_layer_class_is_ported():
    jnames = set(mxj.gluon.nn.__all__)
    missing = sorted(n for n in jnames if not hasattr(mx.gluon.nn, n))
    assert not missing, missing
    assert len(jnames) >= 38


def test_summary_matches_jax():
    """``summary`` runs the block (finishing deferred shapes) and counts its
    parameter values, running statistics included, as JAX's does."""
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype("float32")
    outs = []
    for pkg, arr in ((mxj, mxj.nd.array), (mx, mx.nd.array)):
        nn = pkg.gluon.nn
        net = nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(nn.Conv2D(4, 3), nn.BatchNorm(), nn.Dense(5))
        if pkg is mx:
            net.initialize(ctx=mx.cpu())
        else:
            net.initialize()
        outs.append(net.summary(arr(x)))
    assert outs[0] == outs[1] == "net: %d parameters" % (
        4 * 3 * 9 + 4 + 4 * 4 + 5 * 4 * 36 + 5)


def test_initializers_of_the_new_layers():
    """PReLU's slope starts at 0.25 and VGG's "normal" initializer draws
    N(0, 0.01) from the port's host generator."""
    p = mx.gluon.nn.PReLU()
    p.initialize(ctx=mx.cpu())
    assert p.alpha.data().asnumpy().tolist() == [0.25]
    mx.random.seed(0)
    d = mx.gluon.nn.Dense(300, in_units=400, weight_initializer="normal")
    d.initialize(ctx=mx.cpu())
    w = d.weight.data().asnumpy()
    assert abs(w.std() - 0.01) < 0.0005 and abs(w.mean()) < 0.0005
