"""The port's ShardedTrainStep (mxnet_tpu_torch/parallel/train.py) held
against the JAX package's (mxnet_tpu/parallel/train.py) on a one-device
mesh, on the CPU.

``functional_call`` equals the eager forward and leaves the block as it
was (its running-statistic updates come back instead of being written).
Two f32 steps of the narrow NHWC ResNet of test_torch_train.py, fuse False
and True, match JAX's step on ``create_mesh(devices=jax.devices()[:1],
dp=1)`` within the bounds of test_narrow_resnet_trains_like_jax: the loss
within 1e-5 relative, every parameter and running statistic within 1e-5
of its largest magnitude. ``remat_policy="conv_outs"`` gives the same bits
as no remat, updates the running statistics once per step, and launches
no convolution again (the fused conv's and the 3x3 convolutions' forwards
run once per step; the training BatchNorm's, an autograd Function, twice).
The JAX side runs its BatchNorm through its Pallas kernel in interpret
mode (``MXTPU_FUSED_BN=interpret``).
"""
import collections

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as mxj
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.parallel import create_mesh as jcreate_mesh
from mxnet_tpu.parallel import data_parallel as jdata_parallel
from mxnet_tpu.parallel import fsdp as jfsdp
from mxnet_tpu.parallel import ShardedTrainStep as JShardedTrainStep
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import batchnorm_fused as BNF
from mxnet_tpu_torch.parallel import (ShardedTrainStep, create_mesh,
                                      data_parallel, extract_params, fsdp,
                                      functional_call)

NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])
CPU = [torch.device("cpu")]
SGD = {"learning_rate": 0.01, "momentum": 0.9}


def _batch(n=4):
    x = np.random.RandomState(1).rand(n, 3, 32, 32).astype("float32")
    y = np.random.RandomState(2).randint(0, 10, (n,)).astype("float32")
    return x, y


def _narrow(fuse, arrays=None):
    """The port's narrow NHWC ResNet with the weights of numpy seed 3."""
    net = tres.ResNetV1(tres.BottleneckV1, *NARROW, classes=10,
                        thumbnail=True, layout="NHWC", fuse=fuse)
    net.initialize(ctx=mx.cpu())
    net(torch.zeros(1, 3, 32, 32))
    if arrays is None:
        arrays = convert.random_numpy_params(convert.param_shapes(net),
                                             seed=3)
    convert.load_numpy_params(net, arrays)
    return net, arrays


def _jnarrow(fuse, arrays):
    jnet = jres.ResNetV1(jres.BottleneckV1, *NARROW, classes=10,
                         thumbnail=True, layout="NHWC", fuse=fuse)
    jnet.initialize()
    jnet(mxj.nd.array(np.zeros((1, 3, 32, 32), "float32")))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(arrays[k]))
    return jnet


def _step(net, opt=("sgd", SGD), remat_policy=None):
    mesh = create_mesh(devices=CPU, dp=1)
    return ShardedTrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                            topt.create(opt[0], **opt[1]),
                            strategy=data_parallel(mesh),
                            remat_policy=remat_policy)


def _params(step):
    return {k: v.detach().clone() for k, v in step.params.items()}


def _within(got, want, rtol=1e-5):
    """Every tensor within rtol of its largest magnitude (the parameter
    bound of test_narrow_resnet_trains_like_jax)."""
    assert set(got) == set(want)
    for k, w in got.items():
        w = w.detach().float().numpy()
        r = np.asarray(want[k], dtype="float32")
        assert np.abs(w - r).max() <= rtol * np.abs(r).max(), k


def test_functional_call_matches_eager():
    """functional_call of a Dense equals its eager forward (the JAX suite's
    test_functional_call_matches_eager), and a BatchNorm net's running
    statistics come back as aux without being written."""
    net = mx.gluon.nn.Dense(4, in_units=3)
    net.initialize(ctx=mx.cpu())
    x = torch.from_numpy(np.random.rand(2, 3).astype("float32"))
    want = net(x)
    got = functional_call(net, extract_params(net), [x])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    bnet, _ = _narrow(False)
    before = {k: v.clone() for k, v in extract_params(bnet).items()}
    params = {k: v.clone() for k, v in before.items()}
    xb = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        out, aux = functional_call(bnet, params, [xb], training=True,
                                   return_aux=True)
    assert out.shape == (4, 10)
    stats = [k for k in before if k.endswith(("running_mean",
                                              "running_var"))]
    assert sorted(aux) == sorted(stats)
    for k, v in extract_params(bnet).items():     # the block as it was
        assert torch.equal(v, before[k]), k
    assert any(not torch.equal(aux[k], before[k]) for k in stats)


def test_eager_paths_still_write_running_statistics():
    """Outside functional_call report_aux_update writes in place: one eager
    Trainer step and one gluon.train_step step each move every running
    statistic of the narrow ResNet, in its own tensor, to the value that
    functional_call returns as aux from the same weights and batch."""
    x = torch.from_numpy(_batch()[0])
    y = torch.from_numpy(_batch()[1])
    ref, arrays = _narrow(False)
    with torch.no_grad():
        _, aux = functional_call(ref, extract_params(ref), [x],
                                 training=True, return_aux=True)
    for mode in ("trainer", "train_step"):
        net, _ = _narrow(False, arrays)
        held = dict(extract_params(net))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
        lf = tloss.SoftmaxCrossEntropyLoss()
        if mode == "trainer":
            with autograd.record():
                loss = lf(net(x), y)
            loss.backward()
            tr.step(4)
        else:
            net.hybridize()
            mx.gluon.train_step(net, lf, tr)(x, y)
        now = extract_params(net)
        for k, new in aux.items():
            assert now[k] is held[k], (mode, k)     # written in place
            assert torch.equal(now[k], new), (mode, k)


@pytest.mark.parametrize("fuse", [False, True])
def test_narrow_resnet_matches_jax(fuse, monkeypatch):
    """Two SGD-momentum steps, f32, batch 4, the port's step against JAX's
    on a one-device mesh: each loss within 1e-5 relative, every parameter
    and running statistic within 1e-5 of its largest magnitude."""
    monkeypatch.setenv("MXTPU_FUSED_BN", "interpret")
    x, y = _batch()
    net, arrays = _narrow(fuse)
    jnet = _jnarrow(fuse, arrays)
    step = _step(net)
    jmesh = jcreate_mesh(devices=jax.devices()[:1], dp=1)
    jstep = JShardedTrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                              jopt.create("sgd", **SGD),
                              strategy=jdata_parallel(jmesh))
    for _ in range(2):
        want = jstep(x, y)
        got = step(x, y)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        _within(step.params, {k: np.asarray(v)
                              for k, v in jstep.params.items()})
    assert step._param_paths == jstep._param_paths
    # every path is updated once a step, in sorted order (JAX's jitted
    # step runs the optimizer's Python once, when it traces, so its counts
    # stay at 1: the port counts every step, as the eager Trainer does)
    n = len(step._param_paths)
    assert step.optimizer._index_update_count == {i: 2 for i in range(n)}
    assert jstep.optimizer._index_update_count == {i: 1 for i in range(n)}


class _Executed(TorchDispatchMode):
    """Counts the ops that run, by name, below any selective checkpoint
    mode: an op whose output a policy kept, and that a recompute therefore
    skips, is not counted again."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("fuse", [False, True])
def test_remat_same_bits_and_stats_once(fuse, monkeypatch):
    """Two steps with remat_policy="conv_outs" against two without, from
    the same weights: losses, parameters, running statistics and optimizer
    state equal bit for bit. Per step the fused conv forward and the 3x3
    convolutions run as often as without remat (their outputs are kept),
    the BatchNorm statistics twice (the recompute replays the autograd
    Function), and each running statistic is written once (its tensor's
    version moves as without remat: the recompute's reports are
    dropped)."""
    x, y = _batch()
    stats_calls = []
    stats = BNF.stats_reference
    monkeypatch.setattr(BNF, "stats_reference",
                        lambda *a: stats_calls.append(1) or stats(*a))
    runs = {}
    for rp in (None, "conv_outs"):
        net, _ = _narrow(fuse)
        step = _step(net, remat_policy=rp)
        del stats_calls[:]
        with _Executed() as ran:
            losses = [step(x, y) for _ in range(2)]
        runs[rp] = (losses, _params(step), step.opt_states, ran.n,
                    len(stats_calls),
                    {k: t._version for k, t in step.params.items()})
    (l0, p0, s0, n0, b0, v0), (l1, p1, s1, n1, b1, v1) = runs[None], \
        runs["conv_outs"]
    assert l0 == l1
    # every tensor written as often: a running statistic by its update
    # and once by the step's aux write, not again by the recompute
    assert v0 == v1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        st0, st1 = s0[k], s1[k]
        assert (st0 is None and st1 is None) or torch.equal(st0, st1), k
    # the kept producers ran once a step: the five 3x3 convolutions (the
    # stem's and the bottlenecks', which with fuse=True run inside the
    # fused conv's plain version on the CPU), the fused conv (4 a step),
    # the 1x1 convolutions and the Dense (mm, forward and backward alike)
    for op in ("convolution", "mm", "fused_scale_relu_conv3x3"):
        assert n1[op] == n0[op], op
    assert n0["fused_scale_relu_conv3x3"] == (8 if fuse else 0)
    assert n0["convolution"] == 2 * 5
    # the BatchNorm's autograd Function (16 BatchNorms, 4 of them folds
    # into the fused conv) ran twice a step under remat
    assert b1 == 2 * b0 == 2 * 2 * (16 - (4 if fuse else 0))


def test_remat_without_sequential_is_one_region():
    """A network with no HybridSequential (one Dense) runs as one region:
    the same bits as without remat."""
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 6)
                         .astype("float32"))
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 4, (8,))
                         .astype("float32"))
    got = []
    for rp in (None, "conv_outs"):
        net = mx.gluon.nn.Dense(4, in_units=6)
        net.initialize(ctx=mx.cpu())
        convert.load_numpy_params(net, {
            "weight": np.linspace(-1, 1, 24, dtype="float32").reshape(4, 6),
            "bias": np.zeros(4, "float32")})
        step = _step(net, remat_policy=rp)
        assert step._segmented is False
        got.append(([step(x, y) for _ in range(3)], _params(step)))
    assert got[0][0] == got[1][0]
    assert all(torch.equal(got[0][1][k], got[1][1][k]) for k in got[0][1])


class _Noisy(mx.gluon.HybridBlock):
    """Adds noise drawn from the port's generator, then a Dense."""

    def __init__(self):
        super().__init__()
        self.dense = mx.gluon.nn.Dense(4, in_units=6)

    def hybrid_forward(self, F, x):
        noise = torch.randn(tuple(x.shape), generator=mx.random.generator())
        return self.dense(x + noise)


def test_remat_recompute_replays_the_random_stream():
    """A region whose forward draws from the port's generator: the
    recompute draws the same numbers (the first run's state replayed), so
    remat gives the same bits as no remat, and the generator's own stream
    moves as far as without remat."""
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 6)
                         .astype("float32"))
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 4, (8,))
                         .astype("float32"))
    got = []
    for rp in (None, "conv_outs"):
        net = mx.gluon.nn.HybridSequential()
        net.add(_Noisy())
        net.initialize(ctx=mx.cpu())
        convert.load_numpy_params(net, {
            "0.dense.weight": np.linspace(-1, 1, 24, dtype="float32")
            .reshape(4, 6), "0.dense.bias": np.zeros(4, "float32")})
        mx.random.seed(11)
        step = _step(net, remat_policy=rp)
        assert step._segmented
        losses = [step(x, y) for _ in range(3)]
        got.append((losses, _params(step),
                    torch.rand(3, generator=mx.random.generator())))
    assert got[0][0] == got[1][0]
    assert all(torch.equal(got[0][1][k], got[1][1][k]) for k in got[0][1])
    assert torch.equal(got[0][2], got[1][2])


def _dense_pair(seed=1):
    rs = np.random.RandomState(seed)
    w = {"weight": rs.uniform(-0.3, 0.3, (8, 64)).astype("float32"),
         "bias": rs.uniform(-0.1, 0.1, (8,)).astype("float32")}
    net = mx.gluon.nn.Dense(8, in_units=64)
    net.initialize(ctx=mx.cpu())
    convert.load_numpy_params(net, w)
    jnet = mxj.gluon.nn.Dense(8, in_units=64)
    jnet.initialize()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(w[k]))
    return net, jnet


def test_dense_adam_matches_jax():
    """The counterpart of the JAX suite's test_sharded_train_step_fsdp on
    one device: a Dense(8) net, Adam lr 0.01, the fsdp strategy with
    min_size 64, six steps at batch 8. Each parameter's PartitionSpec
    equals JAX's. The first step's loss within 1e-5 relative, and its
    parameters and Adam states within 1e-5 of their largest magnitude, of
    JAX's. JAX's jitted step runs the optimizer's Python only when it
    traces, so its Adam keeps the bias correction of update 1 in later
    steps; the port counts every step, as the eager Trainer does, and
    every step equals the eager record/backward/Trainer.step with Adam bit
    for bit (the mean loss's 1/8 and the Trainer's rescale_grad 1/8 are
    exact). The loss falls."""
    net, jnet = _dense_pair()
    ref, _ = _dense_pair()
    tr = mx.gluon.Trainer(ref.collect_params(), "adam",
                          {"learning_rate": 0.01})
    mesh = create_mesh(devices=CPU, dp=1, fsdp=1)
    step = ShardedTrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                            topt.create("adam", learning_rate=0.01),
                            strategy=fsdp(mesh, min_size=64))
    jmesh = jcreate_mesh(devices=jax.devices()[:1], dp=1, fsdp=1)
    jstep = JShardedTrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                              jopt.create("adam", learning_rate=0.01),
                              strategy=jfsdp(jmesh, min_size=64))
    rs = np.random.RandomState(0)
    x = rs.rand(8, 64).astype("float32")
    y = rs.randint(0, 8, (8,)).astype("float32")
    for k in step.params:
        assert tuple(step._shardings[k].spec) \
            == tuple(jstep._shardings[k].spec), k
    np.testing.assert_allclose(step(x, y), jstep(x, y), rtol=1e-5)
    _within(step.params, {k: np.asarray(v) for k, v in jstep.params.items()})
    for k, (m, v) in step.opt_states.items():
        jm, jv = jstep.opt_states[k]
        _within({"m": m, "v": v}, {"m": np.asarray(jm), "v": np.asarray(jv)})
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    lf = tloss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        first = lf(ref(xt), yt)
    first.backward()
    tr.step(8)
    losses = [float(first.detach().mean())]
    for _ in range(5):
        losses.append(step(x, y))
        with autograd.record():
            loss = lf(ref(xt), yt)
        loss.backward()
        tr.step(8)
        assert float(loss.detach().mean()) == losses[-1]
        for k, p in ref._collect_params_with_prefix().items():
            assert torch.equal(p.data(), step.params[k]), k
    assert losses[-1] < losses[0]


def test_sync_to_block_and_place_batch():
    """The block keeps its weights until sync_to_block, which writes the
    step's parameters back into its own tensors; place_batch puts the
    batch on the mesh's device once and step takes it as it is."""
    net, _ = _narrow(False)
    held = {k: v for k, v in extract_params(net).items()}
    before = {k: v.clone() for k, v in held.items()}
    step = _step(net)
    xd, yd = step.place_batch(*_batch())
    assert isinstance(xd, torch.Tensor) and xd.device == step.device
    loss = step.step(xd, yd)
    assert isinstance(loss, torch.Tensor) and loss.dim() == 0
    assert all(torch.equal(held[k], before[k]) for k in held)
    step.sync_to_block()
    now = extract_params(net)
    for k, v in step.params.items():
        assert now[k] is held[k] and torch.equal(now[k], v), k
    assert any(not torch.equal(now[k], before[k]) for k in now)


def test_what_waits_for_other_slices_raises():
    """A mesh of more than one device and overlap_grads wait for the
    multi-process slice; lower() has no eager counterpart."""
    net, _ = _narrow(False)
    loss, opt = tloss.SoftmaxCrossEntropyLoss(), topt.create("sgd")
    with pytest.raises(NotImplementedError, match="M10"):
        ShardedTrainStep(net, loss, opt, mesh=create_mesh(devices=CPU * 2))
    with pytest.raises(NotImplementedError, match="M10"):
        ShardedTrainStep(net, loss, opt, mesh=create_mesh(devices=CPU),
                         overlap_grads=True)
    with pytest.raises(ValueError):
        ShardedTrainStep(net, loss, opt)
    step = ShardedTrainStep(net, loss, opt, mesh=create_mesh(devices=CPU))
    with pytest.raises(NotImplementedError):
        step.lower(*_batch())
