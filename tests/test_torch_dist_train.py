"""Data-parallel training across two processes (the port's
``ShardedTrainStep`` on a dp mesh and ``gluon.train_step(mesh=...)``) held
against the JAX package's on a two-device mesh.

One cluster of two gloo ranks for the module (test_torch_collectives.py's
``run_cluster``); each rank runs every check of ``CHECKS`` on the same
global batch and writes its losses and parameters. The JAX goldens run
here on ``jax.devices()[:2]``: ``ShardedTrainStep`` on
``data_parallel(create_mesh(...))``, on its default (GSPMD) path and with
``overlap_grads=True``, and the fused step on the mesh.

- The narrow NHWC ResNet (f32; fuse False, and True on the default path)
  and the Dense net of tests/test_overlap.py, 3 and 5 steps: the losses
  and every parameter (running statistics included) within rtol 1e-5 /
  atol 1e-6 of JAX's, the JAX package's own bar in test_overlap.py. The
  default path normalizes with the global batch's statistics, combined
  from the ranks' (Chan's combination), where JAX's one program sums the
  global batch in one tree: the same statistics up to rounding.
- The two ranks' parameters are equal bit for bit after every run.
- ``overlap_grads`` with an ``fsdp`` strategy raises JAX's ``ValueError``.
- A small channels-first net (its BatchNorm through a transpose) on the
  default path, the same bar.
- Dropout's mask on the default path is the rank's rows of the global
  batch's; on the overlap path the ranks draw different masks.
- The fused step in dp mode (the dense pair of test_overlap.py, 6 steps)
  against JAX's on the mesh; a batch of 7 runs the eager step on the whole
  batch, counted as a fallback and a mesh fallback, and training goes on
  fused. On a BatchNorm it averages the running statistics the forward
  updated over 'dp' and leaves a frozen weight (which the test makes
  differ between the ranks) as it was.
"""
import os
import sys

import numpy as np
import pytest

from test_torch_collectives import (assert_ranks_equal, cluster_fixture,
                                    result, worker_main)

NARROW = ([1, 1], [16, 32, 64])
SIZE = 16
SGD = {"learning_rate": 0.01, "momentum": 0.9}
RESNET_STEPS = 3
DENSE_STEPS = 5
RTOL, ATOL = 1e-5, 1e-6


def _batch(n=4):
    x = np.random.RandomState(1).rand(n, 3, SIZE, SIZE).astype("float32")
    y = np.random.RandomState(2).randint(0, 10, (n,)).astype("float32")
    return x, y


def _dense_batch():
    rs = np.random.RandomState(5)
    return (rs.rand(16, 10).astype(np.float32),
            rs.rand(16, 6).astype(np.float32))


def _dense_init():
    """Dense(6, in_units=10)'s (bias, weight) as test_overlap.py draws
    them."""
    rs = np.random.RandomState(11)
    return [rs.randn(6).astype(np.float32) * 0.1,
            rs.randn(6, 10).astype(np.float32) * 0.1]


def _pair_init():
    rs = np.random.RandomState(0)
    w1 = rs.randn(16, 12).astype(np.float32) * 0.1
    w2 = rs.randn(4, 16).astype(np.float32) * 0.1
    return [np.zeros(16, np.float32), w1, np.zeros(4, np.float32), w2]


def _pair_batches(n, batch=8):
    rs = np.random.RandomState(7)
    return [(rs.rand(batch, 12).astype(np.float32),
             rs.rand(batch, 4).astype(np.float32)) for _ in range(n)]


# -- the checks (run on each rank) ----------------------------------------------

def _narrow(fuse):
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as R
    net = R.ResNetV1(R.BottleneckV1, *NARROW, classes=10, thumbnail=True,
                     layout="NHWC", fuse=fuse)
    net.initialize(ctx=mx.cpu())
    net(torch.zeros(1, 3, SIZE, SIZE))
    arrays = convert.random_numpy_params(convert.param_shapes(net), seed=3)
    convert.load_numpy_params(net, arrays)
    return net, arrays


def _run(step, batch, steps):
    losses = [float(step(*batch)) for _ in range(steps)]
    out = {"param:" + k: v.detach().numpy() for k, v in step.params.items()}
    out["losses"] = np.array(losses)
    return out


def _resnet(fuse, overlap):
    def check(rank, world):
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
        from mxnet_tpu_torch.parallel import ShardedTrainStep, create_mesh
        step = ShardedTrainStep(
            _narrow(fuse)[0], SoftmaxCrossEntropyLoss(),
            mx.optimizer.create("sgd", **SGD), mesh=create_mesh(),
            overlap_grads=overlap)
        return _run(step, _batch(), RESNET_STEPS)
    return check


def _dense(overlap):
    def check(rank, world):
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.gluon import nn
        from mxnet_tpu_torch.gluon.loss import L2Loss
        from mxnet_tpu_torch.parallel import (ShardedTrainStep, create_mesh,
                                              data_parallel)
        net = nn.Dense(6, in_units=10)
        net.initialize(ctx=mx.cpu())
        for (_, p), v in zip(sorted(net.collect_params().items()),
                             _dense_init()):
            p.set_data(mx.nd.array(v, ctx=mx.cpu()))
        step = ShardedTrainStep(
            net, L2Loss(), mx.optimizer.create("sgd", learning_rate=0.05,
                                               momentum=0.9),
            strategy=data_parallel(create_mesh()), overlap_grads=overlap,
            bucket_bytes=128)
        return _run(step, _dense_batch(), DENSE_STEPS)
    return check


def _nchw_net(mx):
    """A small channels-first net: its BatchNorm takes the global
    BatchNorm Function through a transpose on the default path."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Dense(3, in_units=4))
    return net


def _nchw_init(shapes):
    rs = np.random.RandomState(21)
    return [rs.randn(*s).astype(np.float32) * 0.3
            + (1.0 if len(s) == 1 and i in (2, 5) else 0.0)
            for i, s in enumerate(shapes)]


def _nchw_batch():
    rs = np.random.RandomState(22)
    return (rs.rand(4, 3, 6, 6).astype(np.float32),
            rs.randint(0, 3, (4,)).astype(np.float32))


def check_nchw_default(rank, world):
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import ShardedTrainStep, create_mesh
    net = _nchw_net(mx)
    net.initialize(ctx=mx.cpu())
    net(torch.zeros(1, 3, 6, 6))
    items = sorted(net.collect_params().items())
    for (_, p), v in zip(items, _nchw_init([p.shape for _, p in items])):
        p.set_data(mx.nd.array(v, ctx=mx.cpu()))
    step = ShardedTrainStep(net, SoftmaxCrossEntropyLoss(),
                            mx.optimizer.create("sgd", **SGD),
                            mesh=create_mesh())
    return _run(step, _nchw_batch(), RESNET_STEPS)


def check_overlap_fsdp(rank, world):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import L2Loss
    from mxnet_tpu_torch.parallel import ShardedTrainStep, create_mesh, fsdp
    net = nn.Dense(8, in_units=64)
    net.initialize(ctx=mx.cpu())
    mesh = create_mesh(dp=1, fsdp=2)
    try:
        ShardedTrainStep(net, L2Loss(),
                         mx.optimizer.create("sgd", learning_rate=0.01),
                         strategy=fsdp(mesh, min_size=64),
                         overlap_grads=True)
    except ValueError as e:
        return {"raised": np.array(str(e))}
    return {"raised": np.array("")}


def _pair_net():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=12))
    net.add(nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    for (_, p), v in zip(sorted(net.collect_params().items()), _pair_init()):
        p.set_data(mx.nd.array(v, ctx=mx.cpu()))
    return net


def check_fused_dp(rank, world):
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import fused_step as fs
    from mxnet_tpu_torch.gluon.loss import L2Loss
    from mxnet_tpu_torch.parallel import create_mesh
    net = _pair_net()
    loss_fn = L2Loss()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    step = tr.fuse_step(lambda xx, yy: loss_fn(net(xx), yy),
                        mesh=create_mesh(), bucket_bytes=512)
    before = fs.stats()
    losses, modes = [], []
    for x, y in _pair_batches(6):
        out = step(torch.from_numpy(x), torch.from_numpy(y), batch_size=8)
        losses.append(float(out.mean()))
        modes.append(step.last_mode)
    out = {"param:%d" % i: p._tensor().detach().numpy().copy()
           for i, (_, p) in enumerate(sorted(net.collect_params().items()))}
    out["losses"] = np.array(losses)
    out["loss_shape"] = np.array(tuple(step(
        torch.from_numpy(x), torch.from_numpy(y), batch_size=8).shape))
    mid = fs.stats()
    x7 = np.random.RandomState(3).rand(7, 12).astype(np.float32)
    y7 = np.random.RandomState(4).rand(7, 4).astype(np.float32)
    with pytest.warns(UserWarning, match="does not divide"):
        l7 = step(torch.from_numpy(x7), torch.from_numpy(y7), batch_size=7)
    modes.append(step.last_mode)
    after7 = fs.stats()
    for x, y in _pair_batches(3):
        step(torch.from_numpy(x), torch.from_numpy(y), batch_size=8)
        modes.append(step.last_mode)
    out["modes"] = np.array(modes)
    out["counts"] = np.array([
        mid["hits"] - before["hits"], after7["fallbacks"] - mid["fallbacks"],
        after7["mesh_fallbacks"] - mid["mesh_fallbacks"],
        fs.stats()["hits"] - after7["hits"]])
    out["loss7"] = l7.numpy()
    return out


def check_fused_dp_aux(rank, world):
    """The fused step in dp mode on a BatchNorm and a frozen Dense whose
    weight differs between the ranks: one step, then the running
    statistics and the frozen weight."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import L2Loss
    from mxnet_tpu_torch.parallel import create_mesh
    net = nn.HybridSequential()
    net.add(nn.BatchNorm(axis=-1, in_channels=12))
    net.add(nn.Dense(16, in_units=12))
    net.add(nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    frozen = net[1].weight
    frozen.set_data(mx.nd.array(np.full((16, 12), 0.1 * (rank + 1),
                                        np.float32), ctx=mx.cpu()))
    frozen.grad_req = "null"
    loss_fn = L2Loss()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05})
    step = tr.fuse_step(lambda xx, yy: loss_fn(net(xx), yy),
                        mesh=create_mesh())
    x, y = _pair_batches(1)[0]
    step(torch.from_numpy(x), torch.from_numpy(y), batch_size=8)
    return {"mode": np.array(step.last_mode), "x": x,
            "running_mean": net[0].running_mean._tensor().numpy().copy(),
            "frozen": frozen._tensor().numpy().copy()}


CHECKS = [("resnet_default", _resnet(False, False)),
          ("resnet_overlap", _resnet(False, True)),
          ("resnet_fused", _resnet(True, False)),
          ("nchw_default", check_nchw_default),
          ("dense_default", _dense(False)),
          ("dense_overlap", _dense(True)),
          ("overlap_fsdp", check_overlap_fsdp),
          ("fused_dp", check_fused_dp),
          ("fused_dp_aux", check_fused_dp_aux)]


# -- the JAX goldens -----------------------------------------------------------------
# They run in the test process, whose JAX gluon counts the blocks it names
# automatically: their layers take explicit prefixes, so that a JAX test
# later in the same process names its layers as it would alone.

def _jax_mesh():
    import jax
    from mxnet_tpu.parallel import create_mesh
    return create_mesh(devices=jax.devices()[:2])


def _jrun(step, batch, steps):
    losses = [float(step(*batch)) for _ in range(steps)]
    out = {"param:" + k: np.asarray(v) for k, v in step.params.items()}
    out["losses"] = np.array(losses)
    return out


def _jax_resnet(fuse, overlap):
    import mxnet_tpu as mxj
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
    from mxnet_tpu.parallel import ShardedTrainStep, data_parallel
    arrays = _narrow(fuse)[1]
    jnet = jres.ResNetV1(jres.BottleneckV1, *NARROW, classes=10,
                         thumbnail=True, layout="NHWC", fuse=fuse)
    jnet.initialize()
    jnet(mxj.nd.array(np.zeros((1, 3, SIZE, SIZE), "float32")))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(arrays[k]))
    step = ShardedTrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                            jopt.create("sgd", **SGD),
                            strategy=data_parallel(_jax_mesh()),
                            overlap_grads=overlap)
    return _jrun(step, _batch(), RESNET_STEPS)


def _jax_dense(overlap):
    import mxnet_tpu as mxj
    import mxnet_tpu.optimizer as jopt
    from mxnet_tpu.gluon import nn
    from mxnet_tpu.gluon.loss import L2Loss
    from mxnet_tpu.parallel import ShardedTrainStep, data_parallel
    net = nn.Dense(6, in_units=10, prefix="dense0_")
    net.initialize()
    for (_, p), v in zip(sorted(net.collect_params().items()),
                         _dense_init()):
        p.set_data(mxj.nd.array(v))
    step = ShardedTrainStep(net, L2Loss(),
                            jopt.create("sgd", learning_rate=0.05,
                                        momentum=0.9),
                            strategy=data_parallel(_jax_mesh()),
                            overlap_grads=overlap, bucket_bytes=128)
    return _jrun(step, _dense_batch(), DENSE_STEPS)


def _jax_nchw():
    import mxnet_tpu as mxj
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn
    from mxnet_tpu.parallel import ShardedTrainStep, data_parallel
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3, prefix="conv2d0_"),
            nn.BatchNorm(in_channels=4, prefix="batchnorm0_"),
            nn.Activation("relu"), nn.GlobalAvgPool2D(),
            nn.Dense(3, in_units=4, prefix="dense0_"))
    net.initialize()
    net(mxj.nd.array(np.zeros((1, 3, 6, 6), "float32")))
    items = sorted(net.collect_params().items())
    for (_, p), v in zip(items, _nchw_init([p.shape for _, p in items])):
        p.set_data(mxj.nd.array(v))
    step = ShardedTrainStep(net, jloss.SoftmaxCrossEntropyLoss(),
                            jopt.create("sgd", **SGD),
                            strategy=data_parallel(_jax_mesh()))
    return _jrun(step, _nchw_batch(), RESNET_STEPS)


def _jax_fused():
    import mxnet_tpu as mxj
    from mxnet_tpu import gluon
    from mxnet_tpu.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=12, prefix="dense0_"))
    net.add(nn.Dense(4, in_units=16, prefix="dense1_"))
    net.initialize()
    net.hybridize()
    for (_, p), v in zip(sorted(net.collect_params().items()), _pair_init()):
        p.set_data(mxj.nd.array(v))
    loss_fn = gluon.loss.L2Loss()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9})
    step = tr.fuse_step(lambda xx, yy: loss_fn(net(xx), yy),
                        mesh=_jax_mesh(), bucket_bytes=512)
    losses = [float(step(mxj.nd.array(x), mxj.nd.array(y),
                         batch_size=8).asnumpy().mean())
              for x, y in _pair_batches(6)]
    out = {"param:%d" % i: p.data().asnumpy()
           for i, (_, p) in enumerate(sorted(net.collect_params().items()))}
    out["losses"] = np.array(losses)
    return out


GOLDENS = {"resnet_default": lambda: _jax_resnet(False, False),
           "resnet_overlap": lambda: _jax_resnet(False, True),
           "resnet_fused": lambda: _jax_resnet(True, False),
           "nchw_default": _jax_nchw,
           "dense_default": lambda: _jax_dense(False),
           "dense_overlap": lambda: _jax_dense(True),
           "fused_dp": _jax_fused}


# -- the tests ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return cluster_fixture(os.path.abspath(__file__), tmp_path_factory,
                           lambda: {k: fn() for k, fn in GOLDENS.items()})


@pytest.fixture(scope="module")
def cluster(run):
    return run[0]


@pytest.fixture(scope="module")
def goldens(run):
    return run[1]


def _compare(got, want, name):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL, err_msg=name + " losses")
    keys = [k for k in want if k.startswith("param:")]
    assert sorted(keys) == sorted(k for k in got if k.startswith("param:"))
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg="%s %s" % (name, k))


@pytest.mark.parametrize("name", ["resnet_default", "resnet_overlap",
                                  "resnet_fused", "nchw_default",
                                  "dense_default", "dense_overlap",
                                  "fused_dp"])
def test_matches_jax_on_a_two_device_mesh(cluster, goldens, name):
    _compare(result(cluster, name, 0), goldens[name], name)


@pytest.mark.parametrize("name", ["resnet_default", "resnet_overlap",
                                  "resnet_fused", "nchw_default",
                                  "dense_default", "dense_overlap",
                                  "fused_dp"])
def test_ranks_hold_the_same_parameters(cluster, name):
    assert_ranks_equal(cluster, name)


def test_overlap_with_fsdp_raises_like_jax(cluster):
    for rank in range(2):
        msg = str(result(cluster, "overlap_fsdp", rank)["raised"])
        assert "pure data-parallel" in msg


def test_fused_step_indivisible_batch_falls_back(cluster):
    r = result(cluster, "fused_dp", 0)
    modes = list(r["modes"])
    assert modes[:6] == ["fused"] * 6
    assert modes[6] == "fallback:mesh-batch-indivisible"
    assert modes[7:] == ["fused"] * 3
    # 7 fused steps (6 and the loss-shape one), one fallback counted in
    # both counters, 3 fused steps after it
    assert list(r["counts"]) == [7, 1, 1, 3]
    assert tuple(r["loss_shape"]) == (8,)
    assert r["loss7"].shape == (7,) and np.isfinite(r["loss7"]).all()


def test_fused_step_averages_only_the_running_statistics(cluster):
    """The fused dp mode writes the running statistics the forward
    updated, averaged over 'dp' (each rank's local batch mean: together
    the global batch's), and leaves a frozen weight as each rank holds
    it."""
    r = [result(cluster, "fused_dp_aux", rank) for rank in range(2)]
    assert [str(q["mode"]) for q in r] == ["fused", "fused"]
    np.testing.assert_array_equal(r[0]["running_mean"], r[1]["running_mean"])
    want = 0.1 * r[0]["x"].astype(np.float64).mean(axis=0)
    np.testing.assert_allclose(r[0]["running_mean"], want, rtol=RTOL,
                               atol=ATOL)
    for rank in range(2):
        np.testing.assert_array_equal(
            r[rank]["frozen"], np.full((16, 12), 0.1 * (rank + 1),
                                       np.float32))


def test_dropout_draws_the_global_batch_mask():
    """On the default path a rank's Dropout mask is its rows of the global
    batch's mask from the shared generator; on the overlap path
    (random.folded) the ranks draw different masks and, after the step,
    the same stream again."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import global_batch
    from mxnet_tpu_torch.ops.nn import dropout
    ones = torch.ones(4, 5)
    mx.random.seed(7)
    full = dropout(ones, p=0.5)
    for index in range(2):
        mx.random.seed(7)
        with global_batch.scope(None, 2, index):
            rows = dropout(ones[:2], p=0.5)
        assert torch.equal(rows, full[2 * index:2 * index + 2])
    masks, after = [], []
    for index in range(2):
        mx.random.seed(7)
        with mx.random.folded(torch.device("cpu"), index):
            masks.append(dropout(ones, p=0.5))
        after.append(dropout(ones, p=0.5))
    assert not torch.equal(masks[0], masks[1])
    assert torch.equal(after[0], after[1])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main(CHECKS)
