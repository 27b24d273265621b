"""The port's ``dist_sync`` kvstore (mxnet_tpu_torch/kvstore.py) and
``gluon.Trainer(kvstore='dist_sync')`` on two processes, held against the
JAX package's kvstore semantics.

One cluster of two gloo ranks for the module (test_torch_collectives.py's
``cluster_fixture``); each rank runs every check of ``CHECKS`` and writes
what it pulled.

- Push and pull are exact, after tests/dist_sync_kvstore_worker.py's
  ``check_diff_to_scalar``: the sum over the ranks of rank-dependent
  values, repeated rounds, string keys and ``pushpull``, key lists, and
  several values for one key; every dist kind.
- A compressed push against JAX's codec (``quantize_2bit_jnp``,
  ``dequantize_2bit_jnp``) summed over both ranks' values as the JAX
  store's ``_compress_reduce`` sums them, two rounds (the residuals carry
  over), bit for bit; an uncompressed key of the same push is the plain
  sum.
- ``Trainer(kvstore='dist_sync')`` (update on the kvstore, the default)
  against JAX's in-process Trainer fed the gradient of both ranks'
  batches, within rtol 1e-5 / atol 1e-6; both ranks' weights bit for bit.
- ``dist_async`` raises, naming M10b; a dist kind in one process is the
  in-process store.
"""
import os
import sys

import numpy as np
import pytest

from test_torch_collectives import (assert_ranks_equal, cluster_fixture,
                                    result, worker_main)

SHAPE = (4, 4)
THR = 0.5
SIZES = {"big": 5000, "small": 64}
ROUNDS = 2
STEPS = 3


def _values(rank, rnd, n):
    return (np.random.RandomState(100 + rank + 10 * rnd).randn(n)
            .astype(np.float32))


def _dense_init():
    rs = np.random.RandomState(4)
    return [rs.randn(3).astype(np.float32) * 0.1,
            rs.randn(3, 5).astype(np.float32) * 0.1]


def _data(rank, step):
    rs = np.random.RandomState(200 + rank + 10 * step)
    return rs.rand(4, 5).astype(np.float32), rs.rand(4, 3).astype(np.float32)


# -- the checks (run on each rank) ----------------------------------------------

def check_push_pull(rank, world):
    import torch
    import mxnet_tpu_torch as mx
    out = {}
    for kind in ("dist_sync", "dist_device_sync", "dist"):
        kv = mx.kv.create(kind)
        assert (kv.rank, kv.num_workers) == (rank, world)
        o = torch.zeros(SHAPE)
        kv.init(3, torch.zeros(SHAPE))
        kv.push(3, torch.ones(SHAPE) * (rank + 1))
        kv.pull(3, out=o)
        out[kind + ":first"] = o.numpy().copy()
        for rnd in range(3):
            kv.push(3, torch.ones(SHAPE))
            kv.pull(3, out=o)
            out["%s:round%d" % (kind, rnd)] = o.numpy().copy()
        kv.init("w0", torch.zeros(SHAPE))
        kv.pushpull("w0", torch.ones(SHAPE) * rank, out=o)
        out[kind + ":str"] = o.numpy().copy()
    kv = mx.kv.create("dist_sync")
    vals = [torch.from_numpy(_values(rank, 0, 6)),
            torch.from_numpy(_values(rank, 1, 6))]
    kv.init([5, 6], [torch.zeros(6), torch.zeros(6)])
    kv.push([5, 6], vals)
    outs = [torch.zeros(6), torch.zeros(6)]
    kv.pull([5, 6], out=outs)
    out["list5"], out["list6"] = outs[0].numpy(), outs[1].numpy()
    kv.init(7, torch.zeros(6))
    kv.push(7, vals)              # two values for one key: add_n, then sum
    o = torch.zeros(6)
    kv.pull(7, out=o)
    out["multi"] = o.numpy()
    kv._barrier()
    return out


def check_compressed(rank, world):
    import torch
    import mxnet_tpu_torch as mx
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": THR})
    keys = sorted(SIZES)
    kv.init(keys, [torch.zeros(SIZES[k]) for k in keys])
    out = {}
    for rnd in range(ROUNDS):
        kv.push(keys, [torch.from_numpy(_values(rank, rnd, SIZES[k]))
                       for k in keys])
        outs = [torch.zeros(SIZES[k]) for k in keys]
        kv.pull(keys, out=outs)
        for k, o in zip(keys, outs):
            out["%s:%d" % (k, rnd)] = o.numpy()
    return out


def check_trainer(rank, world):
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import L2Loss
    net = nn.Dense(3, in_units=5)
    net.initialize(ctx=mx.cpu())
    for (_, p), v in zip(sorted(net.collect_params().items()),
                         _dense_init()):
        p.set_data(mx.nd.array(v, ctx=mx.cpu()))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9},
                          kvstore="dist_sync")
    loss_fn = L2Loss()
    out = {}
    for step in range(STEPS):
        x, y = (torch.from_numpy(a) for a in _data(rank, step))
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(4)
        for i, (_, p) in enumerate(sorted(net.collect_params().items())):
            out["%d:%d" % (step, i)] = p._tensor().detach().numpy().copy()
    out["update_on_kvstore"] = np.array(tr._update_on_kvstore)
    out["kind"] = np.array(tr._kvstore.type)
    return out


CHECKS = [("push_pull", check_push_pull), ("compressed", check_compressed),
          ("trainer", check_trainer)]


# -- the JAX goldens -----------------------------------------------------------------

def _jax_compressed():
    """The JAX store's compressed sum over the ranks: each rank quantizes
    its value with its residual, every rank's words are dequantized and
    added from 0 in rank order, cast to the value's dtype."""
    import jax.numpy as jnp
    from mxnet_tpu.pallas_kernels.compression import (dequantize_2bit_jnp,
                                                      quantize_2bit_jnp)
    n = SIZES["big"]
    res = [jnp.zeros(n, jnp.float32) for _ in range(2)]
    out = {}
    for rnd in range(ROUNDS):
        words = []
        for r in range(2):
            w, res[r] = quantize_2bit_jnp(jnp.asarray(_values(r, rnd, n)),
                                          res[r], THR)
            words.append(w)
        total = sum(dequantize_2bit_jnp(w, n, THR) for w in words)
        out["big:%d" % rnd] = np.asarray(total.astype(jnp.float32))
    return out


def _jax_trainer():
    import mxnet_tpu as mxj
    from mxnet_tpu import autograd, gluon
    from mxnet_tpu.gluon import nn
    # an explicit prefix: the test process's JAX block counter stays as it
    # was for the JAX tests after this file
    net = nn.Dense(3, in_units=5, prefix="dense0_")
    net.initialize()
    for (_, p), v in zip(sorted(net.collect_params().items()),
                         _dense_init()):
        p.set_data(mxj.nd.array(v))
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = gluon.loss.L2Loss()
    out = {}
    for step in range(STEPS):
        xs, ys = zip(*[_data(r, step) for r in range(2)])
        with autograd.record():
            loss = loss_fn(net(mxj.nd.array(np.concatenate(xs))),
                           mxj.nd.array(np.concatenate(ys)))
        loss.backward()
        tr.step(4)
        for i, (_, p) in enumerate(sorted(net.collect_params().items())):
            out["%d:%d" % (step, i)] = p.data().asnumpy()
    return out


# -- the tests ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return cluster_fixture(
        os.path.abspath(__file__), tmp_path_factory,
        lambda: {"compressed": _jax_compressed(), "trainer": _jax_trainer()})


@pytest.fixture(scope="module")
def cluster(run):
    return run[0]


@pytest.fixture(scope="module")
def goldens(run):
    return run[1]


def _check(a, value):
    """tests/dist_sync_kvstore_worker.py's check_diff_to_scalar: exact."""
    assert (a == value).all(), (value, a)


@pytest.mark.parametrize("kind", ["dist_sync", "dist_device_sync", "dist"])
def test_push_pull_exact(cluster, kind):
    for rank in range(2):
        r = result(cluster, "push_pull", rank)
        _check(r[kind + ":first"], 3.0)
        for rnd in range(3):
            _check(r["%s:round%d" % (kind, rnd)], 2.0)
        _check(r[kind + ":str"], 1.0)


def test_key_lists_and_several_values_sum_over_ranks(cluster):
    for rank in range(2):
        r = result(cluster, "push_pull", rank)
        for key, rnd in (("list5", 0), ("list6", 1)):
            np.testing.assert_array_equal(
                r[key], _values(0, rnd, 6) + _values(1, rnd, 6))
        np.testing.assert_array_equal(
            r["multi"], (_values(0, 0, 6) + _values(0, 1, 6))
            + (_values(1, 0, 6) + _values(1, 1, 6)))


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_compressed_push_matches_jax_codec(cluster, goldens, rnd):
    for rank in range(2):
        r = result(cluster, "compressed", rank)
        np.testing.assert_array_equal(r["big:%d" % rnd],
                                      goldens["compressed"]["big:%d" % rnd])
        # under size_lower_bound (4096): the plain sum
        np.testing.assert_array_equal(
            r["small:%d" % rnd], _values(0, rnd, SIZES["small"])
            + _values(1, rnd, SIZES["small"]))


def test_trainer_dist_sync_matches_jax(cluster, goldens):
    r = result(cluster, "trainer", 0)
    assert bool(r["update_on_kvstore"]) and str(r["kind"]) == "dist_sync"
    for k, want in goldens["trainer"].items():
        np.testing.assert_allclose(r[k], want, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["push_pull", "compressed", "trainer"])
def test_ranks_pull_the_same_bits(cluster, name):
    assert_ranks_equal(cluster, name)


def test_dist_async_raises_naming_m10b():
    import mxnet_tpu_torch as mx
    with pytest.raises(NotImplementedError, match="M10b"):
        mx.kv.create("dist_async")


def test_dist_kind_in_one_process_is_the_local_store(monkeypatch):
    import torch
    import mxnet_tpu_torch as mx
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    kv = mx.kv.create("dist_sync")
    assert (kv.type, kv.rank, kv.num_workers) == ("dist_sync", 0, 1)
    kv.init(0, torch.zeros(3))
    kv.push(0, [torch.ones(3), torch.ones(3)])
    o = torch.zeros(3)
    kv.pull(0, out=o)
    _check(o.numpy(), 2.0)
    kv.set_barrier_before_exit(False)
    kv._barrier()
    kv.send_command_to_servers(0, "")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker_main(CHECKS)
