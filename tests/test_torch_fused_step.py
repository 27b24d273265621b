"""The port's fused train step (mxnet_tpu_torch/gluon/fused_step.py) held
against its own eager step and against the JAX package's
``gluon.train_step``, on the CPU: the update phase packed
(``MXTPU_FUSED_APPLY=1``) or per parameter (``0``) equals the eager
record/backward/``Trainer.step`` bit for bit, and each fallback reason
names itself in ``last_mode`` and still trains.
"""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import fused_step
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(8, 8).astype("float32"),
            rs.randint(0, 4, (8,)).astype("float32"))


def _weights(seed=1):
    rs = np.random.RandomState(seed)
    return {"0.weight": rs.uniform(-0.5, 0.5, (16, 8)).astype("float32"),
            "0.bias": rs.uniform(-0.1, 0.1, (16,)).astype("float32"),
            "1.weight": rs.uniform(-0.5, 0.5, (4, 16)).astype("float32"),
            "1.bias": rs.uniform(-0.1, 0.1, (4,)).astype("float32")}


def _net(dtype="float32", hybridize=True):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, in_units=8, activation="relu"))
    net.add(mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    mx.convert.load_numpy_params(net, _weights())
    net.cast(dtype)
    if hybridize:
        net.hybridize()
    return net


def _trainer(net, opt=None, multi_precision=False):
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            opt or {"learning_rate": 0.05, "momentum": 0.9,
                                    "wd": 1e-3,
                                    "multi_precision": multi_precision})


def _snapshot(net):
    return {k: (p._tensor().detach().clone(), p._grad_tensor().clone())
            for k, p in net._collect_params_with_prefix().items()}


def _same(a, b):
    return all(torch.equal(a[k][0], b[k][0]) and torch.equal(a[k][1],
                                                              b[k][1])
               for k in a)


def _natural_order(trainer):
    """The trainer's parameter indices in the natural order of their names
    (the counters compared as numbers)."""
    def key(i):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", trainer._params[i].name)]
    return sorted(range(len(trainer._params)), key=key)


def _run(mode, dtype, steps=3, multi_precision=False):
    x, y = _data()
    x, y = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(y)
    net = _net(dtype)
    tr = _trainer(net, multi_precision=multi_precision)
    loss_fn = SoftmaxCrossEntropyLoss()
    step = mx.gluon.train_step(net, loss_fn, tr)
    for _ in range(steps):
        if mode == "eager":
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
        else:
            loss = step(x, y)
            assert step.last_mode == "fused"
    return _snapshot(net), tr


def _same_state(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(_same_state(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("dtype,mp", [("float32", False),
                                      ("bfloat16", False),
                                      ("bfloat16", True)])
def test_train_step_bitwise_across_apply_modes(dtype, mp, monkeypatch):
    """The fused step with MXTPU_FUSED_APPLY 0 and 1 against the eager
    step: weights, gradients, optimizer state and update counts equal bit
    for bit after three steps (TestFusedStepApply of the JAX suite). With
    multi_precision the bf16 weights keep f32 masters, which the packed
    apply leaves to the per-parameter step_fn_multi_precision."""
    base, btr = _run("eager", dtype, multi_precision=mp)
    for mode in ("0", "1"):
        monkeypatch.setenv("MXTPU_FUSED_APPLY", mode)
        got, tr = _run("fused", dtype, multi_precision=mp)
        assert _same(got, base), mode
        # each Trainer indexes its parameters in the order of their full
        # names, which hang on the process's block counters ("dense9"
        # sorts after "dense10"): match the states in the names' natural
        # order, the order the blocks were made in
        for bi, i in zip(_natural_order(btr), _natural_order(tr)):
            assert _same_state(tr._updater.states[i],
                               btr._updater.states[bi])
        assert tr._optimizer.num_update == btr._optimizer.num_update == 3


def test_train_step_matches_jax(monkeypatch):
    """The port's fused step against the JAX package's train_step (three
    steps: warm, compile, one fused hit) from the same weights: weights
    and gradients within 1e-6 of their largest magnitude, f32."""
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1")
    x, y = _data()
    got, _ = _run("fused", "float32")
    jnet = mxj.gluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(mxj.gluon.nn.Dense(16, in_units=8, activation="relu"))
        jnet.add(mxj.gluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mxj.nd.array(_weights()[k]))
    jnet.hybridize()
    jtr = mxj.gluon.Trainer(jnet.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9,
                             "wd": 1e-3})
    jstep = mxj.gluon.train_step(jnet, mxj.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 jtr)
    for _ in range(3):
        jstep(mxj.nd.array(x), mxj.nd.array(y))
    assert jstep.last_mode == "fused"
    for k, p in jnet._collect_params_with_prefix().items():
        for t, r in zip(got[k], (p.data().asnumpy(), p.grad().asnumpy())):
            assert np.abs(t.numpy() - r).max() <= 1e-6 * np.abs(r).max(), k


class _NoStepFn(topt.Optimizer):
    """An optimizer with only the in-place update (no pure step_fn)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            weight.sub_(self.lr * self.rescale_grad * grad)


@pytest.mark.parametrize("reason", [
    "disabled", "recording-scope", "optimizer:_NoStepFn", "non-hybridized",
    "grad-req-add", "no-trainable-params", "deferred-init"])
def test_fallback_reasons_still_train(reason):
    """Each fallback names itself in last_mode and runs the eager step,
    which still updates the weights."""
    x, y = _data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    net = _net(hybridize=reason != "non-hybridized")
    opt = _NoStepFn(learning_rate=0.1) if reason.startswith("optimizer") \
        else None
    params = net.collect_params()
    if reason == "no-trainable-params":       # the trainer owns none of them
        params = []
    if reason == "grad-req-add":
        net[0].bias.grad_req = "add"
    if reason == "deferred-init":
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(16, activation="relu"))
        net.add(mx.gluon.nn.Dense(4))
        net.initialize(ctx=mx.cpu())
        net.hybridize()
        params = net.collect_params()
    tr = mx.gluon.Trainer(params, opt) if opt is not None else \
        mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    step = mx.gluon.train_step(net, SoftmaxCrossEntropyLoss(), tr)
    before = fused_step.stats()["fallbacks"]
    prev = fused_step.set_fused_step(reason != "disabled")
    try:
        if reason == "recording-scope":
            with autograd.record():
                step(x, y)
        elif reason == "no-trainable-params":
            step(x, y, ignore_stale_grad=True)
        else:
            step(x, y)
    finally:
        fused_step.set_fused_step(prev)
    assert step.last_mode == "fallback:" + reason
    assert fused_step.stats()["fallbacks"] == before + 1
    w = net[0].weight._tensor()
    if reason == "no-trainable-params":       # the eager backward ran
        assert net[0].weight._grad_tensor().abs().sum() > 0
    elif reason == "deferred-init":
        assert w.shape == (16, 8)
        step(x, y)                              # shapes known: fused now
        assert step.last_mode == "fused"
    else:
        assert not torch.equal(w, torch.from_numpy(_weights()["0.weight"]))


@pytest.mark.parametrize("kw", [{"mesh": dict(dp=1, tp=2)},
                                {"rules": [("w", None)]},
                                {"mesh": dict(dp=1, fsdp=2),
                                 "bucket_bytes": 1 << 10}])
def test_multi_gpu_arguments_raise(kw):
    """rules= and a mesh with a model axis (the GSPMD step over sharded
    parameters) raise, naming M10c; a data-parallel mesh runs
    (tests/test_torch_dist_train.py)."""
    from mxnet_tpu_torch.parallel import create_mesh
    net = _net()
    kw = dict(kw)
    if "mesh" in kw:
        kw["mesh"] = create_mesh(devices=[torch.device("cpu")] * 2,
                                 **kw["mesh"])
    with pytest.raises(NotImplementedError, match="M10c"):
        mx.gluon.train_step(net, SoftmaxCrossEntropyLoss(), _trainer(net),
                            **kw)


def test_eager_and_fused_steps_share_optimizer_state():
    """Updater.ensure_state: an eager step creates the momentum the fused
    step then updates in place, and the reverse; the result equals three
    eager steps bit for bit."""
    base, _ = _run("eager", "float32")
    x, y = _data()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    net = _net()
    tr = _trainer(net)
    loss_fn = SoftmaxCrossEntropyLoss()
    step = tr.fuse_step(lambda a, b: loss_fn(net(a), b))   # closure form
    for fused in (False, True, False):
        if fused:
            step(x, y)
            assert step.last_mode == "fused"
        else:
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
        if not fused:
            states = dict(tr._updater.states)
    assert all(tr._updater.states[i] is s for i, s in states.items())
    assert _same(_snapshot(net), base)


def test_failed_step_rolls_back_update_counts():
    x, y = _data()
    net = _net()
    tr = _trainer(net)

    def bad_loss(out, label):
        raise RuntimeError("loss failed")

    step = mx.gluon.train_step(net, bad_loss, tr)
    with pytest.raises(RuntimeError):
        step(torch.from_numpy(x), torch.from_numpy(y))
    assert step.last_mode == "error"
    assert tr._optimizer.num_update == 0
    assert tr._optimizer._index_update_count == {}


def test_stats_count_fused_steps():
    fused_step.reset_stats()
    _run("fused", "float32", steps=2)
    assert fused_step.stats() == {"hits": 2, "fallbacks": 0,
                                  "health_errors": 0, "mesh_fallbacks": 0}
    fused_step.reset_stats()
    assert fused_step.stats() == {"hits": 0, "fallbacks": 0,
                                  "health_errors": 0, "mesh_fallbacks": 0}
