"""The port's training-health plane (mxnet_tpu_torch/_debug/healthmon.py)
against the JAX package's (mxnet_tpu/_debug/healthmon.py), and its weld
into the port's fused step, loss scaler, profiler and TensorInspector.

The JAX side runs its pure functions on numpy inputs (graph_summary
eagerly through jax.numpy, layer_stats, unpack_summary, note_step), as its
own tests do; the port's fused step is held to the contract: with the
fault point disarmed MXTPU_HEALTH=1 training is bit for bit MXTPU_HEALTH=0
training, and a skipped step leaves every weight, optimizer state, moving
statistic and update count as it was.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu._debug.faultpoint as jfault
import mxnet_tpu._debug.healthmon as jhm
import mxnet_tpu_torch as mx
import mxnet_tpu_torch._debug.faultpoint as tfault
import mxnet_tpu_torch._debug.healthmon as thm
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.monitor import Monitor
from mxnet_tpu_torch.parallel.overlap import bucket_plan
from mxnet_tpu_torch.tensor_inspector import TensorInspector

NARROW = ([1, 1, 1, 1], [16, 32, 64, 128, 256])


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path / "frec"))
    for k in ("MXTPU_HEALTH", "MXTPU_HEALTH_ACTION"):
        monkeypatch.delenv(k, raising=False)
    for m in (jfault, tfault):
        m.reset()
    for m in (jhm, thm):
        m.reset()
    yield
    for m in (jfault, tfault):
        m.reset()
    for m in (jhm, thm):
        m.reset()


# -- the device half: graph_summary, unpack_summary ---------------------------

def _leaves(seed, poison=None):
    """Grads and weights of mixed dtypes (bf16, f32) and a loss vector, as
    numpy float32 values exact in their dtype; ``poison`` = (which, leaf,
    value) writes one non-finite element."""
    rs = np.random.RandomState(seed)
    shapes = [(4, 3), (5,), (2, 2, 3), (7,), (3, 3)]
    dts = ["bfloat16", "bfloat16", "float32", "float32", "float32"]
    out = {}
    for which in ("g", "w"):
        out[which] = [torch.from_numpy(rs.randn(*s).astype("float32"))
                      .to(getattr(torch, d)).float().numpy()
                      for s, d in zip(shapes, dts)]
    out["loss"] = rs.rand(8).astype("float32")
    if poison is not None:
        which, leaf, value = poison
        if which == "loss":
            out["loss"][leaf] = value
        else:
            out[which][leaf].reshape(-1)[0] = value
    return out, dts


def _summaries(case):
    import jax.numpy as jnp
    data, dts = _leaves(case[0], case[1])
    t_g = [torch.from_numpy(a).to(getattr(torch, d))
           for a, d in zip(data["g"], dts)]
    t_w = [torch.from_numpy(a).to(getattr(torch, d))
           for a, d in zip(data["w"], dts)]
    plan = [list(b) for b in bucket_plan(t_g, bucket_bytes=40)]
    j_g = [jnp.asarray(a, getattr(jnp, d)) for a, d in zip(data["g"], dts)]
    j_w = [jnp.asarray(a, getattr(jnp, d)) for a, d in zip(data["w"], dts)]
    jp, jok = jhm.graph_summary(plan, j_g, j_w, jnp.asarray(data["loss"]))
    tp, tok = thm.graph_summary(plan, t_g, t_w, torch.from_numpy(
        data["loss"]))
    return plan, np.asarray(jp), bool(jok), tp.numpy(), bool(tok)


SUMMARY_CASES = {
    "clean": (0, None), "nan_grad": (1, ("g", 3, np.nan)),
    "inf_weight": (2, ("w", 0, np.inf)), "nan_loss": (3, ("loss", 2, np.nan)),
    "overflow": (4, ("g", 4, 3e30)), "neg_inf_bf16": (5, ("g", 1, -np.inf))}


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_graph_summary_matches_jax(case):
    plan, jp, jok, tp, tok = _summaries(SUMMARY_CASES[case])
    assert len(plan) > 1 and tp.shape == jp.shape == (2 * len(plan) + 3,)
    assert tok == jok == (case == "clean")
    np.testing.assert_array_equal(np.isfinite(tp), np.isfinite(jp))
    fin = np.isfinite(jp)
    np.testing.assert_allclose(tp[fin], jp[fin], rtol=1e-5)
    ju, tu = jhm.unpack_summary(jp, len(plan)), thm.unpack_summary(tp,
                                                                   len(plan))
    for k in ("g_bad", "w_bad"):
        np.testing.assert_array_equal(tu[k], ju[k])
    assert (tu["loss_bad"], tu["ok"]) == (ju["loss_bad"], ju["ok"])


def test_apply_corruption_matches_jax():
    import jax.numpy as jnp
    g = np.array([1.5, -0.0, 3.0], np.float32)
    for corrupt in (0.0, float("nan"), float("inf"), 1.0):
        for dt in ("float32", "bfloat16"):
            t = thm.apply_corruption(
                [torch.from_numpy(g).to(getattr(torch, dt))], corrupt)[0]
            j = jhm.apply_corruption([jnp.asarray(g, getattr(jnp, dt))],
                                     jnp.float32(corrupt))[0]
            jv = np.asarray(j.astype(jnp.float32))
            tv = t.float().numpy()
            assert t.dtype == getattr(torch, dt)
            fin = np.isfinite(jv)
            np.testing.assert_array_equal(np.signbit(tv[fin]),
                                          np.signbit(jv[fin]))
            np.testing.assert_array_equal(tv, jv)


def test_one_fault_spec_corrupts_the_same_steps():
    spec = "raise:ArithmeticError@p=0.3"
    seqs = []
    for fault, hm in ((jfault, jhm), (tfault, thm)):
        fault.configure({"health.grad.corrupt": spec}, seed=7)
        seqs.append([hm.corruption_operand() for _ in range(40)])
        fault.reset()
    j, t = (np.array(s) for s in seqs)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert 0 < np.isnan(t).sum() < 40 and not np.isinf(t).any()
    for exc, want in (("OverflowError", np.inf), ("RuntimeError", 1.0)):
        tfault.configure({"health.grad.corrupt": "raise:%s@n=1" % exc})
        assert thm.corruption_operand() == want
        assert thm.corruption_operand() == 0.0
        tfault.reset()


# -- the host half: layer_stats and note_step ----------------------------------

def test_layer_stats_rows_equal_jax():
    data, dts = _leaves(6, ("g", 2, np.inf))
    names = ["p%d" % i for i in range(len(dts))]
    j = jhm.layer_stats(names, [a.astype(d if d == "float32" else "float32")
                                for a, d in zip(data["g"], dts)], data["w"])
    t = thm.layer_stats(names, [torch.from_numpy(a).to(getattr(torch, d))
                                for a, d in zip(data["g"], dts)],
                        [torch.from_numpy(a) for a in data["w"]])
    assert t == j
    assert t[2][1]["g_nonfinite"] == 1


def _meta(plan, act):
    names = ["p%d" % i for i in range(sum(len(b) for b in plan))]
    return {"plan": plan, "names": names,
            "bucket_names": [[names[i] for i in b] for b in plan],
            "action": act, "select": act != "record", "replicated": False}


@pytest.mark.parametrize("act", ["record", "skip_step", "halt"])
def test_note_step_verdicts_equal_jax(act, monkeypatch, tmp_path):
    """One sequence of packed summaries (clean, a loss spike, two poisoned
    steps in a row, clean) into both packages: the same verdicts, stats,
    digests and one numerics dump per episode."""
    for hm in (jhm, thm):
        hm.configure(interval=2, loss_factor=4.0, window=8, min_samples=3)
    seq = [(0, None)] * 4 + [(7, ("loss", 0, 1e3)), (11, None)] \
        + [(8, ("g", 0, np.nan)), (9, ("w", 4, np.inf))] + [(10, None)] * 2
    got = {}
    for name, hm, to in (("jax", jhm, np.asarray),
                         ("torch", thm, torch.from_numpy)):
        monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path / name))
        verdicts = []
        for seed, poison in seq:
            plan, jp, _, _, _ = _summaries((seed, poison))
            data, _ = _leaves(seed, poison)
            v = hm.note_step(jp, _meta(plan, act),
                             [to(a) for a in data["g"]],
                             [to(a) for a in data["w"]], 8)
            verdicts.append((v["anomaly"], v["skipped"],
                             v["halt"] is not None))
        stats = hm.stats()
        got[name] = (verdicts, {k: stats[k] for k in stats
                                if k not in ("enabled", "action")},
                     hm.last_digest(), hm.last_layer_stats(),
                     len([f for f in os.listdir(tmp_path / name)
                          if "_numerics_" in f]))
    assert got["torch"] == got["jax"]
    verdicts, stats, _, _, dumps = got["torch"]
    assert stats["nonfinite_steps"] == 2 and stats["loss_spikes"] == 1
    assert dumps == stats["episodes"] == 2
    assert [v[1] for v in verdicts] == [False] * 6 + [act == "skip_step"] * 2 \
        + [False] * 2


# -- the fused step -------------------------------------------------------------

def _net_step(resnet=False, seed=3):
    """A fused step on the narrow NHWC ResNet (``resnet``: the fused links,
    every kernel wrapper) or on a small conv + BatchNorm + dense net (the
    same step path in a fraction of the time)."""
    if resnet:
        net = tres.ResNetV1(tres.BottleneckV1, *NARROW, classes=10,
                            thumbnail=True, layout="NHWC", fuse=True)
    else:
        nn = mx.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3, layout="NHWC"),
                nn.BatchNorm(axis=-1, in_channels=8), nn.Activation("relu"),
                nn.Flatten(), nn.Dense(10, in_units=8 * 8 * 8))
    net.initialize(ctx=mx.cpu())
    net(torch.zeros(1, 3, 32, 32) if resnet else torch.zeros(1, 8, 8, 3))
    mx.convert.load_numpy_params(net, mx.convert.random_numpy_params(
        mx.convert.param_shapes(net), seed=seed))
    net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return net, tr, mx.gluon.train_step(net, loss, tr)


def _batches(n, resnet=False, seed=1):
    rs = np.random.RandomState(seed)
    shape = (2, 3, 32, 32) if resnet else (2, 8, 8, 3)
    return [(torch.from_numpy(rs.rand(*shape).astype("float32")),
             torch.from_numpy(rs.randint(0, 10, (2,)).astype("float32")))
            for _ in range(n)]


def _state(net, tr):
    """Weights and moving statistics in structural order (two nets differ in
    their name prefixes), optimizer states, update counts."""
    opt = tr._optimizer
    return (dict(enumerate(p._tensor().clone()
                           for p in net.collect_params().values())),
            {i: s.clone() for i, s in tr._updater.states.items()},
            opt.num_update, dict(opt._index_update_count))


def _same(a, b):
    return a[2:] == b[2:] and a[0].keys() == b[0].keys() and all(
        torch.equal(a[0][k], b[0][k]) for k in a[0]) and all(
        torch.equal(a[1][k], b[1][k]) for k in a[1])


@pytest.mark.parametrize("resnet", [True, False])
def test_health_on_is_bit_for_bit_health_off(monkeypatch, resnet):
    monkeypatch.setenv("MXTPU_FUSED_APPLY", "1" if resnet else "0")
    states = {}
    for health in ("0", "1"):
        monkeypatch.setenv("MXTPU_HEALTH", health)
        thm.reset()
        net, tr, step = _net_step(resnet)
        with mx.cpu():
            for x, y in _batches(2, resnet):
                step(x, y)
                assert step.last_mode == "fused"
        states[health] = _state(net, tr)
    assert _same(states["0"], states["1"])
    assert thm.stats()["steps"] == 2 and thm.stats()["anomalies"] == 0


def test_skip_step_is_the_step_that_never_happened(monkeypatch):
    """A poisoned step under skip_step: weights, momenta, moving statistics
    and update counts as before it, one numerics dump; the run then equals
    a run that never saw that batch; the next clean step trains."""
    monkeypatch.setenv("MXTPU_HEALTH", "1")
    monkeypatch.setenv("MXTPU_HEALTH_ACTION", "skip_step")
    b = _batches(3)
    net, tr, step = _net_step()
    ref_net, ref_tr, ref_step = _net_step()
    with mx.cpu():
        step(*b[0])
        ref_step(*b[0])
        before = _state(net, tr)
        tfault.configure({"health.grad.corrupt": "raise:ArithmeticError@n=1"})
        step(*b[1])
        tfault.reset()
        assert _same(before, _state(net, tr))
        assert thm.stats()["skipped_steps"] == 1
        frec = os.environ["MXTPU_FLIGHTREC_DIR"]
        dumps = [os.path.join(frec, p) for p in os.listdir(frec)
                 if "_numerics_" in p]
        assert len(dumps) == 1
        meta = json.load(open(dumps[0]))["metadata"]["trigger_info"]
        assert meta["skipped"] and meta["offending_buckets"]
        step(*b[2])
        ref_step(*b[2])
    assert _same(_state(net, tr), _state(ref_net, ref_tr))
    assert not _same(before, _state(net, tr))
    assert thm.stats()["in_episode"] == 0


def test_halt_raises_with_the_state_kept(monkeypatch):
    monkeypatch.setenv("MXTPU_HEALTH", "1")
    monkeypatch.setenv("MXTPU_HEALTH_ACTION", "halt")
    net, tr, step = _net_step()
    x, y = _batches(1)[0]
    with mx.cpu():
        step(x, y)
        before = _state(net, tr)
        tfault.configure({"health.grad.corrupt": "raise:OverflowError@n=1"})
        with pytest.raises(thm.HealthHaltError):
            step(x, y)
        tfault.reset()
    assert _same(before, _state(net, tr))
    assert thm.stats()["halts"] == 1


def test_monitor_rows_arrive_through_the_fused_step(monkeypatch):
    monkeypatch.setenv("MXTPU_HEALTH", "1")
    net, tr, step = _net_step()
    mon = Monitor(1, pattern=".*weight.*")
    mon.install(net)
    x, y = _batches(1)[0]
    with mx.cpu():
        mon.tic()
        step(x, y)
        rows = mon.toc()
    names = [r[1] for r in rows]
    weights = [n for n in net.collect_params() if "weight" in n]
    assert [n for n in names if "_output" not in n] \
        == [n for w in weights for n in (w, w + "_grad")]
    assert thm.stats()["monitor_rows"] == 2 * len(weights)
    assert len(names) == len(set(names))        # the sweep was skipped


def test_raising_monitor_never_fails_the_step(monkeypatch):
    from mxnet_tpu_torch.gluon import fused_step
    monkeypatch.setenv("MXTPU_HEALTH", "1")
    net, tr, step = _net_step()

    def bad(_x):
        raise RuntimeError("stat_func failed")
    mon = Monitor(1, stat_func=bad, pattern="^$|.*_weight$")
    thm.attach_monitor(mon, params=list(net.collect_params()))
    fused_step.reset_stats()
    with mx.cpu():
        mon.tic()
        step(*_batches(1)[0])
    assert fused_step.stats()["health_errors"] == 1
    assert step.last_mode == "fused" and tr._optimizer.num_update == 1


# -- the surfaces ---------------------------------------------------------------

def test_loss_scaler_feeds_health_with_profiling_off():
    from mxnet_tpu_torch.contrib.amp.loss_scaler import LossScaler
    from mxnet_tpu.contrib.amp.loss_scaler import LossScaler as JLossScaler
    assert not profiler.is_running()
    for scaler, hm in ((JLossScaler, jhm), (LossScaler, thm)):
        s = scaler(init_scale=1024.0, scale_factor=2.0, scale_window=2)
        for overflow in (True, False, False):
            s.update_scale(overflow)
    t = profiler.metrics()["health"]
    for k in ("amp_overflow_skips", "amp_scale_updates", "amp_loss_scale"):
        assert t[k] == jhm.stats()[k]
    assert (t["amp_overflow_skips"], t["amp_loss_scale"]) == (1, 1024.0)


def test_metrics_dumps_and_prometheus(monkeypatch):
    m = profiler.metrics()["health"]
    for key in ("steps", "anomalies", "skipped_steps", "amp_overflow_skips",
                "enabled", "action"):
        assert key in m
    assert "health:" in profiler.dumps()
    monkeypatch.setenv("MXTPU_HEALTH", "1")
    text = profiler.prometheus_text()
    assert 'mxtpu_health_steps_total{rank="%d",kind="checked"}' \
        % profiler.PID in text
    assert "mxtpu_health_anomaly{" in text and "mxtpu_health_loss{" in text
    monkeypatch.setenv("MXTPU_HEALTH", "0")
    assert "mxtpu_health_steps_total" not in profiler.prometheus_text()


# -- TensorInspector -----------------------------------------------------------

def test_tensor_inspector_matches_jax(capsys):
    from mxnet_tpu.tensor_inspector import TensorInspector as JTI
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    a[1, 2] = np.nan
    t, j = TensorInspector(torch.from_numpy(a), tag="x"), JTI(a, tag="x")
    assert t.print_string() == j.print_string()
    assert t.check_value() == j.check_value() == [(1, 2)]
    assert t.has_nan_or_inf() and j.has_nan_or_inf()
    snap = TensorInspector.snapshot({"a": torch.ones(2, dtype=torch.bfloat16),
                                     "b": mx.nd.array(a, ctx=mx.cpu()),
                                     "c": np.zeros(3)})
    assert snap["a"].print_string().startswith("<a 2 bfloat16>")
    assert snap["b"].check_value() == [(1, 2)]
    assert not snap["c"].has_nan_or_inf()
    x = torch.tensor([1.0, float("inf"), -3.0])
    assert TensorInspector.print_in_trace(x, tag="block{0}.d") is x
    assert TensorInspector.check_in_trace(x, tag="g") is x
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("TensorInspector[block{0}.d] <3 float32> nonfinite=1 "
                      "absmax=inf l2=inf")
    assert out[1] == "TensorInspector[g] check: nonfinite=1"
