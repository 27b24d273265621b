"""mx.storage's allocation ledger, the memory watchdog and the goodput
ledger of the port against the JAX package's (mxnet_tpu/storage.py,
mxnet_tpu/_debug/{memwatch,goodput}.py), on a scripted clock.

The same registrations give the same per-tag bytes and counts (the port
tags storages, so a view adds nothing); the same sample series trips the
leak detector at the same sample; the same step, wait and checkpoint
feeds on the same scripted clock give the same goodput partition, whose
eight categories sum to the wall clock (exactly: the clock is scripted).
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu.storage as jst
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.storage as tst
from mxnet_tpu._debug import goodput as jgp
from mxnet_tpu._debug import memwatch as jmw
from mxnet_tpu_torch._debug import faultpoint as tfp
from mxnet_tpu_torch._debug import flightrec as tfr
from mxnet_tpu_torch._debug import goodput as tgp
from mxnet_tpu_torch._debug import memwatch as tmw
from mxnet_tpu_torch._debug import watchdog as twd


@pytest.fixture(autouse=True)
def clean(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path / "fr"))
    monkeypatch.setenv("MXTPU_RUNS_DIR", str(tmp_path / "runs"))
    for m in (jst, tst):
        m.ledger_reset()
    for m in (jmw, tmw, jgp, tgp):
        m.reset()
    tfr.reset_ring()
    tfp.reset()
    yield
    for m in (jst, tst):
        m.ledger_reset()
    for m in (jmw, tmw, jgp, tgp):
        m.reset()
    twd.reset()
    tfp.reset()


SHAPES = [((64, 3, 3, 3), "param"), ((64,), "param"), ((64,), "grad"),
          ((8, 64), "activation"), ((2, 5, 7), "opt_state"),
          ((128,), "io"), ((3,), "other")]


def test_ledger_bytes_by_tag_equal_jax():
    keep_j, keep_t = [], []
    for shape, tag in SHAPES:
        a = jnp.zeros(shape, jnp.float32)
        t = torch.zeros(shape)
        keep_j.append(a)
        keep_t.append(t)
        jst.ledger_register(a, tag, site="s")
        tst.ledger_register(t, tag, site="s")
    # temporaries that died before the drain integrate as nothing
    jst.ledger_register(jnp.ones((1000,)), "activation")
    tst.ledger_register(torch.ones(1000), "activation")
    j, t = jst.ledger_metrics(), tst.ledger_metrics()
    for key in ("by_tag", "counts", "total_bytes", "registered_total",
                "top_sites"):
        assert t[key] == j[key], key
    assert t["by_device"] == {"cpu": t["total_bytes"]}
    del keep_t[3]                       # an activation dies
    assert tst.ledger_metrics()["by_tag"]["activation"] == 0


def test_ledger_tags_storages_not_views():
    w = torch.zeros(16, 4)
    tst.ledger_register(w, "param")
    tst.ledger_register(w[2:], "activation")     # a view: the same storage
    tst.ledger_register(w.t(), "grad")
    led = tst.ledger_metrics()
    assert led["by_tag"]["param"] == 256 and led["total_bytes"] == 256
    assert led["counts"]["param"] == 1
    g = torch.zeros(8)
    tst.ledger_register(g[:4], "activation")     # the generic tag first
    tst.ledger_metrics()
    tst.ledger_register(g, "opt_state")          # the specific one wins
    assert tst.ledger_metrics()["by_tag"]["opt_state"] == 32
    tst.ledger_retire(g)
    assert tst.ledger_metrics()["by_tag"]["opt_state"] == 0
    # a Parameter's live NDArray view and the parameter: one entry
    with mx.cpu():
        p = mx.gluon.Parameter("p0", shape=(5, 5))
        p.initialize()
        tst.ledger_register(p.data(), "other")
    led = tst.ledger_metrics()
    assert led["by_tag"]["param"] == 256 + 100 and led["by_tag"]["other"] == 0


def test_ledger_off_and_guard():
    prev = tst.set_ledger_enabled(False)
    try:
        tst.ledger_register(torch.zeros(4), "param")
    finally:
        tst.set_ledger_enabled(prev)
    assert tst.ledger_metrics()["total_bytes"] == 0
    tst.ledger_register(3.0, "param")           # not a tensor: ignored
    tst.ledger_register(torch.zeros(2, device="meta"), "param")
    assert tst.ledger_metrics()["total_bytes"] == 0


def test_choke_points_tag_the_training_state():
    """A narrow Dense net's eager step: its parameters, gradients,
    optimizer states and the ops' outputs land under their tags."""
    with mx.cpu():
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        x = mx.nd.array(np.ones((2, 4)))
        with mx.autograd.record():
            out = net(x)
        out.backward()
        tr.step(2)
        led = tst.ledger_metrics()
    assert led["by_tag"]["param"] == (12 + 3) * 4
    assert led["by_tag"]["opt_state"] == (12 + 3) * 4
    assert led["by_tag"]["activation"] >= 2 * 3 * 4   # out stays alive
    assert led["by_tag"]["other"] >= 8 * 4            # x


def test_stats_on_cpu_walk_live_tensors():
    t = torch.zeros(1 << 18)                        # 1 MiB
    st = tst.stats()
    assert [str(s.device) for s in st] == ["cpu"]
    assert st[0].bytes_in_use >= t.numel() * 4
    assert st[0].raw["source"] == "live_tensors"
    assert st[0].peak_since_reset >= st[0].bytes_in_use
    tst.reset_peak()
    n = tst.counters()["empty_cache_calls"]
    tst.release_all()
    assert tst.counters()["empty_cache_calls"] == n + 1
    assert tst.total_bytes_in_use() > 0


def _samples():
    """(now, total bytes, by_tag) series: churn, then monotone growth."""
    out = []
    tot = 1000
    for i in range(40):
        now = 100.0 + i
        if i < 12:
            tot = 1000 + (i % 3) * 10
        else:
            tot += 300 * (i % 2 + 1)
        out.append((now, tot, {"param": 1000, "activation": tot - 1000}))
    return out


def test_memwatch_trips_like_jax(tmp_path):
    trips = []
    for mw in (jmw, tmw):
        mw.configure(window=6, warmup_s=5.0, min_bytes=1000, poll_s=60)
        got = []
        for now, tot, by_tag in _samples():
            snap = {"total_bytes": tot, "by_tag": by_tag, "top_sites": []}
            got.append(mw.observe(snap, now=now))
        st = mw.stats()
        trips.append((got, {k: st[k] for k in ("samples", "trips",
                                               "last_trip_bytes",
                                               "last_slope_bps")}))
    assert trips[1] == trips[0] and sum(trips[1][0]) == 1
    shards = os.listdir(str(tmp_path / "fr"))
    leak = [s for s in shards if "memleak" in s]
    assert leak   # the JAX package's and the port's shards
    d = json.load(open(os.path.join(str(tmp_path / "fr"),
                                    tfr.last_dumps()[-1])))
    assert d["metadata"]["trigger_info"]["top_tags"][0]["tag"] == \
        "activation"


def test_oom_post_mortem_and_error_unchanged(monkeypatch):
    """A failed placement in the creation factories writes one 'oom'
    shard naming the ledger's tags, counts the failure and re-raises the
    error as it was; an OOM already written up adds no second shard at
    the excepthook, an unreported one gets its own 'oom' shard."""
    with mx.cpu():
        keep = mx.nd.ones((32,))
        tfp.configure("storage.alloc=raise:MemoryError@n=1")
        with pytest.raises(MemoryError) as e:
            mx.nd.zeros((4, 4))
        assert "storage.alloc" in str(e.value)
        assert mx.nd.zeros((4, 4)).shape == (4, 4)   # n=1 spent
    assert tst.counters()["alloc_fallbacks"] == 1
    assert len(tfr.last_dumps()) == 1
    d = json.load(open(tfr.last_dumps()[0]))
    info = d["metadata"]["trigger_info"]
    assert d["metadata"]["trigger"] == "oom"
    assert info["requested_bytes"] == 64 and info["where"] == "storage.alloc"
    assert info["ledger_by_tag"]["other"] >= 128
    assert keep.shape == (32,)
    # the caching allocator's error is an OOM; one reported at a
    # placement is not dumped again when it reaches the excepthook
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert tmw.is_oom(oom) and jmw.is_oom(RuntimeError("RESOURCE_EXHAUSTED"))
    assert not tmw.is_oom(ValueError("shape"))
    assert tmw.oom_report(oom, requested_bytes=1 << 31, where="test")
    monkeypatch.setattr(tfr, "_prev_sys_hook", lambda *a: None)
    tfr._sys_excepthook(type(oom), oom, None)
    assert len(tfr.last_dumps()) == 2
    other = torch.cuda.OutOfMemoryError("CUDA out of memory (unhandled)")
    tfr._sys_excepthook(type(other), other, None)
    assert json.load(open(tfr.last_dumps()[-1]))["metadata"]["trigger"] \
        == "oom"


class _Clock:
    def __init__(self):
        self.now = 500.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _goodput_run(gp, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(gp, "time", clock)
    gp.open_run(run_id="run_scripted", meta={"world": 1})
    clock.now += 2.0                                  # set-up: idle
    t = clock.now
    steps = [(1.5, True, "eager-warming"), (0.25, False, "fused"),
             (0.25, False, "fused"), (0.5, True, "fallback:kvstore"),
             (0.25, False, "fused")]
    for dur, warm, mode in steps:
        gp.note_step(t, dur, warmup=warm, mode=mode, sig="fused_step:1")
        t += dur
        gp.note_input_wait(50000.0)                   # 50 ms
        t += 0.125
    gp.note_checkpoint(0.125)
    gp.note_event("marker", step=3)
    clock.now = t + 1.0
    snap = gp.snapshot()
    man = gp.close_run()
    return snap, man


def test_goodput_partition_equal_jax(monkeypatch):
    (js, jm), (ts, tm) = (_goodput_run(gp, monkeypatch)
                          for gp in (jgp, tgp))
    assert ts == js
    for key in ("categories_s", "steps", "counters", "events", "wall_s",
                "goodput_ratio", "schema", "outcome"):
        assert tm[key] == jm[key], key
    cats = tm["categories_s"]
    assert set(cats) == set(tgp.CATEGORIES) and len(cats) == 8
    assert abs(sum(cats.values()) - tm["wall_s"]) <= 1e-9 * tm["wall_s"]
    assert cats["compile"] == 1.5 and cats["compute"] == 0.75
    assert cats["input_wait"] > 0 and cats["recovery"] == 0.0
    assert os.path.exists(tm["manifest_path"])
    assert tgp.load_manifest(tm["manifest_path"])["run_id"] == "run_scripted"


def test_watchdog_beacon_feeds_goodput(monkeypatch):
    """The port's fused step: its beacon feeds goodput, a fused step is
    compute and a fallback step (warm-up, by its mode) host overhead."""
    monkeypatch.setattr(twd, "_ensure_thread", lambda: None)
    with mx.cpu():
        net = mx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        net.hybridize()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        lf = mx.gluon.loss.L2Loss()
        step = mx.gluon.train_step(net, lf, tr)
        x, y = torch.ones(4, 3), torch.zeros(4, 2)
        tgp.open_run(run_id="beacon")
        for _ in range(3):
            step(x, y)
        assert step.last_mode == "fused"
        from mxnet_tpu_torch.gluon import fused_step as fs
        prev = fs.set_fused_step(False)
        try:
            step(x, y)
        finally:
            fs.set_fused_step(prev)
        assert step.last_mode == "fallback:disabled"
        man = tgp.close_run()
    assert man["steps"]["count"] == 3 and man["steps"]["fallback"] == 1
    assert man["steps"]["warmup"] == 1
    assert man["categories_s"]["compute"] > 0
    assert twd.stats()["steps"] == 3 and twd.stats()["warmup_steps"] == 1
    assert list(man["steps"]["signatures"]) == [
        fs._signature((x, y))]
