"""mx.profiler of the port against the JAX package's (mxnet_tpu/profiler.py).

The same scripted calls (names, lanes, durations, samples) go into both
packages' profilers; what they print and return is compared exactly: the
aggregate table's rows, the metrics() sections built from those calls, the
latency percentiles, the lane metadata, the Prometheus families and the
merged traces. Host times are scripted, so "equal apart from times" is
equal here. The eager-loop test runs a narrow NHWC ResNet on the CPU under
the port's profiler and reads its trace.
"""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu.profiler as jprof
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.profiler as tprof
from mxnet_tpu_torch.ndarray import register as treg

BOTH = (jprof, tprof)


@pytest.fixture
def profs(tmp_path):
    for p in BOTH:
        p._reset()
        p.set_config(filename=str(tmp_path / ("%s.json" % p.__name__)),
                     xprof=False, aggregate_stats=True,
                     profile_memory=False, continuous_dump=False)
    yield BOTH
    for p in BOTH:
        p._reset()
        p.set_config(xprof=True, aggregate_stats=False,
                     filename="profile.json")


def _script(p):
    """One scripted run: spans on four lanes, counters, latency samples,
    an account total, a marker."""
    p.set_state("run")
    for i, (name, lane) in enumerate([("Convolution", "imperative"),
                                      ("BatchNorm", "imperative"),
                                      ("autograd.backward", "autograd"),
                                      ("gluon.Trainer.step", "gluon"),
                                      ("Convolution", "imperative"),
                                      ("kvstore.push", "kvstore")]):
        p.record_op(name, 10.0 * (i + 1), category=lane, lane=lane)
    p.record_counter("io.prefetch_queue_depth", 2, lane="io")
    for us in (1.0, 3.0, 5.0, 40.0, 41.5, 900.0, 0.2, 12.0):
        p.record_latency("fused_step.step", us)
    p.account("kvstore.bytes_pushed", 4096)
    p.marker("epoch", args={"n": 1})
    p.set_state("stop")


def _table(text):
    """The aggregate rows and the latency rows of a dumps() text."""
    lines = text.splitlines()
    rows = lines[:lines.index("")]
    lat = [ln for ln in lines
           if ln.startswith(("Latency", "fused_step.step"))]
    counters = [ln for ln in lines if ln.startswith("counters:")]
    return rows, lat, counters


@pytest.mark.parametrize("sort_by", ["total", "count", "min", "max", "avg"])
def test_dumps_rows_equal_jax(profs, sort_by):
    for p in profs:
        _script(p)
    j, t = (_table(p.dumps(sort_by=sort_by)) for p in profs)
    assert t == j
    assert t[0][0].startswith("Name") and len(t[0]) == 6
    assert t[1][1].startswith("fused_step.step")


def test_metrics_equal_jax(profs):
    for p in profs:
        _script(p)
    jm, tm = (p.metrics() for p in profs)
    for key in ("aggregate", "counters", "latency", "compile",
                "clock_sync", "imperative"):
        assert tm[key] == jm[key], key
    # the port's sections are the JAX package's (its own 'profiler'
    # section is added only where a device session ran)
    assert set(tm) <= set(jm)
    assert json.loads(json.dumps(tm)) == tm
    # reset clears both the same way
    jr, tr = (p.metrics(reset=True) for p in profs)
    assert tr["aggregate"] == jr["aggregate"]
    assert tprof.metrics()["aggregate"] == {} == jprof.metrics()["aggregate"]


def test_latency_percentiles_equal_jax(profs):
    """The same samples give the same log-bucket percentiles (the bounded
    ~6% bucket error is the JAX package's, bit for bit here)."""
    rng = np.random.RandomState(0)
    samples = np.exp(rng.uniform(-3, 12, 500)).tolist() + [0.0, 0.49]
    for p in profs:
        p.set_state("run")
        for us in samples:
            p.record_latency("x", us)
        p.set_state("stop")
    j, t = (p.latency_metrics()["x"] for p in profs)
    assert t == j
    assert t["count"] == len(samples) and t["p50_us"] <= t["p95_us"]
    for idx in (-1, 0, 5, 77):
        assert tprof._bucket_bounds(idx) == jprof._bucket_bounds(idx)


def test_lane_metadata_equal_jax():
    """The fixed lanes' rows (dynamic lanes, ensure_lane's, start at
    _DYN_LANE_BASE and depend on what ran before in the process)."""
    def fixed(p):
        return [e for e in p._lane_metadata()
                if e.get("tid", 0) < p._DYN_LANE_BASE]
    assert fixed(tprof) == fixed(jprof)
    assert tprof.ensure_lane("io.w0") == tprof.ensure_lane("io.w0") >= 16
    lanes = {e["args"]["name"] for e in tprof._lane_metadata()
             if e["name"] == "thread_name"}
    assert {"imperative", "autograd", "kvstore", "io", "memory", "gluon",
            "compile", "user"} <= lanes


@pytest.mark.parametrize("kwargs", [
    {"bogus": 1}, {"filename": 3}, {"dump_period": 0},
    {"dump_period": -1.0}, {"aggregate_stats": True, "nope": 2}])
def test_set_config_validation_equal_jax(profs, kwargs):
    """Validated before anything applies: both raise the same error and
    leave the config as it was."""
    msgs = []
    for p in profs:
        before = dict(p._state)
        with pytest.raises(ValueError) as e:
            p.set_config(**kwargs)
        msgs.append(str(e.value))
        assert p._state == before
    assert msgs[0] == msgs[1]


def test_account_counts_with_profiling_off(profs):
    for p in profs:
        assert not p.is_running()
        p.account("io.batches", 3, lane="io")
        p.account("io.batches", 2, lane="io")
        assert p.metrics()["counters"]["io.batches"] == 5
        assert p.metrics()["num_events"] == 0  # no trace event while off


def _families(text):
    keep = ("mxtpu_counter_total", "mxtpu_latency_seconds",
            "mxtpu_span_count", "mxtpu_span_seconds_total",
            "# HELP mxtpu_counter", "# TYPE mxtpu_counter",
            "# HELP mxtpu_latency", "# TYPE mxtpu_latency",
            "# HELP mxtpu_span", "# TYPE mxtpu_span")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_prometheus_text_equal_jax(profs):
    for p in profs:
        _script(p)
    j, t = (_families(p.prometheus_text()) for p in profs)
    assert t == j and any("le=" in ln for ln in t)


def test_serve_metrics_localhost(profs):
    import urllib.request
    tprof.account("kvstore.bytes_pulled", 7)
    port = tprof.serve_metrics(port=0)
    try:
        body = urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % port, timeout=10).read()
        assert b'mxtpu_counter_total{rank="0",name="kvstore.bytes_pulled"}' \
            b" 7" in body
        js = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics.json" % port, timeout=10).read())
        assert js["counters"]["kvstore.bytes_pulled"] == 7
    finally:
        tprof.stop_metrics_server()
    assert tprof._http_server is None


def _shards():
    a = {"traceEvents": [
        {"name": "push", "ph": "X", "ts": 100.0, "dur": 5.0, "pid": 0,
         "tid": 2},
        {"name": "f", "ph": "s", "id": 7, "ts": 101.0, "pid": 0, "tid": 2},
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": 2,
         "args": {"name": "kvstore"}}],
        "metadata": {"rank": 0, "clock_sync": {
            "ps0": {"offset_us": 50.0, "rtt_us": 4.0, "primary": True,
                    "samples": 3}}}}
    b = {"traceEvents": [
        {"name": "serve", "ph": "X", "ts": 140.0, "dur": 9.0, "pid": 9,
         "tid": 2},
        {"name": "f", "ph": "f", "id": 7, "ts": 149.0, "pid": 9, "tid": 2,
         "bp": "e"},
        {"name": "thread_name", "ph": "M", "pid": 9, "tid": 2,
         "args": {"name": "kvstore"}}],
        "metadata": {"rank": 1, "flightrec": True}}
    return [a, b]


@pytest.mark.parametrize("align", [True, False])
def test_merge_traces_equal_jax(tmp_path, align):
    outs = []
    for p in BOTH:
        path = str(tmp_path / ("m_%s.json" % p.__name__))
        merged, summary = p.merge_traces(_shards(), output=path,
                                         align=align)
        with open(path) as f:
            assert json.load(f) == merged
        outs.append((merged, summary))
    assert outs[1] == outs[0]
    assert outs[1][1]["flows_paired"] == 1


def test_device_trace_merges_with_host_trace(profs, tmp_path):
    """The port's device session on the CPU (a CPU-activity kineto
    session): its chrome trace carries the offset from kineto's clock to
    the host trace's, so that after merge_traces the spans of one window
    overlap the host trace's window."""
    xdir = str(tmp_path / "x")
    tprof.set_config(xprof=True, xprof_dir=xdir)
    tprof.set_state("run")
    a = torch.randn(64, 64)
    with tprof.Domain("d").new_task("window"):
        for _ in range(4):
            a = torch.tanh(a @ a)
    tprof.set_state("stop")
    tprof.dump()
    dev = tprof.metrics()["profiler"]
    assert dev["error"] is None and dev["lost"] == 0, dev
    assert os.path.exists(dev["trace"])
    merged, _ = tprof.merge_traces([tprof._state["filename"], dev["trace"]])
    host = [e for e in merged["traceEvents"] if e.get("name") == "d::window"]
    kin = [e for e in merged["traceEvents"]
           if e.get("ph") == "X" and "mm" in str(e.get("name"))]
    assert len(host) == 1 and kin
    h0, h1 = host[0]["ts"], host[0]["ts"] + host[0]["dur"]
    # every matmul of the window inside the host span, within 1 ms of
    # clock-read slack at either end
    bad = [(e["name"], e["ts"]) for e in kin
           if not h0 - 1e3 <= e["ts"] <= h1 + 1e3]
    assert not bad, (h0, h1, bad[:5])
    assert "device trace" not in tprof.dumps().splitlines()[0]


def test_device_session_failure_reported(profs, tmp_path, monkeypatch):
    """A session that cannot start leaves the run host-only, with the
    reason in metrics()['profiler'] and dumps()'s first line."""
    import torch.profiler as tp

    class Refused:
        def __init__(self, *a, **k):
            raise RuntimeError("another profiler is active")
    monkeypatch.setattr(tp, "profile", Refused)
    tprof.set_config(xprof=True, xprof_dir=str(tmp_path / "x"))
    tprof.set_state("run")
    tprof.record_op("Convolution", 5.0)
    tprof.set_state("stop")
    dev = tprof.metrics()["profiler"]
    assert dev["error"] == "RuntimeError: another profiler is active"
    assert dev["trace"] is None
    assert tprof.dumps().splitlines()[0] == \
        "device trace: RuntimeError: another profiler is active"
    assert tprof.metrics()["aggregate"]["Convolution"]["count"] == 1


def test_user_objects_and_legacy_aliases(profs):
    for p in profs:
        p.profiler_set_config(filename=p._state["filename"])
        p.profiler_set_state("run")
        d = p.Domain("net")
        with d.new_task("fwd"):
            pass
        with p.Event("ev"):
            pass
        c = d.new_counter("items", 3)
        c += 2
        d.new_marker("m").mark()
        p.pause()
        with d.new_frame("paused"):
            pass
        p.resume()
        p.profiler_set_state("stop")
        p.dump_profile()
    j, t = (sorted(p.metrics()["aggregate"]) for p in BOTH)
    assert t == j == ["event::ev", "net::fwd"]
    names = []
    for p in BOTH:
        with open(p._state["filename"]) as f:
            names.append([e["name"] for e in json.load(f)["traceEvents"]
                          if e["ph"] != "M" and e["ph"] != "X"])
    assert names[0] == names[1]
    assert "profiler.pause" in names[1] and "items" in names[1]


def test_record_compile_and_kernel_builds(profs, monkeypatch):
    for p in profs:
        p.set_state("run")
        p.record_compile("kernel:conv_fused", key="libconv_fused-ab.so",
                         dur_us=2.5e6, args={"source": "csrc/x.cu"})
        p.set_state("stop")
    j, t = (p.compile_stats() for p in BOTH)
    assert t == j
    assert "Compile" in tprof.dumps()


def _narrow(ctx):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as R
    net = R.ResNetV1(R.BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                     classes=10, thumbnail=True, layout="NHWC", fuse=False)
    net.initialize(ctx=ctx)
    return net


def test_eager_loop_lanes_narrow_resnet(profs):
    """Two eager steps of a narrow NHWC ResNet under the profiler: the
    imperative lane holds its ops (one span per op invoked), the autograd
    and gluon lanes their spans, and the trace names every lane it uses;
    with set_profiler_hooks(False) the imperative lane stays empty."""
    with mx.cpu():
        net = _narrow(mx.cpu())
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        x = torch.randn(2, 3, 32, 32)
        y = torch.tensor([1.0, 3.0])

        def step():
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(2)
        step()
        tprof.set_state("run")
        step()
        step()
        tprof.set_state("stop")
        agg = tprof.metrics()["aggregate"]
        assert agg["autograd.backward"]["count"] == 2
        assert agg["gluon.Trainer.step"]["count"] == 2
        for op in ("Convolution", "BatchNorm", "Activation",
                   "FullyConnected"):
            assert agg[op]["count"] % 2 == 0 and agg[op]["count"] > 0, op
        assert agg["BatchNorm"]["count"] == 2 * 16   # 4 blocks of 4
        tprof.dump()
        with open(tprof._state["filename"]) as f:
            events = json.load(f)["traceEvents"]
        lanes = {e["tid"]: e["args"]["name"] for e in events
                 if e["name"] == "thread_name"}
        used = {lanes[e["tid"]] for e in events if e["ph"] == "X"}
        assert used == {"imperative", "autograd", "gluon"}
        prev = treg.set_profiler_hooks(False)
        try:
            tprof.metrics(reset=True)
            tprof.set_state("run")
            step()
            tprof.set_state("stop")
        finally:
            treg.set_profiler_hooks(prev)
        agg = tprof.metrics()["aggregate"]
        assert "Convolution" not in agg and "autograd.backward" in agg
