"""The flight recorder, the step watchdog and the fault points of the port
against the JAX package's (mxnet_tpu/_debug/{flightrec,watchdog,
faultpoint}.py).

The same scripted inputs go into both packages' modules: ring entries,
step series on a scripted clock, fault specs and seeds. The ring renders to
the same chrome-trace events (timestamps within 1e-3 us: each package
subtracts its own trace origin), the watchdog gives the same verdicts and
stats, and one spec with one seed fires at the same calls. A failed
checkpoint write leaves the previous file whole in both.
"""
import json
import os
import signal
import threading
import time
import types

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu.profiler as jprof
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.profiler as tprof
from mxnet_tpu._debug import faultpoint as jfp
from mxnet_tpu._debug import flightrec as jfr
from mxnet_tpu._debug import watchdog as jwd
from mxnet_tpu_torch._debug import faultpoint as tfp
from mxnet_tpu_torch._debug import flightrec as tfr
from mxnet_tpu_torch._debug import watchdog as twd

PAIRS = ((jprof, jfr, jwd, jfp), (tprof, tfr, twd, tfp))


@pytest.fixture(autouse=True)
def clean(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHTREC_DIR", str(tmp_path))
    for prof, fr, wd, fp in PAIRS:
        fr.reset_ring()
        fp.reset()
        wd.reset()
    yield
    for prof, fr, wd, fp in PAIRS:
        fr.reset_ring()
        fp.reset()
        wd.reset()


def _entries(t0):
    return ["Convolution",
            ("X", "gluon.train_step", "gluon", 6, t0 + 0.25, 100.0,
             {"mode": "fused"}),
            "BatchNorm", "Activation",
            ("C", "io.prefetch_queue_depth", "counter", 3, t0 + 0.375, 2,
             None),
            ("C", "memory.ledger", "counter", 5, t0 + 0.5,
             {"param": 10, "grad": 4}, None),
            ("i", "fault:io.prefetch.place", "fault", 7, t0 + 0.625, 0,
             {"action": "delay"}),
            "Pooling"]


def _close(a, b):
    """Rendered events equal, timestamps within 1e-3 us."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if k in ("ts", "dur"):
                assert abs(x[k] - y[k]) <= 1e-3, (k, x, y)
            else:
                assert x[k] == y[k], (k, x, y)


def test_ring_render_equal_jax():
    j, t = (fr._render_events(_entries(prof._t0), prof)
            for prof, fr, _, _ in PAIRS)
    _close(t, j)
    # bare-name breadcrumbs anchor to the nearest timestamped neighbour
    assert t[0]["args"] == {"ts_approx": True} and t[0]["ph"] == "i"
    assert abs(t[0]["ts"] - t[1]["ts"]) <= 1e-3 + 100.0


def test_ring_is_bounded_and_always_on():
    assert tfr.ENABLED and tprof._LIVE
    cap = tfr.stats()["capacity"]
    for i in range(cap + 10):
        tfr.RING.append("op%d" % i)
    assert tfr.stats()["buffered"] == cap
    assert tfr.snapshot()[0] == "op10"


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_manual_and_exception_dumps(tmp_path, monkeypatch):
    tprof.marker("before", args={"k": 1})
    p = tfr.dump("manual", extra={"why": "test"})
    d = _read(p)
    assert d["metadata"]["trigger"] == "manual"
    assert d["metadata"]["trigger_info"] == {"why": "test"}
    assert "goodput" in d["metadata"] and "metrics" in d["metadata"]
    names = [e["name"] for e in d["traceEvents"]]
    assert "before" in names and "flightrec:manual" in names
    assert {"thread_name"} <= set(names)
    # the excepthook chain: a shard, then the previous hook
    seen = []
    monkeypatch.setattr(tfr, "_prev_sys_hook", lambda *a: seen.append(a))
    err = ValueError("boom")
    tfr._sys_excepthook(ValueError, err, None)
    assert seen and seen[0][1] is err
    d = _read(tfr.last_dumps()[-1])
    assert d["metadata"]["trigger"] == "exception"
    assert d["metadata"]["trigger_info"]["exception"] == "ValueError: boom"
    # a worker thread's death
    monkeypatch.setattr(tfr, "_prev_threading_hook", None)
    tfr._threading_excepthook(types.SimpleNamespace(
        exc_type=KeyError, exc_value=KeyError("k"), exc_traceback=None,
        thread=types.SimpleNamespace(name="worker-1")))
    d = _read(tfr.last_dumps()[-1])
    assert d["metadata"]["trigger"] == "thread-exception"
    assert d["metadata"]["trigger_info"]["thread"] == "worker-1"
    assert tfr.stats()["dumps"] == 3 and len(os.listdir(tmp_path)) == 3


def test_sigusr2_writes_one_shard_and_run_goes_on(tmp_path, monkeypatch):
    """SIGUSR2 to this process writes one shard (from a helper thread)
    and changes nothing else."""
    a = np.arange(6.0)
    if threading.current_thread() is threading.main_thread():
        monkeypatch.setattr(tfr, "_prev_sigusr2", None)
        prev = signal.signal(signal.SIGUSR2, tfr._sigusr2_handler)
        try:
            os.kill(os.getpid(), signal.SIGUSR2)
            deadline = time.time() + 20
            while not tfr.last_dumps() and time.time() < deadline:
                time.sleep(0.01)
        finally:
            signal.signal(signal.SIGUSR2, prev)
    else:
        tfr._sigusr2_handler(signal.SIGUSR2, None)
    deadline = time.time() + 20
    while not tfr._sigusr2_inflight.acquire(blocking=False):
        assert time.time() < deadline
        time.sleep(0.01)
    tfr._sigusr2_inflight.release()
    assert len(tfr.last_dumps()) == 1
    assert _read(tfr.last_dumps()[0])["metadata"]["trigger"] == "sigusr2"
    assert np.array_equal(a, np.arange(6.0))


def test_dump_cap_and_swallow(monkeypatch):
    monkeypatch.setattr(tfr, "_MAX_DUMPS", 2)
    assert tfr.dump("manual") and tfr.dump("manual")
    assert tfr.dump("manual") is None            # capped
    monkeypatch.setattr(tfr, "_dump", lambda *a: 1 / 0)
    assert tfr.dump("manual", swallow=True) is None
    with pytest.raises(ZeroDivisionError):
        tfr.dump("manual")
    assert tfr.stats()["dump_failures"] == 2


def test_install_uninstall_restores_hooks():
    import sys
    was = tfr._installed
    tfr.uninstall()
    assert sys.excepthook is not tfr._sys_excepthook
    tfr.install()
    assert sys.excepthook is tfr._sys_excepthook
    tfr.uninstall()
    assert sys.excepthook is not tfr._sys_excepthook
    assert threading.excepthook is not tfr._threading_excepthook
    if was:
        tfr.install()


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


# (duration s, warmup) of each step; 5.0 s min_s, factor 8, 3 samples
SERIES = [(4.0, True), (0.5, False), (0.5, False), (0.6, False),
          (0.5, False), (9.0, False), (0.5, False), (0.7, False)]


def _drive(wd, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(wd, "time", clock)
    monkeypatch.setattr(wd, "_ensure_thread", lambda: None)
    wd.configure(factor=8, min_s=5.0, min_samples=3, window=4)
    verdicts = []
    for dur, warm in SERIES:
        wd.step_begin()
        wd.step_begin()                      # nested: the outer counts
        clock.now += dur
        wd.step_end(warmup=warm, mode="compile" if warm else "fused")
        wd.step_end()
        verdicts.append((wd.stats()["slow_steps"], wd.threshold_s()))
    wd.step_begin()                          # a step held open
    clock.now += 4.0
    verdicts.append(("early", wd._check(clock.now)))
    clock.now += 4.0
    verdicts.append(("late", wd._check(clock.now)))
    verdicts.append(("again", wd._check(clock.now + 10)))
    wd.step_end(mode="fused")
    return verdicts, wd.stats(), wd.last_step()


def test_watchdog_verdicts_equal_jax(monkeypatch):
    """A scripted series on a scripted clock: the same thresholds, the
    same straggler count, one stall (one dump) for the held step, in both
    packages."""
    (jv, js, jl), (tv, ts, tl) = (_drive(wd, monkeypatch)
                                  for _, _, wd, _ in PAIRS)
    assert tv == jv and ts == js and tl == jl
    assert ts["stalls"] == 1 and ts["dumps"] == 1 and ts["slow_steps"] == 1
    assert ts["warmup_steps"] == 1 and ts["steps"] == 8
    d = _read(tfr.last_dumps()[-1])
    assert d["metadata"]["trigger"] == "watchdog"
    assert d["metadata"]["trigger_info"]["step"] == 9


SPECS = ["io.prefetch.place=raise:OSError@p=0.3@skip=2@n=5",
         "checkpoint.save=delay:0ms@p=0.5",
         "storage.alloc=raise:MemoryError@n=2;fused_step.trace="
         "raise:RuntimeError@p=0.25"]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", SPECS)
def test_fault_schedules_equal_jax(spec, seed):
    """One spec and one seed fire at the same calls in both packages."""
    fired = []
    for _, _, _, fp in PAIRS:
        points = fp.configure(spec, seed=seed)
        got = []
        for i in range(60):
            for name in points:
                try:
                    if fp.check(name):
                        got.append((i, name, "delay"))
                except Exception as e:
                    got.append((i, name, type(e).__name__))
        fired.append((got, fp.metrics(), fp.report()))
    assert fired[1] == fired[0]
    assert fired[1][0]


@pytest.mark.parametrize("bad", ["nope=raise:OSError", "io.prefetch.place",
                                 "io.prefetch.place=explode",
                                 "io.prefetch.place=raise:NotAnError",
                                 "io.prefetch.place=raise:OSError@p=2",
                                 "io.prefetch.place=delay:5ms@zz=1"])
def test_fault_spec_errors_equal_jax(bad):
    msgs = []
    for _, _, _, fp in PAIRS:
        with pytest.raises(ValueError) as e:
            fp.configure(bad)
        msgs.append(str(e.value))
        assert not fp.ACTIVE
    assert msgs[0] == msgs[1]


def test_fault_catalog_and_marker():
    assert tfp.POINTS == jfp.POINTS
    tprof._reset()
    tprof.set_config(xprof=False)
    tprof.set_state("run")
    tfp.configure("io.prefetch.place=delay:0ms@n=1")
    assert tfp.check("io.prefetch.place") is True
    assert tfp.check("io.prefetch.place") is False
    tprof.set_state("stop")
    assert tprof.metrics()["faults"] == {"io.prefetch.place": 1}
    assert any(e[1] == "fault:io.prefetch.place" for e in tfr.snapshot()
               if isinstance(e, tuple))
    tprof._reset()
    tprof.set_config(xprof=True)


def test_checkpoint_save_leaves_no_torn_file(tmp_path):
    """checkpoint.save fires between the temp write and the rename: the
    previous file stays whole and no temp file remains, in both."""
    for pkg, (_, _, _, fp) in zip((mxj, mx), PAIRS):
        path = str(tmp_path / ("%s.params" % pkg.__name__))
        with pkg.cpu():
            old = {"w": pkg.nd.array(np.arange(4.0))}
            pkg.nd.save(path, old)
            with open(path, "rb") as f:
                before = f.read()
            fp.configure("checkpoint.save=raise:OSError@n=1")
            with pytest.raises(OSError, match="checkpoint.save"):
                pkg.nd.save(path, {"w": pkg.nd.array(np.ones(9))})
            with open(path, "rb") as f:
                assert f.read() == before
            assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []
            pkg.nd.save(path, {"w": pkg.nd.array(np.ones(9))})  # n=1 spent
            assert pkg.nd.load(path)["w"].shape == (9,)
            assert fp.triggers("checkpoint.save") == 1
