"""The lock-order tracer and the retry policy of the port against the JAX
package's (mxnet_tpu/_debug/locktrace.py, mxnet_tpu/_retry.py).

The same lock sequences give the same order graph, the same inversions and
the same boundary findings in both; the port's observability layer runs
under the tracer with no inversion. The same retry policy under one
fault-point seed sleeps the same sequence in both.
"""
import threading
import time

import pytest
import torch

import mxnet_tpu._retry as jretry
import mxnet_tpu_torch as mx
import mxnet_tpu_torch._retry as tretry
import mxnet_tpu_torch.profiler as tprof
from mxnet_tpu._debug import locktrace as jlt
from mxnet_tpu_torch._debug import locktrace as tlt

BOTH = (jlt, tlt)


@pytest.fixture
def tracing():
    prev = [lt.enable() for lt in BOTH]
    for lt in BOTH:
        lt.reset()
    yield
    for lt, p in zip(BOTH, prev):
        lt.reset()
        if not p:
            lt.disable()


def _inversion(lt, tag):
    a = lt.named_lock("%s.a" % tag)
    b = lt.named_lock("%s.b" % tag)
    c = lt.named_lock("%s.c" % tag)
    with a:
        with b:
            with c:
                pass
    with c:
        with a:                  # c -> a against a -> c: one inversion
            pass
    for _ in range(3):
        with b:
            with a:              # b -> a against a -> b: one more
                pass


def _boundary(lt, tag):
    lk = lt.named_lock("%s.held" % tag)
    lt.boundary("clean")
    with lk:
        lt.boundary("device.sync")
    re = lt.named_lock("%s.re" % tag, reentrant=True)
    with re:
        with re:
            pass
    cond = lt.named_condition("%s.cond" % tag)
    got = []

    def waiter():
        with cond:
            while not got:
                cond.wait(5)
    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        got.append(1)
        cond.notify_all()
    t.join(5)


def _shape(report):
    """A report without its stacks and its process-wide lock registry."""
    out = dict(report)
    out.pop("locks")
    out["inversions"] = [{k: v for k, v in i.items() if k != "stack"}
                         for i in report["inversions"]]
    out["boundary_violations"] = [
        {k: v for k, v in b.items() if k != "stack"}
        for b in report["boundary_violations"]]
    return out


@pytest.mark.parametrize("script", [_inversion, _boundary])
def test_same_findings_as_jax(tracing, script):
    for lt in BOTH:
        script(lt, "t")
    j, t = (_shape(lt.report()) for lt in BOTH)
    assert t == j
    if script is _inversion:
        assert t["inversion_total"] == 2
        assert sorted(map(sorted, (i["pair"] for i in t["inversions"]))) \
            == [["t.a", "t.b"], ["t.a", "t.c"]]
    else:
        assert t["boundary_violation_total"] == 1
        assert t["boundary_violations"][0]["held"] == ["t.held"]


def test_disabled_is_a_plain_lock():
    prev = tlt.disable()
    try:
        tlt.reset()
        lk = tlt.named_lock("t.off")
        with lk:
            assert lk.locked()
        assert not lk.locked()
        assert tlt.report()["acquisitions"] == 0
        assert "locks" not in tprof.metrics()
    finally:
        if prev:
            tlt.enable()


def test_observability_layer_under_tracer(tracing, tmp_path, monkeypatch):
    """The profiler's daemons (memory sampler, continuous dump), the
    ledger, the io stats, goodput and the watchdog, driven from two
    threads under the tracer: no inversion, findings in metrics()."""
    from mxnet_tpu_torch._debug import goodput, watchdog
    monkeypatch.setenv("MXTPU_RUNS_DIR", str(tmp_path / "runs"))
    tprof._reset()
    tprof.set_config(filename=str(tmp_path / "p.json"), xprof=False,
                     profile_memory=True, continuous_dump=True,
                     dump_period=0.02)
    goodput.open_run(run_id="locks")
    tprof.set_state("run")
    try:
        def work():
            with mx.cpu():
                for i in range(20):
                    a = mx.nd.ones((8, 8)) * i
                    tprof.account("io.batches", 1, lane="io")
                    tprof.record_latency("x", float(i))
                    watchdog.step_begin()
                    watchdog.step_end(mode="fused")
                    _ = (a + 1).asnumpy()
        ts = [threading.Thread(target=work) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        time.sleep(0.1)
    finally:
        tprof.set_state("stop")
        goodput.close_run()
        watchdog.reset()
    rep = tprof.metrics()["locks"]
    assert rep["enabled"] and rep["acquisitions"] > 0
    assert rep["inversion_total"] == 0, rep["inversions"]
    assert "profiler.events" in rep["locks"]
    tprof._reset()
    tprof.set_config(xprof=True, profile_memory=False,
                     continuous_dump=False, filename="profile.json")


class _Failing:
    def __init__(self, n, exc=ConnectionError):
        self.n, self.calls, self.exc = n, 0, exc

    def __call__(self):
        self.calls += 1
        if self.calls <= self.n:
            raise self.exc("down %d" % self.calls)
        return "ok"


def _sleeps(mod, monkeypatch, seed, fail, **policy):
    slept = []
    monkeypatch.setattr(mod.time, "sleep", slept.append)
    if seed is None:
        monkeypatch.delenv("MXNET_FAULTPOINTS_SEED", raising=False)
    else:
        monkeypatch.setenv("MXNET_FAULTPOINTS_SEED", str(seed))
    fn = _Failing(fail)
    retries = []
    try:
        out = mod.call(fn, policy=mod.RetryPolicy(**policy),
                       on_retry=lambda a, e, d: retries.append((a, str(e))))
    except ConnectionError as e:
        out = "raised: %s" % e
    return slept, retries, out, fn.calls


@pytest.mark.parametrize("seed,fail,policy", [
    (7, 3, {}), (7, 20, {"max_retries": 5}), (11, 4, {"cap": 0.1}),
    (3, 30, {"deadline": 1.0, "base": 0.2, "max_retries": 50}),
    (5, 2, {"max_retries": 0})])
def test_retry_sleeps_equal_jax(monkeypatch, seed, fail, policy):
    """Under one fault-point seed the jitter stream is seeded, so both
    packages sleep the same sequence, retry the same attempts and give
    up at the same point (deadline or count)."""
    j = _sleeps(jretry, monkeypatch, seed, fail, **policy)
    t = _sleeps(tretry, monkeypatch, seed, fail, **policy)
    assert t == j
    slept = t[0]
    cap = policy.get("cap", 2.0)
    assert all(0 < s <= 1.5 * cap for s in slept)


def test_retry_env_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_PS_RETRY_MAX", "2")
    monkeypatch.setenv("MXTPU_PS_RETRY_BASE", "0.5")
    monkeypatch.setenv("MXTPU_PS_RETRY_CAP", "0.75")
    monkeypatch.setenv("MXTPU_PS_RETRY_DEADLINE", "9")
    for mod in (jretry, tretry):
        p = mod.RetryPolicy()
        assert (p.max_retries, p.base, p.cap, p.deadline) == \
            (2, 0.5, 0.75, 9.0)
    slept, retries, out, calls = _sleeps(tretry, monkeypatch, 1, 5)
    assert out.startswith("raised") and calls == 3 and len(slept) == 2
    assert torch.tensor(slept).le(0.75 * 1.5).all()
