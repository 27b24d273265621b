"""The port's ``callback`` and ``gluon.utils`` held against the JAX
package's on the CPU.

- Callbacks: ``Speedometer`` (auto_reset on and off, no metric, a new
  epoch), ``log_train_metric``, ``LogValidationMetricsCallback`` and
  ``ProgressBar`` print JAX's lines for the same metric values and clock
  readings (``time.time`` is replaced by a counter); the metric windows are
  reset as JAX's; the checkpoint callbacks save JAX's files.
- ``gluon.utils``: ``split_data`` (even and uneven, the error),
  ``split_and_load`` (numpy, NDArray, one and three contexts),
  ``clip_global_norm`` (values within 1e-6 relative, the returned norm,
  the NDArray form, the non-finite warning, a Parameter's gradient scaled
  in place), ``check_sha1``, ``download`` (file URLs, a file already
  there, the IOError) and ``shape_is_known``.
"""
import collections
import hashlib
import logging
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import callback as jcb
from mxnet_tpu import metric as jm
from mxnet_tpu.gluon import utils as ju
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import callback as tcb
from mxnet_tpu_torch import metric as tm
from mxnet_tpu_torch.gluon import utils as tu

Param = collections.namedtuple("BatchEndParam",
                               ["epoch", "nbatch", "eval_metric", "locals"])
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture
def clock(monkeypatch):
    now = [1000.0]

    def fake():
        now[0] += 0.25
        return now[0]
    monkeypatch.setattr(time, "time", fake)
    return now


def _metrics(seed):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 4, 8).astype(np.float32)
    pred = rs.rand(8, 4).astype(np.float32)
    jmet, tmet = jm.Accuracy(), tm.Accuracy()
    jmet.update([mxj.nd.array(label)], [mxj.nd.array(pred)])
    tmet.update([mx.nd.array(label)], [mx.nd.array(pred)])
    return jmet, tmet


def _lines(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name == name]


def _drive(cb_j, cb_t, caplog, clock, batches, with_metric=True):
    """Both callbacks at each (epoch, nbatch), on metrics updated alike
    with one batch before each call, at the same clock readings."""
    jmet, tmet = _metrics(0) if with_metric else (None, None)
    label = np.zeros(8, np.float32)
    pred = np.eye(8, 4, dtype=np.float32)
    for epoch, nbatch in batches:
        if with_metric:
            jmet.update([mxj.nd.array(label)], [mxj.nd.array(pred)])
            tmet.update([mx.nd.array(label)], [mx.nd.array(pred)])
        saved = clock[0]
        cb_j(Param(epoch, nbatch, jmet, None))
        clock[0] = saved
        cb_t(Param(epoch, nbatch, tmet, None))
    want = _lines(caplog, "mxnet_tpu.callback")
    got = _lines(caplog, "mxnet_tpu_torch.callback")
    assert got == want
    return got, jmet, tmet


BATCHES = [(0, n) for n in range(0, 13)] + [(1, n) for n in range(0, 7)]


@pytest.mark.parametrize("auto_reset", [True, False])
def test_speedometer_lines(caplog, clock, auto_reset):
    caplog.set_level(logging.INFO)
    got, jmet, tmet = _drive(jcb.Speedometer(8, 3, auto_reset),
                             tcb.Speedometer(8, 3, auto_reset), caplog,
                             clock, BATCHES)
    assert len(got) == 6 and "samples/sec" in got[0]
    assert repr(tmet.get()) == repr(jmet.get())


def test_speedometer_without_metric(caplog, clock):
    caplog.set_level(logging.INFO)
    got, _, _ = _drive(jcb.Speedometer(4, 5), tcb.Speedometer(4, 5), caplog,
                       clock, BATCHES, with_metric=False)
    assert got and got[0].startswith("Iter[0] Batch [5]")


@pytest.mark.parametrize("auto_reset", [True, False])
def test_log_train_metric_lines(caplog, clock, auto_reset):
    caplog.set_level(logging.INFO)
    got, jmet, tmet = _drive(jcb.log_train_metric(4, auto_reset),
                             tcb.log_train_metric(4, auto_reset), caplog,
                             clock, BATCHES)
    assert got[0].startswith("Iter[0] Batch[0] Train-accuracy=")
    assert repr(tmet.get()) == repr(jmet.get())


def test_validation_and_progress_bar(caplog, capsys, clock):
    caplog.set_level(logging.INFO)
    jmet, tmet = _metrics(3)
    jcb.LogValidationMetricsCallback()(Param(2, 0, jmet, None))
    tcb.LogValidationMetricsCallback()(Param(2, 0, tmet, None))
    tcb.LogValidationMetricsCallback()(Param(2, 0, None, None))
    assert _lines(caplog, "mxnet_tpu_torch.callback") == \
        _lines(caplog, "mxnet_tpu.callback")
    for n in (0, 3, 7, 10):
        jcb.ProgressBar(10, 20)(Param(0, n, None, None))
        want = capsys.readouterr().out
        tcb.ProgressBar(10, 20)(Param(0, n, None, None))
        assert capsys.readouterr().out == want


def test_checkpoint_callbacks_raise(tmp_path):
    """The checkpoint callbacks, which raised until the Module API was
    ported, now save as JAX's: do_checkpoint every ``period`` epochs (the
    same file pair, byte for byte), module_checkpoint through the
    module's save_checkpoint."""
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    for pkg, cb, d in ((mxj, jcb, tmp_path / "j"), (mx, tcb, tmp_path / "t")):
        d.mkdir()
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=2,
                                     name="fc")
        save = cb.do_checkpoint(str(d / "m"), period=2)
        for epoch in range(4):
            save(epoch, net, {"fc_weight": pkg.nd.array(arr + epoch)}, {})
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["m-0002.params", "m-0004.params", "m-symbol.json"]
    for name in ("m-0002.params", "m-0004.params", "m-symbol.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    saved = []

    class _Mod:
        def save_checkpoint(self, prefix, epoch, states):
            saved.append((prefix, epoch, states))
    cb = tcb.module_checkpoint(_Mod(), "prefix", period=2,
                               save_optimizer_states=True)
    for epoch in range(5):
        cb(epoch)
    assert saved == [("prefix", 2, True), ("prefix", 4, True)]
    assert sorted(tcb.__all__) == sorted(jcb.__all__)


# -- gluon.utils ---------------------------------------------------------------

X = np.arange(42, dtype=np.float32).reshape(7, 6)


@pytest.mark.parametrize("num,axis,even", [(1, 0, True), (7, 0, True),
                                           (3, 0, False), (2, 1, True),
                                           (4, 1, False)])
def test_split_data(num, axis, even):
    want = ju.split_data(mxj.nd.array(X), num, axis, even)
    got = tu.split_data(mx.nd.array(X), num, axis, even)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    with pytest.raises(ValueError):
        tu.split_data(mx.nd.array(X), 3)


def test_split_and_load():
    for data in (X, mx.nd.array(X)):
        one = tu.split_and_load(data, [mx.cpu()])
        assert len(one) == 1 and one[0].context == mx.cpu()
        np.testing.assert_array_equal(one[0].asnumpy(), X)
    ctxs = [mx.cpu(0), mx.cpu(1), mx.cpu(2)]
    got = tu.split_and_load(X, ctxs, even_split=False)
    want = ju.split_and_load(X, [mxj.cpu(0)] * 3, even_split=False)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
        assert g.context.device_type == "cpu"
    arr = mx.nd.array(X)       # already there: no copy
    assert tu.split_and_load(arr, [mx.cpu()])[0]._data is arr._data


def _arrays(seed, scale):
    rs = np.random.RandomState(seed)
    return [rs.randn(3, 4).astype(np.float32) * scale,
            rs.randn(5).astype(np.float32) * scale]


@pytest.mark.parametrize("max_norm,scale", [(1.0, 1.0), (100.0, 1.0),
                                            (0.5, 3.0)])
def test_clip_global_norm(max_norm, scale):
    vals = _arrays(0, scale)
    jarr = [mxj.nd.array(v) for v in vals]
    tarr = [mx.nd.array(v) for v in vals]
    want = ju.clip_global_norm(jarr, max_norm)
    got = tu.clip_global_norm(tarr, max_norm)
    assert type(got) is type(want)
    assert abs(got - float(want)) <= RTOL * float(want)
    for g, w in zip(tarr, jarr):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=1e-7)
    tarr = [mx.nd.array(v) for v in vals]
    norm = tu.clip_global_norm(tarr, max_norm, check_isfinite=False)
    assert isinstance(norm, mx.nd.NDArray)
    assert abs(norm.asscalar() - float(want)) <= RTOL * float(want)


def test_clip_global_norm_warns_and_scales_parameter_grads():
    vals = _arrays(1, 1.0)
    vals[1][2] = np.inf
    with pytest.warns(UserWarning, match="nan or inf"):
        tu.clip_global_norm([mx.nd.array(v) for v in vals], 1.0)
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mx.cpu())
    with mx.autograd.record():
        out = net(mx.nd.array(np.ones((2, 4), np.float32)) * 10)
    out.backward()
    before = net.weight._grad_tensor().clone()
    grads = [p.grad() for p in net.collect_params().values()]
    total = np.sqrt(sum(float((g.asnumpy() ** 2).sum()) for g in grads))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        norm = tu.clip_global_norm(grads, 0.1)
    assert abs(norm - total) <= 1e-5 * total
    after = net.weight._grad_tensor()
    np.testing.assert_allclose(after.numpy(),
                               before.numpy() * (0.1 / (total + 1e-8)),
                               rtol=1e-5)


def test_check_sha1_and_download(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"tpu-mx" * 1000)
    digest = hashlib.sha1(src.read_bytes()).hexdigest()
    assert tu.check_sha1(str(src), digest) == ju.check_sha1(str(src), digest)
    assert not tu.check_sha1(str(src), "0" * 40)
    out = tmp_path / "dir"
    out.mkdir()
    got = tu.download("file://" + str(src), path=str(out))
    assert got == ju.download("file://" + str(src), path=str(out))
    assert open(got, "rb").read() == src.read_bytes()
    dest = str(tmp_path / "named.bin")
    assert tu.download("file://" + str(src), path=dest) == dest
    assert tu.download("https://example.invalid/named.bin", path=dest,
                       sha1_hash=digest) == dest
    with pytest.raises(IOError):
        tu.download("https://example.invalid/other.bin",
                    path=str(tmp_path / "other.bin"))
    with pytest.raises(IOError):
        tu.download("https://example.invalid/named.bin", path=dest,
                    sha1_hash="0" * 40)


def test_shape_is_known():
    for shape in (None, (), (2, 3), (2, 0), (-1, 4), [5]):
        assert tu.shape_is_known(shape) == ju.shape_is_known(shape)
    assert sorted(tu.__all__) == sorted(ju.__all__)
    assert torch.is_tensor(mx.nd.array(X)._data)
