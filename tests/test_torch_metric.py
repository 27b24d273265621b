"""The port's ``metric`` held against the JAX package's on the CPU: every
metric's ``get()`` and ``get_global()`` after three batches, then after
``reset_local()`` and one more batch, within 1e-6 relative (float32
batch statistics summed in another order; counts are exact); names,
``create``/aliases, ``CompositeEvalMetric``, ``update_dict``,
``get_config``, and the errors JAX raises.

``update()`` never waits for the device: with ``Tensor.item``,
``tolist``, ``numpy`` and the scalar conversions counted by monkeypatch,
three updates of every device metric make no call, and ``get()`` makes
one ``tolist`` (one device-to-host copy). ``CustomMetric`` and ``np`` hand
numpy to their function, as documented.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import metric as jm
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import metric as tm

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _inputs(kind, seed):
    rs = np.random.RandomState(seed)
    n, c = 12, 5
    if kind == "class":
        pred = rs.rand(n, c).astype(np.float32)
        pred[0, 1] = pred[0, 3] = pred[0].max() + 1     # a tie
        return rs.randint(0, c, n).astype(np.float32), pred
    if kind == "prob":
        p = rs.rand(n, c).astype(np.float32) + 0.1
        return rs.randint(0, c, n).astype(np.float32), \
            p / p.sum(1, keepdims=True)
    if kind == "binary":
        return rs.randint(0, 2, n).astype(np.float32), \
            rs.rand(n, 2).astype(np.float32)
    if kind == "index":
        return rs.randint(0, c, n).astype(np.float32), \
            rs.randint(0, c, n).astype(np.float32)
    if kind == "seq":
        p = rs.rand(3, 4, c).astype(np.float32) + 0.05
        return rs.randint(0, c, (3, 4)).astype(np.float32), \
            p / p.sum(-1, keepdims=True)
    return rs.randn(n, 3).astype(np.float32), \
        rs.randn(n, 3).astype(np.float32)


CASES = [
    ("Accuracy", {}, "class"), ("Accuracy", {}, "index"),
    ("Accuracy", {"axis": 1, "name": "acc2"}, "class"),
    ("TopKAccuracy", {"top_k": 2}, "class"),
    ("TopKAccuracy", {"top_k": 3}, "class"),
    ("TopKAccuracy", {"top_k": 9}, "class"),
    ("F1", {}, "binary"), ("F1", {"average": "micro"}, "binary"),
    ("MCC", {}, "binary"), ("MCC", {"average": "micro"}, "binary"),
    ("Perplexity", {"ignore_label": None}, "seq"),
    ("Perplexity", {"ignore_label": 2}, "seq"),
    ("MAE", {}, "reg"), ("MSE", {}, "reg"), ("RMSE", {}, "reg"),
    ("CrossEntropy", {}, "prob"), ("NegativeLogLikelihood", {}, "prob"),
    ("PearsonCorrelation", {}, "reg"), ("Loss", {}, "reg"),
    ("Torch", {}, "reg"), ("Caffe", {}, "reg"),
]
IDS = ["%s%d" % (c[0], i) for i, c in enumerate(CASES)]


def _close(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, str):
        assert got == want
    elif np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= RTOL * max(abs(want), 1e-12), (got, want)


def _update(metric, nd, label, pred, kind):
    if kind in ("reg",) and isinstance(metric, (jm.Loss, tm.Loss)):
        metric.update(None, [nd.array(pred)])
    else:
        metric.update([nd.array(label)], [nd.array(pred)])


@pytest.mark.parametrize("name,kw,kind", CASES, ids=IDS)
def test_metric_matches_jax(name, kw, kind):
    jmet, tmet = getattr(jm, name)(**kw), getattr(tm, name)(**kw)
    assert tmet.name == jmet.name
    for seed in range(3):
        label, pred = _inputs(kind, seed)
        _update(jmet, mxj.nd, label, pred, kind)
        _update(tmet, mx.nd, label, pred, kind)
    for read in ("get", "get_global", "get_name_value",
                 "get_global_name_value"):
        _close(list(getattr(tmet, read)()), list(getattr(jmet, read)()))
    jmet.reset_local()
    tmet.reset_local()
    label, pred = _inputs(kind, 9)
    _update(jmet, mxj.nd, label, pred, kind)
    _update(tmet, mx.nd, label, pred, kind)
    _close(list(tmet.get()), list(jmet.get()))
    _close(list(tmet.get_global()), list(jmet.get_global()))
    if not isinstance(jmet, jm._FFamily):
        _close(tmet.sum_metric, float(jmet.sum_metric))
        _close(tmet.num_inst, float(jmet.num_inst))
    tmet.reset()
    jmet.reset()
    _close(list(tmet.get()), list(jmet.get()))
    assert tmet.get_config() == jmet.get_config()


def test_metric_inputs_as_tensors_and_bare_arrays():
    label, pred = _inputs("class", 1)
    want = jm.Accuracy()
    want.update(mxj.nd.array(label), mxj.nd.array(pred))
    for lab, prd in ((torch.from_numpy(label), torch.from_numpy(pred)),
                     (mx.nd.array(label), mx.nd.array(pred)),
                     ([label], [pred])):
        got = tm.Accuracy()
        got.update(lab, prd)
        _close(list(got.get()), list(want.get()))
    got = tm.Accuracy()
    got.update([mx.nd.array(label)],
               [mx.nd.array(pred).astype("bfloat16")])
    want_bf = jm.Accuracy()
    want_bf.update([mxj.nd.array(label)],
                   [mxj.nd.array(pred).astype("bfloat16")])
    _close(list(got.get()), list(want_bf.get()))


def test_errors_match_jax():
    with pytest.raises(ValueError):
        tm.TopKAccuracy(top_k=1)
    for mod, nd in ((jm, mxj.nd), (tm, mx.nd)):
        with pytest.raises(ValueError):
            mod.Accuracy().update([nd.array(np.zeros(3))],
                                  [nd.array(np.zeros(3)),
                                   nd.array(np.zeros(3))])
        f1 = mod.F1()
        f1.update([nd.array(np.array([0, 2, 1], np.float32))],
                  [nd.array(np.random.rand(3, 2).astype(np.float32))])
        with pytest.raises(ValueError, match="binary"):
            f1.get()
        with pytest.raises(ValueError):
            mod.TopKAccuracy(top_k=2).update(
                [nd.array(np.zeros(2))], [nd.array(np.zeros((2, 2, 2)))])
        with pytest.raises(ValueError):
            mod.CompositeEvalMetric().get_metric(3)
        with pytest.raises(TypeError):
            mod.create(3)
        with pytest.raises(NotImplementedError):
            mod.CustomMetric(lambda a, b: 0.0).get_config()


def test_create_aliases_composite_and_custom():
    names = ["acc", "top_k_accuracy", "top_k_acc", "f1", "mcc", "mae",
             "mse", "rmse", "ce", "nll_loss", "pearsonr", "loss",
             "composite", "accuracy", "crossentropy", "perplexity"]
    for n in names:
        kw = {"top_k": 2} if n.startswith("top_k") else \
            {"ignore_label": None} if n == "perplexity" else {}
        assert type(tm.create(n, **kw)).__name__ == \
            type(jm.create(n, **kw)).__name__
    assert sorted(tm._REGISTRY) == sorted(jm._REGISTRY)
    assert sorted(tm.__all__) == sorted(jm.__all__)

    def feval(label, pred):
        assert isinstance(label, np.ndarray) and isinstance(pred, np.ndarray)
        return float(np.abs(label - pred.argmax(1)).sum()), label.size

    jc = jm.create(["acc", feval, jm.CrossEntropy()])
    tc = tm.create(["acc", feval, tm.CrossEntropy()])
    assert isinstance(tc, tm.CompositeEvalMetric)
    for seed in range(3):
        label, pred = _inputs("class", seed)
        jc.update([mxj.nd.array(label)], [mxj.nd.array(pred)])
        tc.update([mx.nd.array(label)], [mx.nd.array(pred)])
    _close(list(tc.get()), list(jc.get()))
    _close(list(tc.get_global()), list(jc.get_global()))
    assert tc.get_metric(1).name == jc.get_metric(1).name == "feval"
    jn = jm.np(lambda lab, prd: float((lab == prd.argmax(1)).mean()))
    tn = tm.np(lambda lab, prd: float((lab == prd.argmax(1)).mean()))
    assert tn.name == jn.name
    label, pred = _inputs("class", 4)
    jn.update([mxj.nd.array(label)], [mxj.nd.array(pred)])
    tn.update([mx.nd.array(label)], [mx.nd.array(pred)])
    _close(list(tn.get()), list(jn.get()))
    jc = jm.CompositeEvalMetric(["acc", "ce"], output_names=["out"],
                                label_names=["lab"])
    tc = tm.CompositeEvalMetric(["acc", "ce"], output_names=["out"],
                                label_names=["lab"])
    label, pred = _inputs("class", 5)
    jc.update_dict({"lab": mxj.nd.array(label), "x": mxj.nd.array(label)},
                   {"out": mxj.nd.array(pred)})
    tc.update_dict({"lab": mx.nd.array(label), "x": mx.nd.array(label)},
                   {"out": mx.nd.array(pred)})
    _close(list(tc.get()), list(jc.get()))
    assert str(tm.Accuracy()).startswith("EvalMetric: {'accuracy'")


class _SyncCounter:
    """Counts the host reads of a tensor's values."""

    NAMES = ("item", "tolist", "numpy", "__bool__", "__float__",
             "__int__", "__index__")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, _name=name, **k):
                self.calls.append(_name)
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("name,kw,kind", CASES, ids=IDS)
def test_update_makes_no_host_sync(name, kw, kind, monkeypatch):
    inputs = [_inputs(kind, seed) for seed in range(3)]
    arrays = [(mx.nd.array(lab), mx.nd.array(prd)) for lab, prd in inputs]
    metric = getattr(tm, name)(**kw)
    counter = _SyncCounter(monkeypatch)
    for lab, prd in arrays:
        if isinstance(metric, tm.Loss):
            metric.update(None, [prd])
        else:
            metric.update([lab], [prd])
    assert counter.calls == [], counter.calls
    metric.get()
    assert counter.calls == ["tolist"]
