"""Evaluation metrics, accumulated on the device (counterpart of
mxnet_tpu/metric.py; ref: python/mxnet/metric.py EvalMetric :68,
CompositeEvalMetric :309, Accuracy :393, TopKAccuracy :462, F1 :620, MCC
:721, Perplexity :833, MAE :920, MSE :969, RMSE :1018, CrossEntropy :1067,
NegativeLogLikelihood :1126, PearsonCorrelation :1187, Loss :1230,
Torch/Caffe :1262, CustomMetric :1282, np :1351).

The reference copies every batch to the host and reduces it in numpy. As
in the JAX package, a metric here reduces each batch where its
predictions live, with torch ops queued on that device, and keeps its
running (numerator, denominator) as device scalars: ``update()`` queues
device work and never waits for the device, and ``get()`` reads the
running values with one device-to-host copy. A Speedometer that reads the
metric every 50 batches then syncs once per 50 batches.

The documented exceptions: ``CustomMetric`` and ``np`` hand numpy arrays
to a user function, so they copy their inputs to the host at every
update; F1 and MCC check that the labels are binary when they are read,
not at update (an eager check would sync every batch).

Inputs are NDArrays or tensors (numpy arrays are taken on the host, with
float64 and int64 narrowed to float32 and int32 as the JAX package's
arrays are); a label on another device than its prediction is moved to
the prediction's device.
"""
from __future__ import annotations

import math

import numpy
import torch

from .ndarray.ndarray import NDArray, _to_numpy
from .ops.tensor import topk as _topk

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register", "get"]

_REGISTRY = {}  # mxlint: disable=MX003 (filled by @register decorators at import time, single-threaded; read-only afterwards)
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def register(klass):
    """Register a metric class under its lowercased class name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*names):
    def _add(klass):
        _REGISTRY.update({n.lower(): klass for n in names})
        return klass
    return _add


def get(name):
    return _REGISTRY[name.lower()]


def create(metric, *args, **kwargs):
    """A metric from a name, a callable, an EvalMetric, or a list of them
    (ref: metric.py:50)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, *args, **kwargs))
        return out
    if isinstance(metric, str):
        return get(metric)(*args, **kwargs)
    raise TypeError(
        "cannot create a metric from %r (want str, callable, EvalMetric, "
        "or a list of those)" % (metric,))


def _is_array(x):
    return isinstance(x, (NDArray, torch.Tensor))


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Compare the lengths of ``labels`` and ``preds`` (their shapes with
    ``shape=True``); with ``wrap`` a bare array becomes a list of one
    (ref: metric.py:37)."""
    got = tuple(labels.shape) if shape else len(labels)
    want = tuple(preds.shape) if shape else len(preds)
    if got != want:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(got, want))
    if wrap:
        labels = [labels] if _is_array(labels) else labels
        preds = [preds] if _is_array(preds) else preds
    return labels, preds


def _tensor_of(x):
    """The tensor behind an update() argument, where it lives (a numpy
    array on the host, narrowed as the module docstring says)."""
    if isinstance(x, NDArray):
        return x._data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    t = torch.as_tensor(numpy.asarray(x))
    narrow = _NARROW.get(t.dtype)
    return t if narrow is None else t.to(narrow)


def _pair(label, pred):
    """(label, pred) tensors on pred's device."""
    label, pred = _tensor_of(label), _tensor_of(pred)
    if label.device != pred.device:
        label = label.to(pred.device)
    return label, pred


def _host(values):
    """Python floats of ``values`` (numbers and device scalars), read with
    one device-to-host copy."""
    ts = [v for v in values if isinstance(v, torch.Tensor)]
    if not ts:
        return [float(v) for v in values]
    dev = ts[0].device
    got = iter(torch.stack([t.to(dev, torch.float64).reshape(())
                            for t in ts]).tolist())
    return [next(got) if isinstance(v, torch.Tensor) else float(v)
            for v in values]


class _Running:
    """A lazy (numerator, denominator) pair: host numbers or device
    scalars. Counts start as Python ints, so integer batch statistics
    (hits, element counts) chain as exact int64 device sums."""

    __slots__ = ("num", "den")

    def __init__(self):
        self.clear()

    def clear(self):
        self.num = 0
        self.den = 0

    def add(self, num, den):
        self.num = self.num + num
        self.den = self.den + den

    def value(self):
        num, den = _host([self.num, self.den])
        return num / den if den else float("nan")


class EvalMetric:
    """The metric protocol (ref: metric.py:68): update, reset,
    reset_local, get, get_global, get_name_value, update_dict. The local
    and global windows are ``_Running`` pairs; ``sum_metric`` and
    ``num_inst`` read (and sync) the local one."""

    def __init__(self, name, output_names=None, label_names=None,
                 **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._has_global_stats = kwargs.pop("has_global_stats", False)
        self._kwargs = kwargs
        self._local = _Running()
        self._global = _Running()
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    @property
    def sum_metric(self):
        return _host([self._local.num])[0]

    @sum_metric.setter
    def sum_metric(self, v):
        self._local.num = v

    @property
    def num_inst(self):
        return _host([self._local.den])[0]

    @num_inst.setter
    def num_inst(self, v):
        self._local.den = v

    @property
    def global_sum_metric(self):
        return _host([self._global.num])[0]

    @property
    def global_num_inst(self):
        return _host([self._global.den])[0]

    def _bump(self, num, den):
        """Fold one batch's (numerator, denominator) into both windows."""
        self._local.add(num, den)
        self._global.add(num, den)

    def get_config(self):
        config = dict(self._kwargs)
        config.update(metric=type(self).__name__, name=self.name,
                      output_names=self.output_names,
                      label_names=self.label_names)
        return config

    def update_dict(self, label, pred):
        pred = [pred[k] for k in self.output_names if k in pred] \
            if self.output_names is not None else list(pred.values())
        label = [label[k] for k in self.label_names if k in label] \
            if self.label_names is not None else list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self._local.clear()
        self._global.clear()

    def reset_local(self):
        self._local.clear()

    def get(self):
        return (self.name, self._local.value())

    def get_global(self):
        if self._has_global_stats:
            return (self.name, self._global.value())
        return self.get()

    @staticmethod
    def _as_pairs(name, value):
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))

    def get_name_value(self):
        return self._as_pairs(*self.get())

    def get_global_name_value(self):
        if self._has_global_stats:
            return self._as_pairs(*self.get_global())
        return self.get_name_value()


class _DeviceMetric(EvalMetric):
    """A metric whose ``_stats(label, pred)`` gives a batch's (numerator,
    denominator) as device scalars or Python numbers, folded in without a
    sync."""

    def _stats(self, label, pred):
        raise NotImplementedError

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._bump(*self._stats(*_pair(label, pred)))


@register
@alias("acc")
class Accuracy(_DeviceMetric):
    """The share of argmax predictions equal to the label
    (ref: metric.py:393)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        self.axis = axis
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _stats(self, label, pred):
        if pred.shape != label.shape:       # class scores -> class index
            pred = torch.argmax(pred, dim=self.axis)
        hits = torch.sum(pred.reshape(-1).to(torch.int32)
                         == label.reshape(-1).to(torch.int32))
        return hits, label.numel()


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(_DeviceMetric):
    """The share of labels among the ``top_k`` highest scores of their row
    (ref: metric.py:462); among equal scores the lower class index ranks
    first, as ``lax.top_k`` ranks them."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        if top_k <= 1:
            raise ValueError("use Accuracy for top_k <= 1")
        self.top_k = top_k
        super().__init__("%s_%d" % (name, top_k), top_k=top_k,
                         output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _stats(self, label, pred):
        if pred.dim() > 2:
            raise ValueError("predictions must be 1-D or 2-D, got %d-D"
                             % pred.dim())
        # (N, 1) labels flatten before they meet the k columns
        label = label.reshape(-1)
        if pred.dim() == 1:
            hits = torch.sum(pred.to(torch.int32) == label.to(torch.int32))
        else:
            k = min(self.top_k, pred.shape[1])
            top = _topk(pred.float(), axis=1, k=k, dtype="int32")
            hits = torch.sum(top == label.to(torch.int32)[:, None])
        return hits, pred.shape[0]


class _ConfusionCounts:
    """The binary confusion matrix as device scalars (ref helper:
    metric.py:547 _BinaryClassificationMetrics), with a count of labels
    above 1 for the check at read time."""

    def __init__(self):
        self.reset_stats()

    @staticmethod
    def _batch_tally(label, pred):
        yes = torch.argmax(pred, dim=1) == 1
        lab = label.reshape(-1).to(torch.int32)
        truth = lab == 1
        return (torch.sum(yes & truth), torch.sum(yes & ~truth),
                torch.sum(~yes & truth), torch.sum(~yes & ~truth),
                torch.sum(lab > 1))

    def update_binary_stats(self, label, pred):
        tp, fp, fn, tn, bad = self._batch_tally(*_pair(label, pred))
        self.true_positives = self.true_positives + tp
        self.false_positives = self.false_positives + fp
        self.false_negatives = self.false_negatives + fn
        self.true_negatives = self.true_negatives + tn
        self._bad = self._bad + bad

    def snapshot(self):
        return (self.true_positives, self.false_positives,
                self.false_negatives, self.true_negatives, self._bad)

    def reset_stats(self):
        self.true_positives = 0
        self.false_positives = 0
        self.false_negatives = 0
        self.true_negatives = 0
        self._bad = 0


def _fscore(tp, fp, fn, tn, bad):
    if bad:
        raise ValueError("F1 supports binary labels only; saw a label "
                         "> 1 (checked lazily at read time)")
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    if precision + recall == 0.0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _matthews(tp, fp, fn, tn, bad):
    if bad:
        raise ValueError("MCC supports binary labels only; saw a label "
                         "> 1 (checked lazily at read time)")
    if not (tp + fp + fn + tn):
        return 0.0
    denom = 1.0
    for t in (tp + fp, tp + fn, tn + fp, tn + fn):
        denom *= t or 1.0
    return (tp * tn - fp * fn) / math.sqrt(denom)


class _FFamily(EvalMetric):
    """F1 and MCC: a device confusion matrix read through a score function
    at get(). ``average="macro"`` keeps one snapshot per update and
    averages their scores (the reference's score-and-reset per update,
    with no sync per batch); "micro" pools the counts."""

    _score = None  # staticmethod(_fscore | _matthews)

    def __init__(self, name, output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self._counts = _ConfusionCounts()
        self._snapshots = []
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            if label.shape[0] != pred.shape[0]:
                raise ValueError("label rows %d != pred rows %d"
                                 % (label.shape[0], pred.shape[0]))
            self._counts.update_binary_stats(label, pred)
        if self.average == "macro":
            self._snapshots.append(self._counts.snapshot())
            self._counts.reset_stats()

    def get(self):
        score = type(self)._score
        if self.average == "macro":
            if not self._snapshots:
                return (self.name, float("nan"))
            # one copy for every pending snapshot; the host values are
            # kept, so a second read costs nothing
            flat = _host([c for s in self._snapshots for c in s])
            self._snapshots = [tuple(flat[i:i + 5])
                               for i in range(0, len(flat), 5)]
            vals = [score(*s) for s in self._snapshots]
            return (self.name, sum(vals) / len(vals))
        cells = _host(list(self._counts.snapshot()))
        if not sum(cells[:4]):
            return (self.name, float("nan"))
        return (self.name, score(*cells))

    get_global = get

    def reset(self):
        self._snapshots = []
        self._counts.reset_stats()
        super().reset()

    reset_local = reset


@register
class F1(_FFamily):
    """Binary F1 (ref: metric.py:620)."""

    _score = staticmethod(_fscore)

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)


@register
class MCC(_FFamily):
    """Matthews correlation coefficient (ref: metric.py:721)."""

    _score = staticmethod(_matthews)

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)


@register
class Perplexity(_DeviceMetric):
    """exp of the mean negative log probability of the labels, skipping
    ``ignore_label`` positions (ref: metric.py:833)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        self.ignore_label = ignore_label
        self.axis = axis
        super().__init__(name, ignore_label=ignore_label,
                         output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _stats(self, label, pred):
        classes = pred.shape[-1]
        assert label.numel() * classes == pred.numel(), \
            "label/pred shape mismatch"
        idx = label.reshape(-1).to(torch.int64)
        p = torch.gather(pred.reshape(-1, classes), 1, idx[:, None])[:, 0]
        n = idx.numel()
        if self.ignore_label is not None:
            keep = idx != self.ignore_label
            p = torch.where(keep, p, torch.ones((), dtype=p.dtype,
                                                device=p.device))
            n = torch.sum(keep)
        return -torch.sum(torch.log(torch.clamp_min(p, 1e-10))), n

    def get(self):
        v = self._local.value()
        return (self.name, math.exp(v) if v == v else v)

    def get_global(self):
        v = self._global.value()
        return (self.name, math.exp(v) if v == v else v)


class _PerBatchMean(_DeviceMetric):
    """One value per batch, averaged over batches (the denominator counts
    updates, as in the reference)."""

    _default_name = None

    def __init__(self, name=None, output_names=None, label_names=None):
        super().__init__(name or self._default_name,
                         output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _stats(self, label, pred):
        return self._batch_value(label, pred), 1


@register
@alias("mae")
class MAE(_PerBatchMean):
    """Mean absolute error (ref: metric.py:920)."""

    _default_name = "mae"

    def _batch_value(self, label, pred):
        return torch.mean(torch.abs(label - pred))


@register
@alias("mse")
class MSE(_PerBatchMean):
    """Mean squared error (ref: metric.py:969)."""

    _default_name = "mse"

    def _batch_value(self, label, pred):
        return torch.mean(torch.square(label - pred))


@register
@alias("rmse")
class RMSE(_PerBatchMean):
    """Root mean squared error per batch, averaged over batches (ref:
    metric.py:1018 averages the per-batch roots, not the root of the
    pooled mean)."""

    _default_name = "rmse"

    def _batch_value(self, label, pred):
        return torch.sqrt(torch.mean(torch.square(label - pred)))


@register
@alias("pearsonr")
class PearsonCorrelation(_PerBatchMean):
    """Pearson r per batch (ref: metric.py:1187), from centered moments on
    the device."""

    _default_name = "pearsonr"

    def _batch_value(self, label, pred):
        x = pred.reshape(-1).float()
        y = label.reshape(-1).float()
        xc = x - torch.mean(x)
        yc = y - torch.mean(y)
        return torch.sum(xc * yc) / torch.sqrt(
            torch.sum(torch.square(xc)) * torch.sum(torch.square(yc)))

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            self._bump(*self._stats(*_pair(label, pred)))


class _PickedLogProb(_DeviceMetric):
    """-sum(log p[label]) over an [N, C] probability matrix, per row: the
    frame of CrossEntropy and NegativeLogLikelihood."""

    def __init__(self, eps=1e-12, name=None, output_names=None,
                 label_names=None):
        self.eps = eps
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def _stats(self, label, pred):
        idx = label.reshape(-1).to(torch.int64)
        assert idx.numel() == pred.shape[0], (idx.numel(), pred.shape)
        p = torch.gather(pred, 1, idx[:, None])[:, 0]
        return -torch.sum(torch.log(p + self.eps)), idx.numel()


@register
@alias("ce")
class CrossEntropy(_PickedLogProb):
    """ref: metric.py:1067."""

    def __init__(self, eps=1e-12, name="cross-entropy",
                 output_names=None, label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
@alias("nll_loss")
class NegativeLogLikelihood(_PickedLogProb):
    """ref: metric.py:1126."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Loss(EvalMetric):
    """The running mean of the outputs themselves: the print-the-loss
    metric (ref: metric.py:1230)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)

    def update(self, _, preds):
        if _is_array(preds):
            preds = [preds]
        for pred in preds:
            t = _tensor_of(pred)
            self._bump(torch.sum(t), t.numel())


@register
class Torch(Loss):
    """The frame for torch criterions (ref: metric.py:1262)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """ref: metric.py:1273."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


def _numpy_of(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return _to_numpy(x)
    return numpy.asarray(x)


@register
class CustomMetric(EvalMetric):
    """A user's numpy ``feval(label, pred)`` (ref: metric.py:1282),
    returning a value or (sum, count): the one metric that copies its
    inputs to the host at every update."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:  # lambdas etc.
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            out = self._feval(_numpy_of(label), _numpy_of(pred))
            self._bump(*(out if isinstance(out, tuple) else (out, 1)))

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A bare numpy ``feval(label, pred)`` as a metric
    (ref: metric.py:1351)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register
@alias("composite")
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated, reset and read together
    (ref: metric.py:309)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names, has_global_stats=True)
        self.metrics = [create(m) for m in metrics or []]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            # the reference returns this exception (metric.py:344); it is
            # raised here, as in the JAX package
            raise ValueError("Metric index {} is out of range 0 and {}"
                             .format(index, len(self.metrics)))

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {k: v for k, v in labels.items()
                      if k in self.label_names}
        if self.output_names is not None:
            preds = {k: v for k, v in preds.items()
                     if k in self.output_names}
        for m in self.metrics:
            m.update_dict(labels, preds)

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", ()):
            m.reset()

    def reset_local(self):
        for m in getattr(self, "metrics", ()):
            m.reset_local()

    def _gather(self, one):
        names, values = [], []
        for m in self.metrics:
            name, value = one(m)
            names += name if isinstance(name, list) else [name]
            values += value if isinstance(value, list) else [value]
        return (names, values)

    def get(self):
        return self._gather(lambda m: m.get())

    def get_global(self):
        return self._gather(lambda m: m.get_global())

    def get_config(self):
        config = super().get_config()
        config.update(metrics=[m.get_config() for m in self.metrics])
        return config
