"""Gluon losses (counterpart of mxnet_tpu/gluon/loss.py): the ``Loss`` base
with its shared weighting tail, and ``SoftmaxCrossEntropyLoss``.

A loss returns one value per sample (the mean over every axis but the
batch axis). Under ``autograd.record()`` that is an ``autograd.Head``, so
``loss.backward()`` on the per-sample vector seeds ones, as in MXNet.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _weighted(F, term, weight, sample_weight):
    """The shared weighting tail: elementwise sample_weight (broadcast),
    then the loss's constant weight."""
    if sample_weight is not None:
        term = F.broadcast_mul(term, sample_weight)
    return term if weight is None else term * weight


class Loss(HybridBlock):
    """Base: holds the constant weight and which axis indexes samples."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _per_sample_mean(self, F, term, sample_weight):
        """Weighting, then the mean over every axis except the batch one."""
        term = _weighted(F, term, self._weight, sample_weight)
        return F.mean(term, axis=self._batch_axis, exclude=True)

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)


class SoftmaxCrossEntropyLoss(Loss):
    """Categorical cross-entropy over logits; sparse integer labels by
    default, dense distributions with ``sparse_label=False``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            term = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            term = -F.sum(logp * label.reshape(logp.shape),
                          axis=self._axis, keepdims=True)
        return self._per_sample_mean(F, term, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
