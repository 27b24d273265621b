"""Gluon losses (counterpart of mxnet_tpu/gluon/loss.py): the ``Loss`` base
with its shared weighting tail, and every loss of the JAX package.

Most losses repeat one tail, an optional per-sample weighting and then a
mean over the non-batch axes: it lives once (``_weighted`` and
``_per_sample_mean``), and the elementwise losses state only their term
through the ``_ElementwiseLoss`` template. Every loss goes through the
``F`` op layer, so it runs on tensors inside a net and on NDArrays alike,
and no reduction syncs with the host.

A loss returns one value per sample (``PoissonNLLLoss`` one value in all,
as the reference). Under ``autograd.record()`` a block's output is an
``autograd.Head``, so ``loss.backward()`` on the per-sample vector seeds
ones, as in MXNet.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]

_EPS = 1e-12


def _weighted(F, term, weight, sample_weight):
    """The shared weighting tail: elementwise sample_weight (broadcast),
    then the loss's constant weight."""
    if sample_weight is not None:
        term = F.broadcast_mul(term, sample_weight)
    return term if weight is None else term * weight


def _softplus(F, x):
    """log(1 + exp(x)) via the op layer's softrelu activation."""
    return F.Activation(x, act_type="softrelu")


def _stable_bce(F, z, target):
    """Cross-entropy of sigmoid(z) against target without forming the
    sigmoid: max(z, 0) - z*target + log1p(exp(-|z|))."""
    return F.relu(z) - z * target + _softplus(F, -F.abs(z))


class Loss(HybridBlock):
    """Base: holds the constant weight and which axis indexes samples."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _per_sample_mean(self, F, term, sample_weight):
        """Weighting + mean over every axis except the batch one — the
        tail every elementwise loss shares."""
        term = _weighted(F, term, self._weight, sample_weight)
        return F.mean(term, axis=self._batch_axis, exclude=True)

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)


class _ElementwiseLoss(Loss):
    """Template for losses of the form mean_over_sample(term(pred,
    label)): subclasses implement only `_term`; the label is first
    viewed in pred's shape (the reference reshapes likewise so int
    labels of shape [B] align with preds of [B, 1] etc.)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _term(self, F, pred, label):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        term = self._term(F, pred, label.reshape(pred.shape))
        return self._per_sample_mean(F, term, sample_weight)


class L2Loss(_ElementwiseLoss):
    """Half mean-squared error (the 1/2 makes the gradient pred-label)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _term(self, F, pred, label):
        # the constant 1/2 of the reference's weight/2 folded into the
        # term (scalars commute with the weighting tail)
        return 0.5 * F.square(label - pred)


class L1Loss(_ElementwiseLoss):
    def _term(self, F, pred, label):
        return F.abs(label - pred)


class HuberLoss(_ElementwiseLoss):
    """Quadratic inside |err| <= rho, linear outside."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _term(self, F, pred, label):
        err = F.abs(label - pred)
        return F.where(err > self._rho, err - 0.5 * self._rho,
                       F.square(err) * (0.5 / self._rho))


class HingeLoss(_ElementwiseLoss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _term(self, F, pred, label):
        return F.relu(self._margin - pred * label)


class SquaredHingeLoss(HingeLoss):
    def _term(self, F, pred, label):
        return F.square(super()._term(F, pred, label))


class LogisticLoss(_ElementwiseLoss):
    """Binary logistic loss over raw scores; labels either {-1, 1}
    ("signed", default) or {0, 1} ("binary")."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format must be 'signed' or 'binary', "
                             "got %r" % (label_format,))
        self._label_format = label_format

    def _term(self, F, pred, label):
        if self._label_format == "signed":
            label = (label + 1.0) * 0.5  # {-1,1} -> {0,1}
        return _stable_bce(F, pred, label)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE over logits (default) or over already-sigmoided
    probabilities (from_sigmoid=True), with optional positive-class
    reweighting (ref: gluon/loss.py SigmoidBinaryCrossEntropyLoss)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(pred.shape)
        if self._from_sigmoid:
            pos_term = F.log(pred + _EPS) * label
            if pos_weight is not None:
                pos_term = F.broadcast_mul(pos_term, pos_weight)
            term = -(pos_term + F.log(1 - pred + _EPS) * (1 - label))
        elif pos_weight is None:
            term = _stable_bce(F, pred, label)
        else:
            # log-weight scales only the softplus branch, matching the
            # reference's weighted-logit algebra
            lw = 1 + F.broadcast_mul(pos_weight - 1, label)
            term = pred - pred * label \
                + lw * (_softplus(F, -F.abs(pred)) + F.relu(-pred))
        return self._per_sample_mean(F, term, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Categorical CE over logits; sparse int labels by default, dense
    distributions with sparse_label=False
    (ref: gluon/loss.py SoftmaxCrossEntropyLoss)."""

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


class KLDivLoss(Loss):
    """KL(label || softmax(pred)); pred is log-probabilities when
    from_logits (default), raw scores otherwise."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        term = label * (F.log(label + _EPS) - logp)
        return self._per_sample_mean(F, term, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification, one value per sequence: the
    registered ``ctc_loss`` op (``ops/ctc.py``; blank index 0, labels
    padded with negative values or cut by ``label_lengths``)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        from ..ndarray.register import invoke_by_name
        per_seq = invoke_by_name(
            "ctc_loss", pred, label, pred_lengths=pred_lengths,
            label_lengths=label_lengths, layout=self._layout,
            label_layout=self._label_layout)
        return _weighted(F, per_seq, self._weight, sample_weight)


class TripletLoss(Loss):
    """relu(margin + ||pos - a||^2 - ||neg - a||^2), one value per
    sample (already reduced, so only the weighting tail applies)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        gap = F.sum(F.square(positive.reshape(pred.shape) - pred)
                    - F.square(negative.reshape(pred.shape) - pred),
                    axis=self._batch_axis, exclude=True)
        return _weighted(F, F.relu(gap + self._margin), self._weight,
                         sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood; target * log(target!) tail via
    Stirling when compute_full (ref: gluon/loss.py PoissonNLLLoss —
    which reduces over EVERYTHING, batch included)."""

    _TWO_PI = 6.283185307179586

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-8):
        target = target.reshape(pred.shape)
        if self._from_logits:
            term = F.exp(pred) - target * pred
        else:
            term = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * F.log(target + epsilon) - target
                        + 0.5 * F.log(self._TWO_PI * (target + epsilon)))
            term = term + F.where(target <= 1, F.zeros_like(target),
                                  stirling)
        return F.mean(_weighted(F, term, self._weight, sample_weight))


class CosineEmbeddingLoss(Loss):
    """1 - cos(a, b) for positive pairs, relu(cos - margin) for
    negative ones; returns one value per pair, unreduced like the
    reference."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        a = input1.reshape((input1.shape[0], -1))
        b = input2.reshape((input2.shape[0], -1))
        cos = F.sum(a * b, axis=1) / (
            F.norm(a, axis=1) * F.norm(b, axis=1) + _EPS)
        term = F.where(label.reshape((-1,)) == 1, 1 - cos,
                       F.relu(cos - self._margin))
        return _weighted(F, term, self._weight, sample_weight)
