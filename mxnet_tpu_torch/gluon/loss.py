"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference
``python/mxnet/gluon/loss.py``): L2, L1, softmax cross-entropy, sigmoid
binary cross-entropy, KL divergence, Huber and hinge, each written with
the NDArray ops, so a loss computed inside ``autograd.record()`` joins
the graph.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SigmoidBinaryCrossEntropyLoss", "KLDivLoss", "HuberLoss",
           "HingeLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        from .. import ndarray as nd

        loss = nd.square(pred - label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return nd.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        from .. import ndarray as nd

        loss = nd.abs(pred - label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return nd.mean(loss, axis=self._batch_axis, exclude=True)


class SoftmaxCrossEntropyLoss(Loss):
    """``sparse_label`` picks the label's log-probability; ``axis`` is the
    class axis."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        from .. import ndarray as nd

        if not self._from_logits:
            pred = nd.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -nd.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            loss = -nd.sum(pred * label, axis=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return nd.mean(loss, axis=self._batch_axis, exclude=True)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None):
        from .. import ndarray as nd

        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            # max(x, 0) - x z + log(1 + exp(-|x|)), the stable form
            loss = nd.relu(pred) - pred * label + \
                nd.Activation(-nd.abs(pred), act_type="softrelu")
        else:
            loss = -(nd.log(pred + 1e-12) * label +
                     nd.log(1. - pred + 1e-12) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return nd.mean(loss, axis=self._batch_axis, exclude=True)


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        from .. import ndarray as nd

        if not self._from_logits:
            pred = nd.log_softmax(pred, axis=self._axis)
        loss = label * (nd.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return nd.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        from .. import ndarray as nd

        loss = nd.abs(pred - label.reshape(pred.shape))
        loss = nd.where(loss > self._rho,
                        loss - 0.5 * self._rho,
                        (0.5 / self._rho) * nd.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return nd.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        from .. import ndarray as nd

        loss = nd.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return nd.mean(loss, axis=self._batch_axis, exclude=True)
