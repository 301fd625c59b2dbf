"""Evaluation metrics (reference ``python/mxnet/metric.py``).

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``,
``CompositeEvalMetric``, ``LazyEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``F1``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``Loss``, ``CustomMetric``, ``np`` and ``create``.
Metrics read their inputs on the host (``asnumpy``), as in the JAX
package.
"""
from __future__ import annotations

import logging
import math

import numpy as _np

from .base import _Registry
from .ndarray import NDArray

_logger = logging.getLogger(__name__)

__all__ = ["EvalMetric", "CompositeEvalMetric", "LazyEvalMetric",
           "Accuracy", "TopKAccuracy", "F1", "Perplexity", "MAE", "MSE",
           "RMSE", "CrossEntropy", "Loss", "CustomMetric", "np", "create",
           "register"]

_registry = _Registry("metric")


def register(klass, *names):
    for n in (names or [klass.__name__.lower()]):
        _registry.register(n, klass)
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _registry.get(str(metric).lower())(*args, **kwargs)


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(label_shape, pred_shape))


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.num_nonfinite = 0
        self.reset()

    def update_dict(self, label, pred):
        pred = [pred[name] for name in self.output_names] \
            if self.output_names is not None else list(pred.values())
        label = [label[name] for name in self.label_names] \
            if self.label_names is not None else list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def _accumulate(self, sum_inc, num_inc):
        """Fold one increment into the running sums, unless it is
        non-finite: a NaN batch is dropped and counted in
        ``num_nonfinite`` (with a throttled warning) instead of poisoning
        the rest of the epoch."""
        if not _np.all(_np.isfinite(sum_inc)):
            self.num_nonfinite += 1
            if self.num_nonfinite == 1 or self.num_nonfinite % 100 == 0:
                _logger.warning(
                    "metric %s: dropped non-finite update #%d (value %r); "
                    "the running metric excludes these batches",
                    self.name, self.num_nonfinite, sum_inc)
            return
        self.sum_metric += sum_inc
        self.num_inst += num_inc

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.num_nonfinite = 0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            values.append(value)
        return names, values


class LazyEvalMetric(EvalMetric):
    """Deferred-sync wrapper for the training loop: buffers (labels,
    preds) references and replays them into the wrapped metric at an
    explicit :meth:`flush`, at any ``get`` (what a ``Speedometer``
    calls), or every ``sync_period`` updates.  What it buffers is never
    written in place (a multi-step call's outputs come back as copies of
    its graph's buffers), so a buffered reference still holds the step's
    value when it is read."""

    def __init__(self, base, sync_period=None, **kwargs):
        self._base = create(base)
        self._pending = []
        self._sync_period = sync_period
        super().__init__(self._base.name, **kwargs)

    def update(self, labels, preds):
        self._pending.append((list(labels or []), list(preds)))
        if self._sync_period and len(self._pending) >= self._sync_period:
            self.flush()

    def flush(self):
        pending, self._pending = self._pending, []
        for labels, preds in pending:
            self._base.update(labels, preds)

    def reset(self):
        self._pending = []
        self._base.reset()

    def get(self):
        self.flush()
        return self._base.get()


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            label = label.astype("int32").ravel()
            pred = pred.astype("int32").ravel()
            check_label_shapes(label, pred, shape=1)
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("top_k should be >1; use Accuracy for top_k=1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            if pred.ndim != 2:
                raise ValueError("Predictions should be 2 dims")
            pred_idx = _np.argsort(pred.astype("float32"), axis=1)
            num_samples, num_classes = pred_idx.shape
            for j in range(min(num_classes, self.top_k)):
                self.sum_metric += (
                    pred_idx[:, num_classes - 1 - j].ravel() ==
                    label.astype("int32").ravel()).sum()
            self.num_inst += num_samples


@register
class F1(EvalMetric):
    """Binary F1 (reference F1: predictions argmax'd, labels in {0, 1}),
    averaged over the updates."""

    def __init__(self, name="f1", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            if pred.ndim > 1:
                pred = pred.argmax(axis=1)
            pred = pred.ravel()
            if not set(_np.unique(label)).issubset({0., 1.}):
                raise ValueError("F1 currently only supports binary labels")
            tp = ((pred == 1) & (label == 1)).sum()
            fp = ((pred == 1) & (label == 0)).sum()
            fn = ((pred == 0) & (label == 1)).sum()
            precision = tp / (tp + fp) if tp + fp > 0 else 0.
            recall = tp / (tp + fn) if tp + fn > 0 else 0.
            if precision + recall > 0:
                self.sum_metric += 2 * precision * recall / (precision +
                                                             recall)
            self.num_inst += 1


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels; positions
    whose label is ``ignore_label`` count neither way."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        loss, num = 0., 0
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            label = label.astype("int32").ravel()
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss += -_np.log(_np.maximum(1e-10, probs)).sum()
            num += label.shape[0]
        try:
            ppl = math.exp(loss / max(1, num))
        except OverflowError:
            ppl = float("inf")
        self._accumulate(ppl, 1)


def _as_2d(label, pred):
    label, pred = _as_numpy(label), _as_numpy(pred)
    if label.ndim == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.ndim == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_2d(label, pred)
            self._accumulate(_np.abs(label - pred).mean(), 1)


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_2d(label, pred)
            self._accumulate(((label - pred) ** 2.0).mean(), 1)


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_2d(label, pred)
            self._accumulate(_np.sqrt(((label - pred) ** 2.0).mean()), 1)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            label = label.ravel()
            if label.shape[0] != pred.shape[0]:
                raise ValueError("CrossEntropy: %d labels for %d rows"
                                 % (label.shape[0], pred.shape[0]))
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self._accumulate((-_np.log(prob + self.eps)).sum(),
                             label.shape[0])


@register
class Loss(EvalMetric):
    """Mean of raw outputs (for MakeLoss-style heads)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in preds:
            pred = _as_numpy(pred)
            self._accumulate(pred.sum(), pred.size)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 **kwargs):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                self._accumulate(*reval)
            else:
                self._accumulate(reval, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference ``metric.np``)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = name if name else numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


register(CrossEntropy, "ce", "crossentropy", "cross-entropy")
register(Accuracy, "acc")
register(TopKAccuracy, "top_k_accuracy", "top_k_acc")
