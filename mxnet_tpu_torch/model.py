"""Checkpoint helpers (reference ``python/mxnet/model.py:340-404``).

Counterpart of ``mxnet_tpu/model.py``'s ``save_checkpoint`` and
``load_checkpoint``, in the same format: ``prefix-symbol.json`` holds
the graph JSON and ``prefix-%04d.params`` a flat ``.npz`` of arrays with
``arg:``/``aux:`` name prefixes, so a checkpoint written by either
package loads in the other.  ``FeedForward`` is the reference's legacy
estimator, a thin veneer over ``Module`` as in the JAX package.
"""
from __future__ import annotations

import os

from .base import MXNetError
from . import symbol as sym_mod
from .ndarray import save as nd_save, load as nd_load
from .module.base_module import BatchEndParam  # noqa: F401  (reference home)

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam",
           "FeedForward"]


def _atomic_replace(path, write_cb):
    """``write_cb(tmp)`` writes under a temp name (returning the path it
    actually wrote, for writers that append a suffix), then one
    ``os.replace`` publishes it: a crash mid-save leaves ``path`` as it
    was."""
    from .testing import faults

    tmp = "%s.tmp-%d" % (path, os.getpid())
    actual = None
    try:
        actual = write_cb(tmp) or tmp
        faults.inject("checkpoint_io")
        os.replace(actual, path)
    except BaseException:
        for leftover in {tmp, actual}:
            if leftover and os.path.exists(leftover):
                os.remove(leftover)
        raise
    return path


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``, each
    atomically."""
    if symbol is not None:
        _atomic_replace("%s-symbol.json" % prefix,
                        lambda tmp: symbol.save(tmp))
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})

    def _write(tmp):
        nd_save(tmp, save_dict)
        # numpy appends .npz to a name without it
        return tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp

    _atomic_replace("%s-%04d.params" % (prefix, epoch), _write)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint; the arrays
    land on the current context."""
    symbol_file = "%s-symbol.json" % prefix
    param_name = "%s-%04d.params" % (prefix, epoch)
    if not os.path.exists(symbol_file):
        raise MXNetError("checkpoint %r has no symbol file: %s is missing"
                         % (prefix, symbol_file))
    symbol = sym_mod.load(symbol_file)
    if not os.path.exists(param_name):
        raise MXNetError("checkpoint %r has no params for epoch %d: %s is "
                         "missing" % (prefix, epoch, param_name))
    arg_params, aux_params = {}, {}
    for k, v in nd_load(param_name).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("invalid param key %r" % k)
    return symbol, arg_params, aux_params


class FeedForward:
    """Legacy estimator API (reference ``model.py:408`` ``FeedForward``),
    a thin veneer over :class:`~mxnet_tpu_torch.module.Module`: ``fit``
    wraps numpy inputs in an ``NDArrayIter`` (shuffled; batch
    ``numpy_batch_size``, at most the data size) and runs
    ``Module.fit``; ``predict`` and ``score`` bind a module for
    inference.  ``ctx`` None means the card, as ``Module``'s does."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, begin_epoch=0,
                 **kwargs):
        from .initializer import Uniform

        self._symbol = symbol
        self._ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self._opt_kwargs = kwargs
        self._module = None

    @property
    def symbol(self):
        return self._symbol

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        batch = min(self.numpy_batch_size, len(X))
        return NDArrayIter(X, y, batch_size=batch, shuffle=shuffle)

    def _build_module(self):
        from .module import Module

        # label variables by the *_label convention, so predict without
        # labels still treats them as labels and not as parameters
        label_names = [n for n in self._symbol.list_arguments()
                       if n.endswith("_label")]
        self._module = Module(self._symbol, context=self._ctx,
                              label_names=tuple(label_names))
        return self._module

    def _bound_for_inference(self, data):
        if self._module is None or not self._module.binded:
            mod = self._build_module()
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label or None,
                     for_training=False)
            mod.init_params(arg_params=self.arg_params,
                            aux_params=self.aux_params)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        """Train (reference ``FeedForward.fit``)."""
        train = self._as_iter(X, y, shuffle=True)
        mod = self._build_module()
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self._opt_kwargs,
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor, eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The first output as a numpy array, padding dropped; with
        ``return_data`` also the (data, labels) consumed."""
        import numpy as np

        data = self._as_iter(X)
        mod = self._bound_for_inference(data)
        if reset:
            data.reset()
        outs, datas, labels = [], [], []
        for i, batch in enumerate(data):
            if num_batch is not None and i >= num_batch:
                break
            mod.forward(batch, is_train=False)
            keep = mod.get_outputs()[0].shape[0] - (batch.pad or 0)
            outs.append(mod.get_outputs()[0].asnumpy()[:keep])
            if return_data:
                datas.append(batch.data[0].asnumpy()[:keep])
                if batch.label:
                    labels.append(batch.label[0].asnumpy()[:keep])
        result = np.concatenate(outs, axis=0)
        if return_data:
            return (result, np.concatenate(datas, axis=0),
                    np.concatenate(labels, axis=0) if labels else None)
        return result

    def score(self, X, eval_metric="acc", num_batch=None):
        """The metric's value over ``X`` (reference ``FeedForward.score``)."""
        from .metric import create as metric_create

        data = self._as_iter(X)
        self._bound_for_inference(data)
        metric = metric_create(eval_metric) \
            if isinstance(eval_metric, str) else eval_metric
        res = self._module.score(data, metric, num_batch=num_batch)
        return dict(res).popitem()[1]

    def save(self, prefix, epoch=None):
        epoch = self.num_epoch if epoch is None else epoch
        if epoch is None:
            raise MXNetError("FeedForward.save needs an epoch (num_epoch "
                             "was not set on this model)")
        save_checkpoint(prefix, epoch, self._symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        sym, arg, aux = load_checkpoint(prefix, epoch)
        return FeedForward(sym, ctx=ctx, arg_params=arg, aux_params=aux,
                           begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, **kwargs):
        """Build and fit in one call (reference ``FeedForward.create``)."""
        fit_keys = ("eval_data", "eval_metric", "epoch_end_callback",
                    "batch_end_callback", "kvstore", "logger", "monitor",
                    "eval_end_callback", "eval_batch_end_callback",
                    "work_load_list")
        fit_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if k in fit_keys}
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch, **kwargs)
        return model.fit(X, y, **fit_kwargs)
