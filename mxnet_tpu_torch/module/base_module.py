"""BaseModule — the training-loop contract.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference
``python/mxnet/module/base_module.py``: ``fit`` is bind -> init_params ->
init_optimizer -> the batch loop of forward_backward, update,
update_metric -> the epoch-end ``get_params``/``set_params`` -> the
evaluation ``score``; plus ``score``, ``predict``, ``BatchEndParam``).
The loop is the JAX package's pipelined one: the train iterator is
wrapped in ``io.DevicePrefetchIter`` so batch n+1 is staged onto the
card while step n runs, and the next batch is pulled after the step is
launched.  A SIGTERM/SIGINT stops the loop at the next batch boundary
with :class:`~mxnet_tpu_torch.base.TrainingPreempted`.  With
``steps_per_call=K`` the prefetcher packs K batches into a super-batch
and each call runs K updates (one CUDA-graph replay on the card).
Checkpoint managers, resume, run health, loss scaling, the step
watchdog, ZeRO, plans, elasticity, parameter sharding and monitors come
with later slices and raise.
"""
from __future__ import annotations

import logging
import signal
import sys
import threading
import time

from ..base import MXNetError, TrainingPreempted, get_env, later_slice
from .. import io as io_mod
from .. import metric as metric_mod

__all__ = ["BaseModule", "BatchEndParam"]


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class _PreemptionGuard:
    """SIGTERM/SIGINT watcher for one ``fit``: the handler only records
    the signal; the loop polls ``fired`` at batch boundaries.  Python
    allows handlers on the main thread only, so elsewhere this is a
    no-op.  The previous handlers come back on exit."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.fired = None
        self._prev = {}
        self._enabled = \
            threading.current_thread() is threading.main_thread()

    def __enter__(self):
        if self._enabled:
            for sig in self.SIGNALS:
                try:
                    self._prev[sig] = signal.signal(sig, self._record)
                except (ValueError, OSError):  # embedded interpreter
                    pass
        return self

    def _record(self, signum, frame):
        self.fired = signum

    def __exit__(self, exc_type, exc, tb):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        return False


class BatchEndParam:
    """Callback payload (reference namedtuple ``BatchEndParam``)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- what subclasses implement -----------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # -- shared conveniences -----------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate on a data iterator (reference ``BaseModule.score``)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("score: bind and init_params first")
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                     eval_metric=eval_metric,
                                     locals=locals()))
            actual_num_batch += 1
        if score_end_callback is not None:
            for cb in _as_list(score_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                 eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Forward over an iterator, concatenating the outputs without the
        padding (reference ``BaseModule.predict``)."""
        from ..ndarray import concat

        if not (self.binded and self.params_initialized):
            raise MXNetError("predict: bind and init_params first")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad]
                                for out in self.get_outputs()])
        if not output_list:
            return []
        if merge_batches:
            num_outputs = len(output_list[0])
            if any(len(out) != num_outputs for out in output_list):
                raise MXNetError(
                    "Cannot merge batches: different number of outputs")
            merged = [concat([out[i] for out in output_list], dim=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, param_sharding=None, compute_dtype=None,
            prefetch_to_device=None, prefetch_depth=2,
            metric_sync_period=None, steps_per_call=None,
            checkpoint=None, checkpoint_period=1, resume_from=None,
            health=None, loss_scale=None, step_timeout_s=None,
            zero=None, plan=None, elastic=None):
        """The training loop (reference ``BaseModule.fit``, pipelined as
        in the JAX package).

        * ``prefetch_to_device`` — stage ``train_data`` onto the module's
          device on a background thread (default ``MXNET_FIT_PIPELINE``,
          on); ``prefetch_depth`` is the staging ring's depth.
        * ``metric_sync_period`` — fold (label, prediction) pairs into the
          metric every N batches instead of every batch
          (``MXNET_METRIC_SYNC_PERIOD``).
        * ``compute_dtype`` — e.g. ``"bfloat16"``: the fused step casts
          parameters, aux states and the batch to it
          (``MXNET_COMPUTE_DTYPE``).
        * ``steps_per_call`` — K updates a call over super-batches of K
          batches (``MXNET_STEPS_PER_CALL``); the epoch's last ``len %
          K`` batches are dropped.  ``num_update`` and ``nbatch`` advance
          by K a call, the metric is updated once an inner step, the
          batch callback runs once a call.
        """
        from ..initializer import Uniform

        if num_epoch is None:
            raise MXNetError("fit: please specify num_epoch")
        K = max(1, int(steps_per_call if steps_per_call is not None
                       else get_env("MXNET_STEPS_PER_CALL", 1, int)))
        if K > 1 and monitor is not None:
            raise MXNetError(
                "steps_per_call > 1 is incompatible with a Monitor: the "
                "monitor needs the per-node executor path, which has no "
                "multi-step form")
        timeout = float(step_timeout_s if step_timeout_s is not None
                        else get_env("MXNET_STEP_TIMEOUT_S", 0.0, float))
        for field, value, fine in (
                ("checkpoint", checkpoint, checkpoint is None),
                ("resume_from", resume_from, resume_from is None),
                ("health", health, health is None),
                ("loss_scale", loss_scale, loss_scale is None),
                ("step_timeout_s", timeout, timeout <= 0),
                ("zero", zero, zero is None),
                ("plan", plan, plan is None),
                ("elastic", elastic, elastic in (None, False)),
                ("param_sharding", param_sharding,
                 param_sharding in (None, "replicated")),
                ("monitor", monitor, monitor is None)):
            if not fine:
                raise later_slice(field, value)
        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        opt_kwargs = {}
        if compute_dtype is not None:
            opt_kwargs["compute_dtype"] = compute_dtype
        if K > 1:
            opt_kwargs["steps_per_call"] = K
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params, **opt_kwargs)

        pipeline = prefetch_to_device
        if pipeline is None:
            pipeline = get_env("MXNET_FIT_PIPELINE", True, bool)
        fit_data = train_data
        if pipeline or K > 1:
            # super-batches come only from the staging iterator, so K > 1
            # wraps even with the pipeline switched off
            fit_data = io_mod.prefetch_to_device(
                train_data, prefetch_depth=prefetch_depth,
                context=getattr(self, "_context", [None])[0],
                steps_per_call=K)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)
        sync = int(metric_sync_period if metric_sync_period is not None
                   else get_env("MXNET_METRIC_SYNC_PERIOD", 1, int))
        if sync > 1:
            eval_metric = metric_mod.LazyEvalMetric(eval_metric,
                                                    sync_period=sync)
        try:
            self._fit_epochs(fit_data, eval_data, eval_metric,
                             validation_metric, batch_end_callback,
                             epoch_end_callback, eval_end_callback,
                             eval_batch_end_callback, begin_epoch, num_epoch,
                             K)
        finally:
            if fit_data is not train_data:
                # the staging worker must not outlive fit: it would go on
                # consuming the caller's iterator
                in_flight = sys.exc_info()[0] is not None
                try:
                    fit_data.close()
                except Exception:
                    # close() re-raises worker errors the loop never saw;
                    # surface them on a clean exit, never over the error
                    # already propagating
                    if not in_flight:
                        raise
                    self.logger.exception(
                        "prefetch close() failed during fit teardown; "
                        "keeping the original error")
                train_data.reset()

    def _fit_epochs(self, fit_data, eval_data, eval_metric,
                    validation_metric, batch_end_callback,
                    epoch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, num_epoch,
                    steps_per_call=1):
        from ..testing import faults

        with _PreemptionGuard() as guard:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                nbatch = 0
                data_iter = iter(fit_data)
                end_of_batch = False
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    end_of_batch = True
                while not end_of_batch:
                    data_batch = next_data_batch
                    faults.inject("step")
                    self.forward_backward(data_batch)
                    self.update()
                    # pull batch n+1 after step n is launched: the staging
                    # ring refills while the card works
                    try:
                        next_data_batch = next(data_iter)
                    except StopIteration:
                        end_of_batch = True
                    if steps_per_call > 1:
                        # one metric update an inner step
                        outs = self.get_outputs()
                        labels = data_batch.label or []
                        for k in range(steps_per_call):
                            self.update_metric(eval_metric,
                                               [l[k] for l in labels],
                                               outputs=[o[k] for o in outs])
                    else:
                        self.update_metric(eval_metric, data_batch.label)
                    if batch_end_callback is not None:
                        for cb in _as_list(batch_end_callback):
                            cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                             eval_metric=eval_metric,
                                             locals=locals()))
                    nbatch += steps_per_call
                    if guard.fired is not None:
                        self._preempt(guard.fired, fit_data, epoch, nbatch)

                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)
                arg_params_, aux_params_ = self.get_params()
                self.set_params(arg_params_, aux_params_)
                if epoch_end_callback is not None:
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_params_, aux_params_)
                if guard.fired is not None:
                    self._preempt(guard.fired, fit_data, epoch + 1, 0)
                if eval_data is not None:
                    res = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                fit_data.reset()

    def _preempt(self, signum, fit_data, epoch, nbatch):
        """Shut the staging worker down and raise
        :class:`TrainingPreempted` with the position reached."""
        self.logger.warning("signal %d received: stopping training at "
                            "epoch %d, batch %d", signum, epoch, nbatch)
        close = getattr(fit_data, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                self.logger.exception(
                    "prefetch teardown failed during preemption")
        raise TrainingPreempted(
            "training preempted by signal %d at epoch %d, batch %d (no "
            "checkpoint manager in this slice)" % (signum, epoch, nbatch),
            epoch=epoch, nbatch=nbatch, signum=signum)

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError
