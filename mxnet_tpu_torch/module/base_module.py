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

Fault tolerance and run health (``mxnet_tpu/module/base_module.py``
:191-630): ``checkpoint=`` writes epoch checkpoints through a
``CheckpointManager`` every ``checkpoint_period`` epochs, and a
preemption writes a final mid-epoch one before it raises;
``resume_from=`` restores params, aux, optimizer states and the update
count and fast-forwards the data to the recorded position, so the run
continues the uninterrupted trajectory; ``health=`` feeds the step's
lagged device stats to a ``HealthMonitor`` and rolls back to the last
good checkpoint, with a learning-rate back-off, when it asks;
``loss_scale=`` arms the dynamic loss scaler; ``step_timeout_s=`` a
``StepWatchdog`` kicked at every dispatch and paused over the epoch
tail.  ZeRO, plans, elasticity, parameter sharding and monitors come
with later slices and raise.
"""
from __future__ import annotations

import logging
import signal
import sys
import threading
import time

from ..base import (MXNetError, StepHung, TrainingDiverged,
                    TrainingPreempted, get_env, later_slice)
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
        * ``checkpoint`` — a ``CheckpointManager`` or a directory for one:
          epoch checkpoints every ``checkpoint_period`` epochs (and after
          the last), and on SIGTERM/SIGINT a final checkpoint at the next
          batch boundary before :class:`TrainingPreempted`.
        * ``resume_from`` — a ``CheckpointState``, ``CheckpointManager``,
          prefix or ``(prefix, epoch)`` (``checkpoint.resolve_resume``).
        * ``health`` — True, a policy ('warn'/'skip'/'rollback') or a
          ``HealthMonitor`` (``MXNET_HEALTH_MONITOR=1``); rollback needs
          ``checkpoint``.  ``loss_scale`` — 'dynamic', a number or a
          ``DynamicLossScaler`` (``MXNET_LOSS_SCALE``).
        * ``step_timeout_s`` — a step watchdog (``MXNET_STEP_TIMEOUT_S``):
          a step making no progress for this long dumps all-thread stacks
          and the monitor's snapshot, then raises :class:`StepHung`.
        """
        from ..initializer import Uniform
        from .. import checkpoint as ckpt_mod

        if num_epoch is None:
            raise MXNetError("fit: please specify num_epoch")
        K = max(1, int(steps_per_call if steps_per_call is not None
                       else get_env("MXNET_STEPS_PER_CALL", 1, int)))
        if K > 1 and monitor is not None:
            raise MXNetError(
                "steps_per_call > 1 is incompatible with a Monitor: the "
                "monitor needs the per-node executor path, which has no "
                "multi-step form")
        for field, value, fine in (
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
        mgr = None
        if checkpoint is not None:
            mgr = checkpoint \
                if isinstance(checkpoint, ckpt_mod.CheckpointManager) \
                else ckpt_mod.CheckpointManager(str(checkpoint))
        resume_state = None
        if resume_from is not None:
            ctx = getattr(self, "_context", [None])[0]
            resume_state = ckpt_mod.resolve_resume(
                resume_from, device=ctx.torch_device if ctx is not None
                else None)
            # the checkpoint's params supersede the cold start
            arg_params = resume_state.arg_params
            aux_params = resume_state.aux_params
            force_init = True
            begin_epoch = resume_state.epoch
            self.logger.info(
                "resuming fit from %r: epoch %d, batch offset %d, "
                "num_update %d", resume_state.prefix or resume_from,
                resume_state.epoch, resume_state.nbatch,
                resume_state.num_update)
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
        if health is not None:
            opt_kwargs["health"] = health
        if loss_scale is not None:
            opt_kwargs["loss_scale"] = loss_scale
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params, **opt_kwargs)
        # MXNET_HEALTH_MONITOR=1 arms it inside init_optimizer
        hmon = getattr(self, "_health_monitor", None)
        if resume_state is not None:
            self._restore_from(resume_state)
            # fast-forward the raw iterator before the staging wrap: the
            # staging worker starts pulling batches when it is built
            self._fast_forward_data(train_data, resume_state.epoch,
                                    resume_state.nbatch)

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
        timeout = float(step_timeout_s if step_timeout_s is not None
                        else get_env("MXNET_STEP_TIMEOUT_S", 0.0, float))
        watchdog = None
        if timeout > 0:
            from ..health import StepWatchdog

            watchdog = StepWatchdog(
                timeout, stats_cb=hmon.snapshot if hmon is not None
                else None).start()
        try:
            self._fit_epochs(fit_data, eval_data, eval_metric,
                             validation_metric, batch_end_callback,
                             epoch_end_callback, eval_end_callback,
                             eval_batch_end_callback, begin_epoch, num_epoch,
                             K, mgr=mgr, checkpoint_period=checkpoint_period,
                             resume_nbatch=resume_state.nbatch
                             if resume_state is not None else 0,
                             hmon=hmon, watchdog=watchdog)
            if mgr is not None:
                # a failed background write must fail the fit
                mgr.flush()
        except StepHung as e:
            # the watchdog delivers a bare StepHung (the C API passes no
            # arguments): put back the message and artifact it recorded
            if e.args and e.args[0]:
                raise
            from ..health import last_hang_details

            d = last_hang_details()
            raise StepHung(
                d.get("msg") or "training step made no progress (step "
                "watchdog fired)", note=d.get("note"),
                dump_path=d.get("dump_path")) from None
        finally:
            if watchdog is not None:
                watchdog.stop()
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
                    steps_per_call=1, mgr=None, checkpoint_period=1,
                    resume_nbatch=0, hmon=None, watchdog=None):
        from ..testing import faults

        period = max(1, int(checkpoint_period))
        with _PreemptionGuard() as guard:
            for epoch in range(begin_epoch, num_epoch):
                tic = time.time()
                eval_metric.reset()
                # a resumed mid-epoch run counts from its recorded offset,
                # so a second preemption checkpoints the true position
                nbatch = resume_nbatch if epoch == begin_epoch else 0
                data_iter = iter(fit_data)
                end_of_batch = False
                try:
                    next_data_batch = next(data_iter)
                except StopIteration:
                    # a checkpoint taken right after an epoch's last batch
                    # fast-forwards past the whole epoch
                    end_of_batch = True
                while not end_of_batch:
                    data_batch = next_data_batch
                    if watchdog is not None:
                        watchdog.kick("epoch %d batch %d" % (epoch, nbatch))
                    faults.inject("step")
                    self.forward_backward(data_batch)
                    self.update()
                    if hmon is not None:
                        # feed this step's device stats; the monitor reads
                        # lagged ones and may ask for a rollback
                        self._health_tick(hmon, mgr, epoch, nbatch)
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
                        # a batch boundary: params and states consistent
                        self._preempt(guard.fired, fit_data, mgr, epoch,
                                      nbatch)

                if watchdog is not None:
                    # the epoch tail (eval, checkpoint write, callbacks) is
                    # not step progress; the next kick rearms the timer
                    watchdog.pause()
                if hmon is not None:
                    # drain the lag queue before the epoch checkpoint: a
                    # pending rollback must not take a freshly saved
                    # diverged state for the last good one
                    self._health_tick(hmon, mgr, epoch, nbatch, flush=True)
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - tic)
                arg_params_, aux_params_ = self.get_params()
                self.set_params(arg_params_, aux_params_)
                if mgr is not None and ((epoch + 1) % period == 0
                                        or epoch + 1 == num_epoch):
                    mgr.save(self, epoch=epoch + 1, nbatch=0)
                if epoch_end_callback is not None:
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_params_, aux_params_)
                if guard.fired is not None:
                    # the signal landed in the epoch tail: stop at the
                    # epoch boundary (tag = completed epochs)
                    self._preempt(guard.fired, fit_data, mgr, epoch + 1, 0)
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

    # -- fault tolerance hooks ---------------------------------------------
    def _preempt(self, signum, fit_data, mgr, epoch, nbatch):
        """Shut the staging worker down, write the final checkpoint (with
        a manager) and raise :class:`TrainingPreempted` with the position
        reached."""
        self.logger.warning(
            "signal %d received: stopping training at epoch %d, batch %d%s",
            signum, epoch, nbatch,
            "" if mgr is None else "; writing final checkpoint")
        close = getattr(fit_data, "close", None)
        if close is not None:
            try:
                # drain the staging worker before the checkpoint write
                close()
            except Exception:
                self.logger.exception(
                    "prefetch teardown failed during preemption; "
                    "continuing to the checkpoint write")
        if mgr is not None:
            mgr.save(self, epoch=epoch, nbatch=nbatch)
            mgr.flush()
        raise TrainingPreempted(
            "training preempted by signal %d at epoch %d, batch %d%s"
            % (signum, epoch, nbatch,
               "; checkpoint written under %r" % mgr.prefix
               if mgr is not None else " (no checkpoint manager "
               "configured — pass fit(checkpoint=...) to save on "
               "preemption)"),
            epoch=epoch, nbatch=nbatch, signum=signum)

    def _restore_from(self, state):
        """The optimizer side of a resume, after ``init_optimizer``: the
        states file, then the update count on the optimizer, so the
        schedule and bias correction continue from the checkpointed step
        (the next step number is ``num_update + 1``), and the fused step's
        carried health state where the checkpoint holds one."""
        if state.states_path is not None and \
                hasattr(self, "load_optimizer_states"):
            self.load_optimizer_states(state.states_path)
        o = getattr(self, "_optimizer", None)
        if o is not None:
            n = int(state.num_update)
            o.begin_num_update = n
            o.num_update = n
            o._index_update_count = {}
        # the loss scale and the fp8 amax history the checkpoint carries
        fused = getattr(self, "_fused", None)
        hstate = getattr(state, "hstate", None)
        if hstate and fused is not None and fused._use_hstate:
            fused.load_hstate(hstate)

    def _health_tick(self, hmon, mgr, epoch, nbatch, flush=False):
        """Feed the monitor at a dispatch boundary and act on its verdict:
        'skip' needs nothing (the device kept the old params); 'rollback'
        reloads the last good checkpoint."""
        stats = getattr(self, "_last_health_stats", None)
        self._last_health_stats = None
        try:
            if flush:
                if stats is not None:
                    hmon.tick(stats, step=(epoch, nbatch))
                action = hmon.flush()
            else:
                action = hmon.tick(stats, step=(epoch, nbatch))
        except TrainingDiverged as e:
            e.epoch, e.nbatch = epoch, nbatch
            raise
        if action == "rollback":
            self._health_rollback(hmon, mgr, epoch, nbatch)

    def _health_rollback(self, hmon, mgr, epoch, nbatch):
        """Reload the last good checkpoint, back the learning rate off,
        and continue from the current stream position: the poisoned window
        is consumed, not replayed.  Without a checkpoint there is nothing
        to roll back to: :class:`TrainingDiverged`."""
        reason = getattr(hmon, "_last_anomaly", "sustained divergence")
        if mgr is None or mgr.latest() is None:
            raise TrainingDiverged(
                "health policy requested a rollback at epoch %d batch %d "
                "(%s) but no checkpoint is available — pass "
                "fit(checkpoint=...) so there is a last-good state to "
                "reload" % (epoch, nbatch, reason),
                epoch=epoch, nbatch=nbatch, reason=reason)
        ctx = getattr(self, "_context", [None])[0]
        state = mgr.load(device=ctx.torch_device if ctx is not None
                         else None)
        hmon.note_rollback(step=(epoch, nbatch))
        factor = hmon.lr_backoff
        self.logger.warning(
            "health: rollback %d/%d at epoch %d batch %d (%s) — restoring "
            "checkpoint epoch %d (num_update %d), learning rate x%g",
            hmon.consecutive_rollbacks, hmon.max_rollbacks, epoch, nbatch,
            reason, state.epoch, state.num_update, factor)
        self.set_params(state.arg_params, state.aux_params)
        self._restore_from(state)
        o = getattr(self, "_optimizer", None)
        if o is not None:
            o.lr *= factor
            sch = getattr(o, "lr_scheduler", None)
            if sch is not None:
                # FactorScheduler reads base_lr; Poly/Cosine recompute from
                # base_lr_orig: back both off
                if getattr(sch, "base_lr", None) is not None:
                    sch.base_lr *= factor
                if getattr(sch, "base_lr_orig", None) is not None:
                    sch.base_lr_orig *= factor
        # the restored trajectory has other statistics
        hmon.soft_reset()

    def _fast_forward_data(self, train_data, epochs, nbatch):
        """Fast-forward the raw data stream to a mid-run position: an
        iterator that can ``seek`` jumps there; any other replays the run
        — one ``reset()`` a completed epoch (which repeats the shuffle
        draws an uninterrupted run makes at its epoch boundaries), then
        ``nbatch`` batches drawn and dropped."""
        can_seek = getattr(train_data, "seekable", None)
        if can_seek is not None and can_seek():
            train_data.seek(int(epochs), int(nbatch))
            return
        for _ in range(int(epochs)):
            train_data.reset()
        for skipped in range(int(nbatch)):
            try:
                train_data.next()
            except StopIteration:
                self.logger.warning(
                    "resume fast-forward exhausted the epoch after %d of "
                    "%d batches; continuing from the epoch boundary",
                    skipped, nbatch)
                break

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError
