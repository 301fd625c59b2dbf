"""Run health: in-step numerics guards, the loss scaler, the policy
engine and the step watchdog.

Counterpart of ``mxnet_tpu/health.py`` (:66-392 and the watchdog).  A
run that goes on while it diverges — NaN/Inf gradients, a loss blow-up,
a wedged device call — burns the card without producing a model:

* **In-step numerics** (``fused.TrainStep(health=StepHealth(...))``):
  the step computes a global gradient norm and a non-finite flag on the
  device, and a non-finite step is skipped there — a device-side select
  keeps the old parameters, optimizer states and aux states bit for bit
  — so the clean path never waits on the host, and the same code runs
  inside a captured CUDA graph.
* **Loss scaling** (:class:`DynamicLossScaler`): the loss is multiplied
  by a scale before the backward and the gradients unscaled after; the
  scale and its clean-step streak are device scalars carried by the
  step, so growth on clean streaks and back-off on an overflow happen on
  the device too.
* **Policy engine** (:class:`HealthMonitor`): host-side EMA statistics
  over *lagged* device values (step ``n - lag`` is read while step ``n``
  runs), the ``warn`` → ``skip`` → ``rollback`` ladder, and
  :class:`~mxnet_tpu_torch.base.TrainingDiverged` when recovery is
  exhausted.  ``Module.fit(health=)`` drives it.
* **Liveness**: :class:`StepWatchdog` (the serving supervisor's
  per-replica liveness and ``fit(step_timeout_s=)``) dumps all-thread
  stacks plus the caller's stats to a JSON artifact under
  ``MXNET_HEALTH_DIR``, then delivers
  :class:`~mxnet_tpu_torch.base.StepHung` into the watched thread with
  ``PyThreadState_SetAsyncExc``.  The artifact has the JAX package's
  schema, so ``tools/diagnose.py`` renders it unchanged.  A CUDA call
  the watched thread is blocked in returns only when the card finishes;
  the asynchronous exception lands at the next bytecode after it.  For
  calls that never return, ``MXNET_STEP_TIMEOUT_EXIT=1`` hard-exits
  (code 70) one more timeout after the dump.

The rank heartbeats (``RankHeartbeat``, ``stale_peers``,
``peer_report``) belong to several processes and come with the
multi-device step (ROADMAP queue 1 step 8).
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import tempfile
import threading
import time

import numpy as np

from .base import MXNetError, StepHung, TrainingDiverged, get_env, logger

__all__ = ["HealthMonitor", "DynamicLossScaler", "StepHealth",
           "StepWatchdog", "resolve_monitor", "TrainingDiverged",
           "StepHung", "last_hang_details"]

_POLICIES = ("warn", "skip", "rollback")

# thread-name prefix the pytest leak guard (tests/conftest.py) checks;
# the JAX package's, so one guard covers both packages
WATCHDOG_THREAD_PREFIX = "mxnet-step-watchdog"


# ---------------------------------------------------------------------------
# loss scaling


class DynamicLossScaler:
    """Dynamic loss-scale schedule for low-precision runs.

    The *state* (current scale, clean-step streak) lives as device
    scalars carried by the step; this object holds the schedule's
    constants: on overflow the scale is multiplied by ``backoff`` and the
    step skipped; after ``growth_interval`` consecutive clean steps it is
    multiplied by ``growth``, bounded to [``min_scale``, ``max_scale``].
    bf16 shares fp32's exponent range, so ``init_scale=1`` makes it a
    pure overflow detector there."""

    def __init__(self, init_scale=2.0 ** 15, growth=2.0, backoff=0.5,
                 growth_interval=2000, min_scale=1.0, max_scale=2.0 ** 24):
        if init_scale <= 0 or growth < 1.0 or not 0 < backoff <= 1.0:
            raise MXNetError(
                "DynamicLossScaler needs init_scale > 0, growth >= 1, "
                "0 < backoff <= 1 (got %r, %r, %r)"
                % (init_scale, growth, backoff))
        self.init_scale = float(init_scale)
        self.growth = float(growth)
        self.backoff = float(backoff)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)

    @staticmethod
    def from_spec(spec):
        """Resolve a ``fit(loss_scale=...)`` / ``MXNET_LOSS_SCALE`` value:
        ``'dynamic'`` → the default dynamic scaler, a number → a static
        scale (growth and back-off off), None/'' → no scaling."""
        if spec in (None, "", False):
            return None
        if isinstance(spec, DynamicLossScaler):
            return spec
        if isinstance(spec, str) and spec.lower() == "dynamic":
            return DynamicLossScaler()
        scale = float(spec)
        return DynamicLossScaler(init_scale=scale, growth=1.0, backoff=1.0,
                                 growth_interval=1 << 30, min_scale=scale,
                                 max_scale=scale)


class StepHealth:
    """Static health configuration of a ``TrainStep``.

    ``skip_nonfinite`` — skip a step whose loss or any gradient is
    non-finite, on the device; ``scaler`` — an optional
    :class:`DynamicLossScaler` (whose overflow always skips).  The global
    gradient norm and the non-finite flag are always computed."""

    def __init__(self, skip_nonfinite=True, scaler=None):
        self.skip_nonfinite = bool(skip_nonfinite)
        self.scaler = scaler


# ---------------------------------------------------------------------------
# policy engine


def _host(value):
    """A stats value (tensor, numpy or Python) as a numpy array."""
    value = getattr(value, "_data", value)
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


class HealthMonitor:
    """EMA loss/grad-norm statistics + per-anomaly policy ladder.

    ``tick(stats)`` is called once per dispatched step with that step's
    device stats; the monitor queues them and reads only entries ``lag``
    steps old, which the card has long finished, so the read does not
    stall the clean path.  ``observe`` classifies one step:

    * ``"ok"``   — nothing to do;
    * ``"warn"`` — anomaly logged;
    * ``"skip"`` — a non-finite step; the device already applied the
      skip; escalates after ``max_skips`` consecutive ones;
    * ``"rollback"`` — reload last-good + LR back-off (the trainer does
      it); after ``max_rollbacks`` consecutive rollbacks with no clean
      progress in between, :class:`TrainingDiverged`.

    Thresholds default from the ``MXNET_HEALTH_*`` env knobs."""

    def __init__(self, policy=None, loss_spike=None, grad_spike=None,
                 ema_decay=None, warmup=None, lag=None, max_skips=None,
                 max_rollbacks=None, lr_backoff=None, logger_=None):
        self.policy = policy if policy is not None else \
            get_env("MXNET_HEALTH_POLICY", "skip", str)
        if self.policy not in _POLICIES:
            raise MXNetError("health policy must be one of %s (got %r)"
                             % ("/".join(_POLICIES), self.policy))
        self.loss_spike = loss_spike if loss_spike is not None else \
            get_env("MXNET_HEALTH_LOSS_SPIKE", 10.0, float)
        self.grad_spike = grad_spike if grad_spike is not None else \
            get_env("MXNET_HEALTH_GRAD_SPIKE", 25.0, float)
        self.ema_decay = ema_decay if ema_decay is not None else \
            get_env("MXNET_HEALTH_EMA", 0.98, float)
        self.warmup = warmup if warmup is not None else \
            get_env("MXNET_HEALTH_WARMUP", 20, int)
        self.lag = lag if lag is not None else \
            get_env("MXNET_HEALTH_LAG", 2, int)
        self.max_skips = max_skips if max_skips is not None else \
            get_env("MXNET_HEALTH_MAX_SKIPS", 10, int)
        self.max_rollbacks = max_rollbacks if max_rollbacks is not None \
            else get_env("MXNET_HEALTH_MAX_ROLLBACKS", 3, int)
        self.lr_backoff = lr_backoff if lr_backoff is not None else \
            get_env("MXNET_HEALTH_LR_BACKOFF", 0.5, float)
        self.logger = logger_ or logger
        self._pending = []      # [(step, stats)] not yet read
        self.reset()

    # -- lifecycle ------------------------------------------------------
    def reset(self):
        """Forget everything (a fresh fit)."""
        self._pending = []
        self.soft_reset()
        self.consecutive_rollbacks = 0
        self.total_rollbacks = 0
        self.total_skips = 0
        self.total_warnings = 0

    def soft_reset(self):
        """Drop the EMA state and streaks but keep lifetime and rollback
        accounting — after a rollback restored old parameters."""
        self._pending = []
        self.loss_ema = None
        self.grad_ema = None
        self.observed = 0
        self.consecutive_skips = 0
        self._clean_since_rollback = 0
        self.last_stats = None

    # -- per-step entry points -----------------------------------------
    def tick(self, stats_ref, step=None):
        """Queue this step's stats; read and classify entries ``lag``
        steps old.  Returns the strongest action among them."""
        if stats_ref is not None:
            self._pending.append((step, stats_ref))
        action = "ok"
        while len(self._pending) > self.lag:
            s, ref = self._pending.pop(0)
            action = _stronger(action, self._realize(s, ref))
        return action

    def flush(self):
        """Read every queued entry (epoch end).  Returns the strongest
        action found."""
        action = "ok"
        while self._pending:
            s, ref = self._pending.pop(0)
            action = _stronger(action, self._realize(s, ref))
        return action

    def _realize(self, step, ref):
        vals = {k: _host(v) for k, v in ref.items()}
        # a steps_per_call=K entry carries (K,) arrays, one observation
        # an inner step; a stat the producer did not measure (the split
        # path has no loss) is None, not NaN, which would read as a
        # non-finite step
        has_loss = "loss" in vals
        has_gnorm = "grad_norm" in vals
        loss = np.atleast_1d(np.asarray(vals.get("loss", np.nan),
                                        "float64"))
        gnorm = np.atleast_1d(np.asarray(vals.get("grad_norm", np.nan),
                                         "float64"))
        bad = np.atleast_1d(np.asarray(vals.get("nonfinite", 0)))
        action = "ok"
        n = max(loss.shape[0] if has_loss else 1,
                gnorm.shape[0] if has_gnorm else 1, bad.shape[0])
        for k in range(n):
            action = _stronger(action, self.observe(
                step=step,
                loss=float(loss[min(k, loss.shape[0] - 1)])
                if has_loss else None,
                grad_norm=float(gnorm[min(k, gnorm.shape[0] - 1)])
                if has_gnorm else None,
                nonfinite=bool(bad[min(k, bad.shape[0] - 1)])))
        return action

    def observe(self, step=None, loss=None, grad_norm=None,
                nonfinite=False):
        """Classify one step (host logic only)."""
        self.last_stats = {"step": step, "loss": loss,
                           "grad_norm": grad_norm,
                           "nonfinite": bool(nonfinite)}
        if nonfinite or (loss is not None and not math.isfinite(loss)) \
                or (grad_norm is not None
                    and not math.isfinite(grad_norm)):
            self.consecutive_skips += 1
            self.total_skips += 1
            self._clean_since_rollback = 0
            self.logger.warning(
                "health: non-finite step%s (consecutive %d/%d) — update "
                "skipped on device",
                "" if step is None else " %s" % (step,),
                self.consecutive_skips, self.max_skips)
            if self.policy == "warn":
                self.total_warnings += 1
                return "warn"
            if self.consecutive_skips >= self.max_skips:
                self.consecutive_skips = 0
                return self._escalate(
                    step, "%d consecutive non-finite steps"
                    % self.max_skips)
            return "skip"
        # a finite step: streaks first, then the spike check against the
        # EMA of the earlier steps
        self.consecutive_skips = 0
        self._clean_since_rollback += 1
        if self._clean_since_rollback >= max(1, self.warmup):
            self.consecutive_rollbacks = 0
        anomaly = None
        if self.observed >= self.warmup:
            if loss is not None and self.loss_ema is not None and \
                    abs(loss) > self.loss_spike * (abs(self.loss_ema)
                                                   + 1e-8):
                anomaly = "loss %.4g spiked > %gx EMA %.4g" % (
                    loss, self.loss_spike, self.loss_ema)
            elif grad_norm is not None and self.grad_ema is not None and \
                    grad_norm > self.grad_spike * (self.grad_ema + 1e-8):
                anomaly = "grad norm %.4g spiked > %gx EMA %.4g" % (
                    grad_norm, self.grad_spike, self.grad_ema)
        d = self.ema_decay
        if loss is not None:
            self.loss_ema = loss if self.loss_ema is None else \
                d * self.loss_ema + (1 - d) * loss
        if grad_norm is not None:
            self.grad_ema = grad_norm if self.grad_ema is None else \
                d * self.grad_ema + (1 - d) * grad_norm
        self.observed += 1
        if anomaly is None:
            return "ok"
        self.total_warnings += 1
        self.logger.warning(
            "health: %s%s", anomaly,
            "" if step is None else " at step %s" % (step,))
        if self.policy == "rollback":
            return self._escalate(step, anomaly)
        return "warn"

    def _escalate(self, step, reason):
        """Turn an exhausted skip streak or a spike into a rollback
        request, or into :class:`TrainingDiverged` when the policy
        forbids rollback or rollbacks are exhausted."""
        if self.policy != "rollback":
            raise TrainingDiverged(
                "training diverged: %s and policy %r cannot roll back "
                "(set MXNET_HEALTH_POLICY=rollback and pass "
                "fit(checkpoint=...) for automatic recovery)"
                % (reason, self.policy), reason=reason)
        if self.consecutive_rollbacks >= self.max_rollbacks:
            raise TrainingDiverged(
                "training diverged: %s after %d consecutive rollbacks "
                "(MXNET_HEALTH_MAX_ROLLBACKS) — the run does not recover "
                "from the last-good checkpoint; inspect the data stream "
                "and hyperparameters" % (reason,
                                         self.consecutive_rollbacks),
                reason=reason)
        self._last_anomaly = reason
        return "rollback"

    def note_rollback(self, step=None):
        """Account for a rollback the trainer just performed."""
        self.consecutive_rollbacks += 1
        self.total_rollbacks += 1
        self._clean_since_rollback = 0

    # -- diagnostics ----------------------------------------------------
    def snapshot(self):
        """JSON-able state for the watchdog dump."""
        return {
            "policy": self.policy,
            "observed": self.observed,
            "loss_ema": self.loss_ema,
            "grad_ema": self.grad_ema,
            "last_stats": self.last_stats,
            "consecutive_skips": self.consecutive_skips,
            "consecutive_rollbacks": self.consecutive_rollbacks,
            "total_skips": self.total_skips,
            "total_rollbacks": self.total_rollbacks,
            "total_warnings": self.total_warnings,
        }


def _stronger(a, b):
    order = ("ok", "warn", "skip", "rollback")
    return a if order.index(a) >= order.index(b) else b


def resolve_monitor(spec):
    """Normalize ``fit(health=...)`` / ``MXNET_HEALTH_MONITOR``: None →
    the env switch, True → a default monitor, a policy string →
    ``HealthMonitor(policy=...)``, an instance → itself, falsy → off."""
    if spec is None:
        spec = get_env("MXNET_HEALTH_MONITOR", False, bool)
    if not spec:
        return None
    if isinstance(spec, HealthMonitor):
        return spec
    if isinstance(spec, str):
        return HealthMonitor(policy=spec)
    return HealthMonitor()


# ---------------------------------------------------------------------------
# liveness: step watchdog


class StepWatchdog:
    """Daemon thread that fires when the watched loop stops making
    progress.

    The loop calls :meth:`kick` at every dispatch boundary; if no kick
    arrives for ``timeout_s`` the watchdog (1) dumps all-thread stacks
    via ``faulthandler`` plus ``stats_cb()`` to a JSON artifact under
    ``dump_dir`` (default ``MXNET_HEALTH_DIR``) and mirrors the stacks
    to stderr, then (2) delivers :class:`StepHung` into
    ``target_thread`` (default: the thread that built it)."""

    def __init__(self, timeout_s, stats_cb=None, dump_dir=None,
                 target_thread=None):
        self.timeout_s = float(timeout_s)
        if self.timeout_s <= 0:
            raise MXNetError("StepWatchdog timeout must be > 0 (got %r)"
                             % timeout_s)
        self._stats_cb = stats_cb
        self._dump_dir = dump_dir or get_env(
            "MXNET_HEALTH_DIR", tempfile.gettempdir(), str)
        self._target = target_thread or threading.current_thread()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._last_kick = time.monotonic()
        self._note = "startup (no step dispatched yet)"
        self._paused = False
        self.fired = False
        self.fired_note = None  # the last kick's note when it fired
        self.dump_path = None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="%s-%d" % (WATCHDOG_THREAD_PREFIX, os.getpid()))

    def start(self):
        self._thread.start()
        return self

    def kick(self, note=None):
        """Record progress (one lock and a clock read); also resumes a
        paused watchdog."""
        with self._lock:
            self._last_kick = time.monotonic()
            self._paused = False
            if note is not None:
                self._note = note

    def pause(self):
        """Stop timing until the next :meth:`kick` — for stretches
        (an evaluation pass, a checkpoint write) whose length has
        nothing to do with per-step progress."""
        with self._lock:
            self._paused = True

    def stop(self, join_timeout=5.0):
        self._stop.set()
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=join_timeout)

    @property
    def alive(self):
        return self._thread.is_alive()

    @property
    def target(self):
        """The thread :class:`StepHung` is delivered into."""
        return self._target

    def _run(self):
        # poll at a fraction of the timeout, so a stall is noticed
        # within about timeout + poll
        poll = max(0.05, min(self.timeout_s / 4.0, 2.0))
        while not self._stop.wait(poll):
            with self._lock:
                if self._paused:
                    self._last_kick = time.monotonic()
                    continue
                stalled = time.monotonic() - self._last_kick
                note = self._note
            if stalled >= self.timeout_s:
                self._fire(stalled, note)
                return

    def _fire(self, stalled, note):
        self.fired = True
        self.fired_note = note
        try:
            self.dump_path = self._dump(stalled, note)
        except Exception as e:  # the dump must never mask the raise
            logger.error("watchdog dump failed: %s", e)
        msg = ("step made no progress for %.1fs (timeout %.0fs) at %s — "
               "a wedged device call, deadlocked collective, or stuck "
               "input pipeline; all-thread stacks dumped to %r "
               "(pretty-print with tools/diagnose.py)"
               % (stalled, self.timeout_s, note, self.dump_path))
        logger.critical(msg)
        # stash the details before delivery: SetAsyncExc instantiates
        # the class with no arguments
        _last_hang["msg"] = msg
        _last_hang["note"] = note
        _last_hang["dump_path"] = self.dump_path
        if not _async_raise(self._target, StepHung):
            _last_hang.clear()
        if get_env("MXNET_STEP_TIMEOUT_EXIT", False, bool):
            # a thread wedged inside C never sees the async exception;
            # give it one more timeout, then fail the process loudly
            if not self._stop.wait(self.timeout_s):
                logger.critical(
                    "watchdog: thread still wedged %.0fs after the "
                    "dump; hard-exiting 70", self.timeout_s)
                os._exit(70)

    def _dump(self, stalled, note):
        import faulthandler
        import sys

        os.makedirs(self._dump_dir, exist_ok=True)
        path = os.path.join(
            self._dump_dir,
            "watchdog-%d-%d.json" % (os.getpid(), int(time.time())))
        with tempfile.TemporaryFile(mode="w+") as tf:
            faulthandler.dump_traceback(file=tf, all_threads=True)
            tf.seek(0)
            stacks = tf.read()
        stats = None
        if self._stats_cb is not None:
            try:
                stats = self._stats_cb()
            except Exception as e:
                stats = {"error": "stats_cb failed: %s" % e}
        payload = {
            "kind": "mxnet_tpu-watchdog-dump",
            "pid": os.getpid(),
            "time": time.time(),
            "stalled_s": stalled,
            "timeout_s": self.timeout_s,
            "note": note,
            "health": stats,
            "traceback": stacks,
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        print("WATCHDOG: no step progress for %.1fs at %s; stacks:\n%s"
              % (stalled, note, stacks), file=sys.stderr)
        sys.stderr.flush()
        return path


# details of the most recent firing, read by whoever catches the
# zero-argument StepHung that PyThreadState_SetAsyncExc constructs
_last_hang = {}


def last_hang_details():
    return dict(_last_hang)


def _async_raise(thread, exc_type):
    """Deliver ``exc_type`` asynchronously into ``thread``; True when the
    interpreter accepted it (it lands at the thread's next bytecode)."""
    tid = getattr(thread, "ident", None)
    if tid is None or not thread.is_alive():
        return False
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(tid), ctypes.py_object(exc_type))
    if res > 1:  # undefined state: revoke
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid),
                                                   None)
        return False
    return res == 1
