"""Run health: the step watchdog.

Counterpart of ``mxnet_tpu/health.py``'s liveness half.  A loop that
stops making progress — a wedged device call, a deadlocked collective, a
stuck input pipeline — must fail diagnosably instead of hanging:
:class:`StepWatchdog` (the serving supervisor's per-replica liveness,
and the training loop's once ``fit(step_timeout_s=)`` is wired) dumps
all-thread stacks plus the caller's stats to a JSON artifact under
``MXNET_HEALTH_DIR``, then delivers :class:`~mxnet_tpu_torch.base.
StepHung` into the watched thread with ``PyThreadState_SetAsyncExc``.
The artifact has the JAX package's schema, so ``tools/diagnose.py``
renders it unchanged.

A CUDA call the watched thread is blocked in (a synchronise, a copy to
the host) returns only when the card finishes; the asynchronous
exception lands at the next bytecode after it.  For calls that never
return, ``MXNET_STEP_TIMEOUT_EXIT=1`` hard-exits (code 70) one more
timeout after the dump.

The rest of the JAX module — the in-step numerics guards, the loss
scaler, the policy engine behind ``fit(health=, loss_scale=)`` and the
rank heartbeats — is ported with the training robustness step
(ROADMAP queue 1 step 4).
"""
from __future__ import annotations

import ctypes
import json
import os
import tempfile
import threading
import time

from .base import MXNetError, StepHung, get_env, logger

__all__ = ["StepWatchdog", "StepHung", "last_hang_details"]

# thread-name prefix the pytest leak guard (tests/conftest.py) checks;
# the JAX package's, so one guard covers both packages
WATCHDOG_THREAD_PREFIX = "mxnet-step-watchdog"


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
