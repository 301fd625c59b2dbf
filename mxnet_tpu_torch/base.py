"""Base utilities: the error type, env config, logging and device choice.

The port's own copy of what it needs from the JAX package's ``base.py``:
the same ``MXNetError`` type name and the same ``MXTPU_``/``MXNET_``
env-var lookup, so configuration carries over between the two packages
unchanged.
"""
from __future__ import annotations

import logging
import os

__all__ = ["MXNetError", "RecompileStorm", "StepHung", "TrainingDiverged",
           "TrainingPreempted", "get_env", "later_slice", "logger",
           "resolve_device"]

logger = logging.getLogger("mxnet_tpu_torch")


class MXNetError(RuntimeError):
    """Framework error type (mirrors ``MXNetError`` raised through the
    reference's C ABI ``MXGetLastError``, ``python/mxnet/base.py``)."""


class RecompileStorm(MXNetError):
    """Raised (under ``MXNET_RECOMPILE_ERROR=1``) when one captured
    callable has met more distinct input signatures than
    ``MXNET_RECOMPILE_WARN`` allows: in the port every new signature of a
    multi-step ``TrainStep`` is a new CUDA-graph capture.  ``name`` is the
    registered owner, ``signatures`` the distinct count, ``diff`` the
    leaf-level difference against the previous signature (see
    :mod:`mxnet_tpu_torch.compile_cache`)."""

    def __init__(self, msg, name=None, signatures=None, diff=None):
        super().__init__(msg)
        self.name = name
        self.signatures = signatures
        self.diff = diff


class TrainingPreempted(MXNetError):
    """Raised by ``Module.fit`` after a SIGTERM/SIGINT arrived mid-run:
    the loop stops at the next batch boundary instead of dying inside a
    step.  ``epoch`` and ``nbatch`` name the position reached."""

    def __init__(self, msg, epoch=None, nbatch=None, signum=None):
        super().__init__(msg)
        self.epoch = epoch
        self.nbatch = nbatch
        self.signum = signum


class TrainingDiverged(MXNetError):
    """Raised by the run-health sentinel when training is beyond
    automatic recovery: N consecutive rollbacks (or skip-only policy
    exhausted) without the numerics coming back.  ``epoch``/``nbatch``
    name the position, ``reason`` the anomaly that exhausted the
    policy."""

    def __init__(self, msg, epoch=None, nbatch=None, reason=None):
        super().__init__(msg)
        self.epoch = epoch
        self.nbatch = nbatch
        self.reason = reason


class StepHung(MXNetError):
    """Raised (asynchronously, by :class:`~mxnet_tpu_torch.health.
    StepWatchdog`) when a step made no progress for its timeout: a
    wedged device call, a deadlocked collective, or a stuck input
    pipeline.  By the time this surfaces the watchdog has dumped
    all-thread stacks to the artifact named in ``dump_path``
    (pretty-print it with ``tools/diagnose.py``)."""

    def __init__(self, msg="", note=None, dump_path=None):
        # msg defaults to "" because the watchdog delivers this class
        # through PyThreadState_SetAsyncExc, which instantiates it with
        # no arguments (health.last_hang_details() holds the details)
        super().__init__(msg)
        self.note = note
        self.dump_path = dump_path


def get_env(name, default, typ=None):
    """Typed env-var lookup, equivalent of ``dmlc::GetEnv``: honours the
    ``MXTPU_`` prefix, then the original ``MXNET_`` name."""
    for prefix in ("MXTPU_", "MXNET_", ""):
        key = name if name.startswith(("MXTPU_", "MXNET_")) else prefix + name
        if key in os.environ:
            raw = os.environ[key]
            t = typ or type(default)
            if t is bool:
                return raw not in ("0", "false", "False", "")
            return t(raw)
    return default


def later_slice(field, value):
    """The error for a setting whose feature the port has not reached."""
    return MXNetError("%s=%r: %s is ported in a later slice of the PyTorch "
                      "port" % (field, value, field))


class _Registry:
    """Generic name -> object registry (equivalent of ``dmlc::Registry``)."""

    def __init__(self, kind):
        self._kind = kind
        self._entries = {}

    def register(self, name, obj):
        self._entries[name] = obj
        return obj

    def get(self, name):
        if name not in self._entries:
            raise MXNetError(
                "%s %r is not registered (known: %s)"
                % (self._kind, name, sorted(self._entries)))
        return self._entries[name]


def resolve_device(device, who):
    """The ``device`` an entry point runs on: ``None`` means the card; a
    ``Context`` means its ``torch_device``.

    Entry points never drop to the CPU on their own — without a CUDA
    device the caller must ask for ``device="cpu"`` (``mx.cpu()`` as a
    context) explicitly."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s: no CUDA device is available; pass device='cpu' "
                "(context mx.cpu()) to run on the CPU" % who)
        device = "cuda"
    device = getattr(device, "torch_device", device)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("%s: device=%r but CUDA is not available"
                         % (who, str(device)))
    return device
