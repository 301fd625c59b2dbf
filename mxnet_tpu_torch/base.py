"""Base utilities: the error type, env config, logging and device choice.

The port's own copy of what it needs from the JAX package's ``base.py``:
the same ``MXNetError`` type name and the same ``MXTPU_``/``MXNET_``
env-var lookup, so configuration carries over between the two packages
unchanged.
"""
from __future__ import annotations

import logging
import os

__all__ = ["MXNetError", "get_env", "later_slice", "logger",
           "resolve_device"]

logger = logging.getLogger("mxnet_tpu_torch")


class MXNetError(RuntimeError):
    """Framework error type (mirrors ``MXNetError`` raised through the
    reference's C ABI ``MXGetLastError``, ``python/mxnet/base.py``)."""


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


def resolve_device(device, who):
    """The ``device`` an entry point runs on: ``None`` means the card.

    Entry points never drop to the CPU on their own — without a CUDA
    device the caller must ask for ``device="cpu"`` explicitly."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s: no CUDA device is available; pass device='cpu' to run "
                "on the CPU" % who)
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("%s: device=%r but CUDA is not available"
                         % (who, str(device)))
    return device
