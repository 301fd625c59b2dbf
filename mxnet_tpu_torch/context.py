"""Device context.

Counterpart of ``mxnet_tpu/context.py`` (the reference's
``python/mxnet/context.py``: ``Context``, ``mx.cpu()``/``mx.gpu()``, a
thread-local default).  A context names a ``torch.device``: ``cpu()`` the
host, ``gpu(i)`` the CUDA card ``i``.  ``tpu(i)`` is an alias of
``gpu(i)``, as the JAX package's ``gpu`` aliases its accelerator, so
scripts written for either package run unchanged.  The default context
is ``gpu(0)``: entry points run on the card unless the caller asks for
the CPU.
"""
from __future__ import annotations

import threading

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context"]


class Context:
    """Device context, API-compatible with the reference ``Context``
    (``python/mxnet/context.py:23``): device type and id, equality,
    ``with ctx:`` default scoping."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type == "tpu":
                device_type = "gpu"
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        # the context to restore goes on a per-thread stack, not on the
        # instance: ``with c: with c:`` then restores the outer default
        local = Context._default_ctx
        if not hasattr(local, "stack"):
            local.stack = []
        local.stack.append(getattr(local, "value", None))
        local.value = self
        return self

    def __exit__(self, ptype, value, trace):
        local = Context._default_ctx
        local.value = local.stack.pop()

    @property
    def torch_device(self):
        """The ``torch.device`` this context denotes (the JAX package's
        ``jax_device``).  A card context without a CUDA device raises: the
        caller must ask for ``mx.cpu()`` explicitly."""
        import torch

        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError("%s: no CUDA device is available; pass the "
                             "context mx.cpu() to run on the CPU" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%s: only %d CUDA device(s)"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)


def cpu(device_id=0):
    """A CPU context (reference ``mx.cpu()``)."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """The CUDA card ``device_id`` (reference ``mx.gpu()``)."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`: scripts written for the JAX package's
    ``mx.tpu()`` get the card."""
    return Context("gpu", device_id)


def current_context():
    """The thread-local default context (reference ``current_context()``):
    ``gpu(0)`` unless a ``with ctx:`` block says otherwise."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)


def context_of(device):
    """The :class:`Context` of a ``torch.device``."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    return cpu()
