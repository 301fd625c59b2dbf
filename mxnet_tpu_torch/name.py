"""Automatic symbol naming (reference ``python/mxnet/name.py``; the
port's own copy of ``mxnet_tpu/name.py``).

``NameManager`` assigns sequential names (``convolution0``, ``convolution1``
…) to anonymously-created symbols; ``Prefix`` prepends a scope prefix.  Both
are context managers and nest, exactly like the reference's
``NameManager.current`` stack — this is what makes two separately-built
networks get disjoint parameter names.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_local = threading.local()


def current():
    """The innermost active NameManager (a default one if none entered)."""
    stack = getattr(_local, "stack", None)
    if not stack:
        _local.stack = [NameManager()]
        stack = _local.stack
    return stack[-1]


class NameManager:
    """Sequential auto-namer; ``with NameManager():`` scopes the counters so
    names restart from 0 inside the block (reference ``name.py:20-73``)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self):
        if not hasattr(_local, "stack"):
            _local.stack = [NameManager()]
        _local.stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()


class Prefix(NameManager):
    """NameManager that prepends ``prefix`` to every generated name
    (reference ``name.py:76-97``)::

        with mx.name.Prefix("resnet_"):
            net = build()   # parameters named resnet_convolution0_weight …
    """

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
