"""AttrScope — scoped symbol attributes.

Reference: ``python/mxnet/attribute.py`` (``AttrScope``; the mechanism
behind ``group2ctx`` model parallelism: ``with AttrScope(ctx_group=...)``
tags every symbol built inside the scope).  The port's own copy of
``mxnet_tpu/attribute.py``; lr/wd multipliers (``__lr_mult__`` etc.)
flow through the same channel.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


class AttrScope:
    """``with AttrScope(ctx_group='dev1'): ...`` — attributes applied to
    every symbol created in the scope (nested scopes merge, inner
    wins)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings, got "
                                 "%r" % (v,))
        self._attrs = kwargs

    def get(self, attrs=None):
        """Merge scope attrs with explicitly-passed ones (explicit
        wins)."""
        merged = {}
        for scope in _stack():
            merged.update(scope._attrs)
        merged.update(self._attrs)
        if attrs:
            merged.update(attrs)
        return merged

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        _stack().pop()


def current():
    """The merged attribute dict of the active scopes."""
    merged = {}
    for scope in _stack():
        merged.update(scope._attrs)
    return merged
