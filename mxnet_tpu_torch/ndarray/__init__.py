"""The ``mx.nd`` namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: every operator function
here is generated from the registry at import time (reference
``python/mxnet/ndarray/op.py:174-209``), and dispatches through
:func:`.ndarray.imperative_invoke`.
"""
from __future__ import annotations

import sys as _sys

import numpy as _np

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..ops import registry as _registry
from .ndarray import (NDArray, imperative_invoke, array, empty, zeros, ones,
                      full, arange, concat, save, load, waitall)

_RESERVED = {"array", "empty", "save", "load", "concat", "waitall", "zeros",
             "ones", "full", "arange"}


def _make_op_func(name, op):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)  # symbol-compat no-op
        ctx = kwargs.pop("ctx", None)
        inputs = []
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, _np.ndarray):
                inputs.append(array(a, ctx))
            else:
                raise TypeError(
                    "%s: positional args must be NDArray, got %r" % (name, a))
        # NDArray keyword arguments are tensor inputs in the reference call
        # style (nd.FullyConnected(data=x, weight=w, ...)), ordered by the
        # op's declared argument names
        named = {k: v for k, v in kwargs.items()
                 if isinstance(v, (NDArray, _np.ndarray))}
        if named:
            from ..ops.op_names import expected_inputs

            for k in named:
                kwargs.pop(k)
            arg_names, aux_names = expected_inputs(name, kwargs)
            ordered = []
            for an in list(arg_names) + list(aux_names):
                if an in named:
                    v = named.pop(an)
                    ordered.append(v if isinstance(v, NDArray)
                                   else array(v, ctx))
                elif inputs:
                    ordered.append(inputs.pop(0))
            if named:
                raise TypeError("%s: unexpected tensor kwargs %s"
                                % (name, sorted(named)))
            inputs = ordered + inputs
        if ctx is not None and not inputs:
            # an op without tensor inputs (a creation or random op) makes
            # its outputs on ``ctx``
            with ctx:
                res = imperative_invoke(name, inputs, kwargs, out=out)
        else:
            res = imperative_invoke(name, inputs, kwargs, out=out)
        return res[0] if len(res) == 1 else res

    op_func.__name__ = name
    op_func.__qualname__ = name
    op_func.__doc__ = op.describe()
    return op_func


for _name in _registry.list_ops():
    if _name not in _RESERVED:
        setattr(_sys.modules[__name__], _name,
                _make_op_func(_name, _registry.get(_name)))
