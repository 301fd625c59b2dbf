"""The ``sym`` namespace — generated from the port's op registry, like the
reference's ``_init_symbol_module`` (``python/mxnet/symbol/op.py``) and
the JAX package's ``mxnet_tpu/symbol/__init__.py``."""
from __future__ import annotations

import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..ops import registry as _registry
from ..ops.op_names import expected_inputs as _expected_inputs
from .symbol import Symbol, Variable, var, Group, load, load_json, _apply

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]

_RESERVED = {"var", "load"}


def _make_sym_func(name):
    def sym_func(*args, **kwargs):
        node_name = kwargs.pop("name", None)
        attrs, named = {}, {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                named[k] = v  # data=..., weight=...: ordered by the op
            else:
                attrs[k] = v
        sym_inputs = list(args)
        if named:
            arg_names, aux_names = _expected_inputs(name, attrs)
            ordered = []
            for an in list(arg_names) + list(aux_names):
                if an in named:
                    ordered.append(named.pop(an))
                elif sym_inputs:
                    ordered.append(sym_inputs.pop(0))
                else:
                    break
            sym_inputs = ordered + sym_inputs + list(named.values())
        return _apply(name, sym_inputs, attrs, name=node_name)

    sym_func.__name__ = name
    sym_func.__doc__ = _registry.get(name).describe()
    return sym_func


for _name in _registry.list_ops():
    if _name not in _RESERVED:
        setattr(_sys.modules[__name__], _name, _make_sym_func(_name))
