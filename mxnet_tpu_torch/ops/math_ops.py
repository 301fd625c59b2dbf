"""Elementwise binary and scalar operators.

Counterpart of ``mxnet_tpu/ops/math_ops.py`` for the ops that symbol
arithmetic (``Symbol.__add__`` and friends) and the transformer LM reach:
the ``elemwise_*``/``broadcast_*`` binary family, the ``_*_scalar``
family and ``negative``.  Each is one PyTorch expression; both binary
spellings broadcast, as in the JAX package.  The rest of the module
comes with the NDArray slice.
"""
from __future__ import annotations

import torch

from .registry import register

register("negative", lambda attrs, x: torch.neg(x))

_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
}

for _name, _fn in _BINARY.items():
    register("elemwise_%s" % _name,
             (lambda fn: lambda attrs, a, b: fn(a, b))(_fn),
             aliases=("_%s" % _name, "broadcast_%s" % _name))

register("_minus", lambda attrs, a, b: a - b, aliases=("elemwise_minus",))
register("broadcast_minus", lambda attrs, a, b: a - b)
register("broadcast_plus", lambda attrs, a, b: a + b)


def _cmp(fn):
    return lambda x, s: fn(x, s).to(x.dtype)


# scalar variants (reference elemwise_binary_scalar_op*.cc); a Python
# scalar keeps the tensor's dtype, as JAX's weak typing does
_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.clamp_min(x, s),
    "_minimum_scalar": lambda x, s: torch.clamp_max(x, s),
    "_hypot_scalar": lambda x, s: torch.hypot(x, torch.full_like(x, s)),
    "_equal_scalar": _cmp(torch.eq),
    "_not_equal_scalar": _cmp(torch.ne),
    "_greater_scalar": _cmp(torch.gt),
    "_greater_equal_scalar": _cmp(torch.ge),
    "_lesser_scalar": _cmp(torch.lt),
    "_lesser_equal_scalar": _cmp(torch.le),
}

for _name, _fn in _SCALAR.items():
    register(_name, (lambda fn: lambda attrs, x: fn(
        x, float(attrs["scalar"])))(_fn))
