"""The operator registry — single source of truth for the port's ops.

Counterpart of ``mxnet_tpu/ops/registry.py``, with the same contract:

* an op's ``compute`` is a **pure function over tensors**,
  ``compute(attrs, *inputs)``, returning a tensor or a tuple of tensors.
  There is no per-op shape function: the Symbol frontend infers shapes by
  running ``compute`` on ``meta`` tensors.
* gradients come from torch autograd over the composed program.  Ops with
  a special gradient contract (``SoftmaxOutput``, whose backward is
  ``softmax - label`` whatever the head gradient) are a
  ``torch.autograd.Function`` inside their ``compute``.
* ops that mutate state declare ``mutable_inputs``; their compute returns
  the updated values as extra outputs, which the caller threads back.
* ops that consume randomness declare ``needs_rng`` and are handed a
  ``torch.Generator`` as their first input.

Imperative invoke (:func:`invoke`, the NDArray path) runs ``compute``
eagerly, under ``torch.no_grad()`` unless the caller records for
autograd: PyTorch has no compilation step for the JAX package's per-op
``jit`` cache to stand for, so ``_jitted`` returns the eager callable.
"""
from __future__ import annotations

from ..base import MXNetError, get_env

__all__ = ["OpDef", "register", "get", "exists", "list_ops", "FrozenAttrs",
           "invoke"]

_OP_REGISTRY = {}


def _freeze(value):
    """Make an attr value hashable."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


class FrozenAttrs(dict):
    """Hashable, immutable attr dict handed to ``compute``."""

    def __hash__(self):
        return hash(_freeze(self))

    def __setitem__(self, key, value):  # pragma: no cover - guard
        raise TypeError("FrozenAttrs is immutable")


class OpDef:
    """One registered operator."""

    def __init__(self, name, compute, num_outputs=1, needs_rng=False,
                 mutable_inputs=(), uses_train_mode=False, aliases=(),
                 doc=None):
        self.name = name
        self.compute = compute
        # int, or callable(attrs) -> int for attr-dependent output counts
        self.num_outputs = num_outputs
        self.needs_rng = needs_rng
        self.mutable_inputs = tuple(mutable_inputs)
        self.uses_train_mode = uses_train_mode
        self.aliases = tuple(aliases)
        self.doc = doc or (compute.__doc__ or "")
        # (name, type, default, description) rows from ops/op_params.py
        self.param_specs = None

    def describe(self):
        """The op's docstring: its doc, declared inputs and parameters."""
        from .op_names import INPUT_NAMES
        from .op_params import REQUIRED

        parts = [self.doc.strip() or self.name]
        if self.name in INPUT_NAMES:
            args, aux = INPUT_NAMES[self.name]
            parts.append("Inputs:\n" + "\n".join(
                "    - %s" % a for a in args + aux))
        if self.param_specs:
            rows = []
            for pname, ptype, default, desc in self.param_specs:
                dflt = "required" if default is REQUIRED \
                    else "optional, default=%r" % (default,)
                rows.append("%s : %s (%s)\n    %s"
                            % (pname, ptype, dflt, desc))
            parts.append("Parameters\n----------\n" + "\n".join(rows))
        return "\n\n".join(parts)

    def validate_attrs(self, attrs):
        """With ``MXNET_STRICT_OP_PARAMS=1``, reject attribute names not
        declared in the op's parameter spec, and missing required ones.
        No-op for ops without a spec."""
        if not self.param_specs:
            return
        if not get_env("MXNET_STRICT_OP_PARAMS", 0, int):
            return
        from .op_params import REQUIRED

        known = {p[0] for p in self.param_specs}
        unknown = [k for k in attrs
                   if not k.startswith("__") and k not in known]
        if unknown:
            raise MXNetError(
                "%s: unknown parameter(s) %s (declared: %s)"
                % (self.name, sorted(unknown), sorted(known)))
        missing = [p[0] for p in self.param_specs
                   if p[2] is REQUIRED and p[0] not in attrs]
        if missing:
            raise MXNetError("%s: missing required parameter(s) %s"
                             % (self.name, missing))

    def count_outputs(self, attrs):
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def _jitted(self, frozen_attrs, record=False):
        """``fn(*inputs) -> tuple`` running ``compute`` eagerly (the JAX
        package's jitted executable), building torch's graph only when
        ``record``."""
        import torch

        def fn(*inputs):
            with torch.enable_grad() if record else torch.no_grad():
                out = self.compute(frozen_attrs, *inputs)
            return out if isinstance(out, tuple) else (out,)

        return fn

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, compute=None, **kwargs):
    """Register an op.  Usable as a decorator::

        @register("relu")
        def _(attrs, x):
            return torch.clamp_min(x, 0)
    """
    def _do(fn):
        op = OpDef(name, fn, **kwargs)
        _OP_REGISTRY[name] = op
        for alias in op.aliases:
            _OP_REGISTRY[alias] = op
        return fn

    if compute is not None:
        return _do(compute)
    return _do


def get(name):
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("operator %r is not registered" % (name,)) from None


def exists(name):
    return name in _OP_REGISTRY


def list_ops():
    return sorted(_OP_REGISTRY)


def invoke(op, inputs, attrs, record=False):
    """Run an op's compute on raw tensors (a ``torch.Generator`` already
    prepended when the op declares ``needs_rng``), recording torch's
    graph when ``record``.  Returns a tuple:
    ``(*outputs, *updated_mutable_values)``."""
    if not isinstance(op, OpDef):
        op = get(op)
    frozen = attrs if isinstance(attrs, FrozenAttrs) else FrozenAttrs(attrs)
    return op._jitted(frozen, record)(*inputs)
