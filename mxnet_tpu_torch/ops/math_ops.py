"""Elementwise unary, binary and scalar operators, and reductions.

Counterpart of ``mxnet_tpu/ops/math_ops.py``, the whole module: the
unary family, ``make_loss``, ``Cast``, ``clip``, ``smooth_l1``, the
``elemwise_*``/``broadcast_*`` binary family, ``add_n``, the
``_*_scalar`` family, the reductions (``sum``, ``mean``, ``prod``,
``nansum``, ``nanprod``, ``max``, ``min`` with ``axis``, ``keepdims``
and ``exclude``), ``norm``, ``argmax``/``argmin``/``argmax_channel`` and
``broadcast_to``/``broadcast_axis``.  Each is one PyTorch expression;
both binary spellings broadcast, as in the JAX package.  Where JAX's
gradient at a tie or a kink differs from a torch built-in's, the op is
written so that torch's gradient is JAX's:
``maximum``/``minimum`` (and their scalar forms, ``relu`` and ``clip``)
go through ``torch.maximum``/``torch.minimum``, which split a tie's
gradient in halves as ``jnp.maximum`` does (``torch.clamp`` would give
it all to the input, so ``clip``'s gradient at a bound is 1/2, as
``jnp.clip``'s); ``abs`` is a select whose gradient at 0 is 1, as
``jnp.abs``'s is (``torch.abs``'s is 0); ``max``/``min`` reduce with
``amax``/``amin``, which share a tied maximum's gradient evenly as
``jnp.max`` does.  ``argmax``/``argmin`` take the first extremum (a NaN
counts as one), as ``jnp.argmax`` does.
"""
from __future__ import annotations

import torch

from .registry import register


def _scalar(x, s):
    """A Python scalar as a 0-d tensor of ``x``'s dtype (JAX's weak
    typing), filled on ``x``'s device (no copy from the host)."""
    return x.new_full((), s)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3)


_UNARY = {
    "abs": lambda x: torch.where(x >= 0, x, -x),
    "ceil": torch.ceil, "floor": torch.floor,
    "rint": torch.round, "round": torch.round, "trunc": torch.trunc,
    "fix": torch.trunc, "exp": torch.exp, "expm1": torch.expm1,
    "log": torch.log, "log1p": torch.log1p, "log2": torch.log2,
    "log10": torch.log10, "sqrt": torch.sqrt, "cbrt": _cbrt,
    "square": torch.square, "negative": torch.neg, "sign": torch.sign,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma, "erf": torch.erf,
    "erfinv": torch.erfinv, "rsqrt": torch.rsqrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x), "reciprocal": torch.reciprocal,
    "relu": lambda x: torch.maximum(x, x.new_zeros(())),
    "sigmoid": torch.sigmoid,
    "softsign": torch.nn.functional.softsign,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _fn in _UNARY.items():
    register(_name, (lambda fn: lambda attrs, x: fn(x))(_fn))


@register("_copy", aliases=("identity",))
def _copy(attrs, x):
    return x.clone()


@register("BlockGrad", aliases=("stop_gradient", "block_grad"))
def _block_grad(attrs, x):
    """Reference ``BlockGrad``: identity forward, no gradient."""
    return x.detach()


@register("Cast", aliases=("cast",))
def _cast(attrs, x):
    from ..ndarray.ndarray import torch_dtype

    return x.to(torch_dtype(attrs["dtype"]))


class _MakeLossFn(torch.autograd.Function):
    """Identity forward; backward ``grad_scale`` times the cotangent."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale) * g, None


@register("make_loss", aliases=("MakeLoss",))
def _make_loss(attrs, x):
    """Reference ``MakeLoss`` (``src/operator/make_loss.cc``): marks a
    head whose backward seeds ``grad_scale`` (times the head cotangent,
    ones under the reference's seeding) instead of a head gradient."""
    return _MakeLossFn.apply(x, float(attrs.get("grad_scale", 1.0)))


@register("clip")
def _clip(attrs, x):
    """``minimum(maximum(x, a_min), a_max)``, ``jnp.clip``'s form."""
    return torch.minimum(torch.maximum(x, _scalar(x, float(attrs["a_min"]))),
                         _scalar(x, float(attrs["a_max"])))


@register("smooth_l1")
def _smooth_l1(attrs, x):
    sigma = float(attrs.get("scalar", 1.0))
    s2 = sigma * sigma
    ax = _UNARY["abs"](x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def _logic(fn):
    return lambda a, b: fn(a, b).to(torch.result_type(a, b))


_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "mod": torch.remainder, "hypot": torch.hypot, "arctan2": torch.atan2,
    "equal": _logic(torch.eq), "not_equal": _logic(torch.ne),
    "greater": _logic(torch.gt), "greater_equal": _logic(torch.ge),
    "lesser": _logic(torch.lt), "lesser_equal": _logic(torch.le),
    "logical_and": _logic(lambda a, b: (a != 0) & (b != 0)),
    "logical_or": _logic(lambda a, b: (a != 0) | (b != 0)),
    "logical_xor": _logic(lambda a, b: (a != 0) ^ (b != 0)),
}

for _name, _fn in _BINARY.items():
    register("elemwise_%s" % _name,
             (lambda fn: lambda attrs, a, b: fn(a, b))(_fn),
             aliases=("_%s" % _name, "broadcast_%s" % _name))

register("_grad_add", lambda attrs, a, b: a + b)
register("_minus", lambda attrs, a, b: a - b, aliases=("elemwise_minus",))
register("broadcast_minus", lambda attrs, a, b: a - b)
register("broadcast_plus", lambda attrs, a, b: a + b)


@register("add_n", aliases=("ElementWiseSum", "_sum", "elemwise_sum"))
def _add_n(attrs, *xs):
    """The inputs summed left to right."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


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
    "_maximum_scalar": lambda x, s: torch.maximum(x, _scalar(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _scalar(x, s)),
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


# ---------------------------------------------------------------------------
# reductions (reference broadcast_reduce_op_value.cc)
# ---------------------------------------------------------------------------

def _norm_axis(axis, ndim, exclude=False):
    """The reduced axes as a tuple (None: all of them)."""
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(int(a) % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _reduce(fn):
    def compute(attrs, x):
        axis = _norm_axis(attrs.get("axis"), x.dim(),
                          bool(attrs.get("exclude", False)))
        keepdims = bool(attrs.get("keepdims", False))
        if axis == ():
            return x  # an empty axis list reduces nothing, as in JAX
        if axis is None:
            axis = tuple(range(x.dim()))
        return fn(x, axis, keepdims)
    return compute


def _prod(x, axes, keepdim):
    """``torch.prod`` over several axes, one at a time (it takes one)."""
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def _nanprod(x, axes, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), axes,
                 keepdim)


_REDUCE = {
    "sum": lambda x, a, k: torch.sum(x, dim=a, keepdim=k),
    "mean": lambda x, a, k: torch.mean(x, dim=a, keepdim=k),
    "prod": _prod,
    "nansum": lambda x, a, k: torch.nansum(x, dim=a, keepdim=k),
    "nanprod": _nanprod,
    "max": lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
    "min": lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
}

for _name, _fn in _REDUCE.items():
    register(_name, _reduce(_fn), aliases=("%s_axis" % _name,))


@register("norm")
def _norm(attrs, x):
    """L1 (``ord=1``) or L2 norm; the L2 form is ``sqrt(sum(x^2))``, so
    its gradient at 0 is NaN, as the JAX package's is."""
    axis = _norm_axis(attrs.get("axis"), x.dim())
    axis = tuple(range(x.dim())) if axis is None else axis
    keepdims = bool(attrs.get("keepdims", False))
    if int(attrs.get("ord", 2)) == 1:
        return torch.sum(_UNARY["abs"](x), dim=axis, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=axis,
                                keepdim=keepdims))


def _arg_reduce(fn):
    def compute(attrs, x):
        axis = attrs.get("axis")
        if axis is None:
            return fn(x.reshape(-1), dim=0).to(torch.float32)
        out = fn(x, dim=int(axis),
                 keepdim=bool(attrs.get("keepdims", False)))
        return out.to(torch.float32)
    return compute


register("argmax", _arg_reduce(torch.argmax))
register("argmin", _arg_reduce(torch.argmin))


@register("argmax_channel")
def _argmax_channel(attrs, x):
    return torch.argmax(x, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# broadcast structure ops
# ---------------------------------------------------------------------------

@register("broadcast_to")
def _broadcast_to(attrs, x):
    """Broadcast to ``shape``; a 0 keeps that dimension."""
    shape = tuple(int(s) if int(s) != 0 else x.shape[i]
                  for i, s in enumerate(attrs["shape"]))
    return x.expand(shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(attrs, x):
    axes, sizes = attrs["axis"], attrs["size"]
    if isinstance(axes, int):
        axes, sizes = (axes,), (sizes,)
    shape = list(x.shape)
    for a, n in zip(axes, sizes):
        shape[int(a)] = int(n)
    return x.expand(tuple(shape))
