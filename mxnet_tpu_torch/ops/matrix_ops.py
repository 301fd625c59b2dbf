"""Shape and indexing operators: ``Reshape``, ``Flatten``,
``Embedding``, ``Concat``, ``pick`` and ``where``.

Counterpart of ``mxnet_tpu/ops/matrix_ops.py`` for the ops the
transformer LM, ResNet and the Gluon losses reach; the rest of the module
comes with a later slice.
"""
from __future__ import annotations

import torch

from .registry import register


def _infer_reshape(shape, target):
    """The reference's Reshape special codes 0, -1, -2, -3, -4
    (``src/operator/tensor/matrix_op.cc`` Reshape doc)."""
    out, src_i, i = [], 0, 0
    target = list(target)
    while i < len(target):
        t = int(target[i])
        if t == 0:
            out.append(shape[src_i])
            src_i += 1
        elif t == -1:
            out.append(-1)
            src_i += 1
        elif t == -2:
            out.extend(shape[src_i:])
            src_i = len(shape)
        elif t == -3:
            out.append(shape[src_i] * shape[src_i + 1])
            src_i += 2
        elif t == -4:
            a, b = int(target[i + 1]), int(target[i + 2])
            dim = shape[src_i]
            if a == -1:
                a = dim // b
            if b == -1:
                b = dim // a
            out.extend([a, b])
            src_i += 1
            i += 2
        else:
            out.append(t)
            src_i += 1
        i += 1
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def _reshape(attrs, x):
    shape = attrs["shape"]
    if attrs.get("reverse", False):
        rshape = _infer_reshape(tuple(x.shape)[::-1], list(shape)[::-1])
        return x.reshape(rshape[::-1])
    return x.reshape(_infer_reshape(tuple(x.shape), shape))


@register("Flatten", aliases=("flatten",))
def _flatten(attrs, x):
    """(N, ...) -> (N, prod(...)) (reference ``Flatten``)."""
    return x.reshape(x.shape[0], -1)


@register("Embedding")
def _embedding(attrs, data, weight):
    """Table lookup with ``jnp.take``'s default fill mode, the JAX
    package's semantics: an id in [-V, 0) counts from the end, and an id
    outside [-V, V) gives a NaN row and no gradient.  The ids are masked
    before indexing, so the card never sees an out-of-range index.  Ids
    arrive as floats and truncate toward zero (``astype(int32)``)."""
    v = weight.shape[0]
    ids = data.to(torch.int64)
    valid = (ids >= -v) & (ids < v)
    safe = torch.where(valid, torch.remainder(ids, v), torch.zeros_like(ids))
    rows = torch.nn.functional.embedding(safe, weight)
    return torch.where(valid[..., None], rows,
                       torch.full_like(rows, float("nan")))


@register("Concat", aliases=("concat", "concatenate"))
def _concat(attrs, *xs):
    """Join along ``dim`` (default 1)."""
    return torch.cat(xs, dim=int(attrs.get("dim", 1)))


@register("pick", aliases=("choose_element_0index",))
def _pick(attrs, x, index):
    """``x``'s entry at ``index`` along ``axis`` (default 1; None means
    the last).  Indices truncate toward zero and clip into range, as the
    JAX package's ``take_along_axis`` does; the gradient lands on the
    picked entries only."""
    axis = attrs.get("axis", 1)
    axis = x.dim() - 1 if axis is None else int(axis) % x.dim()
    idx = index.to(torch.int64).clamp(0, x.shape[axis] - 1)
    picked = torch.gather(x, axis, idx.unsqueeze(axis))
    if bool(attrs.get("keepdims", False)):
        return picked
    return picked.squeeze(axis)


@register("where")
def _where(attrs, cond, a, b):
    """``a`` where ``cond`` is non-zero, else ``b``; a condition of lower
    rank selects whole rows (the reference's ``where``)."""
    if cond.dim() < a.dim():
        cond = cond.reshape(tuple(cond.shape) + (1,) * (a.dim() - cond.dim()))
    return torch.where(cond != 0, a, b)
