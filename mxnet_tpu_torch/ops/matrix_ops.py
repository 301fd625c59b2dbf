"""Tensor structure, indexing, creation, ordering and linalg operators.

Counterpart of ``mxnet_tpu/ops/matrix_ops.py``, the whole module:
``Reshape`` with its special codes, ``Flatten``, ``transpose``,
``expand_dims``, ``squeeze``, ``SwapAxis``, the slice family with its
assign forms, ``repeat``/``tile``/``reverse``/``stack``/``Concat``/
``SliceChannel``/``Pad``, ``take``/``batch_take``/``Embedding``/
``one_hot``/``pick``/``where``, the creation ops, ``sort``/``argsort``/
``topk``, ``dot``/``batch_dot`` and the eight ``linalg_*``.

Semantics follow the JAX package where PyTorch's built-in differs:
``take`` clips (a negative index to 0) or wraps as ``jnp.take`` does;
``batch_take`` counts a negative index from the end and clamps the rest,
as JAX's gather does; ``sort``, ``argsort`` and ``topk`` are stable, so a
tie keeps the lower index first (``lax.top_k``'s order); slices with a
negative step, which torch's indexing lacks, read and write through a
flip.  A creation op (no tensor input) makes its output on the device
the caller names (``__device__``, else the current context's).  The
matrix products are PyTorch's (cuBLAS, cuSOLVER on the card): the JAX
package computes them in XLA, outside Pallas.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..quantize import fp8_apply_dot
from .registry import register


def _device(attrs):
    """Where an op without tensor inputs puts its output."""
    dev = attrs.get("__device__")
    if dev is not None:
        return torch.device(dev)
    from ..context import current_context

    return current_context().torch_device


def _dtype(attrs, default="float32"):
    from ..ndarray.ndarray import torch_dtype

    return torch_dtype(attrs.get("dtype") or default)


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


@register("transpose")
def _transpose(attrs, x):
    """Permute by ``axes`` (reverse all of them without)."""
    axes = attrs.get("axes") or tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*(int(a) for a in axes))


@register("expand_dims")
def _expand_dims(attrs, x):
    return x.unsqueeze(int(attrs["axis"]))


@register("squeeze")
def _squeeze(attrs, x):
    """Drop the size-1 ``axis`` (all size-1 axes without)."""
    axis = attrs.get("axis")
    if axis is None:
        return x.squeeze()
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    for a in axes:
        if x.shape[int(a)] != 1:
            raise MXNetError("squeeze: axis %d has size %d, not 1"
                             % (int(a), x.shape[int(a)]))
    return x.squeeze(tuple(int(a) for a in axes))


@register("SwapAxis", aliases=("swapaxes",))
def _swapaxes(attrs, x):
    return x.transpose(int(attrs["dim1"]), int(attrs["dim2"]))


def _slice_tuple(attrs, ndim):
    begin, end = attrs["begin"], attrs["end"]
    step = attrs.get("step") or (None,) * len(begin)
    idx = tuple(
        slice(None if b is None else int(b),
              None if e is None else int(e),
              None if st in (None, 0) else int(st))
        for b, e, st in zip(begin, end, step))
    return idx + (slice(None),) * (ndim - len(idx))


def _positive(idx, shape):
    """``idx`` with every negative-step slice replaced by the
    positive-step slice over the same elements, and the dims whose order
    must then be flipped."""
    out, flips = [], []
    for d, (sl, n) in enumerate(zip(idx, shape)):
        if sl.step is None or sl.step > 0:
            out.append(sl)
            continue
        r = range(*sl.indices(n))
        out.append(slice(r[-1], r[0] + 1, -r.step) if len(r)
                   else slice(0, 0))
        flips.append(d)
    return tuple(out), flips


def _take_slice(x, idx):
    idx, flips = _positive(idx, x.shape)
    out = x[idx]
    return out.flip(flips) if flips else out


@register("slice", aliases=("crop",))
def _slice(attrs, x):
    """``x[begin:end:step]`` per leading axis (a None bound is open)."""
    return _take_slice(x, _slice_tuple(attrs, x.dim()))


def _assign(lhs, idx, value):
    idx, flips = _positive(idx, lhs.shape)
    if flips and value.dim():
        lead = lhs.dim() - value.dim()
        value = value.flip([d - lead for d in flips if d >= lead])
    out = lhs.clone()
    out[idx] = value
    return out


@register("_slice_assign", aliases=("_crop_assign",))
def _slice_assign(attrs, lhs, rhs):
    """``lhs`` with ``rhs`` written into the slice region (reference
    ``_slice_assign``/``_crop_assign``); a new tensor, as JAX's
    ``.at[].set`` gives."""
    return _assign(lhs, _slice_tuple(attrs, lhs.dim()), rhs.to(lhs.dtype))


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(attrs, lhs):
    return _assign(lhs, _slice_tuple(attrs, lhs.dim()),
                   lhs.new_full((), float(attrs.get("scalar", 0.0))))


@register("_CrossDeviceCopy")
def _cross_device_copy(attrs, x):
    """Device-boundary marker of ``group2ctx`` graphs (reference
    ``src/operator/cross_device_copy.cc``): an identity on one device."""
    return x


@register("slice_axis")
def _slice_axis(attrs, x):
    axis = int(attrs["axis"]) % x.dim()
    end = attrs.get("end")
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(int(attrs["begin"]),
                      x.shape[axis] if end is None else int(end))
    return x[tuple(idx)]


@register("slice_like")
def _slice_like(attrs, x, like):
    axes = attrs.get("axes") or tuple(range(like.dim()))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[int(a)] = slice(0, like.shape[int(a)])
    return x[tuple(idx)]


@register("repeat")
def _repeat(attrs, x):
    """``jnp.repeat``: each element ``repeats`` times along ``axis`` (the
    flattened input without one)."""
    axis = attrs.get("axis")
    return torch.repeat_interleave(x, int(attrs["repeats"]),
                                   dim=None if axis is None else int(axis))


@register("tile")
def _tile(attrs, x):
    return torch.tile(x, tuple(int(r) for r in attrs["reps"]))


@register("reverse", aliases=("flip",))
def _reverse(attrs, x):
    axis = attrs["axis"]
    axis = (axis,) if isinstance(axis, int) else axis
    return torch.flip(x, [int(a) for a in axis])


@register("stack")
def _stack(attrs, *xs):
    return torch.stack(xs, dim=int(attrs.get("axis", 0)))


def _split_outputs(attrs):
    return int(attrs["num_outputs"])


@register("SliceChannel", aliases=("split",), num_outputs=_split_outputs)
def _split(attrs, x):
    """``num_outputs`` equal parts along ``axis`` (default 1), each
    squeezed there with ``squeeze_axis``."""
    num = int(attrs["num_outputs"])
    axis = int(attrs.get("axis", 1))
    if x.shape[axis] % num:
        raise MXNetError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (axis, x.shape[axis], num))
    parts = torch.split(x, x.shape[axis] // num, dim=axis)
    if attrs.get("squeeze_axis", False):
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("Pad", aliases=("pad",))
def _pad(attrs, x):
    """``jnp.pad`` with ``pad_width`` (before, after) pairs per axis:
    ``constant`` fills ``constant_value``; ``edge`` and ``reflect`` gather
    each padded axis through its source indices (:func:`_pad_index`)."""
    pw = attrs["pad_width"]
    pairs = [(int(pw[2 * i]), int(pw[2 * i + 1])) for i in range(len(pw) // 2)]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return torch.nn.functional.pad(
            x, flat, value=float(attrs.get("constant_value", 0)))
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad: unknown mode %r" % (mode,))
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def _pad_index(n, lo, hi, mode, device):
    """The source index of each position of an axis of ``n`` padded by
    (``lo``, ``hi``): ``np.pad(np.arange(n), (lo, hi), mode)``, made on
    ``device``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    j = torch.remainder(i, 2 * (n - 1))  # reflect without the edge twice
    return torch.where(j >= n, 2 * (n - 1) - j, j)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

def _ids(indices):
    """Float ids as int64, truncated toward zero (``astype(int32)``)."""
    return indices.to(torch.int64)


@register("take")
def _take(attrs, a, indices):
    """``jnp.take`` along ``axis``: mode ``clip`` (the default, a
    negative id to 0) or ``wrap``."""
    axis = int(attrs.get("axis", 0)) % a.dim()
    n = a.shape[axis]
    ids = _ids(indices)
    if attrs.get("mode", "clip") == "wrap":
        ids = torch.remainder(ids, n)
    else:
        ids = ids.clamp(0, n - 1)
    out = a.index_select(axis, ids.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(ids.shape)
                       + tuple(a.shape[axis + 1:]))


@register("batch_take")
def _batch_take(attrs, a, indices):
    """``a[i, indices[i]]`` as JAX indexes: a negative id counts from the
    end once; an id still out of range reads the clamped entry, and its
    gradient is dropped (the gather clamps, its scatter drops)."""
    n = a.shape[1]
    ids = _ids(indices)
    ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    out = torch.gather(a, 1, ids.clamp(0, n - 1).reshape(-1, 1)).reshape(
        ids.shape)
    return torch.where(inside, out, out.detach())


@register("one_hot")
def _one_hot(attrs, indices):
    depth = int(attrs["depth"])
    on = float(attrs.get("on_value", 1.0))
    off = float(attrs.get("off_value", 0.0))
    hot = _ids(indices)[..., None] == torch.arange(depth,
                                                   device=indices.device)
    return torch.where(hot, on, off).to(_dtype(attrs))


@register("ones_like")
def _ones_like(attrs, x):
    return torch.ones_like(x)


@register("zeros_like")
def _zeros_like(attrs, x):
    return torch.zeros_like(x)


@register("_identity_with_attr_like_rhs")
def _ident_like(attrs, lhs, rhs):
    return lhs


# ---------------------------------------------------------------------------
# creation ops (no tensor inputs)
# ---------------------------------------------------------------------------

@register("_zeros", aliases=("zeros",))
def _zeros(attrs):
    return torch.zeros(tuple(attrs["shape"]), dtype=_dtype(attrs),
                       device=_device(attrs))


@register("_ones", aliases=("ones",))
def _ones(attrs):
    return torch.ones(tuple(attrs["shape"]), dtype=_dtype(attrs),
                      device=_device(attrs))


@register("_full", aliases=("full",))
def _full(attrs):
    return torch.full(tuple(attrs["shape"]), float(attrs["value"]),
                      dtype=_dtype(attrs), device=_device(attrs))


@register("_arange", aliases=("arange",))
def _arange(attrs):
    """``np.arange(start, stop, step)`` in float64, each value
    ``repeat`` times, cast to ``dtype``."""
    start = float(attrs.get("start", 0))
    stop = attrs.get("stop")
    step = float(attrs.get("step", 1.0))
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, float(stop), step, dtype=torch.float64,
                       device=_device(attrs))
    repeat = int(attrs.get("repeat", 1))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out.to(_dtype(attrs))


@register("_eye", aliases=("eye",))
def _eye(attrs):
    """Ones on the ``k``-th diagonal of an N x M matrix."""
    n = int(attrs["N"])
    m = int(attrs.get("M", 0)) or n
    dev = _device(attrs)
    diag = (torch.arange(m, device=dev)[None, :]
            - torch.arange(n, device=dev)[:, None]) == int(attrs.get("k", 0))
    return diag.to(_dtype(attrs))


# ---------------------------------------------------------------------------
# ordering (reference ordering_op.cc); every sort is stable
# ---------------------------------------------------------------------------

def _axis(attrs, x):
    axis = attrs.get("axis", -1)
    return x.dim() - 1 if axis is None else int(axis) % x.dim()


@register("sort")
def _sort(attrs, x):
    axis = _axis(attrs, x)
    out = torch.sort(x, dim=axis, stable=True).values
    return out if attrs.get("is_ascend", True) else out.flip(axis)


@register("argsort")
def _argsort(attrs, x):
    axis = _axis(attrs, x)
    out = torch.sort(x, dim=axis, stable=True).indices
    if not attrs.get("is_ascend", True):
        out = out.flip(axis)
    return out.to(_dtype(attrs))


def _topk_outputs(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_outputs)
def _topk(attrs, x):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``, a
    tie's lower index first (``lax.top_k`` over ``x`` or ``-x``, as the
    JAX package runs it); indices float32."""
    axis = _axis(attrs, x)
    k = int(attrs.get("k", 1))
    ret = attrs.get("ret_typ", "indices")
    if ret == "mask":
        raise MXNetError("topk ret_typ='mask' not supported yet")
    largest = not bool(attrs.get("is_ascend", False))
    xm = x.movedim(axis, -1)
    order = torch.sort(xm if largest else -xm, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    vals = torch.gather(xm, -1, order).movedim(-1, axis)
    idx = order.movedim(-1, axis).to(torch.float32)
    if ret == "value":
        return vals
    if ret == "both":
        return vals, idx
    return idx


# ---------------------------------------------------------------------------
# dot and linalg
# ---------------------------------------------------------------------------

def _mt(x, flag):
    return x.transpose(-1, -2) if flag else x


def _flags(attrs):
    return (bool(attrs.get("transpose_a", False)),
            bool(attrs.get("transpose_b", False)))


@register("dot")
def _dot(attrs, a, b):
    """The JAX package's ``dot``: ``transpose_a``/``_b`` reverse all axes
    (``.T``), then a 2-D product over the flattened leading dims of ``a``
    and trailing dims of ``b``, in ``a``'s dtype."""
    ta, tb = _flags(attrs)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    am = a.permute(*range(a.dim() - 1, -1, -1)) if ta else a
    bm = b.permute(*range(b.dim() - 1, -1, -1)) if tb else b
    if am.dim() > 2:
        am = am.reshape(-1, am.shape[-1])
    if bm.dim() > 2:
        bm = bm.reshape(bm.shape[0], -1)
    out = fp8_apply_dot(am, bm, label=attrs.get("__node_name__"), w_dim=0)
    if out is None:
        out = torch.matmul(am, bm)
    return out.to(a.dtype)


@register("batch_dot")
def _batch_dot(attrs, a, b):
    ta, tb = _flags(attrs)
    return torch.matmul(_mt(a, ta), _mt(b, tb))


@register("linalg_gemm")
def _linalg_gemm(attrs, a, b, c):
    ta, tb = _flags(attrs)
    return (float(attrs.get("alpha", 1.0)) * torch.matmul(_mt(a, ta),
                                                          _mt(b, tb))
            + float(attrs.get("beta", 1.0)) * c)


@register("linalg_gemm2")
def _linalg_gemm2(attrs, a, b):
    ta, tb = _flags(attrs)
    return float(attrs.get("alpha", 1.0)) * torch.matmul(_mt(a, ta),
                                                         _mt(b, tb))


@register("linalg_potrf")
def _potrf(attrs, a):
    """The lower Cholesky factor (no host check of the result, as JAX
    runs it)."""
    return torch.linalg.cholesky_ex(a).L


def _lower_solve(a, b, left=True, transpose=False):
    """Solve with the lower triangle of ``a`` (or its transpose)."""
    if transpose:
        return torch.linalg.solve_triangular(a.transpose(-1, -2), b,
                                             upper=True, left=left)
    return torch.linalg.solve_triangular(a, b, upper=False, left=left)


@register("linalg_potri")
def _potri(attrs, a):
    """(L L^T)^-1 from the Cholesky factor L."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(
        a.shape)
    linv = _lower_solve(a, eye)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register("linalg_trmm")
def _trmm(attrs, a, b):
    alpha = float(attrs.get("alpha", 1.0))
    am = _mt(a, bool(attrs.get("transpose", False)))
    if bool(attrs.get("rightside", False)):
        return alpha * torch.matmul(b, am)
    return alpha * torch.matmul(am, b)


@register("linalg_trsm")
def _trsm(attrs, a, b):
    return float(attrs.get("alpha", 1.0)) * _lower_solve(
        a, b, left=not bool(attrs.get("rightside", False)),
        transpose=bool(attrs.get("transpose", False)))


@register("linalg_sumlogdiag")
def _sumlogdiag(attrs, a):
    return torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_syrk")
def _syrk(attrs, a):
    alpha = float(attrs.get("alpha", 1.0))
    at = a.transpose(-1, -2)
    if bool(attrs.get("transpose", False)):
        return alpha * torch.matmul(at, a)
    return alpha * torch.matmul(a, at)
