"""BatchNorm's channel sums: kernels K5 (``bn_stats``) and K6
(``bn_grad_sums``).

Counterpart of ``mxnet_tpu/ops/pallas_bn.py``, the JAX package's Pallas
kernels of the same names (there behind ``MXNET_BN_PALLAS``, off by
default on a TPU, where XLA's fused reductions won).  On the card PyTorch
has no such fusion to lose to, so these two kernels are the bf16
training path of BatchNorm: ``nn_ops._BNTrain`` calls them for every
training-mode BatchNorm on bf16 data.

* :func:`bn_stats` — per-channel fp32 ``(Σx, Σx²)``;
* :func:`bn_grad_sums` — per-channel fp32 ``(Σdy, Σdy·x̂)`` with
  ``x̂ = (x − mean)·inv`` formed in fp32 inside the reduction.

Both treat a contiguous tensor as ``(outer, C, inner)`` around the channel
``axis`` (NCHW axis 1 is ``(N, C, H·W)``, NHWC axis 3 is ``(N·H·W, C,
1)``), so one kernel serves both layouts.  A wrapper takes the plain
version only for a tensor that lies on the CPU (or ``meta``); a CUDA
tensor launches the kernel (``csrc/batch_norm.cu``) or raises.

The kernels sum without atomics: each channel's elements are cut into
``S`` chunks of whole ``outer`` rows (:func:`chunk_rows`), each chunk is
reduced by one thread block in a fixed order into an fp32 partial, and a
second launch adds the ``S`` partials in order — so reruns give the same
bits.
"""
from __future__ import annotations

import torch

from .. import _cuda
from ..base import MXNetError

__all__ = ["bn_stats", "bn_grad_sums", "bn_stats_plain",
           "bn_grad_sums_plain", "chunk_rows"]

# thread blocks the stage-1 launch aims for (~31 per SM of an H100's 132):
# enough that a C = 3 layer still fills the card, few enough that every
# block streams tens of thousands of elements
_TARGET_BLOCKS = 4096
_COLS = 32  # channels per block when inner == 1 (csrc/batch_norm.cu kCols)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dims(x, axis):
    axis = axis % x.dim()
    outer = 1
    for d in x.shape[:axis]:
        outer *= d
    inner = 1
    for d in x.shape[axis + 1:]:
        inner *= d
    return outer, x.shape[axis], inner


def _reduce_dims(x, axis):
    axis = axis % x.dim()
    return tuple(i for i in range(x.dim()) if i != axis)


def chunk_rows(outer, c, inner):
    """``(rows, chunks)``: each channel's ``outer`` rows are cut into
    ``chunks`` runs of ``rows`` rows (the last may be shorter), one thread
    block each.  A function of the shape alone, so the summation order is
    too."""
    tiles = c if inner > 1 else -(-c // _COLS)
    want = max(1, min(outer, -(-_TARGET_BLOCKS // tiles)))
    rows = -(-outer // want)
    return rows, -(-outer // rows)


def bn_stats_plain(x, axis=1):
    """``(Σx, Σx²)`` over every axis but ``axis``, in fp32."""
    dims = _reduce_dims(x, axis)
    xf = x.float()
    return xf.sum(dims), (xf * xf).sum(dims)


def bn_grad_sums_plain(dy, x, mean, inv, axis=1):
    """``(Σdy, Σdy·x̂)`` with ``x̂ = (x − mean)·inv`` in fp32."""
    dims = _reduce_dims(x, axis)
    shape = [1] * x.dim()
    shape[axis % x.dim()] = x.shape[axis]
    dyf = dy.float()
    xhat = (x.float() - mean.float().reshape(shape)) * \
        inv.float().reshape(shape)
    return dyf.sum(dims), (dyf * xhat).sum(dims)


def _check(name, tensors, c):
    x = tensors[0]
    for t in tensors:
        if t.device != x.device:
            raise MXNetError("%s: inputs on different devices" % name)
        if t.dtype != x.dtype:
            raise MXNetError("%s: inputs of different dtypes (%s, %s)"
                             % (name, x.dtype, t.dtype))
        if t.shape != x.shape:
            raise MXNetError("%s: shapes %r and %r differ"
                             % (name, tuple(x.shape), tuple(t.shape)))
    if x.dtype not in _DTYPES:
        raise MXNetError("%s: the CUDA kernel takes float32 or bfloat16, "
                         "got %s" % (name, x.dtype))
    if x.numel() >= 2 ** 31:
        raise MXNetError("%s: %d elements is beyond the kernel's int32 "
                         "row arithmetic" % (name, x.numel()))
    if c == 0:
        raise MXNetError("%s: no channels" % name)


def _launch(name, ins, stats, axis):
    """Run K5 or K6 on CUDA tensors ``ins`` (x, or dy and x) and the fp32
    per-channel ``stats`` (none, or mean and inv); returns two (C,)
    fp32 tensors."""
    x = ins[-1]
    outer, c, inner = _dims(x, axis)
    _check(name, ins, c)
    ins = [t.contiguous() for t in ins]
    stats = [s.detach().float().contiguous() for s in stats]
    for s in stats:
        if tuple(s.shape) != (c,) or s.device != x.device:
            raise MXNetError("%s: per-channel input of shape %r on %s, "
                             "want (%d,) on %s" % (name, tuple(s.shape),
                                                   s.device, c, x.device))
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out.zero_().unbind(0)
    rows, chunks = chunk_rows(outer, c, inner)
    partial = torch.empty((2, chunks, c), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        _cuda.launch(name, *(t.data_ptr() for t in ins + stats),
                     _DTYPES[x.dtype], outer, c, inner, rows, chunks,
                     partial.data_ptr(), out.data_ptr(), _cuda.stream_of(x))
    return out.unbind(0)


def bn_stats(x, axis=1):
    """Per-channel fp32 ``(Σx, Σx²)`` of ``x`` over every axis but
    ``axis``: kernel K5 on a CUDA tensor, :func:`bn_stats_plain` on a CPU
    one."""
    if x.is_cuda:
        return _launch("bn_stats", [x], [], axis)
    return bn_stats_plain(x, axis)


def bn_grad_sums(dy, x, mean, inv, axis=1):
    """Per-channel fp32 ``(Σdy, Σdy·x̂)``, ``x̂ = (x − mean)·inv``: kernel
    K6 on CUDA tensors, :func:`bn_grad_sums_plain` on CPU ones.  ``dy``
    may arrive non-contiguous from autograd; the wrapper copies it."""
    if x.is_cuda:
        return _launch("bn_grad_sums", [dy, x], [mean, inv], axis)
    return bn_grad_sums_plain(dy, x, mean, inv, axis)
