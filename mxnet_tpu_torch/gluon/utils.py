"""Gluon utilities.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference
``python/mxnet/gluon/utils.py``): ``split_data``, ``split_and_load`` (one
context in this slice) and ``clip_global_norm``.
"""
from __future__ import annotations

import math

from ..base import MXNetError, later_slice
from ..ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` into ``num_slice`` parts along ``batch_axis``."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise MXNetError(
            "Too many slices for data with shape %s" % (data.shape,))
    if even_split and size % num_slice != 0:
        raise MXNetError(
            "data size %d cannot be evenly split into %d slices"
            % (size, num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * len(data.shape)
        idx[batch_axis] = slice(begin, end)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` on the one context of ``ctx_list``."""
    if len(ctx_list) != 1:
        raise later_slice("split_and_load(ctx_list)", list(ctx_list))
    if not isinstance(data, NDArray):
        data = array(data, ctx_list[0])
    return [data.as_in_context(ctx_list[0])]


def clip_global_norm(arrays, max_norm):
    """Rescale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before."""
    total = 0.0
    for arr in arrays:
        total += float((arr * arr).sum().asscalar())
    total = math.sqrt(total)
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total
