"""Fused optimizer-update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
``src/operator/optimizer_op.cc``) for ``sgd_update`` and
``sgd_mom_update``, each a pure function of tensors that returns the new
weight (and momentum); the invoke layer rebinds the NDArrays (``out=w``
for the weight, ``mutable_inputs`` for the momentum), detached.  The
other updates come with a later slice.
"""
from __future__ import annotations

import torch

from .registry import register


def _prep_grad(grad, attrs):
    g = grad * float(attrs.get("rescale_grad", 1.0))
    clip = float(attrs.get("clip_gradient", -1.0))
    if clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g


@register("sgd_update")
def _sgd_update(attrs, weight, grad):
    lr = float(attrs["lr"])
    wd = float(attrs.get("wd", 0.0))
    g = _prep_grad(grad, attrs)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", mutable_inputs=(2,))
def _sgd_mom_update(attrs, weight, grad, mom):
    lr = float(attrs["lr"])
    wd = float(attrs.get("wd", 0.0))
    momentum = float(attrs.get("momentum", 0.0))
    g = _prep_grad(grad, attrs)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom
