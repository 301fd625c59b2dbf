"""Fused optimizer-update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference
``src/operator/optimizer_op.cc``): ``sgd_update``, ``sgd_mom_update``,
the multi-precision ``mp_sgd_update``/``mp_sgd_mom_update``,
``adam_update``, ``rmsprop_update``, ``rmspropalex_update`` and
``ftrl_update`` (:47-124), each a pure function of tensors that returns
the new weight and then the new state tensors, in the order of the op's
``mutable_inputs``; the invoke layer rebinds the NDArrays (``out=w`` for
the weight), detached.  The arithmetic is the JAX package's, term for
term: coefficients are Python floats, and the right-hand sides keep its
order of operations.  The JAX package computes these in XLA, outside
Pallas, so no kernel is owed: on the card each is a few elementwise
PyTorch kernels.
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


def _lr_wd(attrs):
    return float(attrs["lr"]), float(attrs.get("wd", 0.0))


@register("sgd_update")
def _sgd_update(attrs, weight, grad):
    lr, wd = _lr_wd(attrs)
    g = _prep_grad(grad, attrs)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", mutable_inputs=(2,))
def _sgd_mom_update(attrs, weight, grad, mom):
    lr, wd = _lr_wd(attrs)
    momentum = float(attrs.get("momentum", 0.0))
    g = _prep_grad(grad, attrs)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register("mp_sgd_update", mutable_inputs=(2,))
def _mp_sgd_update(attrs, weight, grad, weight32):
    """Half-precision weights with an fp32 master copy (reference
    ``mp_sgd_update``)."""
    lr, wd = _lr_wd(attrs)
    g = _prep_grad(grad.float(), attrs)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", mutable_inputs=(2, 3))
def _mp_sgd_mom_update(attrs, weight, grad, mom, weight32):
    lr, wd = _lr_wd(attrs)
    momentum = float(attrs.get("momentum", 0.0))
    g = _prep_grad(grad.float(), attrs)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", mutable_inputs=(2, 3))
def _adam_update(attrs, weight, grad, mean, var):
    lr, wd = _lr_wd(attrs)
    beta1 = float(attrs.get("beta1", 0.9))
    beta2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep_grad(grad, attrs) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + eps)
    return new_w, new_mean, new_var


@register("rmsprop_update", mutable_inputs=(2,))
def _rmsprop_update(attrs, weight, grad, n):
    lr, wd = _lr_wd(attrs)
    gamma1 = float(attrs.get("gamma1", 0.95))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep_grad(grad, attrs) + wd * weight
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_w = weight - lr * g / torch.sqrt(new_n + eps)
    return new_w, new_n


@register("rmspropalex_update", mutable_inputs=(2, 3, 4))
def _rmspropalex_update(attrs, weight, grad, n, g_state, delta):
    lr, wd = _lr_wd(attrs)
    gamma1 = float(attrs.get("gamma1", 0.95))
    gamma2 = float(attrs.get("gamma2", 0.9))
    eps = float(attrs.get("epsilon", 1e-8))
    g = _prep_grad(grad, attrs) + wd * weight
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    new_g = (1 - gamma1) * g + gamma1 * g_state
    new_delta = (gamma2 * delta -
                 lr * g / torch.sqrt(new_n - torch.square(new_g) + eps))
    return weight + new_delta, new_n, new_g, new_delta


@register("ftrl_update", mutable_inputs=(2, 3))
def _ftrl_update(attrs, weight, grad, z, n):
    lr, wd = _lr_wd(attrs)
    lamda1 = float(attrs.get("lamda1", 0.01))
    beta = float(attrs.get("beta", 1.0))
    g = _prep_grad(grad, attrs)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1) /
        ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n
