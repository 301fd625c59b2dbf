"""Optimizers: the base class and SGD's fused form.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference
``python/mxnet/optimizer.py``).  This slice ports what ``fused.TrainStep``
drives: the ``Optimizer`` base (``rescale_grad``, ``clip_gradient``,
``wd``, per-parameter ``lr_mult``/``wd_mult``, the registry) and the
fused update form — ``init_fused_state(weight)`` and ``fused_update(
weight, grad, state, lr, wd, t, rng) -> (new_weight, new_state)``, pure
functions over tensors that return new tensors and leave their inputs
as they were.  SGD (momentum, multi-precision) is the one optimizer of
the slice; the split ``update()`` path and the others come later.
"""
from __future__ import annotations

import torch

from .base import MXNetError, later_slice

__all__ = ["Optimizer", "SGD", "create", "register"]

_registry = {}


def register(klass):
    """Register an optimizer class by (lowercased) name."""
    _registry[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    key = name.lower()
    if key not in _registry:
        raise MXNetError("optimizer %r is not registered (known: %s)"
                         % (name, sorted(_registry)))
    return _registry[key](**kwargs)


class Optimizer:
    """Base optimizer (reference ``python/mxnet/optimizer.py:30``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, clip_global_norm=None):
        if lr_scheduler is not None:
            raise later_slice("lr_scheduler", lr_scheduler)
        if clip_global_norm is not None:
            raise later_slice("clip_global_norm", clip_global_norm)
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.idx2name = dict(param_idx2name or {})
        self.sym_attrs = sym.attr_dict() if sym is not None else {}
        self.lr_mult = {}
        self.wd_mult = {}

    create_optimizer = staticmethod(create)

    # -- lr/wd multipliers (reference semantics incl. symbol attrs) -----
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        for name, attrs in self.sym_attrs.items():
            if "__lr_mult__" in attrs:
                self.lr_mult[name] = float(attrs["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # biases/gammas/betas get no weight decay by default
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        for name, attrs in self.sym_attrs.items():
            if "__wd_mult__" in attrs:
                self.wd_mult[name] = float(attrs["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    # -- fused form -------------------------------------------------------
    # ``grad`` is the raw (pre-rescale) gradient; lr/wd already carry the
    # per-parameter multipliers; ``t`` is the update count, 1 at the first
    # call; ``rng`` is a torch.Generator or None.
    def init_fused_state(self, weight):
        raise NotImplementedError(
            "%s has no fused form" % type(self).__name__)

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        raise NotImplementedError

    @property
    def supports_fused(self):
        return type(self).fused_update is not Optimizer.fused_update

    def _fused_prep(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


@register
class SGD(Optimizer):
    """SGD with momentum (reference ``optimizer.py`` SGD and the fused
    ``sgd_mom_update`` of ``src/operator/optimizer_op.cc``).
    ``multi_precision`` keeps an fp32 master copy for fp16/bf16 weights."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def init_fused_state(self, weight):
        if self.multi_precision and weight.dtype in (torch.float16,
                                                     torch.bfloat16):
            mom = torch.zeros(weight.shape, dtype=torch.float32,
                              device=weight.device) \
                if self.momentum != 0.0 else None
            return (mom, weight.float())
        return torch.zeros_like(weight) if self.momentum != 0.0 else None

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad)
        if isinstance(state, tuple):  # multi-precision master weights
            mom, w32 = state
            g = g.float()
            if mom is not None:
                new_mom = self.momentum * mom - lr * (g + wd * w32)
                new_w32 = w32 + new_mom
                return new_w32.to(weight.dtype), (new_mom, new_w32)
            new_w32 = w32 - lr * (g + wd * w32)
            return new_w32.to(weight.dtype), (None, new_w32)
        if state is not None:
            new_mom = self.momentum * state - lr * (g + wd * weight)
            return weight + new_mom, new_mom
        return weight - lr * (g + wd * weight), None
