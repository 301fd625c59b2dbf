"""Optimizers: the base class, SGD, and the updater of the split path.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference
``python/mxnet/optimizer.py``).  Ported: the ``Optimizer`` base
(``rescale_grad``, ``clip_gradient``, ``wd``, per-parameter
``lr_mult``/``wd_mult``, the update counters ``num_update`` and
``_update_count`` that ``Module`` reads, the registry); the fused update
form that ``fused.TrainStep`` drives — ``init_fused_state(weight)`` and
``fused_update(weight, grad, state, lr, wd, t, rng) -> (new_weight,
new_state)``, pure functions over tensors that return new tensors and
leave their inputs as they were; and the split form ``create_state``/
``update`` over NDArrays with :func:`get_updater`, the path of
``Module.update`` after an executor's ``forward``/``backward``.  SGD
(momentum, multi-precision) is the one optimizer; the others and
``lr_scheduler`` come with a later slice.
"""
from __future__ import annotations

import torch

from .base import MXNetError, later_slice

__all__ = ["Optimizer", "SGD", "Updater", "create", "get_updater",
           "register"]

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
        self.lr_scheduler = None
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
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

    # -- update counting and per-parameter lr/wd (split path) -------------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr
        if index in self.lr_mult:
            return lr * self.lr_mult[index]
        return lr * self.lr_mult.get(self.idx2name.get(index), 1.0)

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            return wd * self.wd_mult[index]
        return wd * self.wd_mult.get(self.idx2name.get(index), 1.0)

    def create_state(self, index, weight):
        """The split path's state for NDArray ``weight``: the fused state
        over its tensor."""
        with torch.no_grad():
            return self.init_fused_state(weight._data.detach())

    def update(self, index, weight, grad, state):
        """One split-path step on NDArrays: ``weight`` is rebound; returns
        the new state."""
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        with torch.no_grad():
            new_w, new_state = self.fused_update(
                weight._data, grad._data, state, lr, wd,
                self._index_update_count[index], None)
        weight._set_data(new_w)
        return new_state

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


class Updater:
    """Worker-side updater closure (reference ``get_updater``/``Updater``:
    what a KVStore calls per key)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
