"""Optimizers: the base class, every registered optimizer, global-norm
clipping and the updater of the split path.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference
``python/mxnet/optimizer.py``).  Each optimizer has the JAX package's two
forms, with its arithmetic:

* the split form, ``create_state(index, weight)`` and ``update(index,
  weight, grad, state)`` over NDArrays — the path of ``Module.update``
  after an executor's ``forward``/``backward``, of ``Trainer.step`` and
  of :class:`Updater`.  It reads the per-parameter learning rate (through
  the ``lr_scheduler`` when there is one) and weight decay, advances the
  update counts, and runs the registered update op where the JAX package
  does (``sgd_update``, ``adam_update``, ...) or the same NDArray
  arithmetic, rebinding the weight and the state arrays.  Coefficients
  (Adam's bias correction, Adamax's, Nadam's schedule) are Python floats,
  as there (:490-493);
* the fused form, ``init_fused_state(weight)`` and ``fused_update(weight,
  grad, state, lr, wd, t, rng) -> (new_weight, new_state)``, pure
  functions over tensors that ``fused.TrainStep`` drives: ``grad`` is the
  raw (pre-rescale) gradient, ``lr``/``wd`` carry the per-parameter
  multipliers and ``t`` is the update count, 1 at the first call.  The
  coefficients that depend on ``t`` are fp32 tensors, as the JAX
  package's traced ones are (:515-528), and the right-hand sides keep its
  order.

:func:`global_grad_norm` and :func:`global_norm_scale` are the
``clip_global_norm`` pair the fused step and ``Module.update`` apply
across all parameters.  Outside this slice: the row-sparse branches of
the split path (``ndarray/sparse.py``), the ZeRO drivers
``sharded_fused_update*`` and the checkpoint conversions
``fused_state_to_nd``/``fused_state_from_nd``.
"""
from __future__ import annotations

import math
import pickle

import torch

from .base import MXNetError
from .ndarray import imperative_invoke, zeros
from . import ndarray as nd

__all__ = ["Optimizer", "SGD", "DCASGD", "NAG", "SGLD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "Test",
           "create", "register", "get_updater", "Updater",
           "global_grad_norm", "global_norm_scale"]

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


def _f32(value):
    """``value`` as an fp32 0-d tensor: a number becomes a host scalar
    (which PyTorch hands to a card kernel by value, with no copy), a
    tensor keeps its device."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return torch.tensor(float(value), dtype=torch.float32)


class Optimizer:
    """Base optimizer (reference ``python/mxnet/optimizer.py:30``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, clip_global_norm=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        if clip_global_norm is not None and clip_global_norm <= 0:
            raise MXNetError("clip_global_norm must be > 0 (got %r)"
                             % (clip_global_norm,))
        # the whole gradient is scaled by min(1, clip / ||g||), the norm
        # taken over all trainable parameters together (after
        # rescale_grad, before the per-element clip_gradient); the fused
        # step and Module.update apply it, since the norm spans parameters
        self.clip_global_norm = clip_global_norm
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_attrs = sym.attr_dict() if sym is not None else {}
        self.lr_mult = {}
        self.wd_mult = {}

    create_optimizer = staticmethod(create)

    # -- split form ---------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

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
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common_kwargs(self):
        kw = {"rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def _split_prep(self, grad):
        """``rescale_grad`` then ``clip_gradient`` on an NDArray."""
        grad = grad * self.rescale_grad
        if self.clip_gradient is not None:
            grad = grad.clip(a_min=-self.clip_gradient,
                             a_max=self.clip_gradient)
        return grad

    # -- fused form ---------------------------------------------------------
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


def global_grad_norm(grads, rescale_grad=1.0):
    """Global L2 norm, in fp32, over a list or dict of gradient tensors as
    the optimizer will see them (scaled by ``rescale_grad``): the fused
    step calls it on its gradients, ``Module.update`` on ``grad_dict``."""
    leaves = list(grads.values()) if isinstance(grads, dict) else list(grads)
    sq = torch.zeros((), dtype=torch.float32,
                     device=leaves[0].device if leaves else None)
    for g in leaves:
        sq = sq + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(sq) * abs(rescale_grad)


def global_norm_scale(norm, max_norm, dtype=torch.float32):
    """min(1, max_norm / ||g||), guarded against a zero norm, as an
    ``dtype`` tensor (a NaN norm gives a NaN factor, as in JAX)."""
    factor = max_norm / (norm + 1e-12)
    return torch.minimum(torch.ones_like(factor), factor).to(dtype)


@register
class SGD(Optimizer):
    """SGD with momentum (reference ``optimizer.py`` SGD and the fused
    ``sgd_mom_update`` of ``src/operator/optimizer_op.cc``).
    ``multi_precision`` keeps an fp32 master copy for fp16/bf16 weights."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        mom = zeros(weight.shape, weight.context) \
            if self.momentum != 0.0 else None
        if self.multi_precision and weight._data.dtype in (torch.float16,
                                                           torch.bfloat16):
            return (mom, weight.astype("float32"))
        return mom

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        kw = self._common_kwargs()
        if isinstance(state, tuple):
            mom, w32 = state
            if mom is not None:
                imperative_invoke("mp_sgd_mom_update", [weight, grad, mom, w32],
                                  dict(lr=lr, wd=wd, momentum=self.momentum,
                                       **kw), out=weight)
            else:
                imperative_invoke("mp_sgd_update", [weight, grad, w32],
                                  dict(lr=lr, wd=wd, **kw), out=weight)
        elif state is not None:
            imperative_invoke("sgd_mom_update", [weight, grad, state],
                              dict(lr=lr, wd=wd, momentum=self.momentum,
                                   **kw), out=weight)
        else:
            imperative_invoke("sgd_update", [weight, grad],
                              dict(lr=lr, wd=wd, **kw), out=weight)

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


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference NAG)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context) \
            if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        grad = self._split_prep(grad)
        if state is not None:
            mom = state
            mom *= self.momentum
            grad += wd * weight
            mom += grad
            grad += self.momentum * mom
            weight += -lr * grad
        else:
            weight += -lr * (grad + wd * weight)

    def init_fused_state(self, weight):
        return torch.zeros_like(weight) if self.momentum != 0.0 else None

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad)
        if state is None:
            return weight - lr * (g + wd * weight), None
        g = g + wd * weight
        new_mom = self.momentum * state + g
        return weight - lr * (g + self.momentum * new_mom), new_mom


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (reference SGLD): half a step
    of SGD plus N(0, lr) noise, drawn from the step's generator."""

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        grad = self._split_prep(grad)
        noise = nd.random_normal(loc=0, scale=math.sqrt(lr),
                                 shape=weight.shape, ctx=weight.context)
        weight += -lr / 2 * (grad + wd * weight) + noise

    def init_fused_state(self, weight):
        return None

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad)
        noise = torch.sqrt(_f32(lr)) * torch.randn(
            weight.shape, generator=rng, dtype=weight.dtype,
            device=weight.device)
        return weight - lr / 2 * (g + wd * weight) + noise, None


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference DCASGD)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = zeros(weight.shape, weight.context) \
            if self.momentum != 0.0 else None
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        grad = self._split_prep(grad)
        mom, prev = state
        comp = grad + self.lamda * grad * grad * (weight - prev)
        if mom is not None:
            mom *= self.momentum
            mom += -lr * (comp + wd * weight)
            delta = mom
        else:
            delta = -lr * (comp + wd * weight)
        prev[:] = weight
        weight += delta

    def init_fused_state(self, weight):
        mom = torch.zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.clone())

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad)
        mom, prev = state
        comp = g + self.lamda * g * g * (weight - prev)
        if mom is not None:
            new_mom = self.momentum * mom - lr * (comp + wd * weight)
            return weight + new_mom, (new_mom, weight)
        return weight - lr * (comp + wd * weight), (None, weight)


@register
class Adam(Optimizer):
    """Adam with the reference's bias-corrected learning rate; the split
    path runs the ``adam_update`` op."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        imperative_invoke("adam_update", [weight, grad, mean, var],
                          dict(lr=lr, wd=wd, beta1=self.beta1,
                               beta2=self.beta2, epsilon=self.epsilon,
                               **self._common_kwargs()), out=weight)

    def init_fused_state(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        tf = _f32(t)
        coef1 = 1.0 - torch.pow(self.beta1, tf)
        coef2 = 1.0 - torch.pow(self.beta2, tf)
        lr = lr * torch.sqrt(coef2) / coef1
        g = self._fused_prep(grad) + wd * weight
        mean, var = state
        new_mean = self.beta1 * mean + (1 - self.beta1) * g
        new_var = self.beta2 * var + (1 - self.beta2) * torch.square(g)
        new_w = weight - lr * new_mean / (torch.sqrt(new_var) + self.epsilon)
        return new_w, (new_mean, new_var)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        grad = self._split_prep(grad)
        history = state
        history += grad * grad
        weight += -lr * (grad / (history + self.float_stable_eps).sqrt()
                         + wd * weight)

    def init_fused_state(self, weight):
        return torch.zeros_like(weight)

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad)
        new_hist = state + g * g
        new_w = weight - lr * (
            g / torch.sqrt(new_hist + self.float_stable_eps) + wd * weight)
        return new_w, new_hist


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Alex Graves' variant (reference)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (zeros(weight.shape, weight.context),
                    zeros(weight.shape, weight.context),
                    zeros(weight.shape, weight.context))
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        kw = dict(lr=lr, wd=wd, gamma1=self.gamma1, epsilon=self.epsilon,
                  **self._common_kwargs())
        if self.centered:
            n, g, delta = state
            imperative_invoke("rmspropalex_update",
                              [weight, grad, n, g, delta],
                              dict(gamma2=self.gamma2, **kw), out=weight)
        else:
            imperative_invoke("rmsprop_update", [weight, grad, state], kw,
                              out=weight)
        if self.clip_weights:
            weight._set_data(weight.clip(a_min=-self.clip_weights,
                                         a_max=self.clip_weights)._data)

    def init_fused_state(self, weight):
        if self.centered:
            return (torch.zeros_like(weight), torch.zeros_like(weight),
                    torch.zeros_like(weight))
        return torch.zeros_like(weight)

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad) + wd * weight
        if self.centered:
            n, gs, delta = state
            new_n = (1 - self.gamma1) * torch.square(g) + self.gamma1 * n
            new_g = (1 - self.gamma1) * g + self.gamma1 * gs
            new_delta = (self.gamma2 * delta - lr * g / torch.sqrt(
                new_n - torch.square(new_g) + self.epsilon))
            new_w = weight + new_delta
            if self.clip_weights:
                new_w = torch.clamp(new_w, -self.clip_weights,
                                    self.clip_weights)
            return new_w, (new_n, new_g, new_delta)
        new_n = (1 - self.gamma1) * torch.square(g) + self.gamma1 * state
        new_w = weight - lr * g / torch.sqrt(new_n + self.epsilon)
        if self.clip_weights:
            new_w = torch.clamp(new_w, -self.clip_weights, self.clip_weights)
        return new_w, new_n


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        grad = self._split_prep(grad)
        acc_g, acc_delta = state
        acc_g._set_data((self.rho * acc_g
                         + (1 - self.rho) * grad * grad)._data)
        delta = (acc_delta + self.epsilon).sqrt() / \
            (acc_g + self.epsilon).sqrt() * grad
        acc_delta._set_data(
            (self.rho * acc_delta + (1 - self.rho) * delta * delta)._data)
        weight += -delta - wd * weight

    def init_fused_state(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad)
        acc_g, acc_delta = state
        new_acc_g = self.rho * acc_g + (1 - self.rho) * g * g
        delta = (torch.sqrt(acc_delta + self.epsilon) /
                 torch.sqrt(new_acc_g + self.epsilon) * g)
        new_acc_delta = self.rho * acc_delta + (1 - self.rho) * delta * delta
        return weight - delta - wd * weight, (new_acc_g, new_acc_delta)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        z, n = state
        imperative_invoke("ftrl_update", [weight, grad, z, n],
                          dict(lr=lr, wd=wd, lamda1=self.lamda1,
                               beta=self.beta, **self._common_kwargs()),
                          out=weight)

    def init_fused_state(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        g = self._fused_prep(grad)
        z, n = state
        new_n = n + torch.square(g)
        sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
        new_z = z + g - sigma * weight
        new_w = torch.where(
            torch.abs(new_z) <= self.lamda1, torch.zeros_like(weight),
            -(new_z - torch.sign(new_z) * self.lamda1) /
            ((self.beta + torch.sqrt(new_n)) / lr + wd))
        return new_w, (new_z, new_n)


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clip(a_min=-self.clip_gradient,
                             a_max=self.clip_gradient)
        m_t, u_t = state
        m_t._set_data((self.beta1 * m_t + (1. - self.beta1) * grad)._data)
        u_t._set_data(nd.elemwise_maximum(self.beta2 * u_t,
                                          grad.abs())._data)
        weight += -lr * m_t / u_t

    def init_fused_state(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        lr = lr / (1.0 - torch.pow(self.beta1, _f32(t)))
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        new_m = self.beta1 * m_t + (1 - self.beta1) * g
        new_u = torch.maximum(self.beta2 * u_t, torch.abs(g))
        return weight - lr * new_m / new_u, (new_m, new_u)


@register
class Nadam(Optimizer):
    """Nadam.  The split path multiplies one schedule shared by every
    parameter, once a parameter a step, as the reference does; the fused
    state carries a schedule per parameter (the Nadam paper's recursion),
    so the two forms' trajectories differ slightly, as in the JAX
    package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = grad.clip(a_min=-self.clip_gradient,
                             a_max=self.clip_gradient)
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        m_t, v_t = state
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule = self.m_schedule
        m_schedule_next = m_schedule * momentum_t_1
        grad_prime = grad / (1. - m_schedule)
        m_t._set_data((self.beta1 * m_t + (1. - self.beta1) * grad)._data)
        v_t._set_data((self.beta2 * v_t
                       + (1. - self.beta2) * grad * grad)._data)
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t_prime = v_t / (1. - self.beta2 ** t)
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        weight += -lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon)

    def init_fused_state(self, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight),
                torch.ones((), dtype=torch.float32, device=weight.device))

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        tf = _f32(t)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (
            1. - 0.5 * torch.pow(0.96, tf * self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1. - 0.5 * torch.pow(0.96, (tf + 1) * self.schedule_decay))
        m_t, v_t, m_schedule = state
        m_schedule = m_schedule * momentum_t
        m_schedule_next = m_schedule * momentum_t_1
        grad_prime = g / (1. - m_schedule)
        new_m = self.beta1 * m_t + (1. - self.beta1) * g
        new_v = self.beta2 * v_t + (1. - self.beta2) * g * g
        m_t_prime = new_m / (1. - m_schedule_next)
        v_t_prime = new_v / (1. - torch.pow(self.beta2, tf))
        m_t_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        new_w = weight - lr * m_t_bar / (torch.sqrt(v_t_prime) + self.epsilon)
        return new_w, (new_m, new_v, m_schedule)


@register
class Test(Optimizer):
    """Trivial optimizer of the reference test suite."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight

    def init_fused_state(self, weight):
        return torch.zeros_like(weight)

    def fused_update(self, weight, grad, state, lr, wd, t, rng):
        new_w = weight + grad * self.rescale_grad
        return new_w, new_w


ccSGD = SGD
_registry["ccsgd"] = SGD


class Updater:
    """Worker-side updater closure (reference ``get_updater``/``Updater``:
    what a KVStore calls per key).  The states are the split form's
    NDArrays, which ``update`` rebinds."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        """Restore states from the bytes :meth:`get_states` returned
        (pickle: pass only bytes this program wrote)."""
        self.states = pickle.loads(states)

    def get_states(self):
        return pickle.dumps(self.states)


def get_updater(optimizer):
    return Updater(optimizer)
