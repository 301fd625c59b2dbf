"""The train step: forward, backward and optimizer update in one call.

Counterpart of ``mxnet_tpu/fused.py``.  This slice ports the single-device
:class:`TrainStep` (:143) with the same constructor and the same
``__call__(params, aux, states, batch, rng, lr=None, t=None) -> (params,
aux, states, outs)``:

* the loss is the JAX package's: with ``compute_dtype`` every floating
  argument — parameters, aux states *and the batch* — is cast to that
  dtype (``cast_compute``, :341-343 and :357-359), then the outputs are
  summed (``_loss_from_outputs``, :70-78), whose loss heads carry their
  own backward;
* the backward is torch autograd over the eagerly run graph; gradients
  of fp32 parameters come back fp32 through the cast;
* with the optimizer's ``clip_global_norm``, every live gradient is
  scaled by ``min(1, clip / ||g||)``, the norm taken over all of them in
  fp32 after ``rescale_grad`` and the factor cast to each gradient's
  dtype (:467-474);
* the update runs in ``sorted(grads)`` order through the optimizer's
  fused form (:475-501) — any registered optimizer, each with its own
  state — returning new tensors, so the caller's old state stays valid.

Where the JAX package compiles the step into one XLA program, this one
runs eagerly; capturing it in a CUDA graph is later work.  ``mesh``,
``zero``, ``plan``, ``health``, ``remat``, ``steps_per_call > 1``,
``param_sharding`` and ``MXNET_FP8`` belong to later slices and raise.

Note on ``compute_dtype="bfloat16"``: the cast reaches the token ids too,
as in the JAX package, so ids above 256 round to bf16 and an id that
rounds to V or beyond looks up a NaN row (``ops/matrix_ops.py``).  The
port reproduces this on purpose; the JAX package is the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from . import optimizer as opt_mod
from .base import MXNetError, get_env, later_slice, resolve_device

__all__ = ["TrainStep", "compile_train_step", "state_from_numpy"]


def _loss_from_outputs(outs):
    """Seed the backward like ``Executor.backward`` with ones head grads:
    the sum of the outputs (loss heads carry a backward that ignores the
    cotangent's value)."""
    total = None
    for o in outs:
        s = o.float().sum()
        total = s if total is None else total + s
    return total


def _check_slice(mesh, zero, plan, health, remat, steps_per_call,
                 param_sharding):
    """Raise ``later_slice`` for every option outside the single-device
    eager step, including the env spellings the JAX package reads."""
    zero = zero if zero is not None else get_env("MXNET_ZERO", "auto", str)
    plan = plan if plan is not None else \
        (get_env("MXNET_PLAN", "", str).strip() or None)
    fp8 = str(get_env("MXNET_FP8", "off") or "off").strip().lower()
    for field, value, fine in (
            ("mesh", mesh, mesh is None),
            ("zero", zero, str(zero).strip().lower() in
             ("auto", "off", "0", "false", "no", "")),
            ("plan", plan, plan is None),
            ("health", health, health is None),
            ("remat", remat, remat in (None, False)),
            ("steps_per_call", steps_per_call, int(steps_per_call) == 1),
            ("param_sharding", param_sharding,
             param_sharding in (None, "replicated")),
            ("MXNET_FP8", fp8, fp8 in ("off", "0", "false", "no", ""))):
        if not fine:
            raise later_slice(field, value)


class TrainStep:
    """(params, aux, opt_states, batch) -> updated state, one call per
    step.  ``device`` is where :meth:`init_state` places the state (None:
    the card); ``__call__`` runs where the tensors it is given live."""

    def __init__(self, symbol, optimizer="sgd", optimizer_params=None,
                 mesh=None, data_names=("data",),
                 label_names=("softmax_label",), dtype="float32",
                 batch_sharding_axis="data", compute_dtype=None,
                 remat=None, fixed_param_names=(), param_sharding=None,
                 steps_per_call=1, health=None, zero=None, plan=None,
                 device=None):
        from .executor import _trace_fn

        _check_slice(mesh, zero, plan, health, remat, steps_per_call,
                     param_sharding)
        self.symbol = symbol
        self._device = device
        self._fwd_fn, self._arg_names, self._aux_names = _trace_fn(
            symbol, is_train=True)
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.param_names = [n for n in self._arg_names
                            if n not in self.data_names
                            and n not in self.label_names]
        opt_params = dict(optimizer_params or {})
        self._frozen = frozenset(fixed_param_names) | frozenset(
            opt_params.pop("fixed_param_names", ()))
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **opt_params)
        elif isinstance(optimizer, opt_mod.Optimizer):
            if opt_params:
                raise MXNetError(
                    "optimizer_params must not be set when passing an "
                    "Optimizer instance (got %r); configure the instance "
                    "instead" % sorted(opt_params))
        else:
            raise MXNetError("optimizer must be a name or Optimizer")
        if not optimizer.supports_fused:
            raise MXNetError("optimizer %s has no fused form"
                             % type(optimizer).__name__)
        self.optimizer = optimizer
        self.lr = optimizer.lr
        self._lr_mults = {n: optimizer.lr_mult.get(n, 1.0)
                          for n in self.param_names}
        self._wd_mults = {n: optimizer.wd_mult.get(n, 1.0)
                          for n in self.param_names}
        if compute_dtype is not None:
            compute_dtype = getattr(torch, str(compute_dtype))
        self._compute_dtype = compute_dtype
        self._t = 0

    def _cast(self, x):
        if self._compute_dtype is not None and x.is_floating_point():
            return x.to(self._compute_dtype)
        return x

    def __call__(self, params, aux, states, batch, rng, lr=None, t=None):
        if t is None:
            self._t += 1
            t = self._t
        else:
            self._t = int(t)
        lr = self.lr if lr is None else lr
        frozen = self._frozen
        leaves = {k: v.detach().requires_grad_(k not in frozen)
                  for k, v in params.items()}
        with torch.enable_grad():
            args = dict(leaves)
            args.update(batch)
            args = {k: self._cast(v) for k, v in args.items()}
            outs, new_aux = self._fwd_fn(
                args, {k: self._cast(v) for k, v in aux.items()}, rng)
            new_aux = {k: v.detach().to(aux[k].dtype)
                       for k, v in new_aux.items()}
            loss = _loss_from_outputs(outs)
            live = [k for k in sorted(leaves) if k not in frozen]
            got = torch.autograd.grad(loss, [leaves[k] for k in live],
                                      allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(live, got)}
        clip = self.optimizer.clip_global_norm
        if clip is not None:
            factor = opt_mod.global_norm_scale(opt_mod.global_grad_norm(
                [grads[k] for k in live], self.optimizer.rescale_grad), clip)
            grads = {k: g * factor.to(g.dtype) for k, g in grads.items()}
        new_params, new_states = {}, {}
        with torch.no_grad():
            for k in sorted(params):
                if k in frozen:
                    new_params[k], new_states[k] = params[k], states[k]
                    continue
                new_params[k], new_states[k] = self.optimizer.fused_update(
                    params[k], grads[k], states[k],
                    lr * self._lr_mults[k],
                    self.optimizer.wd * self._wd_mults[k], t, rng)
        return new_params, new_aux, new_states, tuple(o.detach()
                                                      for o in outs)

    def init_state(self, shapes, dtype="float32", seed=0):
        """Allocate params/aux/optimizer states from the shape inference
        pass, with the JAX package's rules: ``*_gamma`` ones, ``*_bias`` and
        ``*_beta`` zeros, every other parameter ``sqrt(2 / fan_in) *
        normal`` with fan_in the product of the trailing dims (the first
        dim for 1-D).  Draws come from a ``torch.Generator`` seeded with
        ``seed``, one parameter after another in argument order, so the
        values differ from the JAX package's; carry one state across with
        :func:`state_from_numpy` to compare the two."""
        from .symbol.symbol import _infer_param_shapes

        device = resolve_device(self._device, "TrainStep.init_state")
        dtype = getattr(torch, str(dtype))
        all_shapes = _infer_param_shapes(self.symbol, dict(shapes))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        params, aux, states = {}, {}, {}
        for n in self.param_names:
            shp = tuple(all_shapes[n])
            if n.endswith("_gamma"):
                params[n] = torch.ones(shp, dtype=dtype, device=device)
            elif n.endswith(("_bias", "_beta")):
                params[n] = torch.zeros(shp, dtype=dtype, device=device)
            else:
                fan_in = int(np.prod(shp[1:])) if len(shp) > 1 else shp[0]
                scale = (2.0 / max(1, fan_in)) ** 0.5
                params[n] = scale * torch.randn(shp, generator=gen,
                                                dtype=dtype, device=device)
        for n in self.param_names:
            states[n] = self.optimizer.init_fused_state(params[n])
        for n in self._aux_names:
            fill = torch.ones if n.endswith("_var") else torch.zeros
            aux[n] = fill(tuple(all_shapes[n]), dtype=torch.float32,
                          device=device)
        return params, aux, states


def compile_train_step(symbol, **kwargs):
    return TrainStep(symbol, **kwargs)


def state_from_numpy(params, aux, states, device=None):
    """The port's (params, aux, states) from numpy ones — for example the
    JAX package's ``init_state`` output converted with ``np.asarray``:
    {name: array}, with each optimizer state None, an array or a tuple of
    those.  Tensors land on ``device`` (None: the card)."""
    device = resolve_device(device, "state_from_numpy")

    def conv(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(conv(e) for e in x)
        return torch.from_numpy(np.array(x)).to(device)

    return ({k: conv(v) for k, v in params.items()},
            {k: conv(v) for k, v in aux.items()},
            {k: conv(v) for k, v in states.items()})
