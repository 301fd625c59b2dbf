"""Module — Symbol + Executor + Optimizer on one device.

Counterpart of ``mxnet_tpu/module/module.py`` (reference
``python/mxnet/module/module.py``: bind, init_params, init_optimizer,
forward, backward, update, get/set_params, checkpoints).  One executor
holds the bound graph; with an optimizer that has a fused form (every
registered one) ``fit``'s ``forward_backward`` runs the whole step — forward, backward
and update — through ``fused.TrainStep``, and ``update`` is then a no-op,
as in the JAX package.  ``forward``/``backward``/``update`` called by
hand take the split path: the executor's autograd backward and the
optimizer's updater.

Run health (``init_optimizer(health=, loss_scale=)``): the fused step
carries a ``StepHealth`` (the loss scaler, the on-device skip) and
leaves its stats on ``_last_health_stats`` for ``fit``'s monitor; the
split path's :meth:`_split_health_pass` zeroes a poisoned batch's
gradients instead.  Optimizer states save and load as the port's pickle
of host arrays (``checkpoint.states_to_blob``).

This slice is single-device: ``kvstore`` ``"local"``/``"device"`` (or
None) means no store, as ``_create_kvstore`` decides for one device; a
``dist*`` store, several contexts, pipeline stages, shared modules, the
ZeRO and plan options and the monitor raise.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError, get_env, later_slice, resolve_device
from ..context import Context, context_of
from .. import optimizer as opt
from ..initializer import InitDesc
from ..ndarray import NDArray, array
from .base_module import BaseModule

__all__ = ["Module", "params_from_numpy"]


def params_from_numpy(arg_params, aux_params, ctx):
    """``(arg_params, aux_params)`` as NDArrays on ``ctx`` from {name:
    numpy array} dicts — for example the JAX package's ``get_params()``
    converted with ``asnumpy()`` — so both packages start from one
    state."""
    return ({k: array(np.asarray(v), ctx) for k, v in arg_params.items()},
            {k: array(np.asarray(v), ctx) for k, v in aux_params.items()})


def _copy_into(src, arr):
    """Write ``src`` (an NDArray or anything numpy takes) into ``arr``,
    keeping ``arr``'s device and dtype."""
    if isinstance(src, NDArray):
        src.copyto(arr)
    else:
        arr[:] = np.asarray(src)


def pair_metric_outputs(symbol, label_names, labels, outputs):
    """Pair each label with its prediction head: by exact head name
    (``stem + '_output'``), else by position (``executor_manager.py``'s
    rule in the JAX package)."""
    if len(outputs) <= len(labels):
        return outputs
    names = symbol.list_outputs()
    picked = []
    for i, ln in enumerate(label_names[:len(labels)]):
        stem = ln[:-6] if ln.endswith("_label") else ln
        match = [o for n, o in zip(names, outputs)
                 if n == stem + "_output" or n == stem]
        picked.append(match[0] if match else outputs[i])
    return picked


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, pipeline_stages=0,
                 pipeline_microbatches=None, pipeline_schedule="1f1b"):
        """``context`` None means ``gpu(0)``; without a card that raises
        and names ``mx.cpu()``, which the caller passes to run on the
        CPU."""
        super().__init__(logger=logger)
        if int(pipeline_stages):
            raise later_slice("pipeline_stages", pipeline_stages)
        if context is None:
            context = context_of(resolve_device(None, "Module"))
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise later_slice("context", list(context))
            context = context[0]
        if not isinstance(context, Context):
            raise MXNetError("Module: context must be a Context, got %r"
                             % (context,))
        resolve_device(context, "Module")  # gpu(i) without a card raises
        self._context = [context]
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._fused = None
        self._fused_states = None
        self._fused_ran = False
        self._steps_per_call = 1
        self._grad_req = None
        self._health_monitor = None
        self._loss_scaler = None
        self._last_health_stats = None
        self._preload_opt_states = None

    # -- introspection -----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        if self._exec.outputs:
            return [o.shape for o in self._exec.outputs]
        return self._symbol._infer_outputs(
            {d.name: d.shape for d in self._data_shapes
             + (self._label_shapes or [])})

    # -- bind ----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise later_slice("shared_module", shared_module)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = [_as_desc(d) for d in data_shapes]
        self._label_shapes = [_as_desc(d) for d in (label_shapes or [])]
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes})
        req = grad_req
        if isinstance(req, str) and not for_training:
            req = "null"
        if isinstance(req, str) and self._fixed_param_names:
            req = {n: ("null" if n in self._fixed_param_names else grad_req)
                   for n in self._param_names}
        if inputs_need_grad and isinstance(req, dict):
            for n in self._data_names:
                req[n] = grad_req
        elif inputs_need_grad and isinstance(req, str):
            req = {n: grad_req for n in
                   self._param_names + self._data_names}
        self._exec = self._symbol.simple_bind(self._context[0],
                                              grad_req=req, **shapes)
        self.binded = True

    # -- params --------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Initialize parameters and aux states; ``arg_params`` and
        ``aux_params`` may hold NDArrays or numpy arrays (for example the
        JAX package's, through ``asnumpy()``)."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing parameters")
        if initializer is None:
            from ..initializer import Uniform

            initializer = Uniform(0.01)
        attrs = self._symbol.attr_dict()
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                _copy_into(arg_params[name], arr)
            elif arg_params is not None and not allow_missing:
                raise MXNetError("parameter %s missing from arg_params"
                                 % name)
            else:
                initializer(InitDesc(name, attrs.get(name, {})), arr)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                _copy_into(aux_params[name], arr)
            else:
                initializer(InitDesc(name, attrs.get(name, {})), arr)
        self.params_initialized = True

    def get_params(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("get_params: bind and init_params first")
        return ({n: self._exec.arg_dict[n].copy() for n in self._param_names},
                {n: self._exec.aux_dict[n].copy() for n in self._aux_names})

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False, param_sharding=None,
                       compute_dtype=None, steps_per_call=None,
                       health=None, loss_scale=None, zero=None,
                       plan=None):
        """Create the optimizer (``rescale_grad`` = 1/batch unless given)
        and, when it has a fused form, the ``fused.TrainStep`` that
        ``fit`` drives.  ``compute_dtype`` (or ``MXNET_COMPUTE_DTYPE``):
        bf16 activations over fp32 master weights.  ``steps_per_call=K``
        (or ``MXNET_STEPS_PER_CALL``): each ``forward_backward`` takes a
        ``(K, batch, ...)`` super-batch and runs K updates, one CUDA-graph
        replay on the card; the split path has no such form, so K > 1
        raises where the fused step is unavailable.  ``health``: True, a
        policy string or a :class:`~mxnet_tpu_torch.health.HealthMonitor`
        (``MXNET_HEALTH_MONITOR=1``); ``loss_scale``: 'dynamic', a number
        or a :class:`~mxnet_tpu_torch.health.DynamicLossScaler`
        (``MXNET_LOSS_SCALE``).  ``MXNET_BACKWARD_DO_MIRROR=1`` makes the
        fused step recompute its forward in the backward (``remat``)."""
        from ..fused import TrainStep
        from ..health import DynamicLossScaler, StepHealth, resolve_monitor

        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer: bind and init_params first")
        if self.optimizer_initialized and not force_init:
            return
        if steps_per_call is None:
            steps_per_call = get_env("MXNET_STEPS_PER_CALL", 1, int)
        steps_per_call = int(steps_per_call)
        if steps_per_call < 1:
            raise MXNetError("steps_per_call must be >= 1, got %d"
                             % steps_per_call)
        for field, value, fine in (
                ("param_sharding", param_sharding,
                 param_sharding in (None, "replicated")),
                ("zero", zero, zero is None),
                ("plan", plan, plan is None)):
            if not fine:
                raise later_slice(field, value)
        if kvstore is not None and (not isinstance(kvstore, str)
                                    or "dist" in kvstore):
            raise later_slice("kvstore", kvstore)
        if compute_dtype is None:
            compute_dtype = get_env("MXNET_COMPUTE_DTYPE", "", str) or None
        self._compute_dtype = compute_dtype
        self._health_monitor = resolve_monitor(health)
        if loss_scale is None:
            loss_scale = get_env("MXNET_LOSS_SCALE", "", str) or None
        self._loss_scaler = DynamicLossScaler.from_spec(loss_scale)
        self._last_health_stats = None
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._data_shapes[0].shape[0])
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        optimizer.set_lr_mult({})
        optimizer.set_wd_mult({})
        self._updater = opt.get_updater(optimizer)
        self._fused, self._fused_states, self._fused_ran = None, None, False
        self._steps_per_call = steps_per_call
        reason = self._fused_blocker()
        if reason is None:
            step_health = None
            if self._loss_scaler is not None or \
                    self._health_monitor is not None:
                step_health = StepHealth(scaler=self._loss_scaler)
            remat = "full" if get_env("MXNET_BACKWARD_DO_MIRROR", False,
                                      bool) else None
            self._fused = TrainStep(
                self._symbol, optimizer=optimizer,
                data_names=self._data_names, label_names=self._label_names,
                fixed_param_names=self._fixed_param_names,
                compute_dtype=compute_dtype, steps_per_call=steps_per_call,
                health=step_health, remat=remat,
                device=self._context[0].torch_device)
        else:
            # an explicit mixed-precision, loss-scaled or multi-step
            # request never trains through the split path silently: it
            # has none of them
            for field, value, fine in (
                    ("compute_dtype", compute_dtype, compute_dtype is None),
                    ("loss_scale", loss_scale, self._loss_scaler is None),
                    ("steps_per_call", steps_per_call,
                     steps_per_call == 1)):
                if not fine:
                    raise MXNetError("%s=%r was requested but the fused "
                                     "step is unavailable: %s"
                                     % (field, value, reason))
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _fused_blocker(self):
        """Why the fused step cannot run, or None."""
        if not get_env("MXNET_FUSED_STEP", True, bool):
            return "MXNET_FUSED_STEP=0"
        if self.inputs_need_grad:
            return "inputs_need_grad requires the split executor"
        if not self._optimizer.supports_fused:
            return "optimizer %s has no fused form" \
                % type(self._optimizer).__name__
        if any(not n.is_variable and n.op.name == "Custom"
               for n in self._symbol._topo()):
            return "Custom ops run on the split executor"
        req = self._grad_req
        ok = req == "write" if isinstance(req, str) else all(
            v == "write" or (k in self._fixed_param_names and v == "null")
            for k, v in req.items())
        return None if ok else "grad_req %r is not fusable" % (req,)

    def _fused_forward_backward_update(self, data_batch):
        from .. import random as _rnd

        o = self._optimizer
        dev = self._context[0].torch_device
        params = {n: self._exec.arg_dict[n]._data for n in self._param_names}
        aux = {n: self._exec.aux_dict[n]._data for n in self._aux_names}
        if self._fused_states is None:
            self._fused_states = {n: o.init_fused_state(params[n])
                                  for n in self._param_names}
        batch = {}
        for names, arrs in ((self._data_names, data_batch.data),
                            (self._label_names, data_batch.label or [])):
            for name, arr in zip(names, arrs):
                t = arr._data if isinstance(arr, NDArray) else \
                    array(arr, self._context[0])._data
                batch[name] = t if t.device == dev else t.to(dev)
        from ..testing import faults

        poison = faults.inject("numerics")
        if poison is not None:
            # poison one element of the first data tensor: the NaN/Inf
            # flows through the forward and the backward into the loss
            # and every gradient (MXNET_FAULT_INJECT=numerics:nan:after=N)
            name = self._data_names[0]
            v = batch[name].clone()
            v[(0,) * v.dim()] = poison
            batch[name] = v
        # the scheduler read at the pre-increment count, the step number
        # t at the post-increment one: the split path's order
        # (mxnet_tpu/module/module.py:831-838).  A multi-step call holds
        # lr for its K steps and advances the count by K; t is its first
        # step's number
        K = self._steps_per_call
        lr = o.lr_scheduler(o.num_update) if o.lr_scheduler else o.lr
        for _ in range(K):
            for i in range(len(self._param_names)):
                o._update_count(i)
        new_params, new_aux, self._fused_states, outs = self._fused(
            params, aux, self._fused_states, batch,
            _rnd.next_key(self._context[0]), lr, o.num_update - K + 1)
        self._last_health_stats = getattr(self._fused, "last_health", None)
        for n, v in new_params.items():
            self._exec.arg_dict[n]._set_data(v)
        for n, v in new_aux.items():
            self._exec.aux_dict[n]._set_data(v)
        self._exec.outputs = [NDArray(t, self._context[0]) for t in outs]
        self._fused_ran = True

    # -- compute -------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward: bind and init_params first")
        if is_train is None:
            is_train = self.for_training
        inputs = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            inputs.update(zip(self._label_names, data_batch.label))
        # rebind on a batch-size change (the reference reshapes)
        cur = self._exec.arg_dict[self._data_names[0]].shape
        new = tuple(inputs[self._data_names[0]].shape)
        if cur != new:
            self._exec = self._exec.reshape(
                **{k: tuple(v.shape) for k, v in inputs.items()})
        self._exec.forward(is_train=is_train, **inputs)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("backward: bind and init_params first")
        self._exec.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        if self._fused is not None:
            self._fused_forward_backward_update(data_batch)
            return
        self.forward(data_batch, is_train=True)
        self.backward()

    def update(self):
        """Apply the gradients (reference ``Module.update``); a no-op
        after the fused step, which updated already."""
        if not self.optimizer_initialized:
            raise MXNetError("update: init_optimizer first")
        if self._fused_ran:
            self._fused_ran = False
            return
        if self._optimizer.clip_global_norm or \
                self._health_monitor is not None:
            self._split_health_pass()
        for i, name in enumerate(self._param_names):
            g = self._exec.grad_dict.get(name)
            if g is not None:
                self._updater(i, g, self._exec.arg_dict[name])

    def _split_health_pass(self):
        """The split path's sentinel (``mxnet_tpu/module/module.py:941``):
        one pass over ``grad_dict`` computing the global norm in fp32 as
        the optimizer will see it (after ``rescale_grad``), scaling by
        ``clip_global_norm``'s factor (cast to each gradient's dtype),
        and, with a health monitor, zeroing the gradients of a
        non-finite batch — no host sync.  Unlike the fused path the skip
        is approximate: momentum still decays and weight decay still
        applies over the zeroed gradients."""
        import torch

        o = self._optimizer
        names = [n for n in self._param_names
                 if self._exec.grad_dict.get(n) is not None]
        if not names:
            return
        grads = {n: self._exec.grad_dict[n]._data for n in names}
        gnorm = opt.global_grad_norm(grads, o.rescale_grad)
        finite = torch.isfinite(gnorm)
        factor = torch.ones((), dtype=torch.float32, device=gnorm.device)
        if o.clip_global_norm:
            factor = opt.global_norm_scale(gnorm, o.clip_global_norm)
        zero_bad = self._health_monitor is not None
        if zero_bad:
            self._last_health_stats = {"grad_norm": gnorm,
                                       "nonfinite": ~finite}
        for n in names:
            g = grads[n] * factor.to(grads[n].dtype)
            if zero_bad:
                # 0 * NaN is NaN: a multiplicative skip would leak the
                # poison into the optimizer state, so select instead
                g = torch.where(finite, g, torch.zeros_like(g))
            self._exec.grad_dict[n]._set_data(g)

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("get_input_grads: bind with inputs_need_grad")
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, outputs=None):
        outs = self._exec.outputs if outputs is None else outputs
        eval_metric.update(labels, pair_metric_outputs(
            self._symbol, self._label_names, labels, outs))

    def install_monitor(self, monitor):
        raise later_slice("monitor", monitor)

    def reshape(self, data_shapes, label_shapes=None):
        self._data_shapes = [_as_desc(d) for d in data_shapes]
        self._label_shapes = [_as_desc(d) for d in (label_shapes or [])]
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes})
        self._exec = self._exec.reshape(**shapes)

    # -- checkpoint ----------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` + ``prefix-%04d.params`` (reference
        ``module.py:152``), in the JAX package's format, and with
        ``save_optimizer_states`` ``prefix-%04d.states``."""
        from ..model import save_checkpoint

        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a saved checkpoint; its parameters are applied at
        ``init_params`` (so at ``fit``'s first step too) and, with
        ``load_optimizer_states``, its states at ``init_optimizer``."""
        from ..model import load_checkpoint

        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        orig_init = mod.init_params

        def init_with_loaded(initializer=None, arg_params=None,
                             aux_params=None, **kw):
            orig_init(initializer=initializer,
                      arg_params=arg_params or args,
                      aux_params=aux_params or auxs, **kw)
        mod.init_params = init_with_loaded
        return mod

    def save_optimizer_states(self, fname):
        """Write the optimizer states — the fused step's, else the split
        updater's, by parameter index — as the port's pickle of host
        arrays (``checkpoint.states_to_blob``; the file a
        ``CheckpointManager`` writes as ``.states``)."""
        from ..checkpoint import _states_blob, atomic_replace

        if not self.optimizer_initialized:
            raise MXNetError("save_optimizer_states: init_optimizer first")
        blob = _states_blob(self)

        def write(tmp):
            with open(tmp, "wb") as f:
                f.write(blob)
        atomic_replace(fname, write)

    def load_optimizer_states(self, fname):
        """Read a :meth:`save_optimizer_states` file onto the module's
        device: into the fused step's states, or the split updater's."""
        from ..checkpoint import states_from_blob

        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states: init_optimizer first")
        with open(fname, "rb") as f:
            states = states_from_blob(f.read())
        ctx = self._context[0]
        dev = ctx.torch_device

        def to_dev(v, wrap):
            if v is None:
                return None
            if isinstance(v, (tuple, list)):
                return type(v)(to_dev(e, wrap) for e in v)
            if hasattr(v, "to"):
                v = v.to(dev)
                return NDArray(v, ctx) if wrap else v
            return v

        if self._fused is not None:
            self._fused_states = {n: to_dev(states.get(i), False)
                                  for i, n in enumerate(self._param_names)}
        else:
            self._updater.states = {i: to_dev(v, True)
                                    for i, v in states.items()}


def _as_desc(d):
    from ..io import DataDesc

    if isinstance(d, DataDesc):
        return d
    return DataDesc(d[0], d[1])
