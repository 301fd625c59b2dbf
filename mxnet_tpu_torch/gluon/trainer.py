"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference
``python/mxnet/gluon/trainer.py``): applies an optimizer to a
ParameterDict's parameters from their gradient buffers.  This slice is
single-device: ``kvstore`` ``"device"``/``"local"`` (or None) means no
store, as for one device in the reference; a ``dist*`` store raises.
Any registered optimizer, by name or instance, with its
``lr_scheduler``: each step runs its split form (``Optimizer.update``),
outside autograd, which rebinds each parameter to a new
``requires_grad`` leaf; with SGD's ``multi_precision=True`` a bf16 or
fp16 parameter keeps an fp32 master copy in its optimizer state.  ``save_states`` and
``load_states`` round-trip the states as host arrays.
"""
from __future__ import annotations

from ..base import MXNetError, later_slice
from .. import optimizer as opt

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if kvstore is not None and (not isinstance(kvstore, str)
                                    or "dist" in kvstore):
            raise later_slice("kvstore", kvstore)
        if isinstance(params, dict) or hasattr(params, "values"):
            params = list(params.values())
        self._params = [p for p in params if p.grad_req != "null"]
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            self._optimizer = optimizer
        else:
            param_idx2name = {i: p.name for i, p in enumerate(self._params)}
            self._optimizer = opt.create(
                optimizer, param_idx2name=param_idx2name, **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One update from the gradients on the parameters, rescaled by
        ``1 / batch_size`` (reference ``Trainer.step``)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, p in enumerate(self._params):
            if p._grad is None:
                if not ignore_stale_grad:
                    raise MXNetError(
                        "Parameter %s has no gradient; call backward first "
                        "or set grad_req" % p.name)
                continue
            self._updater(i, p._grad, p.data())

    def save_states(self, fname):
        """Write the updater's states (``mxnet_tpu/gluon/trainer.py:106``)
        as the port's pickle of host arrays
        (``checkpoint.states_to_blob``), loadable with or without a
        card."""
        from ..checkpoint import states_to_blob

        with open(fname, "wb") as f:
            f.write(states_to_blob(self._updater.states))

    def load_states(self, fname):
        """Read a :meth:`save_states` file: each state lands as NDArrays
        on its parameter's context."""
        from ..checkpoint import states_from_blob
        from ..ndarray import NDArray

        with open(fname, "rb") as f:
            states = states_from_blob(f.read())

        def place(v, ctx):
            if v is None:
                return None
            if isinstance(v, (tuple, list)):
                return type(v)(place(e, ctx) for e in v)
            if hasattr(v, "to"):
                return NDArray(v.to(ctx.torch_device), ctx)
            return v

        self._updater.states = {
            i: place(v, self._params[i].data().context)
            for i, v in states.items()}
