"""Gluon Parameter and ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference
``python/mxnet/gluon/parameter.py``): deferred initialization,
``grad_req``, one data NDArray (on one context) and its gradient buffer,
prefix-scoped ``ParameterDict`` with ``save``/``load`` in the ``.npz``
format both packages read.  A parameter's data is marked for autograd
(:func:`..autograd.mark_variables`), so its tensor is a
``requires_grad`` leaf that stays one across the trainer's rebinds.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..base import MXNetError
from .. import autograd
from ..ndarray import NDArray, array, zeros
from ..initializer import InitDesc, create as init_create

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Parameter used before its shape was known (reference same name)."""


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        if not differentiable:
            grad_req = "null"
        self.grad_req = grad_req
        self._data = None
        self._grad = None
        self._deferred_init = None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    # -- initialization -------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize now, or at the first forward when the shape is still
        unknown.  ``ctx`` None means the current context (``gpu(0)``
        unless a ``with mx.cpu():`` block says otherwise)."""
        from ..initializer import Uniform

        default_init = default_init or Uniform()
        if self._data is not None and not force_reinit:
            return
        if self.shape is None or any(s == 0 for s in self.shape):
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s has unknown shape and deferred init is "
                    "not allowed" % self.name)
            self._deferred_init = (init, ctx, default_init)
            return
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        from ..context import current_context

        ctx = ctx or current_context()
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                from ..base import later_slice

                raise later_slice("Parameter.initialize(ctx)", list(ctx))
            ctx = ctx[0]
        ctx.torch_device  # a card context without a card raises here
        data = zeros(self.shape, ctx, dtype=self.dtype)
        initializer = init or self.init or default_init
        if isinstance(initializer, str):
            initializer = init_create(initializer)
        initializer(InitDesc(self.name,
                             {"__init__": ""} if init or self.init else {}),
                    data)
        self._bind(data)

    def _bind(self, data):
        """Take ``data`` as the value, with a fresh gradient buffer marked
        for autograd unless ``grad_req`` is null."""
        self._data = data
        self._grad = None
        if self.grad_req != "null":
            self._grad = zeros(data.shape, data.context, dtype=data.dtype)
            autograd.mark_variables([data], [self._grad], self.grad_req)

    def _shape_from_data(self, data_shape):
        """Resolve a deferred shape from the input's shape."""
        if self.shape is None:
            self.shape = tuple(data_shape)
        else:
            self.shape = tuple(ds if s == 0 else s
                               for s, ds in zip(self.shape, data_shape))
        if self._deferred_init is not None:
            init, ctx, default_init = self._deferred_init
            self._deferred_init = None
            self._finish_init(init, ctx, default_init)

    # -- access ---------------------------------------------------------
    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s not initialized yet: run a forward pass "
                    "first" % self.name)
            raise MXNetError("Parameter %s has not been initialized"
                             % self.name)
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._grad is None:
            raise MXNetError("Parameter %s has no gradient (grad_req=%s)"
                             % (self.name, self.grad_req))
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0.0

    def set_data(self, data):
        """Set the value from an NDArray or a numpy array (the JAX
        package's parameters, through ``asnumpy()``); an initialized
        parameter keeps its dtype and context."""
        if not isinstance(data, NDArray):
            data = np.asarray(data)
        if self._data is None:
            self.shape = tuple(data.shape)
            if not isinstance(data, NDArray):
                data = array(data, dtype=self.dtype)
            self._bind(data.copy())
        elif isinstance(data, NDArray):
            data.copyto(self._data)
        else:
            self._data[:] = data

    def cast(self, dtype):
        """Cast the value and the gradient buffer to ``dtype`` (every
        parameter, BatchNorm's included)."""
        self.dtype = dtype
        if self._data is not None:
            self._bind(self._data.astype(dtype).detach())


class ParameterDict:
    """Prefix-scoped parameter dictionary (reference ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict %s(%s)" % (
            self._prefix, ", ".join(self._params))

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def __getitem__(self, key):
        return self._params[key]

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """Get or create the parameter named prefix + ``name``."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            for k, v in kwargs.items():
                if v is not None and getattr(param, k, None) in (None, v) \
                        or k == "shape" and param.shape is None:
                    setattr(param, k, tuple(v) if k == "shape" else v)
            return param
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        param = Parameter(name, **kwargs)
        self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("Cannot update: duplicate parameter %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from ..initializer import Uniform

        for param in self._params.values():
            param.initialize(None, ctx, init or Uniform(),
                             force_reinit=force_reinit)

    def zero_grad(self):
        for param in self._params.values():
            param.zero_grad()

    def setattr(self, name, value):
        for param in self._params.values():
            setattr(param, name, value)

    def save(self, fname, strip_prefix=""):
        from ..ndarray import save as nd_save

        arg_dict = {}
        for param in self._params.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.data()
        nd_save(fname, arg_dict)

    def load(self, fname, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a file written by ``save`` in either package."""
        from ..context import cpu
        from ..ndarray import load as nd_load

        with cpu():
            loaded = nd_load(fname)
        params = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self._params:
                if name not in params:
                    raise MXNetError("Parameter %s missing in file %s"
                                     % (name, fname))
        for name, val in params.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError("Parameter %s in file is not in this "
                                     "dict" % name)
                continue
            p = self._params[name]
            if p._data is None:
                p.shape = tuple(val.shape)
                p._deferred_init = None
                p._finish_init("zeros", ctx, None)
            p.set_data(val)
