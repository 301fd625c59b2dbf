"""Gluon Block and HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference
``python/mxnet/gluon/block.py``): ``Block`` (an imperative container
with name-scoped parameters, ``collect_params``, ``save_params``/
``load_params``, ``cast``) and ``HybridBlock``.  Deferred parameter
shapes resolve from the input's shape at the first forward
(``_shape_from_data`` in the layers), without running an op twice.

``hybridize()`` keeps the reference's switch but runs the same eager
forward: the JAX package jits the forward in inference mode, and the
port's counterpart — capturing it as a CUDA graph — is later work.
``SymbolBlock`` comes with a later slice.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from ..base import later_slice
from .parameter import ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_name_counter = threading.local()


def _auto_prefix(cls_name):
    counts = getattr(_name_counter, "counts", None)
    if counts is None:
        counts = _name_counter.counts = {}
    base = re.sub("(?!^)([A-Z]+)", r"_\1", cls_name).lower()
    idx = counts.get(base, 0)
    counts[base] = idx + 1
    return "%s%d_" % (base, idx)


class _BlockScope:
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _auto_prefix(hint)
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, shared=None)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        _BlockScope._current.value = self._old_scope


class Block:
    """Base container (reference ``gluon.Block``)."""

    def __init__(self, prefix=None, params=None):
        hint = re.sub("(?!^)([A-Z]+)", r"_\1",
                      self.__class__.__name__).lower()
        self._prefix, self._params = _BlockScope.create(prefix, params, hint)
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()

    def __repr__(self):
        s = "{name}(\n{modstr}\n)" if self._children else "{name}()"
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=repr(block).replace("\n", "\n  "))
            for key, block in self._children.items())
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Every parameter of this block and its children; ``select`` is
        a regular expression the names must match."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (None: the current
        context, ``gpu(0)`` by default; without a card pass
        ``mx.cpu()``)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def save_params(self, fname):
        self.collect_params().save(fname, strip_prefix=self.prefix)

    def load_params(self, fname, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(fname, ctx, allow_missing, ignore_extra,
                                   restore_prefix=self.prefix)

    def hybridize(self, active=True):
        for child in self._children.values():
            child.hybridize(active)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, x, **params)`` takes the op
    namespace as ``F``; ``hybridize()`` runs the same eager forward (see
    the module note)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active=True):
        self._active = active
        super().hybridize(active)

    def infer_shape(self, *args):
        self._resolve_deferred(args)

    def __call__(self, *args):
        try:
            return self.forward(*args)
        except DeferredInitializationError:
            # a parameter whose shape the block fixed but could not
            # initialize yet: initialize and run again
            self._resolve_deferred(args)
            return self.forward(*args)

    def _resolve_deferred(self, args):
        for child in self._children.values():
            if isinstance(child, HybridBlock):
                child._resolve_deferred(args)
        for param in self.params.values():
            if param._deferred_init is not None and param.shape is not None \
                    and all(s != 0 for s in param.shape):
                param._shape_from_data(param.shape)

    def forward(self, x, *args):
        from .. import ndarray as ndm

        kwargs = {self._short_name(k): v.data()
                  for k, v in self.params.items()}
        return self.hybrid_forward(ndm, x, *args, **kwargs)

    def _short_name(self, full):
        return full[len(self.prefix):] if full.startswith(self.prefix) \
            else full

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SymbolBlock(Block):
    """A Symbol graph as a Block (reference ``gluon.SymbolBlock``): in a
    later slice of the port."""

    def __init__(self, outputs, inputs, params=None):
        raise later_slice("gluon.SymbolBlock", "SymbolBlock")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise later_slice("gluon.SymbolBlock", "imports")
