"""Checkpoint helpers (reference ``python/mxnet/model.py:340-404``).

Counterpart of ``mxnet_tpu/model.py``'s ``save_checkpoint`` and
``load_checkpoint``, in the same format: ``prefix-symbol.json`` holds
the graph JSON and ``prefix-%04d.params`` a flat ``.npz`` of arrays with
``arg:``/``aux:`` name prefixes, so a checkpoint written by either
package loads in the other.  ``FeedForward`` comes with a later slice.
"""
from __future__ import annotations

import os

from .base import MXNetError
from . import symbol as sym_mod
from .ndarray import save as nd_save, load as nd_load
from .module.base_module import BatchEndParam  # noqa: F401  (reference home)

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]


def _atomic_replace(path, write_cb):
    """``write_cb(tmp)`` writes under a temp name (returning the path it
    actually wrote, for writers that append a suffix), then one
    ``os.replace`` publishes it: a crash mid-save leaves ``path`` as it
    was."""
    from .testing import faults

    tmp = "%s.tmp-%d" % (path, os.getpid())
    actual = None
    try:
        actual = write_cb(tmp) or tmp
        faults.inject("checkpoint_io")
        os.replace(actual, path)
    except BaseException:
        for leftover in {tmp, actual}:
            if leftover and os.path.exists(leftover):
                os.remove(leftover)
        raise
    return path


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``, each
    atomically."""
    if symbol is not None:
        _atomic_replace("%s-symbol.json" % prefix,
                        lambda tmp: symbol.save(tmp))
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})

    def _write(tmp):
        nd_save(tmp, save_dict)
        # numpy appends .npz to a name without it
        return tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp

    _atomic_replace("%s-%04d.params" % (prefix, epoch), _write)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint; the arrays
    land on the current context."""
    symbol_file = "%s-symbol.json" % prefix
    param_name = "%s-%04d.params" % (prefix, epoch)
    if not os.path.exists(symbol_file):
        raise MXNetError("checkpoint %r has no symbol file: %s is missing"
                         % (prefix, symbol_file))
    symbol = sym_mod.load(symbol_file)
    if not os.path.exists(param_name):
        raise MXNetError("checkpoint %r has no params for epoch %d: %s is "
                         "missing" % (prefix, epoch, param_name))
    arg_params, aux_params = {}, {}
    for k, v in nd_load(param_name).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("invalid param key %r" % k)
    return symbol, arg_params, aux_params
