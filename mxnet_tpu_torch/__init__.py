"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A package of its own beside the JAX one, with the same module layout.
The kernels the JAX package runs on a TPU are CUDA C++ written for the
H100 (``csrc/``, built at first use by :mod:`._cuda`); the rest is plain
PyTorch.  Entry points run on the card unless the caller passes
``device="cpu"``.  Two slices are ported:

* serving — :mod:`.serve` runs the built-in transformer LM end to end;
* training — :mod:`.symbol` builds the LM (:mod:`.models`), and
  :class:`.fused.TrainStep` trains it (forward, backward, SGD update).
"""
from . import executor, fused, models, optimizer, serve, symbol
from .base import MXNetError

sym = symbol

__all__ = ["MXNetError", "executor", "fused", "models", "optimizer",
           "serve", "sym", "symbol"]
