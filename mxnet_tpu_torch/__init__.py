"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A package of its own beside the JAX one, with the same module layout.
The kernels the JAX package runs on a TPU are CUDA C++ written for the
H100 (``csrc/``, built at first use by :mod:`._cuda`); the rest is plain
PyTorch.  Entry points run on the card unless the caller passes
``device="cpu"``.  This first slice is the serving path:
:mod:`.serve` runs the built-in transformer LM end to end.
"""
from . import serve
from .base import MXNetError

__all__ = ["MXNetError", "serve"]
