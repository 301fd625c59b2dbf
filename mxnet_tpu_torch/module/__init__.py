"""Module API (counterpart of ``mxnet_tpu/module``): :class:`Module` on
one device; ``BucketingModule`` and ``SequentialModule`` come with a
later slice."""
from .base_module import BaseModule, BatchEndParam
from .module import Module, params_from_numpy

__all__ = ["BaseModule", "BatchEndParam", "Module", "params_from_numpy"]
