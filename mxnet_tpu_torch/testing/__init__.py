"""Testing utilities: deterministic fault injection for resilience tests.

A copy of the JAX package's harness with identical site names, so a
``MXNET_FAULT_INJECT`` chaos spec carries over between the packages
unchanged (:mod:`mxnet_tpu_torch.testing.faults`).
"""
from . import faults

__all__ = ["faults"]
