"""The port's operators.  ``attention`` and ``linear`` hold the
hand-written CUDA kernels, each beside its plain PyTorch version; the
op modules below register into :mod:`.registry`, which the Symbol
frontend is generated from."""
from . import math_ops, matrix_ops, nn_ops  # noqa: F401  (registration)
from .op_params import attach_specs as _attach_specs
from .registry import exists as _exists, get as _get

_attach_specs(_exists, _get)
