"""The port's operators.  ``attention`` and ``linear`` hold the
hand-written CUDA kernels, each beside its plain PyTorch version; the
op modules below register into :mod:`.registry`, which the Symbol
frontend is generated from (``Custom`` registers from
:mod:`..operator`)."""
from . import (math_ops, matrix_ops, nn_ops, optimizer_ops,  # noqa: F401
               random_ops)
from .. import operator as _operator  # noqa: F401
from .op_params import attach_specs as _attach_specs
from .registry import exists as _exists, get as _get

_attach_specs(_exists, _get)
