"""Gluon — the imperative high-level API.

Counterpart of ``mxnet_tpu/gluon/`` (reference ``python/mxnet/gluon/``):
blocks and parameters, ``nn`` layers, losses, the ``Trainer``, ``utils``,
``data`` and the model zoo, over the port's NDArray ops and
:mod:`..autograd`.  ``rnn``, ``SymbolBlock`` and ``data.vision`` come
with later slices.
"""
from . import parameter
from .parameter import Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock
from . import nn
from . import loss
from .trainer import Trainer
from . import utils
from . import data
from . import model_zoo

__all__ = ["Parameter", "ParameterDict", "Block", "HybridBlock",
           "SymbolBlock", "nn", "loss", "Trainer", "utils", "data",
           "model_zoo"]
