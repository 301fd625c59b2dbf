"""Model zoo: Symbol generators over the port's ``symbol``.

Counterpart of ``mxnet_tpu/models``: the transformer LM
(``transformer.py``, the model ``bench_transformer.py`` trains) and
ResNet (``resnet.py``, the model ``bench.py`` trains).  The other
image-classification symbols come with a later slice.
"""
from ..base import MXNetError
from . import resnet, transformer

__all__ = ["resnet", "transformer", "get_model"]

_MODELS = {"resnet": resnet.get_symbol,
           "transformer": transformer.get_symbol}


def get_model(name, **kwargs):
    if name not in _MODELS:
        raise MXNetError("unknown model %r (have: %s)"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
