"""Model zoo: Symbol generators over the port's ``symbol``.

Counterpart of ``mxnet_tpu/models``; this slice carries the transformer
LM (``transformer.py``), the model ``bench_transformer.py`` trains.  The
image-classification symbols come with the ResNet slice.
"""
from ..base import MXNetError
from . import transformer

__all__ = ["transformer", "get_model"]

_MODELS = {"transformer": transformer.get_symbol}


def get_model(name, **kwargs):
    if name not in _MODELS:
        raise MXNetError("unknown model %r (have: %s)"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
