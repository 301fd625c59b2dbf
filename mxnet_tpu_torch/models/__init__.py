"""Model zoo: Symbol generators over the port's ``symbol``.

Counterpart of ``mxnet_tpu/models``: the reference's image-classification
symbols (``example/image-classification/symbols/``: lenet, mlp, alexnet,
vgg, resnet, inception-bn, mobilenet, inception-v3) and the transformer
LM (``transformer.py``, the model ``bench_transformer.py`` trains).  Each
returns a Symbol ending in ``SoftmaxOutput``, ready for ``Module``.
"""
from ..base import MXNetError
from . import (alexnet, inception_bn, inception_v3, lenet, mlp, mobilenet,
               resnet, transformer, vgg)

__all__ = ["lenet", "mlp", "alexnet", "vgg", "resnet", "inception_bn",
           "mobilenet", "inception_v3", "transformer", "get_model"]

_MODELS = {m.__name__.rsplit(".", 1)[-1]: m.get_symbol
           for m in (lenet, mlp, alexnet, vgg, resnet, inception_bn,
                     mobilenet, inception_v3, transformer)}


def get_model(name, **kwargs):
    if name not in _MODELS:
        raise MXNetError("unknown model %r (have: %s)"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
