"""VGG 11/13/16/19 (reference ``example/image-classification/symbols/vgg.py``).

Counterpart of ``mxnet_tpu/models/vgg.py`` over the port's ``symbol``;
``batch_norm=True`` puts a BatchNorm after every convolution."""
from ..base import MXNetError
from .. import symbol as sym

_CFG = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in _CFG:
        raise MXNetError("vgg depth must be one of %s" % sorted(_CFG))
    layers, filters = _CFG[num_layers]
    body = sym.Variable("data")
    for i, num in enumerate(layers):
        for j in range(num):
            body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=filters[i],
                                   name="conv%d_%d" % (i + 1, j + 1))
            if batch_norm:
                body = sym.BatchNorm(body, name="bn%d_%d" % (i + 1, j + 1))
            body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    flatten = sym.Flatten(body)
    fc6 = sym.FullyConnected(flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu")
    drop6 = sym.Dropout(relu6, p=0.5)
    fc7 = sym.FullyConnected(drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu")
    drop7 = sym.Dropout(relu7, p=0.5)
    fc8 = sym.FullyConnected(drop7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(fc8, name="softmax")
