"""Inception V3 (reference
``example/image-classification/symbols/inception-v3.py``; the
Szegedy et al. 2015 architecture, input 299x299).

Counterpart of ``mxnet_tpu/models/inception_v3.py`` over the port's
``symbol``: every convolution is followed by a BatchNorm
(``fix_gamma=True``, eps 1e-3) and a ReLU."""
from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None):
    c = sym.Convolution(data, kernel=kernel, stride=stride, pad=pad,
                        num_filter=num_filter, no_bias=True,
                        name="%s_conv" % name)
    bn = sym.BatchNorm(c, fix_gamma=True, eps=0.001,
                       name="%s_bn" % name)
    return sym.Activation(bn, act_type="relu", name="%s_relu" % name)


def _pool(data, kernel, stride, pad, pool_type, name):
    return sym.Pooling(data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type, name=name)


def _inception_a(data, b1, b2_1, b2_2, b3_1, b3_2, b4, name):
    t1 = _conv(data, b1, name="%s_1x1" % name)
    t2 = _conv(data, b2_1, name="%s_5x5r" % name)
    t2 = _conv(t2, b2_2, kernel=(5, 5), pad=(2, 2), name="%s_5x5" % name)
    t3 = _conv(data, b3_1, name="%s_3x3r" % name)
    t3 = _conv(t3, b3_2, kernel=(3, 3), pad=(1, 1),
               name="%s_3x3a" % name)
    t3 = _conv(t3, b3_2, kernel=(3, 3), pad=(1, 1),
               name="%s_3x3b" % name)
    t4 = _pool(data, (3, 3), (1, 1), (1, 1), "avg", "%s_pool" % name)
    t4 = _conv(t4, b4, name="%s_proj" % name)
    return sym.Concat(t1, t2, t3, t4, name="%s_concat" % name)


def _reduction_a(data, b3, b23_1, b23_2, b23_3, name):
    t1 = _conv(data, b3, kernel=(3, 3), stride=(2, 2),
               name="%s_3x3" % name)
    t2 = _conv(data, b23_1, name="%s_d3x3r" % name)
    t2 = _conv(t2, b23_2, kernel=(3, 3), pad=(1, 1),
               name="%s_d3x3a" % name)
    t2 = _conv(t2, b23_3, kernel=(3, 3), stride=(2, 2),
               name="%s_d3x3b" % name)
    t3 = _pool(data, (3, 3), (2, 2), (0, 0), "max", "%s_pool" % name)
    return sym.Concat(t1, t2, t3, name="%s_concat" % name)


def _inception_b(data, b7, name):
    t1 = _conv(data, 192, name="%s_1x1" % name)
    t2 = _conv(data, b7, name="%s_7x7r" % name)
    t2 = _conv(t2, b7, kernel=(1, 7), pad=(0, 3), name="%s_1x7a" % name)
    t2 = _conv(t2, 192, kernel=(7, 1), pad=(3, 0), name="%s_7x1a" % name)
    t3 = _conv(data, b7, name="%s_d7r" % name)
    t3 = _conv(t3, b7, kernel=(7, 1), pad=(3, 0), name="%s_7x1b" % name)
    t3 = _conv(t3, b7, kernel=(1, 7), pad=(0, 3), name="%s_1x7b" % name)
    t3 = _conv(t3, b7, kernel=(7, 1), pad=(3, 0), name="%s_7x1c" % name)
    t3 = _conv(t3, 192, kernel=(1, 7), pad=(0, 3), name="%s_1x7c" % name)
    t4 = _pool(data, (3, 3), (1, 1), (1, 1), "avg", "%s_pool" % name)
    t4 = _conv(t4, 192, name="%s_proj" % name)
    return sym.Concat(t1, t2, t3, t4, name="%s_concat" % name)


def _reduction_b(data, name):
    t1 = _conv(data, 192, name="%s_3x3r" % name)
    t1 = _conv(t1, 320, kernel=(3, 3), stride=(2, 2),
               name="%s_3x3" % name)
    t2 = _conv(data, 192, name="%s_7x7r" % name)
    t2 = _conv(t2, 192, kernel=(1, 7), pad=(0, 3), name="%s_1x7" % name)
    t2 = _conv(t2, 192, kernel=(7, 1), pad=(3, 0), name="%s_7x1" % name)
    t2 = _conv(t2, 192, kernel=(3, 3), stride=(2, 2),
               name="%s_3x3b" % name)
    t3 = _pool(data, (3, 3), (2, 2), (0, 0), "max", "%s_pool" % name)
    return sym.Concat(t1, t2, t3, name="%s_concat" % name)


def _inception_c(data, name):
    t1 = _conv(data, 320, name="%s_1x1" % name)
    t2 = _conv(data, 384, name="%s_3x3r" % name)
    t2a = _conv(t2, 384, kernel=(1, 3), pad=(0, 1), name="%s_1x3" % name)
    t2b = _conv(t2, 384, kernel=(3, 1), pad=(1, 0), name="%s_3x1" % name)
    t3 = _conv(data, 448, name="%s_d3r" % name)
    t3 = _conv(t3, 384, kernel=(3, 3), pad=(1, 1), name="%s_d3" % name)
    t3a = _conv(t3, 384, kernel=(1, 3), pad=(0, 1),
                name="%s_d1x3" % name)
    t3b = _conv(t3, 384, kernel=(3, 1), pad=(1, 0),
                name="%s_d3x1" % name)
    t4 = _pool(data, (3, 3), (1, 1), (1, 1), "avg", "%s_pool" % name)
    t4 = _conv(t4, 192, name="%s_proj" % name)
    return sym.Concat(t1, t2a, t2b, t3a, t3b, t4,
                      name="%s_concat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")  # (N, 3, 299, 299)
    net = _conv(data, 32, kernel=(3, 3), stride=(2, 2), name="stem1")
    net = _conv(net, 32, kernel=(3, 3), name="stem2")
    net = _conv(net, 64, kernel=(3, 3), pad=(1, 1), name="stem3")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max", "stem_pool1")
    net = _conv(net, 80, name="stem4")
    net = _conv(net, 192, kernel=(3, 3), name="stem5")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max", "stem_pool2")

    net = _inception_a(net, 64, 48, 64, 64, 96, 32, "mixed0")
    net = _inception_a(net, 64, 48, 64, 64, 96, 64, "mixed1")
    net = _inception_a(net, 64, 48, 64, 64, 96, 64, "mixed2")
    net = _reduction_a(net, 384, 64, 96, 96, "mixed3")
    net = _inception_b(net, 128, "mixed4")
    net = _inception_b(net, 160, "mixed5")
    net = _inception_b(net, 160, "mixed6")
    net = _inception_b(net, 192, "mixed7")
    net = _reduction_b(net, "mixed8")
    net = _inception_c(net, "mixed9")
    net = _inception_c(net, "mixed10")

    pool = sym.Pooling(net, kernel=(8, 8), global_pool=True,
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
