"""MobileNet v1 (reference
``example/image-classification/symbols/mobilenet.py``): depthwise-
separable convolutions — depthwise 3x3 (grouped Convolution with
num_group == channels) followed by pointwise 1x1 — each with BN + ReLU.

Counterpart of ``mxnet_tpu/models/mobilenet.py`` over the port's
``symbol``; the depthwise convolution is a grouped cuDNN convolution
through torch.  ``multiplier`` scales every width.
"""
from .. import symbol as sym


def _conv_block(data, num_filter, kernel, stride, pad, name,
                num_group=1):
    conv = sym.Convolution(data, kernel=kernel, stride=stride, pad=pad,
                           num_filter=num_filter, num_group=num_group,
                           no_bias=True, name=name)
    bn = sym.BatchNorm(conv, fix_gamma=False, name="%s_bn" % name)
    return sym.Activation(bn, act_type="relu", name="%s_relu" % name)


def _dw_sep(data, in_ch, out_ch, stride, idx, multiplier):
    in_ch = int(in_ch * multiplier)
    out_ch = int(out_ch * multiplier)
    dw = _conv_block(data, in_ch, (3, 3), stride, (1, 1),
                     "conv%d_dw" % idx, num_group=in_ch)
    return _conv_block(dw, out_ch, (1, 1), (1, 1), (0, 0),
                       "conv%d_pw" % idx)


def get_symbol(num_classes=1000, multiplier=1.0, **kwargs):
    data = sym.Variable("data")
    net = _conv_block(data, int(32 * multiplier), (3, 3), (2, 2), (1, 1),
                      "conv1")
    spec = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
            (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
           [(512, 1024, 2), (1024, 1024, 1)]
    for i, (cin, cout, s) in enumerate(spec, start=2):
        net = _dw_sep(net, cin, cout, (s, s), i, multiplier)
    pool = sym.Pooling(net, kernel=(7, 7), global_pool=True,
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(fc, name="softmax")
