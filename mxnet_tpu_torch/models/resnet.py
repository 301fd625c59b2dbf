"""ResNet (reference ``example/image-classification/symbols/resnet.py``,
the Kaiming-He v2 pre-activation form).  Depths: 18/34 (basic block),
50/101/152/200 (bottleneck); CIFAR depths for 32x32 images.

Counterpart of ``mxnet_tpu/models/resnet.py``, the same graph built over
the port's ``symbol``: ResNet-50 through ``Module.fit`` is the network of
the JAX package's ``bench.py``.  ``layout`` may be 'NCHW' (the reference
default) or 'NHWC' (BatchNorm over axis 3, OHWI weights)."""
from .. import symbol as sym


def _bn_axis(layout):
    return 3 if layout == "NHWC" else 1


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9, layout="NCHW"):
    ax = _bn_axis(layout)
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            axis=ax, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, layout=layout,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, axis=ax, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, layout=layout,
                                name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, axis=ax, name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                layout=layout, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, layout=layout,
                                       name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        axis=ax, name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            layout=layout, name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        axis=ax, name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            layout=layout, name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride,
                                   no_bias=True, layout=layout,
                                   name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, layout="NCHW"):
    ax = _bn_axis(layout)
    data = sym.Variable("data")
    nchannel, height, _ = image_shape
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         axis=ax, name="bn_data")
    if height <= 32:  # CIFAR
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, layout=layout, name="conv0")
    else:  # ImageNet
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, layout=layout, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, axis=ax, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", layout=layout)

    for i in range(num_stages):
        body = residual_unit(body, filter_list[i + 1],
                             (1 if i == 0 else 2,) * 2, False,
                             name="stage%d_unit%d" % (i + 1, 1),
                             bottle_neck=bottle_neck, bn_mom=bn_mom,
                             layout=layout)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom,
                                 layout=layout)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        axis=ax, name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", layout=layout, name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               layout="NCHW", **kwargs):
    """Build a ResNet symbol (reference ``resnet.py`` ``get_symbol``).

    ``image_shape`` is always given channel-first (C, H, W) like the
    reference; with ``layout='NHWC'`` the bound data shape must be
    (N, H, W, C)."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    height = image_shape[1]
    if height <= 32:  # CIFAR-style
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        unit_map = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                    101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
                    200: [3, 24, 36, 3]}
        if num_layers not in unit_map:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = unit_map[num_layers]
    return resnet(units, num_stages, filter_list, num_classes, image_shape,
                  bottle_neck, layout=layout)
