"""Gluon model zoo — vision networks.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision.py`` (reference
``python/mxnet/gluon/model_zoo/vision/``): ResNet v1/v2 (basic and
bottleneck blocks), VGG, AlexNet, SqueezeNet, DenseNet, MobileNet and
Inception v3, with the same constructors and block structure, built from
the port's HybridBlocks.  ``pretrained=True`` raises: there is no model
store in the build.
"""
from __future__ import annotations

from ...base import MXNetError
from .. import nn
from ..block import HybridBlock

__all__ = ["get_model", "resnet18_v1", "resnet34_v1", "resnet50_v1",
           "resnet101_v1", "resnet152_v1", "resnet18_v2", "resnet34_v2",
           "resnet50_v2", "resnet101_v2", "resnet152_v2", "get_resnet",
           "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg", "alexnet", "squeezenet1_0",
           "squeezenet1_1", "densenet121", "densenet161", "densenet169",
           "densenet201", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "get_mobilenet", "MobileNet", "AlexNet",
           "ResNetV1", "ResNetV2", "VGG", "SqueezeNet", "DenseNet"]


def _no_pretrained(pretrained):
    if pretrained:
        raise MXNetError("pretrained weights are not available in this "
                         "build (no model store); initialize and train")


# ---------------------------------------------------------------------------
# ResNet (reference resnet.py: BasicBlockV1/V2, BottleneckV1/V2)
# ---------------------------------------------------------------------------

def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x2 = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x2 + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1,
                                strides=stride, use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x2 = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x2 + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride,
                                        use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride,
                                        use_bias=False,
                                        in_channels=in_channels)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.bn1(x)
        x = F.Activation(x, act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.bn2(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv2(x)
        x = self.bn3(x)
        x = F.Activation(x, act_type="relu")
        x = self.conv3(x)
        return x + residual


_RESNET_SPEC = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
                34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
                50: ("bottle_neck", [3, 4, 6, 3],
                     [64, 256, 512, 1024, 2048]),
                101: ("bottle_neck", [3, 4, 23, 3],
                      [64, 256, 512, 1024, 2048]),
                152: ("bottle_neck", [3, 8, 36, 3],
                      [64, 256, 512, 1024, 2048])}


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential(prefix="")
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        in_ch = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride, in_ch))
            in_ch = channels[i + 1]
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels):
        layer = nn.HybridSequential(prefix="")
        layer.add(block(channels, stride,
                        downsample=(channels != in_channels or
                                    stride != 1),
                        in_channels=in_channels))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, downsample=False,
                            in_channels=channels))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(F.Flatten(x))


class ResNetV2(ResNetV1):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        HybridBlock.__init__(self, **kwargs)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.BatchNorm(scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        in_ch = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride, in_ch))
            in_ch = channels[i + 1]
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])


_V1_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}
_V2_BLOCKS = {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}


def get_resnet(version, num_layers, pretrained=False, classes=1000,
               **kwargs):
    _no_pretrained(pretrained)
    if num_layers not in _RESNET_SPEC:
        raise MXNetError("no resnet spec for %d layers" % num_layers)
    block_name, layers, channels = _RESNET_SPEC[num_layers]
    if version == 1:
        return ResNetV1(_V1_BLOCKS[block_name], layers, channels,
                        classes=classes, **kwargs)
    if version == 2:
        return ResNetV2(_V2_BLOCKS[block_name], layers, channels,
                        classes=classes, **kwargs)
    raise MXNetError("resnet version must be 1 or 2")


def resnet18_v1(**kw): return get_resnet(1, 18, **kw)
def resnet34_v1(**kw): return get_resnet(1, 34, **kw)
def resnet50_v1(**kw): return get_resnet(1, 50, **kw)
def resnet101_v1(**kw): return get_resnet(1, 101, **kw)
def resnet152_v1(**kw): return get_resnet(1, 152, **kw)
def resnet18_v2(**kw): return get_resnet(2, 18, **kw)
def resnet34_v2(**kw): return get_resnet(2, 34, **kw)
def resnet50_v2(**kw): return get_resnet(2, 50, **kw)
def resnet101_v2(**kw): return get_resnet(2, 101, **kw)
def resnet152_v2(**kw): return get_resnet(2, 152, **kw)


# ---------------------------------------------------------------------------
# VGG (reference vgg.py)
# ---------------------------------------------------------------------------

_VGG_SPEC = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
             13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
             16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
             19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential(prefix="")
        for num, ch in zip(layers, filters):
            for _ in range(num):
                self.features.add(nn.Conv2D(ch, kernel_size=3, padding=1))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(2, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    layers, filters = _VGG_SPEC[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kw): return get_vgg(11, **kw)
def vgg13(**kw): return get_vgg(13, **kw)
def vgg16(**kw): return get_vgg(16, **kw)
def vgg19(**kw): return get_vgg(19, **kw)
def vgg11_bn(**kw): return get_vgg(11, batch_norm=True, **kw)
def vgg13_bn(**kw): return get_vgg(13, batch_norm=True, **kw)
def vgg16_bn(**kw): return get_vgg(16, batch_norm=True, **kw)
def vgg19_bn(**kw): return get_vgg(19, batch_norm=True, **kw)


# ---------------------------------------------------------------------------
# AlexNet (reference alexnet.py)
# ---------------------------------------------------------------------------

class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.Conv2D(64, 11, 4, 2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(192, 5, padding=2, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Conv2D(384, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
        self.features.add(nn.MaxPool2D(3, 2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


# ---------------------------------------------------------------------------
# SqueezeNet (reference squeezenet.py)
# ---------------------------------------------------------------------------

class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze, kernel_size=1,
                                 activation="relu")
        self.expand1 = nn.Conv2D(expand1x1, kernel_size=1,
                                 activation="relu")
        self.expand3 = nn.Conv2D(expand3x3, kernel_size=3, padding=1,
                                 activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.Concat(self.expand1(x), self.expand3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise MXNetError("squeezenet version must be '1.0' or '1.1'")
        self.features = nn.HybridSequential(prefix="")
        if version == "1.0":
            self.features.add(nn.Conv2D(96, 7, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for sq, e1, e3 in ((16, 64, 64), (16, 64, 64),
                               (32, 128, 128)):
                self.features.add(_Fire(sq, e1, e3))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for sq, e1, e3 in ((32, 128, 128), (48, 192, 192),
                               (48, 192, 192), (64, 256, 256)):
                self.features.add(_Fire(sq, e1, e3))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, 3, 2, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for sq, e1, e3 in ((48, 192, 192), (48, 192, 192),
                               (64, 256, 256), (64, 256, 256)):
                self.features.add(_Fire(sq, e1, e3))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential(prefix="")
        self.output.add(nn.Conv2D(classes, kernel_size=1,
                                  activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)


# ---------------------------------------------------------------------------
# DenseNet (reference densenet.py)
# ---------------------------------------------------------------------------

class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.Concat(x, self.body(x), dim=1)


_DENSENET_SPEC = {121: (64, 32, [6, 12, 24, 16]),
                  161: (96, 48, [6, 12, 36, 24]),
                  169: (64, 32, [6, 12, 32, 32]),
                  201: (64, 32, [6, 12, 48, 32])}


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.Conv2D(num_init_features, 7, 2, 3,
                                    use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(3, 2, 1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            blk = nn.HybridSequential(prefix="")
            for _ in range(num_layers):
                blk.add(_DenseLayer(growth_rate, bn_size, dropout))
            self.features.add(blk)
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.Conv2D(num_features // 2,
                                            kernel_size=1,
                                            use_bias=False))
                self.features.add(nn.AvgPool2D(2, 2))
                num_features //= 2
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _densenet(n):
    def make(pretrained=False, **kwargs):
        _no_pretrained(pretrained)
        init, growth, cfg = _DENSENET_SPEC[n]
        return DenseNet(init, growth, cfg, **kwargs)
    make.__name__ = "densenet%d" % n
    return make


densenet121 = _densenet(121)
densenet161 = _densenet(161)
densenet169 = _densenet(169)
densenet201 = _densenet(201)


# ---------------------------------------------------------------------------
# MobileNet v1 (reference mobilenet.py)
# ---------------------------------------------------------------------------

def _add_conv(seq, channels, kernel=1, stride=1, pad=0, num_group=1):
    seq.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu"))


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential(prefix="")
        ch = int(32 * multiplier)
        _add_conv(self.features, ch, kernel=3, stride=2, pad=1)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 +
                       [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 +
                    [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv(self.features, dwc, kernel=3, stride=s, pad=1,
                      num_group=dwc)   # depthwise
            _add_conv(self.features, c)  # pointwise
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return MobileNet(multiplier, **kwargs)


def mobilenet1_0(**kw): return get_mobilenet(1.0, **kw)
def mobilenet0_75(**kw): return get_mobilenet(0.75, **kw)
def mobilenet0_5(**kw): return get_mobilenet(0.5, **kw)
def mobilenet0_25(**kw): return get_mobilenet(0.25, **kw)


# ---------------------------------------------------------------------------

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn, "alexnet": alexnet,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
}


def get_model(name, **kwargs):
    """Build a model by name (reference ``model_zoo.vision.get_model``)."""
    name = name.lower()
    if name not in _MODELS:
        raise MXNetError("model %r is not in the zoo (known: %s)"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)


# ---------------------------------------------------------------------------
# Inception V3 (reference inception.py; input 299x299)
# ---------------------------------------------------------------------------

def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel_size, strides, padding in conv_settings:
        out.add(_make_basic_conv(channels=channels,
                                 kernel_size=kernel_size,
                                 strides=strides, padding=padding))
    return out


class _InceptionBlock(HybridBlock):
    """Concat of parallel branches (the A/B/C/D/E blocks share this
    shape; branch settings differ)."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        self.branches = branches
        for i, b in enumerate(branches):
            self.register_child(b, "b%d" % i)

    def hybrid_forward(self, F, x):
        return F.Concat(*[b(x) for b in self.branches], dim=1)


def _make_A(pool_features):
    return _InceptionBlock([
        _make_branch(None, (64, 1, 1, 0)),
        _make_branch(None, (48, 1, 1, 0), (64, 5, 1, 2)),
        _make_branch(None, (64, 1, 1, 0), (96, 3, 1, 1),
                     (96, 3, 1, 1)),
        _make_branch("avg", (pool_features, 1, 1, 0))])


def _make_B():
    return _InceptionBlock([
        _make_branch(None, (384, 3, 2, 0)),
        _make_branch(None, (64, 1, 1, 0), (96, 3, 1, 1),
                     (96, 3, 2, 0)),
        _make_branch("max")])


def _make_C(channels_7x7):
    return _InceptionBlock([
        _make_branch(None, (192, 1, 1, 0)),
        _make_branch(None, (channels_7x7, 1, 1, 0),
                     (channels_7x7, (1, 7), 1, (0, 3)),
                     (192, (7, 1), 1, (3, 0))),
        _make_branch(None, (channels_7x7, 1, 1, 0),
                     (channels_7x7, (7, 1), 1, (3, 0)),
                     (channels_7x7, (1, 7), 1, (0, 3)),
                     (channels_7x7, (7, 1), 1, (3, 0)),
                     (192, (1, 7), 1, (0, 3))),
        _make_branch("avg", (192, 1, 1, 0))])


def _make_D():
    return _InceptionBlock([
        _make_branch(None, (192, 1, 1, 0), (320, 3, 2, 0)),
        _make_branch(None, (192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
                     (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)),
        _make_branch("max")])


class _InceptionE(HybridBlock):
    """The E block's 3x3 branches split into parallel 1x3/3x1 halves."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.b0 = _make_branch(None, (320, 1, 1, 0))
        self.b1_stem = _make_basic_conv(channels=384, kernel_size=1,
                                        strides=1, padding=0)
        self.b1_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                     strides=1, padding=(0, 1))
        self.b1_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                     strides=1, padding=(1, 0))
        self.b2_stem = nn.HybridSequential(prefix="")
        self.b2_stem.add(_make_basic_conv(channels=448, kernel_size=1,
                                          strides=1, padding=0))
        self.b2_stem.add(_make_basic_conv(channels=384, kernel_size=3,
                                          strides=1, padding=1))
        self.b2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                     strides=1, padding=(0, 1))
        self.b2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                     strides=1, padding=(1, 0))
        self.b3 = _make_branch("avg", (192, 1, 1, 0))

    def hybrid_forward(self, F, x):
        s1 = self.b1_stem(x)
        s2 = self.b2_stem(x)
        return F.Concat(self.b0(x), self.b1_a(s1), self.b1_b(s1),
                        self.b2_a(s2), self.b2_b(s2), self.b3(x), dim=1)


class Inception3(HybridBlock):
    """Inception V3 (reference ``Inception3``; Szegedy et al. 2015)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=2, padding=0))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=1, padding=0))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                           strides=1, padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1,
                                           strides=1, padding=0))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3,
                                           strides=1, padding=0))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_InceptionE())
        self.features.add(_InceptionE())
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return Inception3(**kwargs)


_MODELS["inceptionv3"] = inception_v3
__all__.append("inception_v3")
