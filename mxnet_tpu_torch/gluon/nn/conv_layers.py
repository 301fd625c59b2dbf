"""Gluon convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (reference
``python/mxnet/gluon/nn/conv_layers.py``): Conv1D/2D/3D, Conv2DTranspose,
MaxPool/AvgPool 1-3D and the global pools, each over the ``Convolution``,
``Deconvolution`` and ``Pooling`` ops (cuDNN on the card).
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool2D", "GlobalAvgPool2D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, use_bias, activation, in_channels, ndim,
                 op_name="Convolution", **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._kernel = _tup(kernel_size, ndim)
        self._strides = _tup(strides, ndim)
        self._padding = _tup(padding, ndim)
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self._activation = activation
        self._ndim = ndim
        self._op_name = op_name
        with self.name_scope():
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups if in_channels
                          else 0) + self._kernel
            else:  # Deconvolution: (in, out/groups, *k)
                wshape = (in_channels if in_channels else 0,
                          channels // groups) + self._kernel
            self.weight = self.params.get("weight", shape=wshape,
                                          allow_deferred_init=True)
            self.bias = self.params.get("bias", shape=(channels,),
                                        init="zeros",
                                        allow_deferred_init=True) \
                if use_bias else None

    def forward(self, x):
        from ... import ndarray as nd

        in_c = x.shape[1]
        if self.weight._data is None:
            if self._op_name == "Convolution":
                self.weight._shape_from_data(
                    (self._channels, in_c // self._groups) + self._kernel)
            else:
                self.weight._shape_from_data(
                    (in_c, self._channels // self._groups) + self._kernel)
        if self.bias is not None and self.bias._data is None:
            self.bias._shape_from_data((self._channels,))
        args = [x, self.weight.data()]
        if self.bias is not None:
            args.append(self.bias.data())
        fn = getattr(nd, self._op_name)
        out = fn(*args, kernel=self._kernel, stride=self._strides,
                 pad=self._padding, dilate=self._dilation,
                 num_filter=self._channels, num_group=self._groups,
                 no_bias=self.bias is None)
        if self._activation:
            out = nd.Activation(out, act_type=self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, use_bias=True, activation=None,
                 in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, activation, in_channels, 1,
                         **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, use_bias=True,
                 activation=None, in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, activation, in_channels, 2,
                         **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 use_bias=True, activation=None, in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, activation, in_channels, 3,
                         **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, use_bias=True,
                 activation=None, in_channels=0, **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, use_bias, activation, in_channels, 2,
                         op_name="Deconvolution", **kwargs)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 ndim, ceil_mode=False, **kwargs):
        super().__init__(**kwargs)
        self._kernel = _tup(pool_size, ndim)
        self._stride = _tup(strides if strides is not None else pool_size,
                            ndim)
        self._pad = _tup(padding, ndim)
        self._global = global_pool
        self._pool_type = pool_type
        self._ceil = ceil_mode

    def forward(self, x):
        from ... import ndarray as nd

        return nd.Pooling(x, kernel=self._kernel, stride=self._stride,
                          pad=self._pad, pool_type=self._pool_type,
                          global_pool=self._global,
                          pooling_convention="full" if self._ceil
                          else "valid")


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, **kwargs):
        super().__init__(pool_size, strides, padding, False, "max", 1,
                         **kwargs)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, **kwargs):
        super().__init__(pool_size, strides, padding, False, "max", 2,
                         **kwargs)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 **kwargs):
        super().__init__(pool_size, strides, padding, False, "max", 3,
                         **kwargs)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, **kwargs):
        super().__init__(pool_size, strides, padding, False, "avg", 1,
                         **kwargs)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, **kwargs):
        super().__init__(pool_size, strides, padding, False, "avg", 2,
                         **kwargs)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 **kwargs):
        super().__init__(pool_size, strides, padding, False, "avg", 3,
                         **kwargs)


class GlobalMaxPool2D(_Pool):
    def __init__(self, **kwargs):
        super().__init__((1, 1), None, 0, True, "max", 2, **kwargs)


class GlobalAvgPool2D(_Pool):
    def __init__(self, **kwargs):
        super().__init__((1, 1), None, 0, True, "avg", 2, **kwargs)
