"""Neural-network layer operators.

Counterpart of ``mxnet_tpu/ops/nn_ops.py``: ``FullyConnected``,
``Convolution``, ``Deconvolution``, ``Pooling``, ``UpSampling``,
``Activation``, ``LeakyReLU``, ``softmax``/``log_softmax``,
``SoftmaxActivation``, the output layers (``SoftmaxOutput``, the
regression outputs, ``SVMOutput``), ``softmax_cross_entropy``,
``BatchNorm``, ``InstanceNorm``, ``LayerNorm``, ``L2Normalization``,
``LRN``, ``Dropout``, the ``Sequence*`` ops, ``Crop``, ``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``, ``ROIPooling``,
``IdentityAttachKLSparseReg`` and ``MultiHeadAttention``.  ``MoE`` comes
with the expert-parallel slice.

* Projections are plain matmuls (cuBLAS on the card), as the JAX package
  leaves them to XLA; the bias is added after the product, in the
  product's dtype, as there.
* The output layers keep the reference's loss-layer contract, each a
  ``torch.autograd.Function``: ``SoftmaxOutput``'s backward is ``(p -
  onehot(label)) * grad_scale``, a regression output's ``grad(out,
  label) * grad_scale / (elements a sample)``, ``SVMOutput``'s the hinge
  gradient, each times the incoming cotangent (ones under the
  reference's seeding; a loss scale riding the cotangent passes
  through), and the label's gradient is zero.
* ``MultiHeadAttention`` dispatches the score/value contraction through
  ``ops/attention.py::dot_product_attention`` — kernels K1 (forward) and
  K4 (backward) on the card.
* ``Convolution`` and ``Pooling`` are PyTorch's (cuDNN on the card): the
  JAX package left them to XLA and wrote no TPU kernel for them.
* ``BatchNorm`` in training mode is :func:`_bn_train`, a
  ``torch.autograd.Function`` with the JAX package's closed-form
  backward; on bf16 data its channel sums are kernels K5 and K6
  (``ops/pallas_bn.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, later_slice
from ..quantize import fp8_apply_dot
from . import pallas_bn
from .registry import register


def _pair(v, n=2):
    if v is None:
        return (1,) * n
    if isinstance(v, (int, float)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    return t if t else (1,) * n


def _channels_last(layout):
    return layout in ("NWC", "NHWC", "NDHWC")


def _to_channels_first(x):
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_channels_last(x):
    return x.permute(0, *range(2, x.dim()), 1)


@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected(attrs, data, weight, *bias):
    """Reference ``src/operator/fully_connected.cc``: Y = X W^T + b."""
    if bool(attrs.get("flatten", True)) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = fp8_apply_dot(data, weight, label=attrs.get("__node_name__"),
                        w_dim=1)
    if out is None:
        out = F.linear(data, weight)
    if bias:
        out = out + bias[0]
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("conv", "Convolution_v1"))
def _convolution(attrs, data, weight, *bias):
    """Reference ``src/operator/convolution-inl.h``: grouped ND
    convolution, weight (O, I/g, *kernel) for NC-first layouts, (O,
    *kernel, I/g) for channels-last.  The bias is added after the
    product, in its dtype, as the JAX package adds it."""
    kernel = _pair(attrs["kernel"], len(attrs["kernel"]))
    nd = len(kernel)
    if nd not in _CONV:
        raise MXNetError("Convolution: %d spatial dims" % nd)
    ch_last = _channels_last(attrs.get("layout"))
    if ch_last:
        data, weight = _to_channels_first(data), _to_channels_first(weight)
    out = _CONV[nd](data, weight, stride=_pair(attrs.get("stride"), nd),
                    padding=_pair(attrs.get("pad", (0,) * nd), nd),
                    dilation=_pair(attrs.get("dilate"), nd),
                    groups=int(attrs.get("num_group", 1)))
    if bias:
        out = out + bias[0].reshape((1, -1) + (1,) * nd)
    return _to_channels_last(out) if ch_last else out


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
def _deconvolution(attrs, data, weight, *bias):
    """Reference ``src/operator/deconvolution-inl.h``: the transposed
    convolution, weight (I, O/g, *kernel), output ``(H-1)·stride - 2·pad +
    kernel + adj`` (the JAX package ignores ``dilate`` here too)."""
    kernel = _pair(attrs["kernel"], len(attrs["kernel"]))
    nd = len(kernel)
    out = _DECONV[nd](data, weight, stride=_pair(attrs.get("stride"), nd),
                      padding=_pair(attrs.get("pad", (0,) * nd), nd),
                      output_padding=_pair(attrs.get("adj", (0,) * nd), nd),
                      groups=int(attrs.get("num_group", 1)))
    if bias:
        out = out + bias[0].reshape((1, -1) + (1,) * nd)
    return out


def _window_sum(x, kernel, stride):
    """Sum of each (unpadded) window of the channels-first ``x``."""
    nd = len(kernel)
    if nd == 1:
        return _window_sum(x.unsqueeze(-2), (1,) + kernel,
                           (1,) + stride).squeeze(-2)
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register("Pooling", aliases=("Pooling_v1",))
def _pooling(attrs, data):
    """Reference ``src/operator/pooling-inl.h``: max/avg/sum pooling with
    global_pool and the 'valid'/'full' conventions; avg counts the padding
    (``count_include_pad=True``, the reference default)."""
    pool_type = attrs.get("pool_type", "max")
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %r" % pool_type)
    ch_last = _channels_last(attrs.get("layout"))
    if ch_last:
        data = _to_channels_first(data)
    nd = data.dim() - 2
    if bool(attrs.get("global_pool", False)):
        axes = tuple(range(2, 2 + nd))
        if pool_type == "max":
            out = data.amax(dim=axes, keepdim=True)
        elif pool_type == "sum":
            out = data.sum(dim=axes, keepdim=True)
        else:
            out = data.mean(dim=axes, keepdim=True)
        return _to_channels_last(out) if ch_last else out
    kernel = _pair(attrs["kernel"], len(attrs["kernel"]))
    nd = len(kernel)
    stride = _pair(attrs.get("stride"), nd)
    pad = _pair(attrs.get("pad", (0,) * nd), nd)
    # 'full' (ceil) pads the high edge so partial windows count
    extra = [0] * nd
    if attrs.get("pooling_convention", "valid") == "full":
        for d in range(nd):
            rem = (data.shape[2 + d] + 2 * pad[d] - kernel[d]) % stride[d]
            if rem:
                extra[d] = stride[d] - rem
    pads = []
    for d in reversed(range(nd)):  # F.pad lists the last axis first
        pads += [pad[d], pad[d] + extra[d]]
    if pool_type == "max":
        fill = float("-inf") if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
        out = _MAX_POOL[nd](F.pad(data, pads, value=fill), kernel, stride)
    else:
        out = _window_sum(F.pad(data, pads, value=0.0), kernel, stride)
        if pool_type == "avg":
            denom = 1
            for k in kernel:
                denom *= k
            # a fill on the device, not a host copy: a CUDA graph can
            # hold it
            out = out / torch.full((), denom, dtype=out.dtype,
                                   device=out.device)
    return _to_channels_last(out) if ch_last else out


# relu is max(x, 0) as jnp.maximum computes it: its gradient at exactly
# 0 is 0.5 (torch.relu's is 0), and BatchNorm outputs of exactly 0 occur
# in bf16
_ACTIVATIONS = {
    "relu": lambda x: torch.maximum(x, x.new_zeros(())),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


@register("Activation")
def _activation(attrs, x):
    act = attrs.get("act_type", "relu")
    if act not in _ACTIVATIONS:
        raise MXNetError("unknown act_type %r" % act)
    return _ACTIVATIONS[act](x)


@register("LeakyReLU", needs_rng=True, uses_train_mode=True)
def _leaky_relu(attrs, rng, x, *gamma):
    """Reference ``src/operator/leaky_relu-inl.h``: leaky, elu, prelu and
    rrelu (a random slope per element in training, the mean slope
    otherwise)."""
    act = attrs.get("act_type", "leaky")
    slope = float(attrs.get("slope", 0.25))
    pos = x > 0
    if act == "leaky":
        return torch.where(pos, x, slope * x)
    if act == "elu":
        return torch.where(pos, x, slope * torch.expm1(x))
    if act == "prelu":
        g = gamma[0].reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(pos, x, g * x)
    if act == "rrelu":
        lo = float(attrs.get("lower_bound", 0.125))
        hi = float(attrs.get("upper_bound", 0.334))
        if attrs.get("__is_train__", False):
            s = torch.rand(x.shape, generator=rng, device=x.device,
                           dtype=x.dtype) * (hi - lo) + lo
            return torch.where(pos, x, s * x)
        return torch.where(pos, x, ((lo + hi) / 2) * x)
    raise MXNetError("unknown LeakyReLU act_type %r" % act)


def _temperature(attrs, x):
    t = float(attrs.get("temperature") or 1.0)
    return x if t == 1.0 else x / t


@register("softmax")
def _softmax(attrs, x):
    return torch.softmax(_temperature(attrs, x), dim=int(attrs.get("axis",
                                                                   -1)))


@register("log_softmax")
def _log_softmax(attrs, x):
    return torch.log_softmax(_temperature(attrs, x),
                             dim=int(attrs.get("axis", -1)))


@register("Dropout", needs_rng=True, uses_train_mode=True)
def _dropout(attrs, rng, x):
    """Reference ``src/operator/dropout-inl.h``: inverted dropout, scaled
    in training, the identity otherwise.  The mask is drawn from the
    ``torch.Generator`` the invoke layer hands over (one per call, from
    ``mx.random``'s seed)."""
    p = float(attrs.get("p", 0.5))
    is_train = bool(attrs.get("__is_train__", False))
    if p <= 0 or (not is_train and attrs.get("mode", "training") != "always"):
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


@register("InstanceNorm")
def _instance_norm(attrs, data, gamma, beta):
    """Normalize each (sample, channel) over its spatial axes."""
    eps = float(attrs.get("eps", 1e-3))
    axes = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=axes, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape)
            + beta.reshape(bshape))


@register("LayerNorm")
def _layer_norm(attrs, data, gamma, beta):
    """Normalize over ``axis`` with the population variance, then scale
    and shift."""
    eps = float(attrs.get("eps", 1e-5))
    axis = int(attrs.get("axis", -1)) % data.dim()
    if axis == data.dim() - 1:
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps=eps)
    var, mean = torch.var_mean(data, dim=axis, keepdim=True,
                               correction=0)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape))


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward softmax; backward ``(p - onehot) * scale * g``."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        axis = 1 if bool(attrs.get("multi_output", False)) else -1
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.attrs = attrs
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        attrs = ctx.attrs
        multi_output = bool(attrs.get("multi_output", False))
        axis = 1 if multi_output else p.dim() - 1
        # one_hot of an id outside [0, C) is an all-zero row, as
        # jax.nn.one_hot gives; the scatter index is masked first
        ids = label.to(torch.int64)
        hot = ((ids >= 0) & (ids < p.shape[axis])).unsqueeze(axis)
        grad = p.clone()
        grad.scatter_add_(axis, torch.where(hot, ids.unsqueeze(axis), 0),
                          -hot.to(p.dtype))
        if bool(attrs.get("use_ignore", False)):
            keep = label != float(attrs.get("ignore_label", -1))
            grad = grad * keep.unsqueeze(axis).to(p.dtype)
        scale = float(attrs.get("grad_scale", 1.0))
        normalization = attrs.get("normalization", "null")
        if normalization == "batch":
            # after the LM's Reshape this is N*T rows, not N
            scale = scale / p.shape[0]
        elif normalization == "valid" and attrs.get("use_ignore", False):
            valid = (label != float(attrs.get("ignore_label", -1))).sum()
            grad = grad / torch.clamp_min(valid, 1).to(p.dtype)
        # a Python scale is weakly typed in JAX: it takes p's dtype first
        grad = grad * p.new_full((), scale)
        return grad * g.to(grad.dtype), None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(attrs, data, label):
    """Reference ``src/operator/softmax_output-inl.h``: forward softmax,
    backward ``(softmax - onehot(label)) * grad_scale`` with
    use_ignore/ignore_label, multi_output and null/batch/valid
    normalization; the head gradient multiplies the result."""
    return _SoftmaxOutputFn.apply(data, label, attrs)


class _RegressionFn(torch.autograd.Function):
    """Forward ``transform(data)``; backward ``grad(out, label) *
    grad_scale / (elements a sample)`` times the cotangent, and a zero
    gradient for the label."""

    @staticmethod
    def forward(ctx, data, label, kind, scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.scale = kind, scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        num = 1
        for n in out.shape[1:]:
            num *= n
        gd = diff * (ctx.scale / num)
        return gd * g.to(gd.dtype), torch.zeros_like(label), None, None


def _regression_output(kind):
    def compute(attrs, data, label):
        return _RegressionFn.apply(data, label, kind,
                                   float(attrs.get("grad_scale", 1.0)))
    return compute


register("LinearRegressionOutput", _regression_output("linear"))
register("MAERegressionOutput", _regression_output("mae"))
register("LogisticRegressionOutput", _regression_output("logistic"))


class _SVMOutputFn(torch.autograd.Function):
    """Forward the identity; backward the (squared, or with
    ``use_linear`` linear) hinge gradient of the reference's
    ``svm_output-inl.h``, times the cotangent."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.margin, ctx.reg, ctx.use_linear = margin, reg, use_linear
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        d, label = ctx.saved_tensors
        onehot = F.one_hot(label.to(torch.int64), d.shape[-1]).to(d.dtype)
        correct = torch.sum(d * onehot, dim=-1, keepdim=True)
        if ctx.use_linear:
            viol = ((d - correct + ctx.margin) > 0).to(d.dtype) * (1 - onehot)
            gd = ctx.reg * (viol - onehot * torch.sum(viol, dim=-1,
                                                      keepdim=True))
        else:
            m = torch.clamp_min(d - correct + ctx.margin, 0.) * (1 - onehot)
            gd = ctx.reg * 2 * (m - onehot * torch.sum(m, dim=-1,
                                                       keepdim=True))
        return (gd * g.to(gd.dtype), torch.zeros_like(label), None, None,
                None)


@register("SVMOutput")
def _svm_output(attrs, data, label):
    return _SVMOutputFn.apply(
        data, label, float(attrs.get("margin", 1.0)),
        float(attrs.get("regularization_coefficient", 1.0)),
        bool(attrs.get("use_linear", False)))


@register("softmax_cross_entropy")
def _softmax_xent(attrs, data, label):
    """Summed cross-entropy of the rows of ``data`` at ``label`` (a 0-d
    result)."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.sum(torch.gather(logp, -1,
                                   label.to(torch.int64)[:, None]))


@register("SoftmaxActivation")
def _softmax_activation(attrs, x):
    """Softmax over the channels (``mode="channel"``) or over all of a
    sample's features."""
    if attrs.get("mode", "instance") == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


@register("UpSampling")
def _upsampling(attrs, *inputs):
    """Reference ``src/operator/upsampling.cc``: nearest (each pixel
    ``scale`` x ``scale`` times) or bilinear (half-pixel centres, as
    ``jax.image.resize``) scale-up of the first input."""
    scale = int(attrs["scale"])
    data = inputs[0]
    if attrs.get("sample_type", "nearest") == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


@register("L2Normalization")
def _l2_normalization(attrs, data):
    eps = float(attrs.get("eps", 1e-10))
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                       keepdim=True) + eps)


@register("LRN")
def _lrn(attrs, data):
    """Reference ``src/operator/lrn.cc``: cross-channel local response
    normalization over ``nsize`` channels."""
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    knorm = float(attrs.get("knorm", 2.0))
    nsize = int(attrs["nsize"])
    half = nsize // 2
    padded = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    windows = padded[:, 0:data.shape[1]]
    for i in range(1, nsize):
        windows = windows + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + alpha * windows / nsize, beta)


def _seq_len(attrs, seq_len):
    """The lengths input when ``use_sequence_length``, else None."""
    if bool(attrs.get("use_sequence_length", False)) and seq_len:
        return seq_len[0].to(torch.int64)
    return None


@register("SequenceMask")
def _sequence_mask(attrs, data, *seq_len):
    """Reference ``src/operator/sequence_mask.cc``: time-major (T, B, ...)
    steps at or past a sequence's length set to ``value``."""
    lens = _seq_len(attrs, seq_len)
    if lens is None:
        return data
    value = float(attrs.get("value", 0.0))
    mask = (torch.arange(data.shape[0], device=data.device)[:, None]
            < lens[None, :]).to(data.dtype)
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return data * mask + value * (1 - mask)


@register("SequenceLast")
def _sequence_last(attrs, data, *seq_len):
    lens = _seq_len(attrs, seq_len)
    if lens is None:
        return data[-1]
    return data[lens - 1, torch.arange(data.shape[1], device=data.device)]


@register("SequenceReverse")
def _sequence_reverse(attrs, data, *seq_len):
    lens = _seq_len(attrs, seq_len)
    if lens is None:
        return torch.flip(data, [0])
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    idx = torch.where(t < lens[None, :], lens[None, :] - 1 - t, t)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, idx.expand(data.shape))


@register("Crop")
def _crop(attrs, *inputs):
    """Crop (N, C, H, W) to ``h_w`` (or the second input's H, W) at
    ``offset`` or the centre."""
    data = inputs[0]
    if len(inputs) == 2:
        h, w = inputs[1].shape[2], inputs[1].shape[3]
    else:
        h, w = (int(v) for v in attrs["h_w"])
    if bool(attrs.get("center_crop", False)):
        y0, x0 = (data.shape[2] - h) // 2, (data.shape[3] - w) // 2
    else:
        y0, x0 = (int(v) for v in attrs.get("offset", (0, 0)))
    return data[:, :, y0:y0 + h, x0:x0 + w]


@register("GridGenerator")
def _grid_generator(attrs, data):
    """Reference ``src/operator/grid_generator.cc``: an affine (N, 6)
    transform to an (N, 2, H, W) sampling grid in [-1, 1]; ``warp``
    passes the flow field through, as the JAX package does."""
    h, w = (int(v) for v in attrs["target_shape"])
    if attrs.get("transform_type", "affine") != "affine":
        return data
    n = data.shape[0]
    theta = data.reshape(n, 2, 3)
    gy, gx = torch.meshgrid(
        torch.linspace(-1, 1, h, dtype=data.dtype, device=data.device),
        torch.linspace(-1, 1, w, dtype=data.dtype, device=data.device),
        indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=0).reshape(3, -1)
    return torch.einsum("nij,jk->nik", theta, grid).reshape(n, 2, h, w)


@register("BilinearSampler")
def _bilinear_sampler(attrs, data, grid):
    """Reference ``src/operator/bilinear_sampler.cc``: sample ``data`` at
    the grid's (x, y) in [-1, 1], zero outside the image."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    batch = torch.arange(n, device=data.device)[:, None, None]

    def gather(yy, xx):
        yc = torch.clamp(yy, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xx, 0, w - 1).to(torch.int64)
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        vals = data[batch, :, yc, xc]  # (n, oh, ow, c)
        return torch.where(valid[..., None], vals, vals.new_zeros(()))

    out = (gather(y0, x0) * (wy0 * wx0)[..., None]
           + gather(y0, x1) * (wy0 * wx1)[..., None]
           + gather(y1, x0) * (wy1 * wx0)[..., None]
           + gather(y1, x1) * (wy1 * wx1)[..., None])
    return out.movedim(-1, 1)


@register("SpatialTransformer")
def _spatial_transformer(attrs, data, loc):
    grid = _grid_generator({"target_shape": attrs["target_shape"],
                            "transform_type": "affine"}, loc)
    return _bilinear_sampler({}, data, grid)


@register("ROIPooling")
def _roi_pooling(attrs, data, rois):
    """Reference ``src/operator/roi_pooling.cc``: max-pool each ROI
    ``[batch, x1, y1, x2, y2]`` (scaled by ``spatial_scale``, rounded
    half to even) to ``pooled_size`` cells; an empty cell is -inf, and a
    tied maximum shares the gradient evenly (``jnp.max``'s rule)."""
    ph, pw = (int(v) for v in attrs["pooled_size"])
    scale = float(attrs["spatial_scale"])
    _, _, h, w = data.shape
    dev = data.device
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).to(torch.int64)
                      for i in (1, 2, 3, 4))
    rh = torch.clamp_min(y2 - y1 + 1, 1)[:, None]
    rw = torch.clamp_min(x2 - x1 + 1, 1)[:, None]
    iy = torch.arange(ph, device=dev)[None, :]
    ix = torch.arange(pw, device=dev)[None, :]
    cy0 = y1[:, None] + (iy * rh) // ph                       # (R, ph)
    cy1 = torch.maximum(y1[:, None] + ((iy + 1) * rh + ph - 1) // ph,
                        cy0 + 1)
    cx0 = x1[:, None] + (ix * rw) // pw                       # (R, pw)
    cx1 = torch.maximum(x1[:, None] + ((ix + 1) * rw + pw - 1) // pw,
                        cx0 + 1)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    my = (ys >= cy0[..., None]) & (ys < cy1[..., None])       # (R, ph, h)
    mx = (xs >= cx0[..., None]) & (xs < cx1[..., None])       # (R, pw, w)
    mask = my[:, :, None, :, None] & mx[:, None, :, None, :]  # R ph pw h w
    img = data[b][:, :, None, None]                           # R c 1 1 h w
    masked = torch.where(mask[:, None], img, img.new_full((), -float("inf")))
    return torch.amax(masked, dim=(-2, -1))


@register("IdentityAttachKLSparseReg")
def _identity_kl(attrs, x):
    return x


@register("_contrib_MultiHeadAttention", aliases=("MultiHeadAttention",))
def _multi_head_attention(attrs, data, in_weight, in_bias, out_weight,
                          out_bias):
    """Causal multi-head self-attention: one (3C, C) input projection, the
    score/value contraction per (batch, head) through
    ``dot_product_attention``, one (C, C) output projection."""
    if bool(attrs.get("seq_parallel", False)):
        raise later_slice("seq_parallel", True)
    from .attention import dot_product_attention

    num_heads = int(attrs["num_heads"])
    causal = bool(attrs.get("causal", True))
    n, t, c = data.shape
    d = c // num_heads
    label = attrs.get("__node_name__")
    qkv = fp8_apply_dot(data, in_weight, label=label, w_dim=1)
    if qkv is None:
        qkv = F.linear(data, in_weight)
    qkv = qkv + in_bias
    q, k, v = (x.reshape(n, t, num_heads, d).transpose(1, 2)
               for x in qkv.chunk(3, dim=-1))
    block = int(attrs["attn_block"]) if "attn_block" in attrs else None
    ctx = dot_product_attention(q, k, v, causal=causal,
                                impl=attrs.get("attn_impl") or None,
                                block=block,
                                window=int(attrs.get("window", 0)))
    ctx = ctx.transpose(1, 2).reshape(n, t, c)
    proj = fp8_apply_dot(ctx, out_weight, label=label, w_dim=1)
    if proj is None:
        proj = F.linear(ctx, out_weight)
    return proj + out_bias


def _bshape(data, axis):
    return tuple(data.shape[axis] if i == axis else 1
                 for i in range(data.dim()))


def _as_scalar(value, like):
    """A Python scalar in ``like``'s dtype: JAX's weak typing casts the
    scalar to the array's dtype before the arithmetic.  Made by a fill on
    the device, not a host copy, so a CUDA graph can hold it."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


@register("BatchNorm", aliases=("BatchNorm_v1",), uses_train_mode=True,
          mutable_inputs=(3, 4))
def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """Reference ``src/operator/batch_norm-inl.h``.  Inputs: data, gamma,
    beta, aux moving_mean, moving_var; returns (out, new_mean, new_var).
    ``fix_gamma`` pins gamma to 1 (the reference default), ``axis`` is the
    channel axis.  Training mode runs :func:`_bn_train` and blends the
    batch statistics into the moving ones in the aux dtype."""
    eps = float(attrs.get("eps", 1e-3))
    momentum = float(attrs.get("momentum", 0.9))
    fix_gamma = bool(attrs.get("fix_gamma", True))
    use_global = bool(attrs.get("use_global_stats", False))
    axis = int(attrs.get("axis", 1)) % data.dim()
    if bool(attrs.get("__is_train__", False)) and not use_global:
        out, mean, var = _bn_train(eps, axis, fix_gamma)(data, gamma, beta)
        mom = _as_scalar(momentum, moving_mean)
        rest = _as_scalar(1 - momentum, moving_mean)
        new_mean = mom * moving_mean + rest * mean.to(moving_mean.dtype)
        new_var = mom * moving_var + rest * var.to(moving_var.dtype)
        return out, new_mean, new_var
    bshape = _bshape(data, axis)
    g32 = (torch.ones_like(gamma) if fix_gamma else gamma).float()
    mean32 = moving_mean.float()
    inv = torch.rsqrt(moving_var.float() + eps).reshape(bshape)
    g32 = g32.reshape(bshape)
    scale = (inv * g32).to(data.dtype)
    shift = (beta.float().reshape(bshape) - mean32.reshape(bshape) * inv
             * g32).to(data.dtype)
    return data * scale + shift, moving_mean, moving_var


class _BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm with the JAX package's hand-written
    backward (``nn_ops._bn_train``, :511-620).

    Forward: per-channel mean and biased variance — on bf16 data from
    :func:`pallas_bn.bn_stats` (K5 on the card) as ``E[x²] − E[x]²``, on
    fp32 data by the two-pass variance — then ``out = data·scale + shift``
    with per-channel constants rounded to the data dtype.  Backward:

        dx = (g·inv) · (dy − E[dy] − x̂·E[dy·x̂])

    with the two channel sums from :func:`pallas_bn.bn_grad_sums` (K6 on
    the card) for bf16 data and from PyTorch sums otherwise.  The choice
    follows the data's dtype, as the reference's does.  Every
    activation-sized tensor stays in the data dtype; the sums are fp32.
    The mean and variance outputs carry no gradient: their one consumer
    is the moving-stat blend."""

    @staticmethod
    def forward(ctx, data, gamma, beta, eps, axis, fix_gamma):
        bshape = _bshape(data, axis)
        count = data.numel() // max(data.shape[axis], 1)
        if data.dtype == torch.bfloat16:
            s1, s2 = pallas_bn.bn_stats(data, axis)
            mean = s1 / count
            var = torch.clamp_min(s2 / count - mean * mean, 0.0)
        else:
            dims = tuple(i for i in range(data.dim()) if i != axis)
            var, mean = torch.var_mean(data.float(), dim=dims, correction=0)
        g32 = (torch.ones_like(gamma) if fix_gamma else gamma).float()
        inv = torch.rsqrt(var + eps)
        scale = (inv * g32).reshape(bshape).to(data.dtype)
        shift = (beta.float() - mean * inv * g32).reshape(bshape).to(
            data.dtype)
        out = data * scale + shift
        ctx.save_for_backward(data, gamma, mean, inv)
        ctx.axis, ctx.fix_gamma = axis, fix_gamma
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        data, gamma, mean, inv = ctx.saved_tensors
        axis, fix_gamma = ctx.axis, ctx.fix_gamma
        dt = data.dtype
        bshape = _bshape(data, axis)
        dims = tuple(i for i in range(data.dim()) if i != axis)
        n = data.numel() // max(data.shape[axis], 1)
        g32 = torch.ones_like(gamma).float() if fix_gamma else gamma.float()
        inv_b = inv.reshape(bshape).to(dt)
        mean_b = mean.reshape(bshape).to(dt)
        xhat = (data - mean_b) * inv_b
        if dt == torch.bfloat16:
            s_dy, s_dyxhat = pallas_bn.bn_grad_sums(dy, data, mean, inv,
                                                    axis)
            gi_b = (g32 * inv).reshape(bshape).to(dt)
            e_dy = (s_dy / n).reshape(bshape).to(dt)
            e_dyxhat = (s_dyxhat / n).reshape(bshape).to(dt)
            dx = gi_b * (dy - e_dy - xhat * e_dyxhat)
            dbeta = s_dy.to(gamma.dtype)
            dgamma = torch.zeros_like(gamma) if fix_gamma \
                else s_dyxhat.to(gamma.dtype)
            return dx, dgamma, dbeta, None, None, None
        dxhat = dy * g32.reshape(bshape).to(dt)
        e_dxhat = (dxhat.sum(dims, dtype=torch.float32) / n).reshape(bshape)
        e_dxhat_xhat = ((dxhat * xhat).sum(dims, dtype=torch.float32)
                        / n).reshape(bshape)
        dx = inv_b * (dxhat - e_dxhat.to(dt) - xhat * e_dxhat_xhat.to(dt))
        dbeta = dy.sum(dims, dtype=torch.float32).to(gamma.dtype)
        dgamma = torch.zeros_like(gamma) if fix_gamma else \
            (dy * xhat).sum(dims, dtype=torch.float32).to(gamma.dtype)
        return dx, dgamma, dbeta, None, None, None


def _bn_train(eps, axis, fix_gamma):
    """``bn(data, gamma, beta) -> (out, mean, var)``, training-mode
    BatchNorm over channel ``axis`` (the JAX package's ``_bn_train``
    factory, same signature)."""
    def bn(data, gamma, beta):
        return _BNTrain.apply(data, gamma, beta, float(eps), int(axis),
                              bool(fix_gamma))
    return bn
