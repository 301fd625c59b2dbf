"""Neural-network layer operators of the transformer LM.

Counterpart of ``mxnet_tpu/ops/nn_ops.py`` for ``FullyConnected``,
``Activation``, ``LayerNorm``, ``SoftmaxOutput`` and
``MultiHeadAttention``; the other layers (convolution, pooling,
BatchNorm, dropout, ...) come with later slices.

* Projections are plain matmuls (cuBLAS on the card), as the JAX package
  leaves them to XLA; the bias is added after the product, in the
  product's dtype, as there.
* ``SoftmaxOutput`` keeps the reference's loss-layer contract as a
  ``torch.autograd.Function``: its backward is ``(p - onehot(label)) *
  grad_scale`` times the incoming cotangent (ones under the reference's
  seeding; a loss scale riding the cotangent passes through).
* ``MultiHeadAttention`` dispatches the score/value contraction through
  ``ops/attention.py::dot_product_attention`` — kernels K1 (forward) and
  K4 (backward) on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, later_slice
from .registry import register


@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected(attrs, data, weight, *bias):
    """Reference ``src/operator/fully_connected.cc``: Y = X W^T + b."""
    if bool(attrs.get("flatten", True)) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = F.linear(data, weight)
    if bias:
        out = out + bias[0]
    return out


_ACTIVATIONS = {
    "relu": torch.relu,
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
        grad = grad * torch.tensor(scale, dtype=p.dtype, device=p.device)
        return grad * g.to(grad.dtype), None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(attrs, data, label):
    """Reference ``src/operator/softmax_output-inl.h``: forward softmax,
    backward ``(softmax - onehot(label)) * grad_scale`` with
    use_ignore/ignore_label, multi_output and null/batch/valid
    normalization; the head gradient multiplies the result."""
    return _SoftmaxOutputFn.apply(data, label, attrs)


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
    qkv = F.linear(data, in_weight) + in_bias
    q, k, v = (x.reshape(n, t, num_heads, d).transpose(1, 2)
               for x in qkv.chunk(3, dim=-1))
    block = int(attrs["attn_block"]) if "attn_block" in attrs else None
    ctx = dot_product_attention(q, k, v, causal=causal,
                                impl=attrs.get("attn_impl") or None,
                                block=block,
                                window=int(attrs.get("window", 0)))
    ctx = ctx.transpose(1, 2).reshape(n, t, c)
    return F.linear(ctx, out_weight) + out_bias
