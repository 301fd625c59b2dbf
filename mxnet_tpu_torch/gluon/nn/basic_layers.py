"""Gluon basic layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (reference
``python/mxnet/gluon/nn/basic_layers.py``): Sequential, HybridSequential,
Dense, Dropout, BatchNorm, InstanceNorm, LayerNorm, Embedding, Flatten,
Activation, LeakyReLU, Lambda, and the transformer family's
MultiHeadAttention and TransformerBlock (over the fused
``MultiHeadAttention`` op, kernels K1/K4 on the card).  Each layer
resolves its deferred parameter shapes from its input's shape.  ``MoE``
comes with a later slice.
"""
from __future__ import annotations

from ..block import Block, HybridBlock
from ...base import later_slice

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "Embedding", "Flatten", "Activation",
           "LeakyReLU", "Lambda", "HybridLambda", "MultiHeadAttention",
           "MoE",
           "TransformerBlock"]


class Sequential(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class Dense(HybridBlock):
    """Fully connected (reference ``Dense``): deferred in_units."""

    def __init__(self, units, activation=None, use_bias=True,
                 flatten=True, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None

    def forward(self, x):
        from ... import ndarray as nd

        if self.weight._data is None:
            in_units = x.shape[-1] if not self._flatten else \
                int(_prod(x.shape[1:]))
            self.weight._shape_from_data((self._units, in_units))
        if self.bias is not None and self.bias._data is None:
            self.bias._shape_from_data((self._units,))
        args = [x, self.weight.data()]
        if self.bias is not None:
            args.append(self.bias.data())
        out = nd.FullyConnected(*args, num_hidden=self._units,
                                flatten=self._flatten,
                                no_bias=self.bias is None)
        if self._activation:
            out = nd.Activation(out, act_type=self._activation)
        return out

    hybrid_forward = None


def _prod(t):
    p = 1
    for v in t:
        p *= v
    return p


class Dropout(HybridBlock):
    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def forward(self, x):
        from ... import ndarray as nd

        return nd.Dropout(x, p=self._rate)


class BatchNorm(HybridBlock):
    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer,
                allow_deferred_init=True, differentiable=False)

    def forward(self, x):
        from ... import ndarray as nd

        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            if p._data is None:
                p._shape_from_data((c,))
        return nd.BatchNorm(x, self.gamma.data(), self.beta.data(),
                            self.running_mean.data(),
                            self.running_var.data(),
                            axis=self._axis, momentum=self._momentum,
                            eps=self._epsilon, fix_gamma=not self._scale,
                            use_global_stats=self._use_global_stats)


class InstanceNorm(HybridBlock):
    def __init__(self, epsilon=1e-5, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init="ones",
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init="zeros",
                                        allow_deferred_init=True)

    def forward(self, x):
        from ... import ndarray as nd

        c = x.shape[1]
        for p in (self.gamma, self.beta):
            if p._data is None:
                p._shape_from_data((c,))
        return nd.InstanceNorm(x, self.gamma.data(), self.beta.data(),
                               eps=self._epsilon)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init="ones",
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init="zeros",
                                        allow_deferred_init=True)

    def forward(self, x):
        from ... import ndarray as nd

        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            if p._data is None:
                p._shape_from_data((c,))
        return nd.LayerNorm(x, self.gamma.data(), self.beta.data(),
                            axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def forward(self, x):
        from ... import ndarray as nd

        return nd.Embedding(x, self.weight.data(),
                            input_dim=self._input_dim,
                            output_dim=self._output_dim)


class Flatten(HybridBlock):
    def forward(self, x):
        from ... import ndarray as nd

        return nd.Flatten(x)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def forward(self, x):
        from ... import ndarray as nd

        return nd.Activation(x, act_type=self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        from ... import ndarray as nd

        return nd.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class Lambda(Block):
    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


HybridLambda = Lambda


class MultiHeadAttention(HybridBlock):
    """Causal multi-head self-attention over the fused
    ``MultiHeadAttention`` op (the Gluon face of the transformer family;
    ``seq_parallel=True``, ring attention, comes with a later slice)."""

    def __init__(self, num_heads, causal=True, seq_parallel=False,
                 in_units=0, weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._num_heads = num_heads
        self._causal = causal
        self._seq_parallel = seq_parallel
        with self.name_scope():
            self.in_weight = self.params.get(
                "in_weight", shape=(3 * in_units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            self.in_bias = self.params.get(
                "in_bias", shape=(3 * in_units,), init="zeros",
                allow_deferred_init=True)
            self.out_weight = self.params.get(
                "out_weight", shape=(in_units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            self.out_bias = self.params.get(
                "out_bias", shape=(in_units,), init="zeros",
                allow_deferred_init=True)

    def forward(self, x):
        from ... import ndarray as nd

        c = x.shape[-1]
        for p, shp in ((self.in_weight, (3 * c, c)),
                       (self.in_bias, (3 * c,)),
                       (self.out_weight, (c, c)),
                       (self.out_bias, (c,))):
            if p._data is None:
                p._shape_from_data(shp)
        return nd.MultiHeadAttention(
            x, self.in_weight.data(), self.in_bias.data(),
            self.out_weight.data(), self.out_bias.data(),
            num_heads=self._num_heads, causal=self._causal,
            seq_parallel=self._seq_parallel)


class MoE(HybridBlock):
    """Top-k routed mixture-of-experts feed-forward: in a later slice of
    the port (the routed MoE op and its expert parallelism)."""

    def __init__(self, num_experts, *args, **kwargs):
        raise later_slice("gluon.nn.MoE", num_experts)


class TransformerBlock(HybridBlock):
    """Pre-norm decoder block: x + MHA(LN(x)); x + FFN(LN(x)) with GELU
    (mirrors ``models/transformer.transformer_block`` on the Gluon
    side)."""

    def __init__(self, d_model, num_heads, d_ff=None, seq_parallel=False,
                 **kwargs):
        super().__init__(**kwargs)
        d_ff = d_ff or 4 * d_model
        with self.name_scope():
            self.ln1 = LayerNorm()
            self.attn = MultiHeadAttention(num_heads,
                                           seq_parallel=seq_parallel)
            self.ln2 = LayerNorm()
            self.ffn1 = Dense(d_ff, flatten=False)
            self.ffn2 = Dense(d_model, flatten=False)

    def forward(self, x):
        from ... import ndarray as nd

        h = self.attn(self.ln1(x))
        x = x + h
        h = self.ffn1(self.ln2(x))
        h = nd.Activation(h, act_type="gelu")
        return x + self.ffn2(h)
