"""Decoder-only transformer language model (GPT-style).

The port's copy of ``mxnet_tpu/models/transformer.py``, built over the
port's ``symbol``: the same graph, node names and JSON.  Pre-norm
residual blocks (``LayerNorm``, ``MultiHeadAttention``, GELU MLP from
``FullyConnected``), a token ``Embedding`` plus a learned positional
table, and the LM head ``SoftmaxOutput(normalization="batch")`` over the
flattened (batch * seq) rows.  The mixture-of-experts MLP and residual
dropout come with later slices and raise here.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import later_slice


def transformer_block(x, idx, d_model, num_heads, d_ff,
                      seq_parallel=False):
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x))."""
    h = sym.LayerNorm(x, name="blk%d_ln1" % idx)
    h = sym.MultiHeadAttention(h, num_heads=num_heads, causal=True,
                               seq_parallel=seq_parallel,
                               name="blk%d_attn" % idx)
    x = x + h
    h = sym.LayerNorm(x, name="blk%d_ln2" % idx)
    h = sym.FullyConnected(h, num_hidden=d_ff, flatten=False,
                           name="blk%d_ffn1" % idx)
    h = sym.Activation(h, act_type="gelu", name="blk%d_gelu" % idx)
    h = sym.FullyConnected(h, num_hidden=d_model, flatten=False,
                           name="blk%d_ffn2" % idx)
    return x + h


def get_symbol(vocab_size=32000, num_layers=12, d_model=768, num_heads=12,
               d_ff=None, seq_len=1024, seq_parallel=False,
               moe_experts=0, moe_top_k=2, moe_aux_coef=0.01,
               expert_parallel=False, moe_capacity_factor=1.25,
               dropout=0.0, **kwargs):
    """The LM-loss symbol over (batch, seq) token ids with next-token
    labels.  ``seq_parallel=True`` is accepted into the graph (its
    MultiHeadAttention raises when run); ``moe_experts > 0`` and
    ``dropout > 0`` raise now."""
    if moe_experts:
        raise later_slice("moe_experts", moe_experts)
    if dropout:
        raise later_slice("dropout", dropout)
    d_ff = d_ff or 4 * d_model
    data = sym.Variable("data")          # (N, T) token ids
    label = sym.Variable("softmax_label")
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                      name="tok_embed")
    pos = sym.Variable("pos_embed", shape=(1, seq_len, d_model),
                       init="normal")
    x = sym.broadcast_add(x, pos)
    for i in range(num_layers):
        x = transformer_block(x, i, d_model, num_heads, d_ff,
                              seq_parallel=seq_parallel)
    x = sym.LayerNorm(x, name="final_ln")
    x = sym.Reshape(x, shape=(-1, d_model))
    logits = sym.FullyConnected(x, num_hidden=vocab_size, flatten=False,
                                name="lm_head")
    label_f = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, label_f, name="softmax",
                             normalization="batch")


def count_params(vocab_size=32000, num_layers=12, d_model=768,
                 num_heads=12, d_ff=None, seq_len=1024):
    """Analytic parameter count (for MFU accounting)."""
    d_ff = d_ff or 4 * d_model
    per_block = (3 * d_model * d_model + 3 * d_model      # qkv
                 + d_model * d_model + d_model            # attn out
                 + d_model * d_ff + d_ff                  # ffn1
                 + d_ff * d_model + d_model               # ffn2
                 + 4 * d_model)                           # 2 LN
    return (vocab_size * d_model                          # tok embed
            + seq_len * d_model                           # pos embed
            + num_layers * per_block
            + 2 * d_model                                 # final LN
            + d_model * vocab_size + vocab_size)          # lm head
