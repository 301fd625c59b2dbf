"""Functional transformer decoder for the serving runtime.

Counterpart of ``mxnet_tpu/serve/model.py``: the same network as plain
functions over one parameter dict under the training graph's names
(``tok_embed_weight``, ``blk{i}_attn_in_weight`` ...), specialised five
ways — the full-context reference forward, the bucketed prefill (full
forward plus KV page writes), the single-token decode step over every
slot, and speculative decoding's two steps: the ``K + 1``-row verify and
the draft's ``K + 1``-step proposal scan.  Op semantics follow the
training kernels: ``FullyConnected``'s ``(out, in)`` weight layout,
``LayerNorm`` at eps 1e-5, the head split ``(n, t, h, d) -> (n, h, t,
d)`` and the tanh-approximate GELU.

Bit-exactness contract: with ``exact=True`` every projection runs the
M-invariant kernel K3 (:func:`..ops.linear.mi_linear`) and attention
runs K1/K2, which share one online-softmax step, so a token decoded
through the paged KV cache is bit-identical to the same position of a
full-context forward.  The oracle is :func:`reference_last_logits`, the
full forward padded to the next ``page_size`` multiple with
``block = page_size`` — the attention-block geometry of the paged path.

Where the JAX functions return donated copies of the KV pools, these
update the pools in place and return only tokens and logits.  Every
argument that changes between calls is a tensor (prefill's ``length``
and ``offset`` too) and nothing reads a value back to the host, so each
function can be captured once as a CUDA graph and replayed over the same
buffers (``session.py``).

Quantization (``quantize.py``), per precision as in the JAX package:
weight-only, where a params entry is a ``{"q", "s"}`` record that the
projections take as it is (kernel K3q dequantizes each weight before
K3's chain) and the embeddings dequantize the rows they gather; and
quantized KV pages, where each token's K and V rows are quantized per
row as they are written (kernel K9) and dequantized inside the paged
attention kernel (K2q).  The oracle then is :func:`reference_last_logits`
over the dequantized params with ``kv_quant``, whose forward
fake-quantizes its K and V per token row with the plain form of K9.
Hybrid window/SSM layers are ported in a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import quantize as Q
from ..base import MXNetError, get_env, later_slice, resolve_device
from ..ops.attention import flash_attention, paged_attention
from ..ops.linear import mi_linear

__all__ = ["ModelConfig", "exact_mode", "init_params", "params_from_numpy",
           "config_from_params", "full_forward", "prefill_forward",
           "decode_step", "verify_step", "draft_propose",
           "reference_last_logits"]


def exact_mode():
    """Default for the ``exact`` knob (``MXNET_SERVE_EXACT``, default 1):
    bit-exact M-invariant projections vs plain products."""
    return get_env("MXNET_SERVE_EXACT", True, bool)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static decoder geometry.  ``window``/``layer_kinds`` exist for
    parity with the JAX package; anything but the classic all-full stack
    is a later slice and raises in :meth:`validate`."""
    vocab_size: int
    num_layers: int
    d_model: int
    num_heads: int
    max_len: int          # pos_embed rows == the context ceiling
    window: int = 0
    layer_kinds: tuple = ()

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    def validate(self):
        if self.d_model % self.num_heads:
            raise MXNetError("d_model %d not divisible by num_heads %d"
                             % (self.d_model, self.num_heads))
        if self.window:
            raise later_slice("ModelConfig.window", self.window)
        if set(self.layer_kinds) - {"full"}:
            raise later_slice("ModelConfig.layer_kinds", self.layer_kinds)
        return self


def _layer_norm(x, gamma, beta):
    """Training ``LayerNorm`` semantics: last axis, eps 1e-5.  One row per
    reduction, so it is M-invariant as-is (``chip_smoke.py`` checks that
    on the card)."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps=1e-5)


def init_params(cfg, seed=0, scale=0.02, device=None):
    """Fresh float32 parameters under the training graph's names, drawn
    from a ``torch.Generator`` on ``device`` (default: the card).  The
    JAX package draws from ``jax.random``, so the two give different
    weights from one seed; tests carry weights across with
    :func:`params_from_numpy`."""
    cfg.validate()
    device = resolve_device(device, "init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    c, v = cfg.d_model, cfg.vocab_size

    def normal(*shape):
        return scale * torch.randn(shape, generator=gen, device=device,
                                   dtype=torch.float32)

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    params = {
        "tok_embed_weight": normal(v, c),
        "pos_embed": normal(1, cfg.max_len, c),
        "final_ln_gamma": const(1.0, c),
        "final_ln_beta": const(0.0, c),
        "lm_head_weight": normal(v, c),
        "lm_head_bias": const(0.0, v),
    }
    for i in range(cfg.num_layers):
        params.update({
            "blk%d_ln1_gamma" % i: const(1.0, c),
            "blk%d_ln1_beta" % i: const(0.0, c),
            "blk%d_attn_in_weight" % i: normal(3 * c, c),
            "blk%d_attn_in_bias" % i: const(0.0, 3 * c),
            "blk%d_attn_out_weight" % i: normal(c, c),
            "blk%d_attn_out_bias" % i: const(0.0, c),
            "blk%d_ln2_gamma" % i: const(1.0, c),
            "blk%d_ln2_beta" % i: const(0.0, c),
            "blk%d_ffn1_weight" % i: normal(4 * c, c),
            "blk%d_ffn1_bias" % i: const(0.0, 4 * c),
            "blk%d_ffn2_weight" % i: normal(c, 4 * c),
            "blk%d_ffn2_bias" % i: const(0.0, c),
        })
    return params


def _codes_from(name, val):
    """A record's codes as int8, or as uint8 bytes for e4m3 (an
    ``ml_dtypes`` e4m3 array is read through its bytes)."""
    if not torch.is_tensor(val):
        arr = np.asarray(val)
        if arr.dtype.name == "float8_e4m3fn":
            arr = arr.view(np.uint8)
        val = torch.from_numpy(np.array(arr))
    elif val.dtype == torch.float8_e4m3fn:
        val = val.view(torch.uint8)
    if val.dtype not in (torch.int8, torch.uint8):
        raise MXNetError("quantized parameter %r: codes of dtype %s (int8 "
                         "or e4m3 expected)" % (name, val.dtype))
    return val


def params_from_numpy(np_params, device=None):
    """The JAX package's flat parameter dict (numpy arrays, or tensors,
    under the training names) as the port's tensors on ``device``
    (default: the card): float32, and quantized ``{"q", "s"}`` records
    as int8 or uint8 (e4m3 bytes) codes with float32 scales.
    ``data``/``softmax_label`` are dropped as the JAX session drops
    them."""
    device = resolve_device(device, "params_from_numpy")

    def f32(val):
        if not torch.is_tensor(val):
            val = torch.from_numpy(np.array(val, dtype=np.float32))
        return val.to(device=device, dtype=torch.float32).contiguous()

    out = {}
    for name, val in np_params.items():
        if name in ("data", "softmax_label"):
            continue
        if isinstance(val, dict):
            if not Q.is_quantized(val):
                raise MXNetError("parameter %r: a dict that is not a "
                                 "quantized {\"q\", \"s\"} record: %s"
                                 % (name, sorted(val)))
            out[name] = {"q": _codes_from(name, val["q"]).to(device)
                         .contiguous(), "s": f32(val["s"])}
        else:
            out[name] = f32(val)
    return out


def config_from_params(params, num_heads):
    """Derive the :class:`ModelConfig` from parameter shapes (everything
    except ``num_heads``, which appears in no shape)."""
    if "tok_embed_weight" not in params or "pos_embed" not in params:
        raise MXNetError(
            "not a transformer LM parameter dict (expected "
            "tok_embed_weight / pos_embed; got %s)" % sorted(params)[:8])
    def shape(v):  # a quantized record keeps the shape on its codes
        return (v["q"] if Q.is_quantized(v) else v).shape

    vocab, d_model = shape(params["tok_embed_weight"])
    max_len = shape(params["pos_embed"])[1]
    n = 0
    while "blk%d_attn_in_weight" % n in params:
        n += 1
    if n == 0:
        raise MXNetError("no blk0_attn_in_weight — zero decoder layers?")
    return ModelConfig(vocab_size=int(vocab), num_layers=n,
                       d_model=int(d_model), num_heads=int(num_heads),
                       max_len=int(max_len)).validate()


def _tok_rows(params, tokens):
    """Token embeddings of ``tokens`` as float32.  A quantized table
    dequantizes only the rows it gathers: the same values as gathering
    from the dequantized table."""
    w, idx = params["tok_embed_weight"], tokens.long()
    if Q.is_quantized(w):
        return Q.dequantize_array(w["q"][idx], w["s"][idx])
    return w[idx]


def _pos_rows(params, pos):
    """Rows ``pos`` (an index tensor or a slice) of ``pos_embed[0]`` as
    float32; a quantized table has one scale (its axis 0 is 1 long)."""
    w = params["pos_embed"]
    if Q.is_quantized(w):
        return Q.dequantize_array(w["q"][0][pos], w["s"][0])
    return w[0][pos]


def _heads(x, n, t, h, d):
    """(n, t, h*d) -> (n, h, t, d), contiguous."""
    return x.reshape(n, t, h, d).transpose(1, 2).contiguous()


def _qkv(params, i, x, exact):
    hdn = _layer_norm(x, params["blk%d_ln1_gamma" % i],
                      params["blk%d_ln1_beta" % i])
    qkv = mi_linear(hdn, params["blk%d_attn_in_weight" % i],
                    params["blk%d_attn_in_bias" % i], exact)
    return qkv.chunk(3, dim=-1)


def _attn_out(params, i, x, att, exact):
    """Merge heads of (n, h, t, d) attention output, project, add."""
    n, h, t, d = att.shape
    ctx = att.transpose(1, 2).reshape(n, t, h * d)
    return x + mi_linear(ctx, params["blk%d_attn_out_weight" % i],
                         params["blk%d_attn_out_bias" % i], exact)


def _block_mlp(params, i, x, exact):
    hdn = _layer_norm(x, params["blk%d_ln2_gamma" % i],
                      params["blk%d_ln2_beta" % i])
    hdn = mi_linear(hdn, params["blk%d_ffn1_weight" % i],
                    params["blk%d_ffn1_bias" % i], exact)
    hdn = F.gelu(hdn, approximate="tanh")  # jax.nn.gelu's default
    hdn = mi_linear(hdn, params["blk%d_ffn2_weight" % i],
                    params["blk%d_ffn2_bias" % i], exact)
    return x + hdn


def _lm_head(params, x, exact):
    x = _layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"])
    return mi_linear(x, params["lm_head_weight"], params["lm_head_bias"],
                     exact)


def _kv_append(pools, i, pages, offsets, k_rows, v_rows):
    """Write (N, H, D) K and V rows into layer ``i`` of the page pools at
    (page, offset), in place: as they are into fp32 pools; quantized per
    row into code and scale pools (kernel K9, the JAX package's
    ``_kv_append`` under ``kv_quant``).  ``pools`` is ``(k_pool, v_pool,
    k_scale, v_scale)``, the scales None for fp32 pages.  Only trash-page
    rows can collide, and nothing reads the trash page."""
    k_pool, v_pool, k_scale, v_scale = pools
    if k_scale is not None:
        Q.kv_append_quantized(k_pool[i], v_pool[i], k_scale[i], v_scale[i],
                              pages, offsets, k_rows, v_rows)
    else:
        k_pool[i, pages, offsets] = k_rows
        v_pool[i, pages, offsets] = v_rows


def _paged(q, pools, i, tables, horizons, exact):
    """Layer ``i``'s paged attention (K2, or K2q over quantized pages)."""
    k_pool, v_pool, k_scale, v_scale = pools
    quantized = k_scale is not None
    return paged_attention(q, k_pool[i], v_pool[i], tables, horizons,
                           mi=exact, k_scale=k_scale[i] if quantized else None,
                           v_scale=v_scale[i] if quantized else None)


def _kv_fake_quant(k, v, kv_quant):
    """The oracle's half of the per-precision contract: quantize and
    dequantize the (n, H, T, D) keys and values per token row with the
    plain form of what the paged path writes, so the full-context forward
    sees the values K2q reconstructs."""
    if not kv_quant:
        return k, v

    def fake(t):
        q, s = Q.kv_quantize_rows(t.transpose(1, 2), kv_quant)
        return Q.kv_dequantize(q, s).transpose(1, 2).contiguous()

    return fake(k), fake(v)


def full_forward(params, tokens, cfg, exact=None, block=None, kv_quant=""):
    """Full-context forward: (n, T) int tokens -> (n, T, V) logits.
    ``kv_quant`` fake-quantizes each layer's keys and values per token
    row (:func:`_kv_fake_quant`)."""
    if exact is None:
        exact = exact_mode()
    kv_quant = Q.quant_mode(kv_quant)
    n, t = tokens.shape
    if t > cfg.max_len:
        raise MXNetError("sequence length %d > model max_len %d"
                         % (t, cfg.max_len))
    h, d = cfg.num_heads, cfg.head_dim
    x = _tok_rows(params, tokens) + _pos_rows(params, slice(0, t))
    for i in range(cfg.num_layers):
        q, k, v = (_heads(z, n, t, h, d) for z in _qkv(params, i, x, exact))
        k, v = _kv_fake_quant(k, v, kv_quant)
        att = flash_attention(q, k, v, causal=True, block=block, mi=exact)
        x = _attn_out(params, i, x, att, exact)
        x = _block_mlp(params, i, x, exact)
    return _lm_head(params, x, exact)


def prefill_forward(params, tokens, length, offset, table_row, k_pool,
                    v_pool, cfg, page_size, exact=None, k_scale=None,
                    v_scale=None):
    """Bucketed prefill over one page-aligned chunk of a prompt.

    tokens: (1, Tb) chunk padded to the bucket length (a multiple of
    ``page_size``); ``length``: real tokens in this chunk; ``offset``:
    absolute position of its first token (both ints or 0-dim tensors on
    the tokens' device); table_row: (max_pages,) int32
    page ids, entries past the slot's pages pointing at the trash page;
    ``k_scale``/``v_scale``: the scale pools of quantized pages.
    Writes the chunk's K/V into ``k_pool``/``v_pool`` **in place** and
    attends row ``j`` over every key at or before its absolute position
    (horizon ``offset + j + 1``), cached prefix pages included.  Rows
    whose page index runs past the table go to the trash page (a clipped
    index would alias the slot's last real page).  Returns
    ``(first_token, last_logits)`` at chunk row ``length - 1``; the LM
    head runs on that row alone, which M-invariance makes the same bits
    as taking the row of the whole chunk's logits; the row is picked by
    a device index, so no value goes to the host."""
    if exact is None:
        exact = exact_mode()
    _, t_b = tokens.shape
    if t_b % page_size:
        raise MXNetError("bucket length %d not a multiple of page size %d"
                         % (t_b, page_size))
    h, d = cfg.num_heads, cfg.head_dim
    dev = tokens.device
    length = torch.as_tensor(length, dtype=torch.long, device=dev)
    offset = torch.as_tensor(offset, dtype=torch.long, device=dev)
    abs_pos = offset + torch.arange(t_b, device=dev)
    pos = abs_pos.clamp(0, cfg.max_len - 1)
    x = _tok_rows(params, tokens) + _pos_rows(params, pos)
    horizons = (abs_pos + 1).to(torch.int32).reshape(1, t_b)
    pages, offsets = _write_rows(table_row.reshape(1, -1),
                                 abs_pos.reshape(1, t_b), page_size,
                                 k_pool.shape[1] - 1)
    tables = table_row.reshape(1, -1)
    pools = (k_pool, v_pool, k_scale, v_scale)
    for i in range(cfg.num_layers):
        q, k, v = _qkv(params, i, x, exact)
        _kv_append(pools, i, pages, offsets, k.reshape(t_b, h, d),
                   v.reshape(t_b, h, d))
        att = _paged(_heads(q, 1, t_b, h, d), pools, i, tables, horizons,
                     exact)
        x = _attn_out(params, i, x, att, exact)
        x = _block_mlp(params, i, x, exact)
    last = _lm_head(params, x[0].index_select(0, (length - 1).reshape(1)),
                    exact)[0]
    return last.argmax(-1).to(torch.int32), last


def _write_rows(tables, abs_pos, page_size, trash):
    """(page, offset) of the KV rows at absolute positions ``abs_pos``
    (S, R) through ``tables`` (S, max_pages), flattened to (S * R,).  A
    row whose page index runs past the table goes to the trash page (a
    clipped index would alias the slot's last real page)."""
    max_pages = tables.shape[1]
    idx = abs_pos.long() // page_size
    pages = torch.where(idx < max_pages,
                        tables.long().gather(1, idx.clamp(0, max_pages - 1)),
                        torch.full_like(idx, trash))
    return pages.reshape(-1), (abs_pos.long() % page_size).reshape(-1)


def decode_step(params, tokens, lengths, tables, k_pool, v_pool, cfg,
                page_size, exact=None, k_scale=None, v_scale=None):
    """One continuous-batching decode step for every slot at once.

    tokens: (S,) int — each slot's previous output token; lengths: (S,)
    int32 KV rows already cached per slot (the new token's position);
    tables: (S, max_pages) int32 (inactive slots: all-trash rows, length
    0).  Appends each slot's new K/V at ``lengths`` **in place** in the
    pools, attends over the slot's pages, and returns
    ``(next_tokens (S,), logits (S, V))``."""
    if exact is None:
        exact = exact_mode()
    s = tokens.shape[0]
    h, d = cfg.num_heads, cfg.head_dim
    max_pages = tables.shape[1]
    lengths = lengths.to(torch.int32)
    pos = lengths.long().clamp(0, cfg.max_len - 1)
    x = _tok_rows(params, tokens) + _pos_rows(params, pos)
    x = x[:, None, :]                                     # (S, 1, C)
    page_slot = (lengths.long() // page_size).clamp(0, max_pages - 1)
    page = tables.long().gather(1, page_slot[:, None])[:, 0]
    offset = lengths.long() % page_size
    horizons = lengths + 1
    pools = (k_pool, v_pool, k_scale, v_scale)
    for i in range(cfg.num_layers):
        q, k, v = _qkv(params, i, x, exact)
        _kv_append(pools, i, page, offset, k.reshape(s, h, d),
                   v.reshape(s, h, d))
        att = _paged(q.reshape(s, h, 1, d), pools, i, tables, horizons, exact)
        x = _attn_out(params, i, x, att, exact)
        x = _block_mlp(params, i, x, exact)
    logits = _lm_head(params, x[:, 0], exact)
    return logits.argmax(-1).to(torch.int32), logits


def verify_step(params, tokens, lengths, tables, k_pool, v_pool, cfg,
                page_size, exact=None, k_scale=None, v_scale=None):
    """Speculative decoding's verify: every slot advances ``W = K + 1``
    teacher-forced positions in one fixed-shape step.

    tokens: (S, W) int — per slot, the last committed token followed by
    the draft's K proposals; lengths: (S,) int32 committed KV rows (the
    position of ``tokens[:, 0]``); tables: (S, max_pages) int32.  Writes
    all W rows' KV at ``lengths .. lengths + W - 1`` **in place** (rows
    past the table go to the trash page) and attends row ``j`` over
    ``lengths + j + 1`` keys, the causal horizon as a per-row length.
    Returns ``(greedy (S, W), logits (S, W, V))``, both on the device.

    With ``exact=True`` every op is the M-invariant form of the matching
    :func:`decode_step` op (K3 on S·W rows, K2 with per-row horizons, which
    equals K1 and so the decode kernel row for row), so row ``j`` is bit
    for bit the ``j``-th of W serial decode steps fed the same tokens —
    which makes greedy acceptance an integer comparison."""
    if exact is None:
        exact = exact_mode()
    s, w = tokens.shape
    h, d = cfg.num_heads, cfg.head_dim
    lengths = lengths.to(torch.int32)
    abs_pos = lengths[:, None] + torch.arange(w, dtype=torch.int32,
                                              device=lengths.device)
    pos = abs_pos.long().clamp(0, cfg.max_len - 1)
    x = _tok_rows(params, tokens) + _pos_rows(params, pos)  # (S, W, C)
    horizons = abs_pos + 1
    pages, offsets = _write_rows(tables, abs_pos, page_size,
                                 k_pool.shape[1] - 1)
    pools = (k_pool, v_pool, k_scale, v_scale)
    for i in range(cfg.num_layers):
        q, k, v = _qkv(params, i, x, exact)
        _kv_append(pools, i, pages, offsets, k.reshape(s * w, h, d),
                   v.reshape(s * w, h, d))
        att = _paged(_heads(q, s, w, h, d), pools, i, tables, horizons,
                     exact)
        x = _attn_out(params, i, x, att, exact)
        x = _block_mlp(params, i, x, exact)
    logits = _lm_head(params, x, exact)
    return logits.argmax(-1).to(torch.int32), logits


def draft_propose(params, tokens, n_feed, lengths, tables, k_pool, v_pool,
                  cfg, page_size, exact=None, k_scale=None, v_scale=None):
    """The draft model's ``W``-step scan, one call that both *ingests*
    committed tokens and *proposes* continuations.

    tokens: (S, W) int teacher tokens; n_feed: (S,) int — step ``j``
    feeds ``tokens[:, j]`` while ``j < n_feed`` and the previous step's
    greedy token after that (a ``torch.where`` on the device, so the loop
    reads nothing back and is captured whole).  ``n_feed = 1`` proposes
    (feed the last committed token, then run on); ``n_feed = W`` is pure
    teacher forcing (prompt ingestion in W-token chunks).  Step ``j``
    appends its KV at ``lengths + j`` **in place**.  Returns outs (S, W):
    ``outs[:, j]`` is the greedy token after position ``lengths + j``."""
    w = tokens.shape[1]
    lengths = lengths.to(torch.int32)
    prev = tokens[:, 0]
    outs = []
    for j in range(w):
        tok = torch.where(n_feed > j, tokens[:, j], prev)
        prev, _ = decode_step(params, tok, lengths + j, tables, k_pool,
                              v_pool, cfg, page_size, exact, k_scale,
                              v_scale)
        outs.append(prev)
    return torch.stack(outs, dim=1)


def reference_last_logits(params, seq, cfg, page_size, exact=None,
                          kv_quant=""):
    """Bit-exactness oracle for the serving path: the full-context
    forward over ``seq`` padded to the next ``page_size`` multiple, with
    ``block = page_size`` (the attention-block geometry of the paged
    path), logits at the last real position.  ``kv_quant`` pins the oracle
    to a KV precision (the forward fake-quantizes its keys and values per
    token row); for a weight-quantized session pass its
    ``dequantized_params()``."""
    exact = exact_mode() if exact is None else bool(exact)
    seq = [int(t) for t in seq]
    if not seq:
        raise MXNetError("reference_last_logits: empty sequence")
    pad = (-len(seq)) % int(page_size)
    device = params["final_ln_gamma"].device
    toks = torch.tensor([seq + [0] * pad], dtype=torch.int64, device=device)
    logits = full_forward(params, toks, cfg, exact=exact,
                          block=int(page_size), kv_quant=kv_quant)
    return logits[0, len(seq) - 1]
