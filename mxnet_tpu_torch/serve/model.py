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

Hybrid stacks (``ModelConfig.layer_kinds``, per layer ``full``,
``window`` or ``ssm``; every kind reuses the block's attention weights):
a windowed layer attends over the last ``window`` keys, kept in a ring of
pages a slot (``kw_pool``/``vw_pool``: the ring pages of slot s are pool
pages ``s * RP .. s * RP + RP - 1``), written at ring page ``(pos //
page) % RP`` through the same row writer as the page pools (K9 under
``kv_quant``) and read by K2/K2q through a rotated table built on the
device (:func:`ring_table`), with each table row labelled by its absolute
position; an SSM layer runs the linear-attention recurrence
(:mod:`..ops.ssm_ops`, kernel K10) over a (H, D, D) fp32 state a slot
(``ssm_state``).  The oracle runs K1 with the window and K10 from a zero
state, the same operations a row, so the contract above holds for
hybrid stacks too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import quantize as Q
from ..base import MXNetError, get_env, resolve_device
from ..ops.attention import flash_attention, paged_attention
from ..ops.linear import mi_linear
from ..ops.ssm_ops import ssm_decay, ssm_scan

__all__ = ["ModelConfig", "exact_mode", "init_params", "params_from_numpy",
           "config_from_params", "full_forward", "prefill_forward",
           "decode_step", "verify_step", "draft_propose",
           "reference_last_logits", "ring_table"]


def exact_mode():
    """Default for the ``exact`` knob (``MXNET_SERVE_EXACT``, default 1):
    bit-exact M-invariant projections vs plain products."""
    return get_env("MXNET_SERVE_EXACT", True, bool)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static decoder geometry.  ``layer_kinds``/``window`` describe a
    hybrid stack: per layer ``"full"`` (paged full-context attention),
    ``"window"`` (attention over the last ``window`` keys, ring-buffered)
    or ``"ssm"`` (the linear-attention recurrence); ``()`` is all
    ``full``."""
    vocab_size: int
    num_layers: int
    d_model: int
    num_heads: int
    max_len: int          # pos_embed rows == the context ceiling
    window: int = 0       # sliding-window length of "window" layers
    layer_kinds: tuple = ()  # per-layer kind; () = all "full"

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    @property
    def kinds(self):
        """Per-layer kinds, expanded to ``num_layers`` entries."""
        return tuple(self.layer_kinds) or ("full",) * self.num_layers

    @property
    def hybrid(self):
        return any(k != "full" for k in self.kinds)

    def validate(self):
        if self.d_model % self.num_heads:
            raise MXNetError("d_model %d not divisible by num_heads %d"
                             % (self.d_model, self.num_heads))
        if self.layer_kinds:
            if len(self.layer_kinds) != self.num_layers:
                raise MXNetError("layer_kinds %r does not cover %d layers"
                                 % (self.layer_kinds, self.num_layers))
            bad = set(self.layer_kinds) - {"full", "window", "ssm"}
            if bad:
                raise MXNetError("unknown layer kinds %r" % sorted(bad))
            if "window" in self.layer_kinds and self.window < 1:
                raise MXNetError("windowed layers need window >= 1 (got %d)"
                                 % self.window)
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


def _paged(q, pools, i, tables, horizons, exact, window=0, k_pos0=None):
    """Layer ``i``'s paged attention (K2, or K2q over quantized pages);
    over a windowed layer's rings with ``window`` and ``k_pos0``."""
    k_pool, v_pool, k_scale, v_scale = pools
    quantized = k_scale is not None
    return paged_attention(q, k_pool[i], v_pool[i], tables, horizons,
                           mi=exact, k_scale=k_scale[i] if quantized else None,
                           v_scale=v_scale[i] if quantized else None,
                           window=window, k_pos0=k_pos0)


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


def _block_ssm(params, i, x, cfg, exact, state, row_valid=None,
               collect=False, out_state=None):
    """One SSM sublayer on (n, T, C): the block's q/k/v projections feed
    the recurrence (kernel K10) from ``state`` (n, H, D, D) float32, the
    state before row 0.  ``row_valid`` masks bucket padding out of the
    state; ``out_state`` receives the state after the last row (it may be
    ``state`` itself).  Returns ``(x + out, state[, states])``, states
    (T, n, H, D, D) with ``collect``.  K and V are used in registers and
    never stored, so ``kv_quant`` does not touch them."""
    n, t, c = x.shape
    h, d = cfg.num_heads, cfg.head_dim
    q, k, v = (z.reshape(n, t, h, d) for z in _qkv(params, i, x, exact))
    res = ssm_scan(q, k, v, state, ssm_decay(h, x.device),
                   row_valid=row_valid, collect=collect, out_state=out_state)
    ctx = res[0].reshape(n, t, c)
    out = x + mi_linear(ctx, params["blk%d_attn_out_weight" % i],
                        params["blk%d_attn_out_bias" % i], exact)
    return (out,) + tuple(res[1:])


def full_forward(params, tokens, cfg, exact=None, block=None, kv_quant=""):
    """Full-context forward: (n, T) int tokens -> (n, T, V) logits.
    ``kv_quant`` fake-quantizes each layer's keys and values per token
    row (:func:`_kv_fake_quant`).  Windowed layers run the flash forward
    with the window, SSM layers the recurrence from a zero state: the
    oracle of hybrid stacks."""
    if exact is None:
        exact = exact_mode()
    kv_quant = Q.quant_mode(kv_quant)
    n, t = tokens.shape
    if t > cfg.max_len:
        raise MXNetError("sequence length %d > model max_len %d"
                         % (t, cfg.max_len))
    h, d = cfg.num_heads, cfg.head_dim
    x = _tok_rows(params, tokens) + _pos_rows(params, slice(0, t))
    for i, kind in enumerate(cfg.kinds):
        if kind == "ssm":
            zero = torch.zeros((n, h, d, d), dtype=torch.float32,
                               device=x.device)
            x, _ = _block_ssm(params, i, x, cfg, exact, zero, out_state=zero)
        else:
            q, k, v = (_heads(z, n, t, h, d)
                       for z in _qkv(params, i, x, exact))
            k, v = _kv_fake_quant(k, v, kv_quant)
            att = flash_attention(q, k, v, causal=True, block=block, mi=exact,
                                  window=cfg.window if kind == "window" else 0)
            x = _attn_out(params, i, x, att, exact)
        x = _block_mlp(params, i, x, exact)
    return _lm_head(params, x, exact)


def ring_table(slots, pb_max, ring_pages, page_size):
    """The rotated tables of a windowed layer's rings, built on the device
    (inside a captured graph): (S, RP) int32 with ``table[s, j] =
    slots[s] * RP + (pb_max[s] + 1 + j) % RP``, the ring page holding
    absolute page ``pb_max[s] - RP + 1 + j`` (``pb_max``: each slot's
    newest page), and ``k_pos0`` (S,) int32, the absolute position of each
    table's row 0, ``(pb_max - RP + 1) * page`` — negative until the ring
    first wraps, and such rows mask out.  The JAX package's
    ``_ring_gather`` without the gather: pages keep their absolute
    boundaries, which keeps a ring row equal to the oracle's row."""
    j = torch.arange(ring_pages, device=pb_max.device)
    pb = pb_max.long()[:, None]
    table = slots.long()[:, None] * ring_pages + (pb + 1 + j) % ring_pages
    k_pos0 = (pb_max.long() - ring_pages + 1) * page_size
    return table.to(torch.int32), k_pos0.to(torch.int32)


def _ring_rows(slots, abs_pos, ring_pages, page_size):
    """Ring-page ids and offsets of the rows at positions ``abs_pos`` (S,
    R) of slots ``slots`` (S,), flattened to (S * R,): page ``(pos //
    page) % RP`` of the slot's ring — the JAX package's ``_ring_append``
    row ``pos % (RP * page)``."""
    apos = abs_pos.long()
    pages = slots.long()[:, None] * ring_pages + (apos // page_size) \
        % ring_pages
    return pages.reshape(-1), (apos % page_size).reshape(-1)


def _layers(cfg):
    """(layer, kind, the layer's index among its kind's pool layers) for
    every layer: ``full`` layers index the page pools, ``window`` layers
    the ring pools, ``ssm`` layers the state pool."""
    seen = dict.fromkeys(("full", "window", "ssm"), 0)
    for i, kind in enumerate(cfg.kinds):
        yield i, kind, seen[kind]
        seen[kind] += 1


def prefill_forward(params, tokens, length, offset, table_row, k_pool,
                    v_pool, cfg, page_size, exact=None, k_scale=None,
                    v_scale=None, kw_pool=None, vw_pool=None, kw_scale=None,
                    vw_scale=None, ssm_state=None, slot=None, ring_pages=0):
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
    a device index, so no value goes to the host.

    Hybrid stacks pass ``slot`` (a 0-dim tensor: rings and states are
    slot-indexed) and ``ring_pages``: windowed layers write every bucket
    row into the slot's ring at its position (as the JAX package does; the
    ring's extra page is there for the padding rows) and attend over the
    ring through its rotated table; SSM layers advance the slot's state
    across the chunk, its padding rows masked out of the recurrence, so
    the state crosses chunks."""
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
    offs = torch.arange(t_b, device=dev)
    abs_pos = offset + offs
    pos = abs_pos.clamp(0, cfg.max_len - 1)
    x = _tok_rows(params, tokens) + _pos_rows(params, pos)
    horizons = (abs_pos + 1).to(torch.int32).reshape(1, t_b)
    pages, offsets = _write_rows(table_row.reshape(1, -1),
                                 abs_pos.reshape(1, t_b), page_size,
                                 k_pool.shape[1] - 1)
    tables = table_row.reshape(1, -1)
    pools = (k_pool, v_pool, k_scale, v_scale)
    rings = (kw_pool, vw_pool, kw_scale, vw_scale)
    if cfg.hybrid:
        if slot is None:
            raise MXNetError("prefill_forward: a hybrid stack needs slot")
        slots = torch.as_tensor(slot, dtype=torch.long, device=dev).reshape(1)
    for i, kind, j in _layers(cfg):
        if kind == "ssm":
            state = ssm_state[j].index_select(0, slots)
            valid = (offs < length).reshape(1, t_b)  # padding: identity
            x, _ = _block_ssm(params, i, x, cfg, exact, state,
                              row_valid=valid, out_state=state)
            ssm_state[j].index_copy_(0, slots, state)
            x = _block_mlp(params, i, x, exact)
            continue
        q, k, v = _qkv(params, i, x, exact)
        q = _heads(q, 1, t_b, h, d)
        k, v = k.reshape(t_b, h, d), v.reshape(t_b, h, d)
        if kind == "window":
            rpages, roffs = _ring_rows(slots, abs_pos.reshape(1, t_b),
                                       ring_pages, page_size)
            _kv_append(rings, j, rpages, roffs, k, v)
            rtable, k_pos0 = ring_table(
                slots, (offset + t_b - 1).reshape(1) // page_size,
                ring_pages, page_size)
            att = _paged(q, rings, j, rtable, horizons, exact,
                         window=cfg.window, k_pos0=k_pos0)
        else:
            _kv_append(pools, j, pages, offsets, k, v)
            att = _paged(q, pools, j, tables, horizons, exact)
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
                page_size, exact=None, k_scale=None, v_scale=None,
                kw_pool=None, vw_pool=None, kw_scale=None, vw_scale=None,
                ssm_state=None, ring_pages=0):
    """One continuous-batching decode step for every slot at once.

    tokens: (S,) int — each slot's previous output token; lengths: (S,)
    int32 KV rows already cached per slot (the new token's position);
    tables: (S, max_pages) int32 (inactive slots: all-trash rows, length
    0).  Appends each slot's new K/V at ``lengths`` **in place** in the
    pools, attends over the slot's pages, and returns
    ``(next_tokens (S,), logits (S, V))``.

    Hybrid stacks: windowed layers write the token's K/V into slot s's
    ring at its position and attend over the ring's rotated table (newest
    page ``lengths // page``); SSM layers advance every slot's state one
    row, in place.  Idle slots write their own ring row and state, which
    alloc and prefill set again before anything reads them."""
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
    rings = (kw_pool, vw_pool, kw_scale, vw_scale)
    slots = torch.arange(s, device=tokens.device)
    if kw_pool is not None:
        rpages, roffs = _ring_rows(slots, lengths[:, None], ring_pages,
                                   page_size)
        rtable, k_pos0 = ring_table(slots, lengths.long() // page_size,
                                    ring_pages, page_size)
    for i, kind, j in _layers(cfg):
        if kind == "ssm":
            x, _ = _block_ssm(params, i, x, cfg, exact, ssm_state[j],
                              out_state=ssm_state[j])
            x = _block_mlp(params, i, x, exact)
            continue
        q, k, v = _qkv(params, i, x, exact)
        q = q.reshape(s, h, 1, d)
        k, v = k.reshape(s, h, d), v.reshape(s, h, d)
        if kind == "window":
            _kv_append(rings, j, rpages, roffs, k, v)
            att = _paged(q, rings, j, rtable, horizons, exact,
                         window=cfg.window, k_pos0=k_pos0)
        else:
            _kv_append(pools, j, page, offset, k, v)
            att = _paged(q, pools, j, tables, horizons, exact)
        x = _attn_out(params, i, x, att, exact)
        x = _block_mlp(params, i, x, exact)
    logits = _lm_head(params, x[:, 0], exact)
    return logits.argmax(-1).to(torch.int32), logits


def verify_step(params, tokens, lengths, tables, k_pool, v_pool, cfg,
                page_size, exact=None, k_scale=None, v_scale=None,
                kw_pool=None, vw_pool=None, kw_scale=None, vw_scale=None,
                ssm_state=None, ring_pages=0, limits=None):
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
    which makes greedy acceptance an integer comparison.

    Hybrid stacks roll back in O(1).  Windowed layers write all W rows
    into the rings; a rejected row's ring row is masked by the rolled-back
    length until the committed stream writes it again.  SSM layers scan
    with ``collect`` and, since a recurrence has no rows to mask, the
    acceptance count is computed here on the device from ``greedy`` and
    ``limits`` ((S,) int32 commit caps, the host's commit loop's
    comparison), and only each slot's state at its commit point is
    written back."""
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
    rings = (kw_pool, vw_pool, kw_scale, vw_scale)
    slots = torch.arange(s, device=tokens.device)
    if kw_pool is not None:
        rpages, roffs = _ring_rows(slots, abs_pos, ring_pages, page_size)
        rtable, k_pos0 = ring_table(slots, (lengths.long() + w - 1)
                                    // page_size, ring_pages, page_size)
    snaps = []  # (state pool layer, (W, S, H, D, D) states after each row)
    for i, kind, j in _layers(cfg):
        if kind == "ssm":
            x, _, states = _block_ssm(params, i, x, cfg, exact, ssm_state[j],
                                      collect=True)
            snaps.append((j, states))
            x = _block_mlp(params, i, x, exact)
            continue
        q, k, v = _qkv(params, i, x, exact)
        q = _heads(q, s, w, h, d)
        k, v = k.reshape(s * w, h, d), v.reshape(s * w, h, d)
        if kind == "window":
            _kv_append(rings, j, rpages, roffs, k, v)
            att = _paged(q, rings, j, rtable, horizons, exact,
                         window=cfg.window, k_pos0=k_pos0)
        else:
            _kv_append(pools, j, pages, offsets, k, v)
            att = _paged(q, pools, j, tables, horizons, exact)
        x = _attn_out(params, i, x, att, exact)
        x = _block_mlp(params, i, x, exact)
    logits = _lm_head(params, x, exact)
    greedy = logits.argmax(-1).to(torch.int32)
    if snaps:
        # the commit count of the host's loop: row 0, then one more per
        # proposal the previous row's greedy token agrees with, capped
        agree = (tokens[:, 1:].to(torch.int32) == greedy[:, :-1])
        c = 1 + torch.cumprod(agree.to(torch.int32), dim=1).sum(1)
        if limits is not None:
            c = torch.minimum(c, limits.to(c.dtype))
        idx = (c - 1).clamp(0, w - 1).long()
        for si, states in snaps:
            ssm_state[si].copy_(states[idx, slots])
    return greedy, logits


def draft_propose(params, tokens, n_feed, lengths, tables, k_pool, v_pool,
                  cfg, page_size, exact=None, k_scale=None, v_scale=None,
                  kw_pool=None, vw_pool=None, kw_scale=None, vw_scale=None,
                  ring_pages=0):
    """The draft model's ``W``-step scan, one call that both *ingests*
    committed tokens and *proposes* continuations.

    tokens: (S, W) int teacher tokens; n_feed: (S,) int — step ``j``
    feeds ``tokens[:, j]`` while ``j < n_feed`` and the previous step's
    greedy token after that (a ``torch.where`` on the device, so the loop
    reads nothing back and is captured whole).  ``n_feed = 1`` proposes
    (feed the last committed token, then run on); ``n_feed = W`` is pure
    teacher forcing (prompt ingestion in W-token chunks).  Step ``j``
    appends its KV at ``lengths + j`` **in place**.  Returns outs (S, W):
    ``outs[:, j]`` is the greedy token after position ``lengths + j``.
    A draft may hold windowed layers (their rings roll back by length)
    but no SSM layer: the session rejects one up front."""
    if "ssm" in cfg.kinds:
        raise MXNetError("draft_propose: SSM layers are not supported in "
                         "draft models")
    w = tokens.shape[1]
    lengths = lengths.to(torch.int32)
    prev = tokens[:, 0]
    outs = []
    for j in range(w):
        tok = torch.where(n_feed > j, tokens[:, j], prev)
        prev, _ = decode_step(params, tok, lengths + j, tables, k_pool,
                              v_pool, cfg, page_size, exact, k_scale,
                              v_scale, kw_pool, vw_pool, kw_scale, vw_scale,
                              ring_pages=ring_pages)
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
