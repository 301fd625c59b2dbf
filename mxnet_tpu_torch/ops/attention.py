"""Blockwise (flash-style) attention, its backward, and paged decode
attention.

Counterpart of ``mxnet_tpu/ops/attention.py``.  Each function that the
JAX package runs as a TPU kernel, or as a lax kernel on the serving path,
is a hand-written CUDA kernel here (``csrc/``), with its plain PyTorch
version beside it:

* :func:`flash_attention` forward, the forward of the TPU flash kernel
  ``_pallas_attention`` with the logsumexp the backward needs: kernel K1
  (``csrc/flash_attention.cu``, SIMT) for fp32 inputs and K7
  (``csrc/flash_attention_sm90.cu``, wgmma and TMA) for bf16 ones; plain
  version :func:`flash_forward_plain`, the blockwise loop of
  ``_flash_forward``.
* :func:`flash_attention` backward, the VJP of the same TPU kernel:
  kernel K4 (``csrc/flash_attention_backward.cu``) for fp32 and K8
  (``csrc/flash_attention_backward_sm90.cu``) for bf16; plain version
  :func:`flash_backward_plain`, ``_flash_backward``.  The two halves meet
  in a ``torch.autograd.Function``, the port's form of ``_flash_fn``'s
  custom VJP.
* :func:`paged_attention` — kernel K2 (``csrc/paged_attention.cu``),
  ``decode_attention`` fused with the page-table gather that feeds it;
  plain version :func:`paged_attention_plain`, the gather followed by
  :func:`decode_attention`.  Over quantized pages (one-byte code pools
  with per-row fp32 scale pools, ``decode_attention``'s
  ``k_scale``/``v_scale``) it is kernel K2q, in the same source.

:func:`dot_product_attention` picks the implementation as the JAX
package does (``MXNET_ATTN_IMPL`` or the ``attn_impl`` op attr).

A wrapper takes the plain version only for CPU (or ``meta``) tensors;
for CUDA tensors it launches its kernel or raises.  K1 and K2 share the
online-softmax step of :func:`online_block_merge` (the kernels through
``csrc/online_softmax.cuh``), so a paged decode row reproduces the
matching row of a full-context forward bit for bit — the serving
contract; K2q dequantizes each element before K2's arithmetic, so it
keeps that contract over the dequantized context.

Sliding windows (hybrid serving stacks): ``window > 0`` lets a query at
position i see only keys j with ``i - window < j``.  The forward runs
kernel K1 with the window on fp32 CUDA tensors; its backward (K4, K8)
and the bf16 forward (K7) take no window yet, so a windowed call under
autograd, or in bf16 on the card, raises.  :func:`paged_attention` takes
the window and ``k_pos0``, the absolute position of each slot's first
table row, which reads a windowed layer's per-slot ring through a
rotated table (K2/K2q's ``_ring`` entries); the plain version labels the
gathered rows with their positions, the JAX package's ``k_positions``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _cuda
from .. import quantize as Q
from ..base import MXNetError, get_env, later_slice

__all__ = ["attention_impl", "attention_block_size", "dot_product_attention",
           "reference_attention", "flash_attention", "flash_attention_plain",
           "flash_forward_plain", "flash_backward_plain",
           "flash_attention_backward", "online_block_merge",
           "finalize_attention", "decode_attention", "gather_pages",
           "gather_scales", "table_positions", "paged_attention",
           "paged_attention_plain"]

_IMPLS = ("auto", "flash", "reference")
_MAX_HEAD_DIM = 256   # csrc/online_softmax.cuh: kMaxHeadDim
_MAX_BLOCK = 128      # csrc/online_softmax.cuh: kMaxBlock


def attention_block_size():
    """K/V block length for the blockwise kernel (``MXNET_ATTN_BLOCK``)."""
    block = get_env("MXNET_ATTN_BLOCK", 128)
    if block < 1:
        raise MXNetError("MXNET_ATTN_BLOCK must be >= 1, got %d" % block)
    return block


# ---------------------------------------------------------------------------
# shared online-softmax step (plain versions)
# ---------------------------------------------------------------------------

def _qk_scores(q32, kb, mi):
    """(..., Tq, D) x (..., Tk, D) -> (..., Tq, Tk); ``mi`` selects the
    broadcast-multiply-reduce form whose per-element order over D does
    not depend on Tq."""
    if mi:
        return (q32[..., :, None, :] * kb[..., None, :, :]).sum(-1)
    return q32 @ kb.transpose(-1, -2)


def _pv_accum(p, vb, mi):
    if mi:
        return (p[..., :, :, None] * vb[..., None, :, :]).sum(-2)
    return p @ vb


def online_block_merge(acc, m, l, scores, v, mi=False):
    """One flash-attention accumulation step (masked scores at -inf).
    Returns updated ``(acc, m, l)``; a fully masked block is an exact
    no-op."""
    block_max = scores.amax(-1, keepdim=True)
    new_m = torch.maximum(m, block_max)
    new_m_safe = torch.where(torch.isfinite(new_m), new_m,
                             torch.zeros_like(new_m))
    correction = torch.exp(m - new_m_safe)
    correction = torch.where(torch.isfinite(m), correction,
                             torch.zeros_like(correction))
    p = torch.exp(scores - new_m_safe)
    p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
    new_l = l * correction + p.sum(-1, keepdim=True)
    new_acc = acc * correction + _pv_accum(p, v, mi)
    return new_acc, new_m, new_l


def _attend_block(q32, kb, vb, acc, m, l, mask, mi):
    scores = _qk_scores(q32, kb.float(), mi)
    scores = torch.where(mask, scores, torch.full_like(scores, -torch.inf))
    return online_block_merge(acc, m, l, scores, vb.float(), mi=mi)


def finalize_attention(acc, l):
    """Normalize the accumulator by the running denominator."""
    return acc / torch.clamp(l, min=1e-20)


def _init_state(q, dv):
    shape = q.shape[:-1]
    return (torch.zeros(shape + (dv,), dtype=torch.float32, device=q.device),
            torch.full(shape + (1,), -torch.inf, dtype=torch.float32,
                       device=q.device),
            torch.zeros(shape + (1,), dtype=torch.float32, device=q.device))


# ---------------------------------------------------------------------------
# reference (materialized) path
# ---------------------------------------------------------------------------

def _window_mask(q_pos, k_pos, causal, window):
    """(Tq, Tk) visibility: ``k <= q`` when causal, ``q - k < window``
    when ``window > 0``; None when every key is visible."""
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        wmask = k_pos[None, :] > q_pos[:, None] - window
        mask = wmask if mask is None else mask & wmask
    return mask


def reference_attention(q, k, v, causal=True, scale=None, window=0):
    """Exact softmax attention over the full (..., Tq, Tk) score matrix:
    the numeric ground truth, scores in fp32, O(T^2) memory.  ``window >
    0`` restricts row i to keys j with ``i - j < window``."""
    t, d = q.shape[-2], q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    scores = (q @ k.transpose(-1, -2)).float() * scale
    mask = _window_mask(torch.arange(t, device=q.device),
                        torch.arange(k.shape[-2], device=q.device), causal,
                        window)
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full_like(scores, -torch.inf))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return probs @ v


# ---------------------------------------------------------------------------
# K1 + K4: blockwise flash forward and its recompute backward
# ---------------------------------------------------------------------------

def _padded_block(x, start, block):
    """Rows ``start:start + block`` of (..., T, D), zero-padded to
    ``block`` rows at a ragged end."""
    xb = x[..., start:start + block, :]
    if xb.shape[-2] < block:
        xb = torch.nn.functional.pad(xb, (0, 0, 0, block - xb.shape[-2]))
    return xb


def flash_forward_plain(q, k, v, causal, scale, block, mi=False, window=0):
    """The JAX package's ``_flash_forward``: visit K/V blocks of ``block``
    rows from position 0 in order, carrying (acc, m, l) in fp32; padded
    keys of a ragged last block mask out, and with ``window > 0`` keys at
    or left of ``i - window``.  Returns ``(out, lse)``, ``out`` in q's
    dtype and the fp32 logsumexp ``lse = m + log l`` of shape (..., T, 1)
    that the backward recomputes probabilities from."""
    t = q.shape[-2]
    q32 = q.float() * scale
    q_pos = torch.arange(t, device=q.device)
    acc, m, l = _init_state(q, v.shape[-1])
    for start in range(0, t, block):
        k_pos = torch.arange(start, start + block, device=q.device)
        mask = (k_pos < t)[None, :]
        vis = _window_mask(q_pos, k_pos, causal, window)
        if vis is not None:
            mask = mask & vis
        acc, m, l = _attend_block(q32, _padded_block(k, start, block),
                                  _padded_block(v, start, block), acc, m, l,
                                  mask, mi)
    out = finalize_attention(acc, l).to(q.dtype)
    lse = torch.where(torch.isfinite(m), m, torch.zeros_like(m)) \
        + torch.log(torch.clamp(l, min=1e-38))
    return out, lse


def flash_attention_plain(q, k, v, causal, scale, block, mi=False,
                          window=0):
    """Plain version of kernel K1's output: :func:`flash_forward_plain`
    without the logsumexp."""
    return flash_forward_plain(q, k, v, causal, scale, block, mi=mi,
                               window=window)[0]


def flash_backward_plain(q, k, v, out, lse, g, causal, scale, block):
    """The JAX package's ``_flash_backward``: one more pass over the K/V
    blocks, each block's probabilities rebuilt from ``lse`` (masked pairs
    give exactly 0), ``ds = p * (dp - delta)`` with ``delta = sum(dO *
    O)`` over the saved, dtype-cast ``out``.  dq carries ``scale`` once at
    the end; dk has it through ``q32``.  Linear in ``g``.  Returns (dq,
    dk, dv) in the dtypes of q, k, v."""
    t = q.shape[-2]
    q32 = q.float() * scale
    q_pos = torch.arange(t, device=q.device)
    do = g.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start in range(0, t, block):
        kb32 = _padded_block(k, start, block).float()
        vb32 = _padded_block(v, start, block).float()
        k_pos = torch.arange(start, start + block, device=q.device)
        mask = (k_pos < t)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        scores = q32 @ kb32.transpose(-1, -2)
        scores = torch.where(mask, scores, torch.full_like(scores,
                                                           -torch.inf))
        p = torch.exp(scores - lse)
        dvs.append(p.transpose(-1, -2) @ do)
        ds = p * (do @ vb32.transpose(-1, -2) - delta)
        dq = dq + ds @ kb32
        dks.append(ds.transpose(-1, -2) @ q32)
    dk = torch.cat(dks, dim=-2)[..., :t, :].to(k.dtype)
    dv = torch.cat(dvs, dim=-2)[..., :t, :].to(v.dtype)
    return (dq * scale).to(q.dtype), dk, dv


_SM90_WIDTHS = (64, 128, 256)  # head dims K7/K8 are instantiated for


def _check_inputs(who, tensors):
    first = tensors[0]
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError("%s: %s inputs; the CUDA kernels take float32 (K1, "
                         "K4) or bfloat16 (K7, K8)" % (who, first.dtype))
    for x in tensors:
        if x.dtype != first.dtype or x.device != first.device:
            raise MXNetError("%s: inputs differ in dtype or device (%s on "
                             "%s vs %s on %s)" % (who, x.dtype, x.device,
                                                  first.dtype, first.device))
        if x.shape != first.shape:
            raise MXNetError("%s: shapes %r and %r must share one (..., T, "
                             "D) shape" % (who, tuple(first.shape),
                                           tuple(x.shape)))


def _kernel_rows(who, t, d, block, *tensors):
    """Check the fp32 kernels' (K1, K4) preconditions and flatten each
    (..., T, D) tensor to contiguous (n_bh, T, D) rows."""
    if d > _MAX_HEAD_DIM or not 1 <= block <= _MAX_BLOCK:
        raise MXNetError("%s: head_dim %d (max %d) or block %d (max %d) out "
                         "of the kernel's range"
                         % (who, d, _MAX_HEAD_DIM, block, _MAX_BLOCK))
    return [x.reshape(-1, t, d).contiguous() for x in tensors]


def sm90_width(d):
    """The head dim K7/K8 run a (..., D) call at: the least instantiated
    width >= D (the 128-byte swizzle rows of the tiles hold 64 bf16, so
    64 is the least)."""
    for w in _SM90_WIDTHS:
        if d <= w:
            return w
    raise MXNetError("flash_attention: bf16 head_dim %d above the tensor-core "
                     "kernels' %d" % (d, _SM90_WIDTHS[-1]))


def _sm90_operands(t, d, *tensors):
    """Each bf16 (..., T, D) tensor as K7/K8 read it through a 4-D TMA map:
    an (N, H, T, Dp) view, Dp = ``sm90_width(D)``.  A view whose D is
    contiguous and whose other strides are multiples of 8 elements (16
    bytes) is read where it lies — the heads of a fused QKV projection
    need no copy; any other tensor, or one that needs zero columns (they
    add nothing to q.k or dO.v; the output's are dropped), is copied.
    Returns (views, N, H, Dp, the views' (n, h, t) strides as a ctypes
    array)."""
    dp = sm90_width(d)
    lead = tensors[0].shape[:-2]
    h = lead[-1] if lead else 1
    n = math.prod(lead) // max(h, 1)
    views, strides = [], []
    for x in tensors:
        x4 = x.reshape(n, h, t, d)
        if dp != d:
            x4 = torch.nn.functional.pad(x4, (0, dp - d))
        elif not _tma_readable(x4):
            x4 = x4.contiguous()
            if x4.data_ptr() % 16:
                x4 = x4.clone()
        views.append(x4)
        # a size-1 dim's stride is free: give it the contiguous one
        strides += [st if size > 1 else contiguous
                    for st, size, contiguous in zip(
                        x4.stride()[:3], x4.shape[:3],
                        (h * t * dp, t * dp, dp))]
    return views, n, h, dp, (ctypes.c_longlong * len(strides))(*strides)


def _tma_readable(x4):
    return (x4.stride(-1) == 1 and x4.data_ptr() % 16 == 0
            and all(st > 0 and st % 8 == 0
                    for st, size in zip(x4.stride()[:3], x4.shape[:3])
                    if size > 1))


def _flash_forward_sm90(q, k, v, causal, scale, with_lse):
    """Kernel K7, the bf16 forward on the tensor cores: (out, lse or
    None).  It picks its own tiles (128 queries a CTA, 64 or 128 keys a
    step), so the caller's ``block`` does not reach it."""
    t, d = q.shape[-2], q.shape[-1]
    (q4, k4, v4), n, h, dp, strides = _sm90_operands(t, d, q, k, v)
    out = torch.empty((n * h, t, dp), dtype=q.dtype, device=q.device)
    lse = (torch.empty((n * h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        with torch.cuda.device(q.device):
            _cuda.launch("flash_attention_sm90", q4.data_ptr(), k4.data_ptr(),
                         v4.data_ptr(), out.data_ptr(),
                         lse.data_ptr() if with_lse else None, n, h, t, dp,
                         strides, float(scale), int(bool(causal)),
                         _cuda.stream_of(q))
    out = out[..., :d].reshape(q.shape)
    return out, (lse.reshape(q.shape[:-1] + (1,)) if with_lse else None)


def _flash_backward_sm90(q, k, v, out, lse, g, causal, scale):
    """Kernel K8, the bf16 backward on the tensor cores: (dq, dk, dv)."""
    t, d = q.shape[-2], q.shape[-1]
    (q4, k4, v4, o4, g4), n, h, dp, strides = _sm90_operands(
        t, d, q, k, v, out, g)
    lse = lse.reshape(n * h, t).float().contiguous()
    dq, dk, dv = (torch.empty((n * h, t, dp), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if dq.numel():
        # scratch: lse * log2(e) and delta, rows padded to 128
        rows = torch.empty(2 * n * h * (-(-t // 128) * 128),
                           dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            _cuda.launch("flash_attention_backward_sm90", q4.data_ptr(),
                         k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
                         lse.data_ptr(), g4.data_ptr(), dq.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), rows.data_ptr(), n, h,
                         t, dp, strides, float(scale), int(bool(causal)),
                         _cuda.stream_of(q))
    return tuple(x[..., :d].reshape(q.shape) for x in (dq, dk, dv))


def _flash_forward_cuda(q, k, v, causal, scale, block, with_lse,
                        window=0):
    """The forward on the card, by dtype: K7 for bf16, K1 for fp32 (out,
    lse or None); a window runs K1's windowed entry.  No fallback: another
    dtype or shape raises."""
    _check_inputs("flash_attention", (q, k, v))
    if q.dtype == torch.bfloat16:
        if window:
            raise later_slice("flash_attention(window) in bfloat16 (K7's "
                              "window)", window)
        return _flash_forward_sm90(q, k, v, causal, scale, with_lse)
    t, d = q.shape[-2], q.shape[-1]
    q3, k3, v3 = _kernel_rows("flash_attention", t, d, block, q, k, v)
    out = torch.empty_like(q3)
    lse = (torch.empty(q3.shape[:-1], dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        args = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, q3.shape[0], t, d,
                float(scale), int(bool(causal)), int(block))
        with torch.cuda.device(q.device):
            if window:
                _cuda.launch("flash_attention_window", *args, int(window),
                             _cuda.stream_of(q))
            else:
                _cuda.launch("flash_attention", *args, _cuda.stream_of(q))
    out = out.reshape(q.shape)
    return out, (lse.reshape(q.shape[:-1] + (1,)) if with_lse else None)


def _flash_backward_cuda(q, k, v, out, lse, g, causal, scale, block):
    """The backward on the card, by dtype: K8 for bf16, K4 for fp32 (dq,
    dk, dv)."""
    _check_inputs("flash_attention_backward", (q, k, v, out, g))
    if q.dtype == torch.bfloat16:
        return _flash_backward_sm90(q, k, v, out, lse, g, causal, scale)
    t, d = q.shape[-2], q.shape[-1]
    q3, k3, v3, o3, g3 = _kernel_rows("flash_attention_backward", t, d,
                                      block, q, k, v, out, g)
    lse = lse.reshape(q3.shape[:-1]).float().contiguous()
    dq, dk, dv = (torch.empty_like(q3) for _ in range(3))
    if dq.numel():
        delta = torch.empty(q3.shape[:-1], dtype=torch.float32,
                            device=q.device)
        with torch.cuda.device(q.device):
            _cuda.launch("flash_attention_backward", q3.data_ptr(),
                         k3.data_ptr(), v3.data_ptr(), o3.data_ptr(),
                         lse.data_ptr(), g3.data_ptr(), dq.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                         q3.shape[0], t, d, float(scale),
                         int(bool(causal)), _cuda.stream_of(q))
    return tuple(x.reshape(q.shape) for x in (dq, dk, dv))


def flash_attention_backward(q, k, v, out, lse, g, causal, scale, block):
    """Gradients (dq, dk, dv) of :func:`flash_attention` from the saved
    forward: kernel K4 (fp32) or K8 (bf16) on CUDA tensors,
    :func:`flash_backward_plain` on CPU or meta tensors."""
    if q.is_cuda:
        return _flash_backward_cuda(q, k, v, out, lse, g, causal, scale,
                                    block)
    return flash_backward_plain(q, k, v, out, lse, g, causal, scale, block)


def _flash_forward(q, k, v, causal, scale, block, mi, with_lse, window=0):
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v, causal, scale, block, with_lse,
                                   window)
    return flash_forward_plain(q, k, v, causal, scale, block, mi=mi,
                               window=window)


class _FlashFn(torch.autograd.Function):
    """The JAX package's ``_flash_fn`` custom VJP: the forward saves (q, k,
    v, out, lse), the backward recomputes from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block, mi):
        out, lse = _flash_forward(q, k, v, causal, scale, block, mi, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, scale, block)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, g,
                                              *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, block=None, mi=False,
                    window=0):
    """Blockwise online-softmax attention over (..., T, D), fp32 or bf16.

    On CUDA tensors fp32 runs kernel K1 forward, whose per-row arithmetic
    is fixed (M-invariant whatever ``mi`` says), and K4 backward; bf16
    runs the tensor-core kernels K7 and K8, which round probabilities to
    bf16 for their products as the TPU kernel does and choose their own
    tiles (head_dim <= 256, zero-padded to 64, 128 or 256).  On CPU
    tensors the plain versions, where ``mi`` selects the M-invariant
    matmul form as in the JAX package.  Differentiable through a
    recompute backward when autograd records (the forward then also keeps
    the logsumexp); without a gradient the kernel writes no logsumexp.
    An explicit ``block`` is honoured verbatim by K1 and the plain
    versions (serving bit-exactness needs the accumulation width fixed
    across T).  ``window > 0`` limits row i to keys j with ``i - window <
    j``: K1's windowed forward on fp32 CUDA tensors, the plain forward on
    CPU tensors; the windowed backward (K4/K7/K8's window) is a later
    slice, so a windowed call that autograd records raises, as does a
    bf16 one on the card."""
    d = q.shape[-1]
    t = k.shape[-2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if block is None:
        block = min(attention_block_size(), max(t, 1))
    window = int(window)
    if window < 0:
        raise MXNetError("flash_attention: window must be >= 0, got %d"
                         % window)
    cfg = (bool(causal), float(scale), int(block))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if window:
            raise later_slice("flash_attention(window) under autograd "
                              "(K4/K7/K8's window)", window)
        return _FlashFn.apply(q, k, v, *cfg, bool(mi))
    return _flash_forward(q, k, v, *cfg, mi, False, window)[0]


def attention_impl():
    """Resolve ``MXNET_ATTN_IMPL`` (``auto`` | ``flash`` | ``reference``),
    read at call time."""
    impl = get_env("MXNET_ATTN_IMPL", "auto").strip().lower()
    if impl not in _IMPLS:
        raise MXNetError("MXNET_ATTN_IMPL=%r not in %s" % (impl, _IMPLS))
    return impl


def dot_product_attention(q, k, v, causal=True, scale=None, impl=None,
                          block=None, window=0):
    """Attention by the implementation ``MXNET_ATTN_IMPL`` (or the explicit
    ``impl``) selects: ``reference`` materializes the scores;
    ``auto`` and ``flash`` run :func:`flash_attention` — kernels K1/K4
    (fp32) or K7/K8 (bf16) on CUDA tensors, where the JAX package's
    ``auto`` picks its TPU flash kernel, and the plain blockwise versions
    elsewhere.  ``window`` as in :func:`flash_attention`."""
    impl = (impl or attention_impl()).strip().lower()
    if impl not in _IMPLS:
        raise MXNetError("attention impl %r not in %s" % (impl, _IMPLS))
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
    return flash_attention(q, k, v, causal=causal, scale=scale, block=block,
                           window=window)


# ---------------------------------------------------------------------------
# K2: paged attention (decode and prefill)
# ---------------------------------------------------------------------------

def _valid_len(lengths, q):
    """(S,) or (S, Q) horizons -> a mask-ready (S, 1, Q|1, 1) tensor."""
    if lengths.dim() == 2:
        if tuple(lengths.shape) != (q.shape[0], q.shape[-2]):
            raise MXNetError(
                "decode_attention: per-row lengths %r do not match query "
                "rows %r" % (tuple(lengths.shape), (q.shape[0], q.shape[-2])))
        return lengths[:, None, :, None]
    return lengths.reshape(lengths.shape + (1,) * (q.dim() - 1))


def decode_attention(q, k_ctx, v_ctx, lengths, scale=None, block=None,
                     mi=False, k_scale=None, v_scale=None, window=0,
                     k_positions=None):
    """Attention of (S, H, Q, D) queries over a gathered (S, H, Tcap, D)
    context, the JAX package's ``decode_attention``: ``lengths`` (S,) or
    per-row (S, Q) counts the keys each query sees; all ``Tcap/block``
    blocks are visited in order with the validity mask, and a slot with
    length 0 gives 0.  ``k_scale``/``v_scale`` (S, Tcap) float32 make the
    context quantized codes, dequantized block by block (``code *
    scale``).  ``window > 0`` adds the lower bound: with ``pos = length -
    1`` a row sees positions ``p > pos - window``.  ``k_positions`` (S,
    Tcap) int gives each context row its absolute position (a rotated
    ring gather): visible iff ``0 <= p <= pos`` (and the window); without
    it row j is position j."""
    d = q.shape[-1]
    t_cap = k_ctx.shape[-2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if block is None:
        block = attention_block_size()
    block = min(block, max(t_cap, 1))
    if t_cap % block:
        raise MXNetError("decode_attention: context capacity %d not a "
                         "multiple of block %d" % (t_cap, block))
    valid_len = _valid_len(lengths, q)
    q32 = q.float() * scale
    acc, m, l = _init_state(q, v_ctx.shape[-1])
    for start in range(0, t_cap, block):
        if k_positions is not None:
            # (S, 1, 1, block) labels against the (S, 1, Q|1, 1) horizons
            kp = k_positions[:, None, None, start:start + block]
            pos = valid_len - 1
            mask = (kp >= 0) & (kp <= pos)
            if window:
                mask = mask & (kp > pos - window)
        else:
            k_pos = torch.arange(start, start + block, device=q.device)
            mask = k_pos < valid_len
            if window:
                mask = mask & (k_pos >= valid_len - window)
        kb = k_ctx[..., start:start + block, :]
        vb = v_ctx[..., start:start + block, :]
        if k_scale is not None:  # the quantized context's dequantization
            kb = Q.codes_to_float(kb) \
                * k_scale[:, None, start:start + block, None]
            vb = Q.codes_to_float(vb) \
                * v_scale[:, None, start:start + block, None]
        acc, m, l = _attend_block(q32, kb, vb, acc, m, l, mask, mi)
    return finalize_attention(acc, l).to(q.dtype)


def gather_pages(pool, tables):
    """One layer's (pages + 1, page, H, D) pool read through (S, max_pages)
    page tables -> the (S, H, max_pages * page, D) context."""
    s, max_pages = tables.shape
    _, page, h, d = pool.shape
    return pool[tables.long()].reshape(s, max_pages * page, h, d) \
        .transpose(1, 2)


def gather_scales(scales, tables):
    """One layer's (pages + 1, page) scale pool read through (S, max_pages)
    page tables -> (S, max_pages * page) per-position scales."""
    return scales[tables.long()].reshape(tables.shape[0], -1)


def table_positions(k_pos0, tables, page):
    """(S, max_pages * page) absolute positions of the rows a rotated
    ring table gathers: ``k_pos0[s] + j`` (the JAX package's
    ``k_positions`` of ``_ring_gather``)."""
    cap = tables.shape[1] * page
    return k_pos0.long()[:, None] + torch.arange(cap, device=tables.device)


def paged_attention_plain(q, k_pool, v_pool, tables, lengths, scale=None,
                          mi=True, k_scale=None, v_scale=None, window=0,
                          k_pos0=None):
    """Plain version of kernels K2 and K2q: gather the slots' pages (and
    their scale rows), then :func:`decode_attention` with ``block =
    page_size``; with ``k_pos0`` the gathered rows carry their absolute
    positions (:func:`table_positions`)."""
    ks = vs = None
    if k_scale is not None:
        ks, vs = gather_scales(k_scale, tables), gather_scales(v_scale, tables)
    kpos = None
    if k_pos0 is not None:
        kpos = table_positions(k_pos0, tables, k_pool.shape[1])
    return decode_attention(q, gather_pages(k_pool, tables),
                            gather_pages(v_pool, tables), lengths,
                            scale=scale, block=k_pool.shape[1], mi=mi,
                            k_scale=ks, v_scale=vs, window=window,
                            k_positions=kpos)


def _paged_attention_cuda(q, k_pool, v_pool, tables, lengths, scale,
                          k_scale=None, v_scale=None, window=0, k_pos0=None):
    s, h, nq, d = q.shape
    _, page, ph, pd = k_pool.shape
    quant = k_scale is not None or v_scale is not None
    if (ph, pd) != (h, d) or v_pool.shape != k_pool.shape:
        raise MXNetError("paged_attention: pool %r does not match queries "
                         "%r" % (tuple(k_pool.shape), tuple(q.shape)))
    if q.dtype != torch.float32:
        raise MXNetError("paged_attention: the CUDA kernel takes float32 "
                         "queries")
    if quant:
        if k_pool.dtype not in (torch.int8, torch.uint8) \
                or v_pool.dtype != k_pool.dtype:
            raise MXNetError("paged_attention: quantized pools must be int8 "
                             "or uint8 (e4m3 bytes), both alike; got %s and "
                             "%s" % (k_pool.dtype, v_pool.dtype))
        for sc in (k_scale, v_scale):
            if sc is None or sc.dtype != torch.float32 \
                    or tuple(sc.shape) != tuple(k_pool.shape[:2]) \
                    or not sc.is_contiguous() or sc.device != q.device:
                raise MXNetError(
                    "paged_attention: scale pools must be contiguous float32 "
                    "%r on the queries' device" % (tuple(k_pool.shape[:2]),))
    elif k_pool.dtype != torch.float32 or v_pool.dtype != torch.float32:
        raise MXNetError("paged_attention: the CUDA kernel takes float32 "
                         "pools, or one-byte pools with their scale pools")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise MXNetError("paged_attention: tables and lengths must be int32")
    if tables.dim() != 2 or tables.shape[0] != s:
        raise MXNetError("paged_attention: tables %r do not match %d slots"
                         % (tuple(tables.shape), s))
    per_row = lengths.dim() == 2
    if tuple(lengths.shape) != ((s, nq) if per_row else (s,)):
        raise MXNetError("paged_attention: lengths %r do not match queries "
                         "%r" % (tuple(lengths.shape), tuple(q.shape)))
    ring = bool(window) or k_pos0 is not None
    if ring:
        if k_pos0 is None:
            k_pos0 = torch.zeros((s,), dtype=torch.int32, device=q.device)
        if k_pos0.dtype != torch.int32 or tuple(k_pos0.shape) != (s,):
            raise MXNetError("paged_attention: k_pos0 must be (%d,) int32"
                             % s)
        if window < 0:
            raise MXNetError("paged_attention: window must be >= 0")
        k_pos0 = k_pos0.contiguous()
    for x in (k_pool, v_pool, tables, lengths) + ((k_pos0,) if ring else ()):
        if x.device != q.device:
            raise MXNetError("paged_attention: inputs on different devices")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise MXNetError("paged_attention: pools must be contiguous")
    if d > _MAX_HEAD_DIM or page > _MAX_BLOCK:
        raise MXNetError("paged_attention: head_dim %d (max %d) or page %d "
                         "(max %d) out of the kernel's range"
                         % (d, _MAX_HEAD_DIM, page, _MAX_BLOCK))
    q = q.contiguous()
    tables = tables.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    if not out.numel():
        return out
    pools = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    if quant:
        pools += (k_scale.data_ptr(), v_scale.data_ptr())
    rows = (tables.data_ptr(), lengths.data_ptr())
    if ring:
        rows += (k_pos0.data_ptr(),)
    dims = (out.data_ptr(), s, h, nq, d, page, tables.shape[1], int(per_row))
    if ring:
        dims += (int(window),)
    tail = (float(scale),)
    if quant:
        tail += (int(Q.code_mode(k_pool) == "fp8"),)
    name = "paged_attention_q" if quant else "paged_attention"
    with torch.cuda.device(q.device):
        _cuda.launch(name + ("_ring" if ring else ""), *pools, *rows, *dims,
                     *tail, _cuda.stream_of(q))
    return out


def paged_attention(q, k_pool, v_pool, tables, lengths, scale=None,
                    mi=True, k_scale=None, v_scale=None, window=0,
                    k_pos0=None):
    """Attention of (S, H, Q, D) queries over one layer's paged KV pool.

    ``k_pool``/``v_pool``: (pages + 1, page, H, D); ``tables``: (S,
    max_pages) int32 page ids; ``lengths``: (S,) or per-row (S, Q) int32
    horizons (keys at positions < horizon are visible).  Block size is the
    page size.  Decode is S = slots, Q = 1; prefill is S = 1, Q = bucket
    with horizons ``offset + j + 1``.  ``k_scale``/``v_scale`` (pages + 1,
    page) float32 make the pools one-byte codes (int8, or e4m3 bytes held
    as uint8) with a scale a row.  On CUDA tensors this is kernel K2 (K2q
    over codes), which reads pages through the table and never builds the
    gathered context (its order is fixed whatever ``mi`` says); on CPU
    tensors the plain gather + :func:`decode_attention`.

    Windowed layers: ``window > 0`` lets a row with horizon n see
    positions ``p >= n - window`` only, and ``k_pos0`` (S,) int32 is the
    absolute position of each slot's table row 0 (a multiple of the page;
    negative positions mask out), so the table may be a ring's rotated
    one — K2/K2q's ``_ring`` entries on the card."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return _paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                     scale, k_scale, v_scale, window, k_pos0)
    return paged_attention_plain(q, k_pool, v_pool, tables, lengths,
                                 scale=scale, mi=mi, k_scale=k_scale,
                                 v_scale=v_scale, window=window,
                                 k_pos0=k_pos0)
