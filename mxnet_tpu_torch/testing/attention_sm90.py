"""What the bf16 tensor-core attention kernels (K7, K8) are held to.

K7 and K8 do the TPU flash kernel's arithmetic: bf16 x bf16 dots with
fp32 results, the scale applied after the dot, and the probabilities P
(and the score gradient dS) rounded to bf16 before the products that
consume them.  The plain versions, ``flash_forward_plain`` and
``flash_backward_plain``, keep P and dS in fp32.  So the two may differ
per output element by

* the bf16 term the fp32-vs-fp32 comparisons of K1/K4 use: each side
  rounds an fp32 value to bf16 once and the fp32 values differ by
  reduction order, ``2^-7 |want| + 1e-4 max|want|``; plus
* the rounding of P or dS to bf16 (relative error at most 2^-8) inside
  the contraction: ``2^-8`` times the same contraction over absolute
  values — ``sum p |v| / l`` for out, ``sum p |dO|`` for dV,
  ``scale sum |ds| |q|`` for dK and ``scale sum |ds| |k|`` for dQ.

:func:`forward_bound` and :func:`backward_bounds` materialise those
contractions (O(T^2) memory: check shapes only).  :func:`forward_emulated`
and :func:`backward_emulated` are the kernels' arithmetic in plain
PyTorch — key blocks of 128, exp2 with ``scale * log2(e)`` folded into one
multiply, bf16 P and dS — so the CPU tests can hold that arithmetic to
the same bound without a card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["TOLERANCE_NOTE", "forward_emulated", "backward_emulated",
           "forward_bound", "backward_bounds", "violation"]

TOLERANCE_NOTE = (
    "|diff| <= 2^-7 |want| + 1e-4 max|want| + 2^-8 C: one bf16 rounding "
    "of fp32 values that differ by order, plus P and dS rounded to bf16 "
    "before the tensor-core products (C = the same contraction over "
    "absolute values: sum p|v|/l for out, sum p|dO| for dV, scale "
    "sum|ds||q| for dK, scale sum|ds||k| for dQ)")

_LOG2E = 1.0 / math.log(2.0)


def _mask(t, causal, device):
    if not causal:
        return None
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def _scores(q, k):
    return q.float() @ k.float().transpose(-1, -2)


def _probs(q, k, lse, causal, scale):
    """p = exp(q.k * scale - lse) in fp32, masked pairs exactly 0."""
    s = _scores(q, k) * scale - lse
    m = _mask(q.shape[-2], causal, q.device)
    if m is not None:
        s = s.masked_fill(~m, -torch.inf)
    return torch.exp(s)


def forward_emulated(q, k, v, causal, scale, block=128):
    """K7's arithmetic: (out in q's dtype, fp32 lse of shape (..., T, 1))."""
    t = q.shape[-2]
    c = scale * _LOG2E
    q32, k32, v32 = q.float(), k.float(), v.float()
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, -torch.inf, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    q_pos = torch.arange(t, device=q.device)[:, None]
    for start in range(0, t, block):
        kb = k32[..., start:start + block, :]
        vb = v32[..., start:start + block, :]
        s = q32 @ kb.transpose(-1, -2)
        if causal:
            k_pos = torch.arange(start, start + kb.shape[-2], device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        safe = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
        corr = torch.exp2(m - safe)
        p = torch.exp2(s * c - safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vb
        m = m_new
    out = (acc / l.clamp_min(1e-20)).to(q.dtype)
    lse = torch.where(m == -torch.inf, torch.zeros_like(m), m / _LOG2E) \
        + torch.log(l.clamp_min(1e-38))
    return out, lse


def backward_emulated(q, k, v, out, lse, g, causal, scale):
    """K8's arithmetic: (dq, dk, dv) in the inputs' dtypes."""
    c = scale * _LOG2E
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    delta = (g32 * out.float()).sum(-1, keepdim=True)
    s = (q32 @ k32.transpose(-1, -2)) * c - lse * _LOG2E
    m = _mask(q.shape[-2], causal, q.device)
    if m is not None:
        s = s.masked_fill(~m, -torch.inf)
    p = torch.exp2(s)
    ds = p * (g32 @ v32.transpose(-1, -2) - delta)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = pb.transpose(-1, -2) @ g32
    dk = scale * (dsb.transpose(-1, -2) @ q32)
    dq = scale * (dsb @ k32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bound(want, contraction):
    w = want.float()
    return 2.0 ** -7 * w.abs() + 1e-4 * w.abs().max() + 2.0 ** -8 * contraction


def forward_bound(q, k, v, want, causal, scale):
    """Per-element bound on |K7 out - flash_forward_plain out|."""
    s = _scores(q, k) * scale
    m = _mask(q.shape[-2], causal, q.device)
    if m is not None:
        s = s.masked_fill(~m, -torch.inf)
    return _bound(want, torch.softmax(s, -1) @ v.float().abs())


def backward_bounds(q, k, v, out, lse, g, wants, causal, scale):
    """Per-element bounds on |K8 - flash_backward_plain| for (dq, dk, dv);
    ``wants`` are the plain version's three results."""
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    p = _probs(q, k, lse, causal, scale)
    delta = (g32 * out.float()).sum(-1, keepdim=True)
    ds = (p * (g32 @ v32.transpose(-1, -2) - delta)).abs()
    return (_bound(wants[0], scale * (ds @ k32.abs())),
            _bound(wants[1], scale * (ds.transpose(-1, -2) @ q32.abs())),
            _bound(wants[2], p.transpose(-1, -2) @ g32.abs()))


def violation(got, want, bound):
    """(max |got - want|, max |got - want| / bound): inside the bound
    when the second is <= 1."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff / bound).max().item()
