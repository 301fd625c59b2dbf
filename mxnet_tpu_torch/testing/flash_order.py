"""Emulation, on CPU float32 tensors, of the order in which the tiled
flash-attention forward K1 (``csrc/flash_attention.cu``) runs a tile of
query rows, and of the single-thread score sum it rests on.

A warp formed a score as 32 lane partials (lane t: q[d] k[d] over
d = t, t + 32, ... from +0) added by the xor butterfly 16, 8, 4, 2, 1
(``paged_order.scores``).  That butterfly is one fixed tree: its leaves
are the lanes in 5-bit bit-reversed order, added pairwise as a binary
counter.  :func:`tree_scores` forms the same sums the way one K1 thread
does, leaf after leaf with pending partial sums, and must give the
butterfly's bits.

:func:`tile_forward` runs a tile's rows as K1 does: scores of a group of
whole blocks (masked pairs -inf), per row and block the max, rescale and
probabilities (-0 marking a key left out), the serial probability sum,
then P.V over the staged value chunks in key order — ``p * v`` added
for every key where the chunk's values are all finite, a select where
one is not — folded at each block's end.  Its rows must equal
``paged_order.merge_sequential``'s, the order of the one-warp-a-row K1
that serving's bit-exactness was proved against, bit for bit.

Every product and sum is a separate fp32 rounding (no fused
multiply-add), ``fmax`` takes maxima, and ``paged_order._exp`` is the
one shared exp, as in ``paged_order``.
"""
from __future__ import annotations

import torch

from .paged_order import _exp, _rescale

__all__ = ["CHUNK", "GROUP", "group_of", "tree_scores", "tile_forward",
           "flash_forward"]

CHUNK = 64   # keys K1 stages at once
GROUP = 128  # keys K1 scores before it sums, in whole blocks
_WARP = 32
_NEG_INF = float("-inf")


def group_of(block):
    """Keys K1 scores before it sums: as many whole blocks as fit in
    :data:`GROUP` keys (block <= 128)."""
    return block * (GROUP // block)


def _padded(x, dp):
    return torch.nn.functional.pad(x, (0, dp - x.shape[-1]))


def _bitrev3(a):
    return ((a & 1) << 2) | (a & 2) | ((a & 4) >> 2)


def tree_scores(q, k):
    """Scores (R, n) of scaled query rows ``q`` (R, D) against key rows
    ``k`` (n, D), summed as one K1 thread sums them: D padded with zeros
    to a multiple of 32; leaf index 4a + b is lane bitrev3(a) + (0, 16,
    8, 24)[b], each leaf the lane's partial in increasing d from +0; the
    four leaves of one ``a`` add as a subtree, the eight subtrees as a
    binary counter over ``a``."""
    dp = -(-q.shape[-1] // _WARP) * _WARP
    q, k = _padded(q, dp), _padded(k, dp)

    def leaf(lane):
        x = torch.zeros(q.shape[0], k.shape[0], dtype=torch.float32)
        for d in range(lane, dp, _WARP):
            x = x + q[:, d, None] * k[None, :, d]
        return x

    pending = {}
    for a in range(8):
        base = _bitrev3(a)
        x = (leaf(base) + leaf(base + 16)) + (leaf(base + 8)
                                              + leaf(base + 24))
        level = 0
        while a >> level & 1:  # the counter's carries
            x = pending.pop(level) + x
            level += 1
        pending[level] = x
    return pending[3]


def _fmax_rows(s):
    """Row max of ``s`` (R, n) by fmax (NaN ignored, exact in any order),
    from -inf."""
    out = torch.full((s.shape[0],), _NEG_INF, dtype=torch.float32)
    for j in range(s.shape[1]):
        out = torch.fmax(out, s[:, j])
    return out


def tile_forward(q, k, v, horizons, block):
    """One K1 tile: scaled query rows ``q`` (R, D), row r seeing keys
    j < ``horizons[r]`` of ``k``, ``v`` (n, D).  Returns (out (R, D), l
    (R,), m (R,))."""
    rows, d = q.shape
    horizons = torch.as_tensor(horizons)
    key_end = int(horizons.max()) if rows else 0
    g = group_of(block)
    m = torch.full((rows,), _NEG_INF, dtype=torch.float32)
    l = torch.zeros(rows, dtype=torch.float32)
    acc = torch.zeros(rows, d, dtype=torch.float32)
    neg0 = torch.tensor(-0.0)
    for g0 in range(0, key_end, g):
        n_g = min(g, key_end - g0)
        keys = torch.arange(g0, g0 + n_g)
        s = tree_scores(q, k[g0:g0 + n_g])
        s = torch.where(keys[None, :] < horizons[:, None], s,
                        torch.tensor(_NEG_INF))
        p = torch.empty_like(s)
        corr = []
        for j0 in range(0, n_g, block):
            j1 = min(j0 + block, n_g)
            m, safe, c = _rescale(m, _fmax_rows(s[:, j0:j1]))
            blk = s[:, j0:j1]
            p[:, j0:j1] = torch.where(torch.isfinite(blk),
                                      _exp(blk - safe[:, None]), neg0)
            corr.append(c)
            psum = torch.zeros(rows, dtype=torch.float32)
            for j in range(j0, j1):
                psum = psum + p[:, j]  # a left-out key adds -0
            l = l * c + psum
        pv = torch.zeros(rows, d, dtype=torch.float32)
        b = 0
        for c0 in range(0, n_g, CHUNK):
            c1 = min(c0 + CHUNK, n_g)
            finite = bool(torch.isfinite(v[g0 + c0:g0 + c1]).all())
            for j in range(c0, c1):
                add = pv + p[:, j, None] * v[g0 + j]
                if finite:
                    pv = add
                else:
                    pv = torch.where(torch.signbit(p[:, j, None]), pv, add)
                if (j + 1) % block == 0 or j + 1 == n_g:
                    acc = acc * corr[b][:, None] + pv
                    pv = torch.zeros_like(pv)
                    b += 1
    return acc / torch.clamp(l, min=1e-20)[:, None], l, m


def flash_forward(q, k, v, causal, scale, block, tile_rows=32):
    """K1 over (n_bh, T, D) float32 tensors, tile by tile: (out, lse)."""
    n_bh, t, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(n_bh, t, dtype=torch.float32)
    for bh in range(n_bh):
        qs = q[bh] * torch.tensor(scale, dtype=torch.float32)
        for r0 in range(0, t, tile_rows):
            rows = torch.arange(r0, min(r0 + tile_rows, t))
            horizons = rows + 1 if causal else torch.full_like(rows, t)
            o, l, m = tile_forward(qs[rows], k[bh], v[bh], horizons, block)
            out[bh, rows] = o
            lse[bh, rows] = (torch.where(torch.isfinite(m), m,
                                         torch.tensor(0.0))
                             + torch.log(torch.clamp(l, min=1e-38)))
    return out, lse
