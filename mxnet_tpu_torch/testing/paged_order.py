"""Emulation, on CPU float32 tensors, of the orders in which the
paged-attention kernel K2 can run one query row's online softmax.

``merge_sequential`` is the order one warp gives a query row, block
after block, as K1 and K2 ran it before their redesigns (the pieces are
``csrc/online_softmax.cuh``'s; the tiled K1 keeps this order:
``testing/flash_order.py``).
``merge_split`` is the order of K2's decode kernel
(``csrc/paged_attention.cu``): every score first, then the block maxima
and their prefix max, then each block's probability and value sums
(computed here for all blocks at once), and last the serial fold, with
the blocks past every horizon folded as one (exact: see the fold).
(The speculative verify's tiles of up to 8 rows run that kernel too.)
``prefill_tile`` is the order of K2's prefill tiles: K1's tile
(``csrc/flash_tile.cuh``, emulated by ``testing/flash_order.py``) over
the slot's context as the kernel stages it through the page table, chunk
by chunk up to the tile's longest horizon, each score summed in one
thread in the butterfly's tree, then the fold.

All use the kernels' arithmetic: each product and sum a separate fp32
rounding (no fused multiply-add), a score as 32 lane partials over
d = t, t + 32, ... added by the xor butterfly 16, 8, 4, 2, 1, ``fmax``
for maxima, and one shared ``exp``.  Equal bits from them show that
spreading a row's blocks over warps, or a tile's keys over threads,
changes no operation.
"""
from __future__ import annotations

import torch

__all__ = ["scores", "merge_sequential", "merge_split", "gather",
           "prefill_tile"]

_WARP = 32
_NEG_INF = float("-inf")


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _exp(x):
    """fp32 exp through fp64, so that an element's result does not hang
    on whether torch takes a vectorised or a scalar path for it."""
    return torch.exp(x.double()).float()


def scores(q, k):
    """Scores of one scaled query row ``q`` (D,) against key rows ``k``
    (n, D): ``row_dot``'s lane partials, then its butterfly."""
    n, d = k.shape
    lanes = torch.zeros(n, _WARP, dtype=torch.float32)
    for i in range(0, d, _WARP):
        w = min(_WARP, d - i)
        lanes[:, :w] = lanes[:, :w] + q[i:i + w] * k[:, i:i + w]
    o = _WARP // 2
    while o:
        # lane t adds lane t ^ o; both get the same bits, keep the low half
        lanes = lanes[:, :o] + lanes[:, o:2 * o]
        o //= 2
    return lanes[:, 0]


def _rescale(m, bmax, exp=_exp):
    """``online_softmax.cuh::rescale``: (new max, shift, correction)."""
    new_m = torch.fmax(m, bmax)
    safe = torch.where(torch.isfinite(new_m), new_m, _f32(0.0))
    corr = torch.where(torch.isfinite(m), exp(m - safe), _f32(0.0))
    return new_m, safe, corr


def _fold(x, corr, part):
    return x * corr + part


def merge_sequential(q, k, v, horizon, page, exp=_exp):
    """The one-warp-a-row online softmax over the blocks of ``page`` keys
    of ``k`` in order, keys at positions >= ``horizon`` masked; returns
    (out (D,), l).  ``exp`` is the shared exp (on the card, a kernel's
    ``expf``, to hold a kernel's rows to these bits)."""
    m = _f32(_NEG_INF)
    l = _f32(0.0)
    acc = torch.zeros(v.shape[1], dtype=torch.float32)
    for start in range(0, k.shape[0], page):
        n = max(0, min(page, horizon - start))
        sc = torch.full((page,), _NEG_INF, dtype=torch.float32)
        bmax = _f32(_NEG_INF)
        for j in range(n):
            s = scores(q, k[start + j:start + j + 1])[0]
            sc[j] = s
            bmax = torch.fmax(bmax, s)
        m, safe, corr = _rescale(m, bmax, exp)
        psum = _f32(0.0)
        pv = torch.zeros_like(acc)
        for j in range(page):
            if torch.isfinite(sc[j]):
                p = exp(sc[j] - safe)
                psum = psum + p
                pv = pv + p * v[start + j]
        l = _fold(l, corr, psum)
        acc = _fold(acc, corr, pv)
    return acc / torch.clamp(l, min=1e-20), l


def merge_split(q, k, v, horizon, page):
    """The redesigned K2's order for the same row; returns (out, l)."""
    cap, d = k.shape
    n_blocks = cap // page
    horizon = max(0, min(horizon, cap))
    n_vis = -(-horizon // page)  # blocks with a visible key
    keys = n_vis * page
    # 1. every score (masked keys -inf), then each block's max in key order
    sc = torch.full((keys,), _NEG_INF, dtype=torch.float32)
    if horizon:
        sc[:horizon] = scores(q, k[:horizon])
    sc = sc.reshape(n_vis, page)
    bmax = torch.full((n_vis,), _NEG_INF, dtype=torch.float32)
    for j in range(page):
        bmax = torch.fmax(bmax, sc[:, j])
    # 2. the prefix max; each block's shift and correction
    m = torch.empty(n_vis + 1, dtype=torch.float32)
    m[0] = _NEG_INF
    for b in range(n_vis):
        m[b + 1] = torch.fmax(m[b], bmax[b])
    _, safe, corr = _rescale(m[:-1], bmax)
    # 3. every block's sums at once, over its keys in order
    vis = torch.isfinite(sc)
    p = torch.where(vis, _exp(sc - safe[:, None]), _f32(0.0))
    vb = v[:keys].reshape(n_vis, page, d)
    psum = torch.zeros(n_vis, dtype=torch.float32)
    pv = torch.zeros(n_vis, d, dtype=torch.float32)
    for j in range(page):
        sel = vis[:, j]
        psum = torch.where(sel, psum + p[:, j], psum)
        pv = torch.where(sel[:, None], pv + p[:, j, None] * vb[:, j], pv)
    # 4. the fold in block order, then the blocks past every horizon
    l = _f32(0.0)
    acc = torch.zeros(d, dtype=torch.float32)
    for b in range(n_vis):
        l = _fold(l, corr[b], psum[b])
        acc = _fold(acc, corr[b], pv[b])
    # (a masked block's correction is rescale(m, -inf)'s, 1 for a finite
    # m and 0 for -inf; x * c + 0 is then the same after one fold as
    # after many, so one fold stands for every trailing block)
    if n_blocks > n_vis:
        c = _rescale(m[-1], _f32(_NEG_INF))[2]
        l = _fold(l, c, _f32(0.0))
        acc = _fold(acc, c, torch.zeros(d, dtype=torch.float32))
    return acc / torch.clamp(l, min=1e-20), l


def gather(pool, table, n):
    """Keys 0 .. n - 1 of one slot's context: ``pool`` (pages, page, D)
    read through the slot's ``table``, page by page; pages past the n-th
    key are not touched."""
    page = pool.shape[1]
    ids = torch.as_tensor(table)[:-(-n // page)].long()
    return pool[ids].reshape(-1, pool.shape[-1])[:n]


def prefill_tile(q, k_pool, v_pool, table, horizons, page):
    """The redesigned K2's order for one tile of query rows ``q`` (R, D,
    scaled) of one slot and head, row r seeing keys j < ``horizons[r]``:
    K1's tile with block = page over the keys and values the kernel
    stages through ``table``, up to the tile's longest horizon (K2q
    stages ``quantize.kv_dequantize`` of its codes).  Returns (out (R,
    D), l (R,))."""
    from . import flash_order  # it imports this module

    horizons = torch.as_tensor(horizons)
    n = int(horizons.max()) if len(horizons) else 0
    out, l, _ = flash_order.tile_forward(q, gather(k_pool, table, n),
                                         gather(v_pool, table, n), horizons,
                                         page)
    return out, l
