"""The exactness argument behind K2's redesigns, on the CPU.

Spreading one query row's pages over warps — every score, then the
block maxima and their prefix max, then each page's probability and
value sums, then the serial fold — runs the same fp32 operations as one
warp merging the row page after page, so the two orders give the same bits
(``mxnet_tpu_torch/testing/paged_order.py`` emulates both with separate
fp32 products and sums, the lane butterfly and one shared exp).  Both
are also held against the JAX package's ``decode_attention`` on the
same numpy inputs.  K2's prefill and verify tiles run K1's tile over the
pages (``paged_order.prefill_tile``): at any tile height, and with
horizons that cut pages, their rows are the decode order's and K1's
over the contiguous context, bit for bit.

Tolerance: bit equality (as int32 words) between the two orders; atol
1e-5 against the JAX package, chip_smoke.py's ATTN_ATOL (fp32 on both
sides; the D = 128 dots and the per-page sums run in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu_torch.testing import flash_order, paged_order

ATTN_ATOL = 1e-5
PAGE = 16


def _inputs(seed, n_rows, n_pages, d, zeros):
    rs = np.random.RandomState(seed)
    q = rs.randn(n_rows, d).astype(np.float32)
    k = rs.randn(n_rows, n_pages * PAGE, d).astype(np.float32)
    v = rs.randn(n_rows, n_pages * PAGE, d).astype(np.float32)
    if zeros:  # zero keys (scores of 0), signed-zero values and queries
        k[:, ::5] = 0.0
        v[:, 1::3] = -0.0
        v[:, 2::7, ::2] = 0.0
        q[:, ::4] = -0.0
    return q, k, v


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("n_pages,horizons,zeros", [
    # none, one key, page edges and edge + 1, ragged, the whole capacity
    (20, [0, 1, 15, 16, 17, 32, 33, 100, 211, 319, 320], False),
    (20, [0, 1, 16, 17, 57, 320], True),
    (64, [64 * PAGE - 15, 64 * PAGE], False),
], ids=["20pages", "20pages-signed-zeros", "64pages"])
def test_split_order_equals_merge_block_order(n_pages, horizons, zeros):
    d = 128
    q, k, v = _inputs(len(horizons) + n_pages, len(horizons), n_pages, d,
                      zeros)
    scale = np.float32(1.0 / np.sqrt(d))
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q[:, None, None]), jnp.asarray(k[:, None]),
        jnp.asarray(v[:, None]), jnp.asarray(np.array(horizons, np.int32)),
        scale=float(scale), block=PAGE, mi=True))[:, 0, 0]
    for i, horizon in enumerate(horizons):
        qs = torch.from_numpy(q[i]) * torch.tensor(scale)
        kt, vt = torch.from_numpy(k[i]), torch.from_numpy(v[i])
        seq, l_seq = paged_order.merge_sequential(qs, kt, vt, horizon, PAGE)
        split, l_split = paged_order.merge_split(qs, kt, vt, horizon, PAGE)
        assert torch.equal(_bits(seq), _bits(split)), horizon
        assert torch.equal(_bits(l_seq), _bits(l_split)), horizon
        if horizon == 0:
            assert not split.any()
        np.testing.assert_allclose(split.numpy(), want[i], rtol=0,
                                   atol=ATTN_ATOL)


def _butterfly_score(q, k):
    """One score as a warp forms it, in numpy float32 scalars: lane t
    sums q[d] k[d] over d = t, t + 32, ...; then every lane adds the lane
    t ^ o for o = 16, 8, 4, 2, 1."""
    lanes = [np.float32(0.0)] * 32
    for d in range(len(q)):
        lanes[d % 32] = np.float32(lanes[d % 32] + np.float32(q[d] * k[d]))
    for o in (16, 8, 4, 2, 1):
        lanes = [np.float32(lanes[t] + lanes[t ^ o]) for t in range(32)]
    assert len({float(v) for v in lanes}) == 1  # every lane, same bits
    return lanes[0]


def test_scores_follow_the_lane_butterfly():
    """The emulation's scores are the warp's xor butterfly over the lane
    partials, bit for bit, and not a left-to-right sum (which differs on
    some input, or the order tests would prove nothing)."""
    rs = np.random.RandomState(3)
    q = rs.randn(128).astype(np.float32)
    k = rs.randn(256, 128).astype(np.float32)
    got = paged_order.scores(torch.from_numpy(q), torch.from_numpy(k))
    want = np.array([_butterfly_score(q, k[i]) for i in range(8)])
    assert np.array_equal(got[:8].numpy().view(np.int32),
                          want.view(np.int32))
    naive = torch.zeros(256, dtype=torch.float32)
    for d in range(128):
        naive = naive + float(q[d]) * torch.from_numpy(k[:, d])
    assert not torch.equal(got, naive)
    np.testing.assert_allclose(got.numpy(), k.astype(np.float64) @ q,
                               rtol=0, atol=1e-4)


def _pools(seed, n_pages, d, mode):
    """One slot's context (n_pages pages) in pools of ``n_pages + 3``
    pages through a shuffled table; the pages off the table are NaN.
    With ``mode`` the pools are quantized per row and the context is the
    dequantized one (what K2q stages)."""
    from mxnet_tpu_torch import quantize as Q

    rs = np.random.RandomState(seed)
    k, v = (torch.from_numpy(rs.randn(n_pages * PAGE, d).astype(np.float32))
            for _ in range(2))
    if mode:
        k, v = (Q.kv_dequantize(*Q.kv_quantize_rows(x[:, None], mode))[:, 0]
                for x in (k, v))
    table = rs.permutation(n_pages + 3)[:n_pages]
    pools = []
    for x in (k, v):
        pool = torch.full((n_pages + 3, PAGE, d), float("nan"))
        pool[torch.from_numpy(table)] = x.reshape(n_pages, PAGE, d)
        pools.append(pool)
    return k, v, pools, table


# tile heights of 1 to 16 rows; prefill rows offset + j + 1 (a bucket
# whose rows cut pages, offsets on and off a page edge), verify rows
# committed + j + 1, and ragged horizons with empty rows
@pytest.mark.parametrize("tile", [1, 4, 8, 16])
@pytest.mark.parametrize("mode", ["", "int8", "fp8"])
def test_prefill_tile_order_equals_decode_and_k1_order(tile, mode):
    d, n_pages = 128, 12
    k, v, (k_pool, v_pool), table = _pools(tile + len(mode), n_pages, d,
                                           mode)
    rs = np.random.RandomState(40 + tile)
    q = torch.from_numpy(rs.randn(24, d).astype(np.float32)) * torch.tensor(
        np.float32(1.0 / np.sqrt(d)))
    for horizons in ([37 + j + 1 for j in range(16)],
                     [PAGE * 3 + j + 1 for j in range(8)],
                     [100 + j + 1 for j in range(5)],
                     [0, 1, 15, 16, 17, 33, 0, 191, 192, 64, 65, 2]):
        rows = q[:len(horizons)]
        # K1's rows: its own 32-row tile over the contiguous context
        k1, k1_l, _ = flash_order.tile_forward(rows, k, v,
                                               torch.tensor(horizons), PAGE)
        for r0 in range(0, len(horizons), tile):
            hz = torch.tensor(horizons[r0:r0 + tile])
            got, l = paged_order.prefill_tile(rows[r0:r0 + tile], k_pool,
                                              v_pool, table, hz, PAGE)
            for i, n in enumerate(hz.tolist()):
                want, want_l = paged_order.merge_split(rows[r0 + i], k, v, n,
                                                       PAGE)
                assert torch.equal(_bits(got[i]), _bits(want)), (n, tile)
                assert torch.equal(_bits(l[i]), _bits(want_l)), (n, tile)
                assert torch.equal(_bits(got[i]), _bits(k1[r0 + i])), n
                assert torch.equal(_bits(l[i]), _bits(k1_l[r0 + i])), n
                if n == 0:
                    assert not got[i].any()
