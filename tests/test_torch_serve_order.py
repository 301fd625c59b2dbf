"""The exactness argument behind K2's redesign, on the CPU.

Spreading one query row's pages over warps — every score, then the
block maxima and their prefix max, then each page's probability and
value sums, then the serial fold — runs the same fp32 operations as one
warp merging the row page after page, so the two orders give the same bits
(``mxnet_tpu_torch/testing/paged_order.py`` emulates both with separate
fp32 products and sums, the lane butterfly and one shared exp).  Both
are also held against the JAX package's ``decode_attention`` on the
same numpy inputs.

Tolerance: bit equality (as int32 words) between the two orders; atol
1e-5 against the JAX package, chip_smoke.py's ATTN_ATOL (fp32 on both
sides; the D = 128 dots and the per-page sums run in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu_torch.testing import paged_order

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
