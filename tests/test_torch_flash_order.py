"""The exactness argument behind K1's tiled redesign, on the CPU.

K1 (``csrc/flash_attention.cu``) forms each score in one thread, summing
the 32 lane partials in the xor butterfly's own tree (its leaves in
bit-reversed lane order, added as a binary counter), and runs a tile of
query rows together: scores of a group of blocks, then per row and block
the max, rescale, probabilities and serial sums, then P.V in key order.
``mxnet_tpu_torch/testing/flash_order.py`` emulates that order with
separate fp32 products and sums; ``testing/paged_order.py`` emulates the
one-warp-a-row order serving's bit-exactness was proved against.  The
two must agree bit for bit, and the tiled order must compute the JAX
package's ``_flash_forward``.

Tolerance: bit equality (as int32 words) between the orders, NaN where
both are NaN; atol 1e-5 on out and 5e-5 on lse against the JAX package
(chip_smoke.py's ATTN_ATOL and LSE_ATOL: fp32 on both sides, the dots
and the per-block sums in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu_torch.testing import flash_order, paged_order

ATTN_ATOL = 1e-5
LSE_ATOL = 5e-5


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same(a, b):
    """Bit-equal, NaN where both are NaN."""
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    assert torch.equal(_bits(a[~nan]), _bits(b[~nan]))


@pytest.mark.parametrize("d", [16, 40, 64, 128, 256])
def test_tree_scores_equal_the_butterfly(d):
    """One thread's bit-reversed binary-counter sum is the warp's xor
    butterfly, bit for bit: mixed signs, zero keys and signed-zero
    products, and keys that cancel the query exactly or nearly."""
    rs = np.random.RandomState(d)
    q = rs.randn(d).astype(np.float32)
    k = rs.randn(48, d).astype(np.float32)
    k[1] = 0.0
    k[2] = -0.0
    k[3, ::2] = 0.0
    k[4] = -q                     # every product negative
    k[5, : d // 2] = q[: d // 2]  # halves that cancel
    k[5, d // 2:] = -q[d // 2:]
    k[6] = q * np.float32(1e-30)  # products near the subnormal range
    k[7] = np.where(np.arange(d) % 3 == 0, 1e4, -1e-4).astype(np.float32)
    qt = torch.from_numpy(q)
    kt = torch.from_numpy(k)
    got = flash_order.tree_scores(qt[None], kt)[0]
    want = paged_order.scores(qt, kt)
    assert torch.equal(_bits(got), _bits(want))
    # the lane partials added left to right are another sum on some key,
    # so the equality above is a test of the order
    lanes = torch.zeros(48, 32)
    for i in range(0, d, 32):
        w = min(32, d - i)
        lanes[:, :w] = lanes[:, :w] + qt[i:i + w] * kt[:, i:i + w]
    serial = torch.zeros(48)
    for t in range(32):
        serial = serial + lanes[:, t]
    assert not torch.equal(_bits(got), _bits(serial))


def _case(seed, t, d):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(t, d).astype(np.float32))
                 for _ in range(3))


def _check_rows(q, k, v, causal, block, tile_rows, rows):
    """K1's tile order against merge_sequential at ``rows``, each run in
    its tile."""
    t = q.shape[0]
    for r in rows:
        r0 = r // tile_rows * tile_rows
        tile = torch.arange(r0, min(r0 + tile_rows, t))
        hz = tile + 1 if causal else torch.full_like(tile, t)
        out, l, _ = flash_order.tile_forward(q[tile], k, v, hz, block)
        want, want_l = paged_order.merge_sequential(q[r], k, v,
                                                    int(hz[r - r0]), block)
        _same(out[r - r0], want)
        _same(l[r - r0], want_l)


# tile edges (first and last row of a tile, and the row after), ragged T
@pytest.mark.parametrize("block,t", [(8, 75), (16, 75), (128, 150)])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_order_equals_merge_sequential(block, t, causal):
    d, tile_rows = 40, 32
    q, k, v = _case(block + t, t, d)
    q = q * torch.tensor(d ** -0.5)
    rows = sorted({0, tile_rows - 1, tile_rows, 2 * tile_rows - 1,
                   2 * tile_rows, t - 1})
    _check_rows(q, k, v, causal, block, tile_rows, rows)


@pytest.mark.parametrize("block", [8, 16, 128])
def test_masked_inf_and_nan_stay_unread(block):
    """Keys past a row's horizon hold inf and NaN in k and v, inside the
    chunk the tile stages: the rows that do not see them keep
    merge_sequential's finite bits (the chunk runs the select).  Rows
    that see them agree too: a non-finite score leaves its key out of
    the sums, and a NaN value under a finite score gives NaN."""
    t, d, tile_rows = 100, 16, 32
    q, k, v = _case(block, t, d)
    for j, x in ((70, float("nan")), (71, float("inf")),
                 (72, float("-inf"))):
        k[j, ::3] = x
        v[j, 1::2] = x
    v[73, 5] = float("nan")
    rows = [64, 68, 69, 70, 72, 73, 80, 95]
    _check_rows(q, k, v, True, block, tile_rows, rows)
    r0 = 64
    tile = torch.arange(r0, r0 + tile_rows)
    out, _, _ = flash_order.tile_forward(q[tile], k, v, tile + 1, block)
    assert bool(torch.isfinite(out[:70 - r0]).all())
    assert bool(torch.isnan(out[73 - r0:, 5]).all())


def test_tile_order_matches_jax_flash_forward():
    """The tiled order computes the JAX package's ``_flash_forward``."""
    n, h, t, d, block = 1, 2, 37, 16, 8
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(n, h, t, d).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    want, want_lse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), True, scale, block)
    got, lse = flash_order.flash_forward(
        *(torch.from_numpy(x.reshape(n * h, t, d)) for x in (q, k, v)),
        True, scale, block, tile_rows=16)
    np.testing.assert_allclose(got.numpy().reshape(q.shape),
                               np.asarray(want), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(lse.numpy().reshape(n, h, t),
                               np.asarray(want_lse)[..., 0], rtol=0,
                               atol=LSE_ATOL)
