"""The port's attention and projection functions against the JAX package.

Inputs come from numpy seeds and go through both packages.  On the CPU
the port's wrappers run their plain PyTorch versions — the same
arithmetic the CUDA kernels are held to on the card (chip_smoke.py and
tests/test_torch_cuda.py) — so these tests pin the semantics of
``_pallas_attention``'s lax twin ``flash_attention``, of
``decode_attention`` over gathered pages, and of the exact-mode ``_mm``.

Tolerance: atol 1e-6 for attention (fp32, unit-normal inputs, head_dim
16; the two packages reduce in different orders, a few units of
roundoff), and the ``_mm`` comparison at atol 1e-6 on outputs of
magnitude ~0.1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.serve import model as jmodel
from mxnet_tpu_torch import _cuda
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import linear as tlinear

ATOL = 1e-6


def _qkv(seed, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mi", [True, False])
@pytest.mark.parametrize("t", [16, 13])  # 13: ragged last block of 8
def test_flash_attention_matches_jax(causal, mi, t):
    q, k, v = _qkv(t + 2 * causal + mi, (2, 2, t, 16))
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block=8, mi=mi))
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal, block=8,
                                mi=mi).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ref = np.asarray(jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv(7, (1, 3, 11, 8))
    want = np.asarray(jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = tattn.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_flash_attention_window_is_a_later_slice():
    """The windowed forward runs (the JAX package's windowed reference
    gives it); the windowed backward (K4/K7/K8's window) is the later
    slice, so a call autograd records raises."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, (1, 1, 8, 4)))
    got = tattn.flash_attention(q, k, v, window=4, block=4)
    want = np.asarray(jattn.reference_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=True, window=4))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(MXNetError, match="window"):
        tattn.flash_attention(q.requires_grad_(), k, v, window=4)


# ---------------------------------------------------------------------------
# paged attention (K2's plain version) vs decode_attention over a gathered
# context
# ---------------------------------------------------------------------------

PAGE, MAX_PAGES, H, D = 8, 3, 2, 16


def _paged_inputs(seed, s, nq):
    rs = np.random.RandomState(seed)
    n_pages = s * MAX_PAGES
    k_pool = rs.randn(n_pages + 1, PAGE, H, D).astype(np.float32)
    v_pool = rs.randn(n_pages + 1, PAGE, H, D).astype(np.float32)
    tables = rs.permutation(n_pages).reshape(s, MAX_PAGES).astype(np.int32)
    q = rs.randn(s, H, nq, D).astype(np.float32)
    return q, k_pool, v_pool, tables


def _gathered(pool, tables):
    """numpy gather of the slots' pages: (S, H, max_pages * page, D)."""
    s = tables.shape[0]
    return pool[tables].reshape(s, MAX_PAGES * PAGE, H, D).transpose(
        0, 2, 1, 3)


@pytest.mark.parametrize("per_row", [False, True])
def test_paged_attention_matches_jax_decode_attention(per_row):
    s, nq = 3, (4 if per_row else 1)
    q, k_pool, v_pool, tables = _paged_inputs(21 + per_row, s, nq)
    if per_row:  # prefill-style horizons offset + j + 1; slot 2 idle
        lengths = np.array([[3 + j for j in range(nq)],
                            [17 + j for j in range(nq)],
                            [0] * nq], np.int32)
    else:  # decode: one horizon per slot; slot 1 idle
        lengths = np.array([9, 0, MAX_PAGES * PAGE], np.int32)
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(_gathered(k_pool, tables)),
        jnp.asarray(_gathered(v_pool, tables)), jnp.asarray(lengths),
        block=PAGE, mi=True))
    got = tattn.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    idle = 2 if per_row else 1
    assert np.all(got[idle] == 0.0)  # a length-0 slot gives 0, not NaN


def test_paged_decode_row_equals_flash_row_bitwise():
    """Inside the port: a decode query over paged keys gives the same
    bits as the matching row of the blockwise forward over the same keys
    (block = page size) — the shared online-softmax step."""
    rs = np.random.RandomState(5)
    t = 19
    q, k, v = (rs.randn(1, H, t, D).astype(np.float32) for _ in range(3))
    full = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=True, block=PAGE, mi=True)
    n_pages = MAX_PAGES
    k_pool = np.zeros((n_pages + 1, PAGE, H, D), np.float32)
    v_pool = np.zeros_like(k_pool)
    tables = np.array([[2, 0, 1]], np.int32)
    for pos in range(t):
        page, off = tables[0, pos // PAGE], pos % PAGE
        k_pool[page, off] = k[0, :, pos]
        v_pool[page, off] = v[0, :, pos]
    row = tattn.paged_attention(
        torch.from_numpy(q[:, :, t - 1:t].copy()), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables),
        torch.tensor([t], dtype=torch.int32))
    assert torch.equal(row[0, :, 0], full[0, :, t - 1])


# ---------------------------------------------------------------------------
# the exact-mode projection (K3's plain version) vs the JAX _mm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
def test_mi_linear_matches_jax_mm(exact):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 24).astype(np.float32)
    w = (0.05 * rs.randn(40, 24)).astype(np.float32)
    b = (0.05 * rs.randn(40)).astype(np.float32)
    want = np.asarray(jmodel._mm(jnp.asarray(x), jnp.asarray(w), exact)
                      + jnp.asarray(b))
    got = tlinear.mi_linear(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), exact=exact).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_mi_linear_plain_is_row_count_invariant_and_chunks():
    """Row r of an M-row call equals the row alone, and the F-chunked
    plain form gives the bits of the unchunked one."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(9, 32).astype(np.float32))
    w = torch.from_numpy(rs.randn(50, 32).astype(np.float32))
    full = tlinear.mi_linear(x, w)
    for r in range(9):
        assert torch.equal(tlinear.mi_linear(x[r:r + 1], w), full[r:r + 1])
    old = tlinear._PLAIN_CHUNK
    try:
        tlinear._PLAIN_CHUNK = 9 * 32 * 7  # 7 outputs per chunk
        assert torch.equal(tlinear.mi_linear_plain(x, w), full)
    finally:
        tlinear._PLAIN_CHUNK = old


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: no build, no launch count."""
    _cuda.reset_launches()
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, (1, 1, 8, 4)))
    tattn.flash_attention(q, k, v, block=4)
    tlinear.mi_linear(q[0, 0], q[0, 0])
    assert set(_cuda.launches.values()) == {0}
