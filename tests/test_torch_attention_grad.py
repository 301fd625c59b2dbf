"""The port's flash-attention forward (with logsumexp) and recompute
backward against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages.  On the CPU
the port's wrappers run their plain versions — ``flash_forward_plain``
and ``flash_backward_plain``, the arithmetic kernels K1 and K4 are held
to on the card — against the JAX package's ``_flash_forward`` and the
``jax.vjp`` of its ``flash_attention`` (the lax twin of
``_pallas_attention`` and its VJP).

Tolerances:
* fp32: atol 2e-6 — both sides compute in fp32 from the same inputs and
  reduce in other orders (unit-normal inputs, head_dim 16, T <= 37).
* bf16: every value is an fp32 result rounded once to bf16 on both
  sides, so two results may sit one bf16 step apart: rtol 2^-7 (one
  step at the bottom of a binade), plus atol 1e-5 for gradient entries
  that cancel toward zero in fp32 before the rounding.
* lse is fp32 in both dtypes: atol 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import registry as treg

TOL = {"float32": dict(rtol=0, atol=2e-6),
       "bfloat16": dict(rtol=2.0 ** -7, atol=1e-5)}

# (batch, heads, T, D, block): T = 37 leaves a ragged last block of 5;
# T = 5 is shorter than one block, at batch 1
SHAPES = [(2, 2, 37, 16, 16), (1, 3, 5, 8, 16)]


def _inputs(seed, shape):
    rs = np.random.RandomState(seed)
    xs = [rs.randn(*shape).astype(np.float32) for _ in range(4)]
    return xs


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,h,t,d,block", SHAPES)
def test_forward_and_lse_match_jax(dtype, causal, n, h, t, d, block):
    q, k, v, _ = _inputs(t + causal, (n, h, t, d))
    scale = 1.0 / d ** 0.5
    want_out, want_lse = jax.jit(
        lambda q, k, v: jattn._flash_forward(q, k, v, causal, scale, block))(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    got_out, got_lse = tattn.flash_forward_plain(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal, scale,
        block)
    assert str(got_out.dtype).endswith(dtype)
    assert got_lse.dtype == torch.float32
    assert got_lse.shape == (n, h, t, 1)
    np.testing.assert_allclose(_np(got_out), _np(want_out), **TOL[dtype])
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), rtol=0,
                               atol=2e-6)


def _jax_vjp(fn, args, g):
    """(fn(*args), vjp(g)) under one jit: one compile, not one per op."""
    def both(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)

    return jax.jit(both)(tuple(args), g)


def _port_grads(q, k, v, g, causal, block, dtype):
    qt, kt, vt = (_torch(x, dtype).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt, causal=causal, block=block)
    out.backward(_torch(g, dtype))
    return out, (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,h,t,d,block", SHAPES)
def test_gradients_match_jax_vjp(dtype, causal, n, h, t, d, block):
    q, k, v, g = _inputs(3 * t + causal, (n, h, t, d))
    want_out, want = _jax_vjp(
        lambda q, k, v: jattn.flash_attention(q, k, v, causal=causal,
                                              block=block),
        (_jax(q, dtype), _jax(k, dtype), _jax(v, dtype)), _jax(g, dtype))
    got_out, got = _port_grads(q, k, v, g, causal, block, dtype)
    np.testing.assert_allclose(_np(got_out.detach()), _np(want_out),
                               **TOL[dtype])
    for a, b in zip(got, want):
        assert str(a.dtype).endswith(dtype)
        np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])


def test_backward_plain_matches_jax_flash_backward():
    """The plain backward alone, from one saved forward, against
    ``_flash_backward`` (fp32, ragged, causal)."""
    q, k, v, g = _inputs(5, (1, 2, 37, 16))
    scale = 0.25
    q, k, v, g = (jnp.asarray(x) for x in (q, k, v, g))

    @jax.jit
    def ref(q, k, v, g):
        out, lse = jattn._flash_forward(q, k, v, True, scale, 16)
        return out, lse, jattn._flash_backward(q, k, v, out, lse, g, True,
                                               scale, 16)

    out, lse, want = ref(q, k, v, g)
    got = tattn.flash_backward_plain(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)),
        True, scale, 16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)


def test_cotangent_linearity():
    """Twin of tests/test_attention.py::test_custom_vjp_cotangent_is_linear:
    a loss scale rides the cotangent, so the backward must be linear in
    it.  Scaling by 1024, a power of two, is exact in floating point, so
    the port's gradients scale bit for bit; they also match JAX's."""
    q, k, v, g = _inputs(3, (1, 2, 33, 8))
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    _, want = _jax_vjp(
        lambda q, k, v: jattn.flash_attention(q, k, v, causal=True,
                                              block=16),
        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), jnp.asarray(g))
    _, lo = _port_grads(q, k, v, g, True, 16, "float32")
    _, hi = _port_grads(q, k, v, g * 1024.0, True, 16, "float32")
    for a, b, j in zip(lo, hi, want):
        np.testing.assert_array_equal(a.numpy() * 1024.0, b.numpy())
        np.testing.assert_allclose(a.numpy(), np.asarray(j),
                                   **TOL["float32"])


def test_no_lse_without_grad():
    """Without autograd recording, flash_attention is the forward alone
    (serving's path: the kernel writes no logsumexp)."""
    q, k, v, _ = _inputs(1, (1, 1, 9, 8))
    qt = torch.from_numpy(q).requires_grad_()
    with torch.no_grad():
        out = tattn.flash_attention(qt, torch.from_numpy(k),
                                    torch.from_numpy(v), block=4)
    assert out.grad_fn is None
    want = tattn.flash_attention_plain(qt.detach(), torch.from_numpy(k),
                                       torch.from_numpy(v), True,
                                       1.0 / 8 ** 0.5, 4)
    assert torch.equal(out, want)


def test_env_impl_selection(monkeypatch):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(5, (1, 2, 24, 8)))
    monkeypatch.setenv("MXNET_ATTN_IMPL", "reference")
    assert tattn.attention_impl() == "reference"
    ref = tattn.dot_product_attention(q, k, v)
    assert torch.equal(ref, tattn.reference_attention(q, k, v))
    monkeypatch.setenv("MXNET_ATTN_IMPL", "flash")
    assert tattn.attention_impl() == "flash"
    fl = tattn.dot_product_attention(q, k, v)
    monkeypatch.setenv("MXNET_ATTN_IMPL", "auto")
    au = tattn.dot_product_attention(q, k, v)
    assert torch.equal(fl, au)
    assert torch.equal(fl, tattn.flash_attention(q, k, v))
    torch.testing.assert_close(ref, fl, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("MXNET_ATTN_IMPL", "bogus")
    with pytest.raises(MXNetError, match="MXNET_ATTN_IMPL"):
        tattn.dot_product_attention(q, k, v)
    with pytest.raises(MXNetError, match="window"):
        # the windowed backward is a later slice of the port
        tattn.dot_product_attention(q.requires_grad_(), k, v, impl="flash",
                                    window=4)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_attn_impl_attr_selects_per_op(monkeypatch, impl):
    """The ``attn_impl`` op attr wins over the env, in both packages, and
    the two packages agree on MultiHeadAttention's output and
    gradients."""
    monkeypatch.setenv("MXNET_ATTN_IMPL",
                       "flash" if impl == "reference" else "reference")
    rs = np.random.RandomState(8)
    n, t, c, heads = 2, 13, 16, 2
    arrays = [rs.randn(n, t, c).astype(np.float32),
              0.3 * rs.randn(3 * c, c).astype(np.float32),
              0.1 * rs.randn(3 * c).astype(np.float32),
              0.3 * rs.randn(c, c).astype(np.float32),
              0.1 * rs.randn(c).astype(np.float32)]
    g = rs.randn(n, t, c).astype(np.float32)
    attrs = {"num_heads": heads, "attn_impl": impl, "attn_block": 8}
    jfn = jreg.get("MultiHeadAttention").compute
    want, want_g = _jax_vjp(
        lambda *xs: jfn(jreg.FrozenAttrs(attrs), *xs),
        [jnp.asarray(x) for x in arrays], jnp.asarray(g))
    xs = [torch.from_numpy(x).requires_grad_() for x in arrays]
    calls = []
    spy = tattn.reference_attention if impl == "reference" \
        else tattn.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return spy(*a, **kw)

    monkeypatch.setattr(tattn, spy.__name__, counted)
    got = treg.get("MultiHeadAttention").compute(treg.FrozenAttrs(attrs),
                                                 *xs)
    got.backward(torch.from_numpy(g))
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=2e-6)
    for x, w in zip(xs, want_g):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
