"""The arithmetic of the bf16 tensor-core attention kernels (K7, K8), and
the per-source build flags, on the CPU.

K7/K8 run only on the card.  Their arithmetic — bf16 dots with fp32
results, the scale after the dot, exp2, P and dS rounded to bf16 before
the products — is emulated in plain PyTorch by
``mxnet_tpu_torch.testing.attention_sm90`` and held, on numpy-seeded
inputs, to the derived bound (``TOLERANCE_NOTE`` there) against the
port's plain versions and against the JAX package's ``_flash_forward``
and ``_flash_backward``: the same bound the card holds the kernels to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu_torch import _cuda
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.testing import attention_sm90 as sm90

# (T, D, causal): ragged key blocks (T = 5, 37, 130 against the 128-key
# blocks of the emulation), head dims that pad (16, 80) and that do not
SHAPES = [(5, 16, True), (37, 64, False), (37, 80, True), (130, 128, True)]


def _inputs(seed, t, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(1, 2, t, d).astype(np.float32) for _ in range(4)]


def _bf16(xs):
    return [torch.from_numpy(x).bfloat16() for x in xs]


def _jax_bf16(xs):
    return [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]


def _torch(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _assert_inside(got, want, bound, what):
    err, ratio = sm90.violation(got, want, bound)
    assert ratio <= 1.0, "%s: error %g is %.3g x the bound (%s)" % (
        what, err, ratio, sm90.TOLERANCE_NOTE)


@pytest.mark.parametrize("t,d,causal", SHAPES)
def test_emulated_forward_inside_bound_of_both_references(t, d, causal):
    q, k, v, _ = _bf16(_inputs(t + d, t, d))
    scale = 1.0 / d ** 0.5
    got, got_lse = sm90.forward_emulated(q, k, v, causal, scale)
    assert got.dtype == torch.bfloat16 and got_lse.shape == (1, 2, t, 1)
    want, want_lse = tattn.flash_forward_plain(q, k, v, causal, scale, 16)
    _assert_inside(got, want, sm90.forward_bound(q, k, v, want, causal,
                                                 scale), "vs port plain")
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=2e-5)
    jq, jk, jv, _ = _jax_bf16(_inputs(t + d, t, d))
    jout, jlse = jattn._flash_forward(jq, jk, jv, causal, scale, 16)
    jout = _torch(jout)
    _assert_inside(got, jout, sm90.forward_bound(q, k, v, jout, causal,
                                                 scale), "vs JAX")
    torch.testing.assert_close(got_lse, _torch(jlse), rtol=0, atol=2e-5)


@pytest.mark.parametrize("t,d,causal", SHAPES)
def test_emulated_backward_inside_bound_of_both_references(t, d, causal):
    xs = _inputs(2 * t + d, t, d)
    q, k, v, g = _bf16(xs)
    scale = 1.0 / d ** 0.5
    out, lse = tattn.flash_forward_plain(q, k, v, causal, scale, 16)
    got = sm90.backward_emulated(q, k, v, out, lse, g, causal, scale)
    want = tattn.flash_backward_plain(q, k, v, out, lse, g, causal, scale,
                                      16)
    bounds = sm90.backward_bounds(q, k, v, out, lse, g, want, causal, scale)
    for name, a, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        assert a.dtype == torch.bfloat16
        _assert_inside(a, w, b, name + " vs port plain")
    jq, jk, jv, jg = _jax_bf16(xs)
    jout, jlse = jattn._flash_forward(jq, jk, jv, causal, scale, 16)
    jwant = [_torch(x) for x in jattn._flash_backward(
        jq, jk, jv, jout, jlse, jg, causal, scale, 16)]
    bounds = sm90.backward_bounds(q, k, v, out, lse, g, jwant, causal, scale)
    for name, a, w, b in zip(("dq", "dk", "dv"), got, jwant, bounds):
        _assert_inside(a, w, b, name + " vs JAX")


def test_emulated_backward_is_linear_in_g():
    q, k, v, g = _bf16(_inputs(3, 37, 64))
    out, lse = sm90.forward_emulated(q, k, v, True, 0.125)
    one = sm90.backward_emulated(q, k, v, out, lse, g, True, 0.125)
    two = sm90.backward_emulated(q, k, v, out, lse, 2 * g, True, 0.125)
    for a, b in zip(one, two):
        assert torch.equal(2 * a, b)


def test_bf16_head_dims_pad_to_the_instantiated_widths():
    assert [tattn.sm90_width(d) for d in (1, 16, 64, 65, 80, 128, 129,
                                          256)] == [64, 64, 64, 128, 128,
                                                    128, 256, 256]
    q = torch.ones(1, 2, 5, 80, dtype=torch.bfloat16)
    (q4,), n, h, dp, strides = tattn._sm90_operands(5, 80, q)
    assert (n, h, dp) == (1, 2, 128) and q4.shape == (1, 2, 5, 128)
    assert q4[..., :80].eq(1).all() and q4[..., 80:].eq(0).all()
    assert list(strides) == [2 * 5 * 128, 5 * 128, 128]


def test_strided_head_views_reach_the_kernel_without_a_copy():
    """The (n, h, T, D) heads the attention op cuts from its fused QKV
    projection go to the tensor maps as they lie; views TMA cannot read
    (D not contiguous, a stride off 16 bytes) are copied."""
    n, t, h, d = 2, 7, 3, 64
    qkv = torch.randn(n, t, 3 * h * d).bfloat16()
    q, k, v = (x.reshape(n, t, h, d).transpose(1, 2)
               for x in qkv.chunk(3, dim=-1))
    views, n4, h4, dp, strides = tattn._sm90_operands(t, d, q, k, v)
    assert (n4, h4, dp) == (n, h, d)
    for x, view in zip((q, k, v), views):
        assert view.data_ptr() == x.data_ptr()
    assert list(strides) == [t * 3 * h * d, d, 3 * h * d] * 3
    odd = torch.randn(1, 1, t, d + 1).bfloat16()[..., 1:]
    (view,), *_ = tattn._sm90_operands(t, d, odd)
    assert view.is_contiguous() and view.data_ptr() != odd.data_ptr()
    torch.testing.assert_close(view, odd, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 264),
                                     (torch.float32, 264),
                                     (torch.float16, 64)])
def test_kernel_path_raises_on_shapes_it_does_not_take(dtype, d):
    """Checked before any launch: the card's wrappers raise, never fall
    back."""
    q = torch.zeros(1, 1, 8, d, dtype=dtype)
    with pytest.raises(MXNetError):
        tattn._flash_forward_cuda(q, q, q, True, 0.1, 16, True)
    with pytest.raises(MXNetError):
        tattn._flash_backward_cuda(q, q, q, q, q[..., :1].float(), q, True,
                                   0.1, 16)


def test_exact_sources_keep_fmad_false_and_sm90_sources_drop_it():
    """The exact sources build with -fmad=false; the sm90 kernels and the
    fp32 backward K4 (no bit contract) build without it."""
    stems = {stem for stem, _, _ in _cuda.KERNELS.values()}
    fast = {"flash_attention_sm90", "flash_attention_backward_sm90",
            "flash_attention_backward"}
    assert fast < stems
    for stem in stems:
        flags = _cuda.nvcc_flags(stem)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert ("-fmad=false" in flags) == (stem not in fast), stem
    for stem in ("flash_attention", "paged_attention", "linear",
                 "kv_quant", "batch_norm"):
        assert "-fmad=false" in _cuda.nvcc_flags(stem)
    assert "-fmad=false" in _cuda.NVCC_FLAGS  # run-time (rtc) sources


def test_build_key_changes_with_a_source_flag(monkeypatch):
    before = _cuda._source_key()
    assert _cuda._source_key() == before
    monkeypatch.setitem(_cuda.SOURCE_FLAGS, "flash_attention_sm90",
                        _cuda.NVCC_FLAGS)
    assert _cuda._source_key() != before
    monkeypatch.setitem(_cuda.SOURCE_FLAGS, "linear", _cuda.FAST_FLAGS)
    assert _cuda._source_key() != before
