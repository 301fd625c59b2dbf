"""The port's BatchNorm against the JAX package's, on the CPU.

* The plain channel sums (``ops/pallas_bn.py``: ``bn_stats_plain``,
  ``bn_grad_sums_plain``, what a CPU tensor takes and what kernels K5/K6
  are held against on the card) against the JAX package's Pallas kernels
  run in interpret mode, at a shape its TPU gate takes and at two it
  rejects (C = 3, H·W = 49), NCHW and NHWC.
* The ``BatchNorm`` op in training and inference mode, ``fix_gamma`` on
  and off, fp32 and bf16, NCHW and NHWC: the output, dx, dγ, dβ for one
  numpy-seeded cotangent and the new moving statistics, against the JAX
  op through its registry and against its ``_bn_train`` directly.
* ``Activation("relu")`` at exactly 0: the gradient is 0.5, as
  ``jnp.maximum(x, 0)``'s is (``torch.relu``'s is 0).

Tolerances: fp32 rtol 1e-5 with atol 1e-5 × the tensor's largest
magnitude (both packages sum in fp32 in other orders; dx and the
centred values cancel toward zero).  bf16: each side rounds to bf16 at
other places — XLA keeps fused elementwise chains in fp32 and the JAX
op's bf16 backward is autodiff where the port's is the closed form of
``_bn_train`` — so an element may sit one bf16 step (2^-8 relative) of
its own value apart, plus one bf16 step of the tensor's largest
magnitude for entries that cancel: |diff| <= 2^-7 (|want| + max|want|).
The fp32 statistics and sums: rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_bn as jbn
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.nn_ops import _bn_train as j_bn_train
from mxnet_tpu_torch.ops import pallas_bn as tbn
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.nn_ops import _bn_train as t_bn_train

BF16_STEP = 2.0 ** -7


def _rand(rs, *shape, scale=1.0, shift=0.0):
    return (scale * rs.randn(*shape) + shift).astype(np.float32)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if want.size else 0.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    else:
        bound = BF16_STEP * (np.abs(want) + scale)
        assert np.all(np.abs(got - want) <= bound), \
            float(np.abs(got - want).max())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the plain sums against the JAX package's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 32, 16, 8), (2, 3, 8, 8),
                                   (2, 32, 7, 7)])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_plain_sums_match_the_pallas_kernels(shape, layout):
    rs = np.random.RandomState(sum(shape))
    x = _rand(rs, *shape, scale=2.0, shift=0.5)
    dy = _rand(rs, *shape)
    mean = x.mean(axis=(0, 2, 3))
    inv = 1.0 / np.sqrt(x.var(axis=(0, 2, 3)) + 1e-3)
    want = [np.asarray(v) for v in jbn.bn_stats(x, interpret=True)]
    want += [np.asarray(v) for v in jbn.bn_grad_sums(
        dy, x, mean, inv, interpret=True)]
    if layout == "NHWC":
        x, dy, axis = x.transpose(0, 2, 3, 1), dy.transpose(0, 2, 3, 1), 3
    else:
        axis = 1
    got = list(tbn.bn_stats_plain(torch.from_numpy(x.copy()), axis))
    got += list(tbn.bn_grad_sums_plain(
        torch.from_numpy(dy.copy()), torch.from_numpy(x.copy()),
        torch.from_numpy(mean), torch.from_numpy(inv), axis))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (shape[1],)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # a CPU tensor takes the plain version through the wrappers too
    np.testing.assert_array_equal(
        tbn.bn_stats(torch.from_numpy(x.copy()), axis)[1].numpy(),
        got[1].numpy())


def test_chunking_is_a_function_of_the_shape():
    """Rows per thread block and blocks per channel (the kernels' fixed
    summation order): every row covered once, and about 4096 blocks."""
    for outer, c, inner in ((256, 64, 12544), (256, 3, 50176),
                            (256, 2048, 49), (802816, 256, 1), (3, 5, 7)):
        rows, chunks = tbn.chunk_rows(outer, c, inner)
        assert (chunks - 1) * rows < outer <= chunks * rows
        tiles = c if inner > 1 else -(-c // 32)
        assert chunks * tiles <= 4096 + tiles or chunks == 1


# ---------------------------------------------------------------------------
# the BatchNorm op against the JAX package's
# ---------------------------------------------------------------------------

def _bn_inputs(dtype, layout, seed=0):
    rs = np.random.RandomState(seed)
    shape = (4, 6, 5, 3) if layout == "NCHW" else (4, 5, 3, 6)
    c = 6
    arrays = [_rand(rs, *shape, scale=1.5, shift=0.3),
              _rand(rs, c, scale=0.2, shift=1.0), _rand(rs, c, scale=0.2),
              _rand(rs, c, scale=0.1), 1.0 + 0.2 * rs.rand(c).astype(
                  np.float32)]
    cot = _rand(rs, *shape)
    if dtype == "bfloat16":  # round once so both packages see one input
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                  for a in arrays]
        cot = np.asarray(jnp.asarray(cot, jnp.bfloat16), np.float32)
    return arrays, cot, (1 if layout == "NCHW" else 3)


def _jax_bn(attrs, arrays, cot, jdt):
    """The JAX op's (out, new_mean, new_var, dx, dgamma, dbeta)."""
    jx = [jnp.asarray(a, jdt) for a in arrays]

    def jfn(d, g, b):
        return jreg.get("BatchNorm").compute(jreg.FrozenAttrs(attrs), d, g,
                                             b, jx[3], jx[4])

    outs, vjp = jax.vjp(jfn, *jx[:3])
    grads = vjp((jnp.asarray(cot, jdt), jnp.zeros_like(outs[1]),
                 jnp.zeros_like(outs[2])))
    return [_f32(v) for v in tuple(outs) + tuple(grads)]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("is_train", [True, False])
def test_batch_norm_op_matches_jax(is_train, fix_gamma, dtype, layout):
    """In bf16 the JAX op's dγ and dβ are sums over the batch that XLA
    accumulates in bf16 (1.3 % off the fp32 values here, where the port's
    fp32 sums are 0.2 % off), so those two are held against the JAX op
    in fp32 on the same bf16-rounded inputs, and must be no farther from
    it than the JAX op's own bf16 result."""
    arrays, cot, axis = _bn_inputs(dtype, layout)
    attrs = {"eps": 2e-5, "momentum": 0.9, "fix_gamma": fix_gamma,
             "axis": axis, "__is_train__": is_train}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = _jax_bn(attrs, arrays, cot, jdt)

    tdt = getattr(torch, dtype)
    tx = [torch.from_numpy(a).to(tdt) for a in arrays]
    for t in tx[:3]:
        t.requires_grad_()
    outs = treg.get("BatchNorm").compute(treg.FrozenAttrs(attrs), *tx)
    assert [o.dtype for o in outs] == [tdt] * 3
    outs[0].backward(torch.from_numpy(cot).to(tdt))
    got = [_f32(o) for o in outs] + [
        np.zeros(t.shape, np.float32) if t.grad is None else _f32(t.grad)
        for t in tx[:3]]
    for g, w in zip(got[:4], want[:4]):
        _close(g, w, dtype)
    truth = want if dtype == "float32" else \
        _jax_bn(attrs, arrays, cot, jnp.float32)
    for g, w, t in zip(got[4:], want[4:], truth[4:]):
        _close(g, t, dtype)
        scale = float(np.abs(t).max())
        assert np.abs(g - t).max() <= max(np.abs(w - t).max(),
                                          BF16_STEP * scale)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_bn_train_matches_the_jax_custom_vjp(fix_gamma, dtype, layout):
    """Against the JAX package's ``_bn_train`` itself: the same closed-form
    backward, so fp32 agrees to reduction order."""
    arrays, cot, axis = _bn_inputs(dtype, layout, seed=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = [jnp.asarray(a, jdt) for a in arrays[:3]]
    (jout, jmean, jvar), vjp = jax.vjp(j_bn_train(2e-5, axis, fix_gamma),
                                       *jx)
    jgrads = vjp((jnp.asarray(cot, jdt), jnp.zeros_like(jmean),
                  jnp.zeros_like(jvar)))
    tdt = getattr(torch, dtype)
    tx = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays[:3]]
    tout, tmean, tvar = t_bn_train(2e-5, axis, fix_gamma)(*tx)
    assert tmean.dtype == tvar.dtype == torch.float32
    assert not tmean.requires_grad and not tvar.requires_grad
    tout.backward(torch.from_numpy(cot).to(tdt))
    _close(_f32(tout), _f32(jout), dtype)
    for got, want in ((tmean, jmean), (tvar, jvar)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-6)
    for t, g in zip(tx, jgrads):
        _close(_f32(t.grad), _f32(g), dtype)
    if fix_gamma:
        assert not tx[1].grad.any()


# ---------------------------------------------------------------------------
# relu at exactly 0
# ---------------------------------------------------------------------------

def test_relu_gradient_at_zero_is_half_as_in_jax():
    x = np.array([[0.0, 1.0, -1.0, 0.0, 2.5, -0.0]], np.float32)
    g = np.array([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]], np.float32)
    want = np.asarray(jax.vjp(lambda v: jreg.get("Activation").compute(
        jreg.FrozenAttrs({"act_type": "relu"}), v),
        jnp.asarray(x))[1](jnp.asarray(g))[0])
    np.testing.assert_array_equal(want, [[0.5, 2.0, 0.0, 2.0, 5.0, 3.0]])
    tx = torch.from_numpy(x).requires_grad_()
    out = treg.get("Activation").compute(
        treg.FrozenAttrs({"act_type": "relu"}), tx)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tx.grad.numpy(), want)
    np.testing.assert_array_equal(out.detach().numpy(), np.maximum(x, 0))
    # torch.relu, the old form, routes no gradient through 0
    old = torch.from_numpy(x).requires_grad_()
    torch.relu(old).backward(torch.from_numpy(g))
    assert not np.array_equal(old.grad.numpy(), want)
