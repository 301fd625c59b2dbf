"""The port's Symbol frontend and the training slice's ops against the JAX
package, on the CPU.

* A symbol's JSON written by either package loads in the other with the
  same arguments, outputs and inferred shapes, and re-serializes to the
  same text.
* Each op of the slice (``FullyConnected``, ``Activation``,
  ``LayerNorm``, ``Embedding``, ``Reshape``, ``SoftmaxOutput``,
  ``MultiHeadAttention``, the arithmetic family) gives the same forward
  and the same gradients for one numpy-seeded cotangent in both
  packages.

Tolerance: fp32 throughout, atol 2e-6 with rtol 1e-6 on values of order
1 (the packages reduce in other orders); exact equality where the op
copies values (Reshape, Embedding's rows) or where a NaN pattern is
the contract.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import symbol as jsym
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttransformer
from mxnet_tpu_torch.ops import registry as treg

TOL = dict(rtol=1e-6, atol=2e-6)
LM = dict(vocab_size=50, num_layers=2, d_model=16, num_heads=2, seq_len=12)
LM_SHAPES = {"data": (3, 12), "softmax_label": (3, 12)}


# ---------------------------------------------------------------------------
# JSON round trip
# ---------------------------------------------------------------------------

def _mlp(sym):
    data = sym.Variable("data")
    with_scope = sym.FullyConnected(data, num_hidden=7, name="fc1")
    h = sym.Activation(with_scope, act_type="gelu", name="act")
    h = sym.LayerNorm(h * 2.0 + 1.0, name="ln")
    h = sym.FullyConnected(h, num_hidden=5, no_bias=True, name="fc2")
    return sym.SoftmaxOutput(h, name="softmax", normalization="valid",
                             use_ignore=True)


@pytest.mark.parametrize("build", ["mlp", "transformer"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_json_round_trip(build, direction):
    if build == "mlp":
        jax_sym, port_sym = _mlp(jsym), _mlp(tsym)
        shapes = {"data": (4, 6)}
    else:
        jax_sym = jtransformer.get_symbol(**LM)
        port_sym = ttransformer.get_symbol(**LM)
        shapes = LM_SHAPES
    src, dst = ((jax_sym, tsym) if direction == "jax_to_port"
                else (port_sym, jsym))
    text = src.tojson()
    loaded = dst.load_json(text)
    assert loaded.tojson() == text
    assert loaded.list_arguments() == src.list_arguments()
    assert loaded.list_outputs() == src.list_outputs()
    assert loaded.list_auxiliary_states() == src.list_auxiliary_states()
    assert loaded.infer_shape(**shapes) == src.infer_shape(**shapes)
    # both packages build the same graph from the same model function
    j = json.loads(jax_sym.tojson())
    p = json.loads(port_sym.tojson())
    assert [n["op"] for n in j["nodes"]] == [n["op"] for n in p["nodes"]]
    assert [n["attrs"] for n in j["nodes"]] == [n["attrs"] for n in
                                                p["nodes"]]


def test_infer_shape_matches_jax():
    j = jtransformer.get_symbol(**LM).infer_shape(**LM_SHAPES)
    p = ttransformer.get_symbol(**LM).infer_shape(**LM_SHAPES)
    assert p == j
    assert p[1] == [(36, 50)]


def test_save_and_load_file(tmp_path):
    sym = _mlp(tsym)
    path = str(tmp_path / "net-symbol.json")
    sym.save(path)
    assert jsym.load(path).tojson() == sym.tojson()
    assert tsym.load(path).list_arguments() == sym.list_arguments()


def test_scopes_and_errors():
    from mxnet_tpu_torch.attribute import AttrScope
    from mxnet_tpu_torch.name import Prefix

    with Prefix("net_"), AttrScope(__lr_mult__="0.5"):
        fc = tsym.FullyConnected(tsym.Variable("x"), num_hidden=3)
    assert fc.list_arguments() == ["x", "net_fullyconnected0_weight",
                                   "net_fullyconnected0_bias"]
    assert fc.attr_dict()["net_fullyconnected0_weight"] == {
        "__lr_mult__": "0.5"}
    from mxnet_tpu_torch import context

    ex = fc.simple_bind(context.cpu(), x=(2, 4))
    assert ex.arg_dict["net_fullyconnected0_weight"].shape == (3, 4)
    if not torch.cuda.is_available():  # the default context is the card
        with pytest.raises(MXNetError, match=r"mx\.cpu\(\)"):
            fc.simple_bind(None, x=(2, 4))
    with pytest.raises(MXNetError, match="not registered"):
        tsym.load_json(json.dumps({"nodes": [{"op": "RNN",
                                              "name": "c", "inputs": []}],
                                   "arg_nodes": [], "heads": [[0, 0, 0]]}))


# ---------------------------------------------------------------------------
# per-op forward and gradient parity
# ---------------------------------------------------------------------------

def _parity(name, attrs, arrays, grad_of, tol=TOL, seed=0):
    """Run op ``name`` in both packages on ``arrays``; compare the forward
    and the gradients w.r.t. the inputs at positions ``grad_of`` for one
    random cotangent.  Returns the port's forward."""
    jfn = jreg.get(name).compute
    tfn = treg.get(name).compute

    def jax_fn(*diff):
        xs = [jnp.asarray(a) for a in arrays]
        for pos, x in zip(grad_of, diff):
            xs[pos] = x
        return jfn(jreg.FrozenAttrs(attrs), *xs)

    want = jax.jit(jax_fn)(*(jnp.asarray(arrays[i]) for i in grad_of))
    g = np.random.RandomState(seed).randn(*want.shape).astype(np.float32)
    want_grads = jax.jit(lambda g, *d: jax.vjp(jax_fn, *d)[1](g))(
        jnp.asarray(g), *(jnp.asarray(arrays[i]) for i in grad_of))

    xs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in grad_of:
        xs[i].requires_grad_()
    got = tfn(treg.FrozenAttrs(attrs), *xs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    got.backward(torch.from_numpy(g))
    for i, w in zip(grad_of, want_grads):
        np.testing.assert_allclose(xs[i].grad.numpy(), np.asarray(w), **tol)
    return got.detach()


def _rand(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("flatten,bias", [(True, True), (False, True),
                                          (False, False)])
def test_fully_connected(flatten, bias):
    rs = np.random.RandomState(1)
    arrays = [_rand(rs, 3, 4, 5), _rand(rs, 6, 20 if flatten else 5)]
    if bias:
        arrays.append(_rand(rs, 6))
    attrs = {"num_hidden": 6, "flatten": flatten, "no_bias": not bias}
    _parity("FullyConnected", attrs, arrays, range(len(arrays)))


@pytest.mark.parametrize("act", ["gelu", "relu", "tanh", "sigmoid",
                                 "softrelu", "softsign"])
def test_activation(act):
    # atol 5e-6: XLA's CPU tanh/exp are approximations a few 1e-7 off
    # libm's, and GELU's 1 + tanh(.) cancels in the negative tail
    rs = np.random.RandomState(2)
    _parity("Activation", {"act_type": act}, [_rand(rs, 4, 9, scale=2.0)],
            [0], tol=dict(rtol=1e-6, atol=5e-6))


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm(axis):
    rs = np.random.RandomState(3)
    data = _rand(rs, 2, 5, 8, scale=3.0) + 1.0
    c = data.shape[axis]
    _parity("LayerNorm", {"axis": axis, "eps": 1e-5},
            [data, 1.0 + _rand(rs, c, scale=0.1), _rand(rs, c, scale=0.1)],
            [0, 1, 2], tol=dict(rtol=1e-5, atol=1e-5))


def test_embedding_with_out_of_range_ids():
    """An id in [-V, 0) counts from the end, an id outside [-V, V) gives
    a NaN row and no gradient — jnp.take's fill mode — in both packages;
    float ids truncate toward zero."""
    rs = np.random.RandomState(4)
    v = 6
    ids = np.array([[0, 5, 2.7, 6], [-1, -6, -7, 3]], np.float32)
    weight = _rand(rs, v, 4)
    attrs = {"input_dim": v, "output_dim": 4}
    want = np.asarray(jax.jit(lambda d, w: jreg.get("Embedding").compute(
        jreg.FrozenAttrs(attrs), d, w))(jnp.asarray(ids), jnp.asarray(weight)))
    nan_rows = np.isnan(want).all(-1)
    assert nan_rows.tolist() == [[False, False, False, True],
                                 [False, False, True, False]]
    w = torch.from_numpy(weight).requires_grad_()
    got = treg.get("Embedding").compute(treg.FrozenAttrs(attrs),
                                        torch.from_numpy(ids), w)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # gradient: only the in-range rows scatter into the table
    g = _rand(rs, *want.shape)
    g_jax = jax.jit(lambda w, g: jax.vjp(
        lambda w: jreg.get("Embedding").compute(
            jreg.FrozenAttrs(attrs), jnp.asarray(ids), w), w)[1](g)[0])(
        jnp.asarray(weight), jnp.asarray(g))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_jax), **TOL)


@pytest.mark.parametrize("shape,target,reverse", [
    ((2, 3, 4), (-1, 4), False),
    ((2, 3, 4), (0, -1), False),
    ((2, 3, 4), (-2,), False),
    ((2, 3, 4), (-3, 0), False),
    ((2, 3, 4), (0, -4, 3, -1, 0), False),
    ((6, 4), (-4, -1, 2, 0), False),
    ((2, 3, 4), (-1, 0), True),
])
def test_reshape_codes(shape, target, reverse):
    rs = np.random.RandomState(5)
    got = _parity("Reshape", {"shape": target, "reverse": reverse},
                  [_rand(rs, *shape)], [0])
    assert got.numel() == int(np.prod(shape))


@pytest.mark.parametrize("attrs", [
    {},
    {"normalization": "batch", "grad_scale": 3.0},
    {"normalization": "valid", "use_ignore": True, "ignore_label": 2},
    {"use_ignore": True, "ignore_label": 0},
    {"multi_output": True, "normalization": "batch"},
])
def test_softmax_output(attrs):
    """Backward ``(p - onehot(label)) * grad_scale * g`` under each
    normalization; an out-of-range label (7 >= C, and -1) gives an
    all-zero one-hot row in both packages."""
    rs = np.random.RandomState(6)
    if attrs.get("multi_output"):
        data, label = _rand(rs, 2, 5, 3), np.array([[0, 4, 7], [2, -1, 1]],
                                                   np.float32)
    else:
        data = _rand(rs, 6, 5)
        label = np.array([0, 4, 7, 2, -1, 2], np.float32)
    _parity("SoftmaxOutput", attrs, [data, label], [0])


def test_multi_head_attention_and_seq_parallel():
    rs = np.random.RandomState(7)
    n, t, c = 2, 11, 12
    arrays = [_rand(rs, n, t, c), _rand(rs, 3 * c, c, scale=0.3),
              _rand(rs, 3 * c, scale=0.1), _rand(rs, c, c, scale=0.3),
              _rand(rs, c, scale=0.1)]
    _parity("MultiHeadAttention", {"num_heads": 3, "attn_block": 4},
            arrays, range(5), tol=dict(rtol=1e-5, atol=2e-6))
    with pytest.raises(MXNetError, match="seq_parallel"):
        treg.get("MultiHeadAttention").compute(
            treg.FrozenAttrs({"num_heads": 3, "seq_parallel": True}),
            *(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("name,attrs,n_in", [
    ("elemwise_add", {}, 2), ("elemwise_sub", {}, 2),
    ("elemwise_mul", {}, 2), ("elemwise_div", {}, 2),
    ("broadcast_add", {}, 2), ("negative", {}, 1),
    ("_plus_scalar", {"scalar": 1.5}, 1),
    ("_minus_scalar", {"scalar": 1.5}, 1),
    ("_rminus_scalar", {"scalar": 1.5}, 1),
    ("_mul_scalar", {"scalar": -2.0}, 1),
    ("_div_scalar", {"scalar": 4.0}, 1),
    ("_rdiv_scalar", {"scalar": 4.0}, 1),
    ("_power_scalar", {"scalar": 2.0}, 1),
])
def test_arithmetic(name, attrs, n_in):
    rs = np.random.RandomState(9)
    arrays = [_rand(rs, 3, 4) + 3.0]
    if n_in == 2:
        arrays.append(_rand(rs, 1, 4) + 3.0 if name.startswith("broadcast")
                      else _rand(rs, 3, 4) + 3.0)
    _parity(name, attrs, arrays, range(n_in))
