"""fp8 training in the port (``mxnet_tpu_torch/quantize.py``'s fp8 half,
``ops/fp8_ops.py``) against the JAX package's ``mxnet_tpu/quantize.py``
on the CPU, where K11 and K12 run their plain versions.

* Codes and amaxes: the port's e4m3 and e5m2 codes (and transposed
  codes) equal the JAX package's cast (``clip(x / s)`` to ml_dtypes) bit
  for bit, saturation, zeros, infinities and NaNs included; the amax
  equals ``jnp.max(jnp.abs(x))``.
* The fp8 dot against ``_fp8_dot_fn``: forward, dx and dw within 1e-5
  relative L2 in fp32 (the port scales after an exact sum; the reference
  sums ``q * s`` products: a few fp32 ulps), within 1e-2 in bf16 (the
  reference rounds ``q * s`` to bf16 before its bf16 dot; the port rounds
  once at the end: bf16's 2^-9 per element).
* Twins of ``tests/test_quantize.py:426-660``: modes, layer opt-out, the
  history roll, the trace contract, ``off`` keeping a state-free step,
  ``on`` training the 2-FC MLP with 2 sites next to the JAX package's fp8
  trajectory (rtol 1e-4, atol 1e-6 over 5 SGD steps: fp32 ulps through
  e4m3 codes), and fp8 with the scaler under ``steps_per_call=3``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import quantize as JQ
from mxnet_tpu.fused import TrainStep as JStep
from mxnet_tpu.health import DynamicLossScaler as JScaler
from mxnet_tpu.health import StepHealth as JHealth
from mxnet_tpu_torch import fused
from mxnet_tpu_torch import quantize as TQ
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.health import DynamicLossScaler as TScaler
from mxnet_tpu_torch.health import StepHealth as THealth
from mxnet_tpu_torch.ops import fp8_ops as F8

KINDS = {F8.E4M3: (ml_dtypes.float8_e4m3fn, TQ.FP8_MAX),
         F8.E5M2: (ml_dtypes.float8_e5m2, TQ.FP8_E5M2_MAX)}


@pytest.fixture(autouse=True)
def _fp8_env(monkeypatch):
    monkeypatch.delenv("MXNET_FP8", raising=False)
    monkeypatch.delenv("MXNET_FP8_LAYERS", raising=False)


def _values(rows=37, cols=21, seed=0):
    """Values across 1e-4..1e3 scales with saturation, zeros, +-inf and
    +-NaN placed in."""
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, cols) * 10.0 ** rs.uniform(-4, 3, (rows, cols))
    x = x.astype(np.float32)
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan]
    x[1, :4] = [1e9, -1e9, 3e-9, -3e-9]
    return x


def _same_bits(jx):
    """A torch tensor holding the bits of the JAX array ``jx`` (fp32 or
    bf16; a NaN keeps its sign, which a float conversion may not)."""
    a = np.array(jx)
    if a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("kind", [F8.E4M3, F8.E5M2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codes_and_amax_equal_jax_bitwise(kind, dtype):
    mdt, qmax = KINDS[kind]
    x = _values()
    jx = jnp.asarray(x, dtype)
    tx = _same_bits(jx)
    for scale in (1.0, 0.0371, 2.5e3):
        s = np.float32(scale)
        want = np.asarray(jnp.clip(jx.astype(jnp.float32) / s, -qmax, qmax)
                          .astype(mdt)).view(np.uint8)
        codes, codes_t, amax = F8.fp8_cast(
            tx, torch.tensor(s), kind, codes=True, transposed=True)
        rows, cols = x.shape
        assert codes.shape == (rows, F8.pitch(cols))
        assert codes_t.shape == (cols, F8.pitch(rows))
        np.testing.assert_array_equal(codes[:, :cols].numpy(), want)
        np.testing.assert_array_equal(codes_t[:, :rows].numpy(), want.T)
        assert not codes[:, cols:].any() and not codes_t[:, rows:].any()
        # the dequantized values, and the port's _fake_cast, are the JAX
        # package's _fake_cast
        fake = np.asarray(JQ._fake_cast(jx, s, qmax, mdt))
        tdt = (torch.float8_e4m3fn, torch.float8_e5m2)[kind]
        for got in ((F8.decode(codes[:, :cols], kind) * s).numpy(),
                    TQ._fake_cast(tx, torch.tensor(s), qmax, tdt).numpy()):
            nan = np.isnan(fake)
            np.testing.assert_array_equal(np.isnan(got), nan)
            np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                          fake[~nan].view(np.uint32))
    jamax = np.asarray(jnp.max(jnp.abs(jx.astype(jnp.float32))))
    assert np.isnan(jamax) and np.isnan(amax.item())
    x[0, 4:6] = 0.0  # without the NaNs: the exact max
    jx = jnp.asarray(x, dtype)
    tx = _same_bits(jx)
    _, _, amax = F8.fp8_cast(tx, None, kind, codes=False)
    assert amax.item() == float(jnp.max(jnp.abs(jx.astype(jnp.float32))))


def test_plain_gemm_is_the_decoded_product():
    rs = np.random.RandomState(1)
    a = torch.from_numpy(rs.randint(0, 256, (5, 32)).astype(np.uint8))
    b = torch.from_numpy(rs.randint(0, 256, (3, 32)).astype(np.uint8))
    a[:, 0] = b[:, 0] = 0x7F & 0x3F  # no NaN codes in this product
    a, b = a & 0x77, b & 0x77        # finite e4m3 and e5m2 codes
    sa, sb = torch.tensor(0.5), torch.tensor(3.0)
    out = F8.fp8_gemm(a, b, F8.E5M2, F8.E4M3, sa, sb, torch.bfloat16)
    want = (F8.decode(a, F8.E5M2) @ F8.decode(b, F8.E4M3).t()) * 0.5 * 3.0
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())
    with pytest.raises(MXNetError, match="uint8"):
        F8.fp8_gemm(a.float(), b, F8.E4M3, F8.E4M3, sa, sb)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("w_dim", [1, 0])
def test_fp8_dot_matches_jax(dtype, tol, w_dim):
    rs = np.random.RandomState(2 + w_dim)
    x = rs.randn(3, 5, 24).astype(np.float32)
    w = rs.randn(*((7, 24) if w_dim == 1 else (24, 7))).astype(np.float32)
    cot = rs.randn(3, 5, 7).astype(np.float32)
    sx, sw = np.float32(0.01), np.float32(0.004)

    def jloss(x, w):
        out = JQ._fp8_dot_fn(w_dim)(x, w, jnp.float32(sx), jnp.float32(sw))
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, jout), (jgx, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x, dtype),
                                             jnp.asarray(w, dtype))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    with TQ.fp8_trace(torch.tensor([[sx, sw]])) as tr:
        out = TQ.fp8_apply_dot(tx, tw, "fc", w_dim)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == tdt and tx.grad.dtype == tdt
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    assert _rel(out.detach().float(), f32(jout)) < tol
    assert _rel(tx.grad.float(), f32(jgx)) < tol
    assert _rel(tw.grad.float(), f32(jgw)) < tol
    want_amax = [float(jnp.max(jnp.abs(jnp.asarray(v, dtype)
                                       .astype(jnp.float32))))
                 for v in (x, w)]
    assert tr.amax[0].tolist() == want_amax


def test_fp8_mode_parsing_and_enabled(monkeypatch):
    for raw, want in (("", "off"), ("off", "off"), ("0", "off"),
                      ("no", "off"), ("on", "on"), ("1", "on"),
                      ("TRUE", "on"), ("auto", "auto")):
        monkeypatch.setenv("MXNET_FP8", raw)
        assert TQ.fp8_mode() == want == JQ.fp8_mode()
    monkeypatch.delenv("MXNET_FP8")
    assert TQ.fp8_mode() == "off" and not TQ.fp8_enabled()
    monkeypatch.setenv("MXNET_FP8", "on")
    assert TQ.fp8_enabled() and TQ.fp8_enabled("cpu")
    # auto: the card's fp8 units arm it, the CPU keeps the clean path
    monkeypatch.setenv("MXNET_FP8", "auto")
    assert TQ.fp8_enabled("cuda:0") and not TQ.fp8_enabled("cpu")
    monkeypatch.setenv("MXNET_FP8", "e4m3")
    with pytest.raises(MXNetError):
        TQ.fp8_mode()


@pytest.mark.parametrize("spec,name", [
    (None, "blk0_attn"), (None, None), ("blk, lm_head", "blk1_ffn2"),
    ("blk, lm_head", "lm_head"), ("blk, lm_head", "embed"),
    ("blk, lm_head", None)])
def test_fp8_layer_allowed_matches_jax(monkeypatch, spec, name):
    if spec is not None:
        monkeypatch.setenv("MXNET_FP8_LAYERS", spec)
    assert TQ.fp8_layer_allowed(name) == JQ.fp8_layer_allowed(name)


def test_fp8_delayed_scaling_history_matches_jax():
    th, jh = TQ.fp8_hist_init(2), JQ.fp8_hist_init(2)
    assert tuple(th.shape) == jh.shape == (2, 2, TQ.FP8_AMAX_HISTORY)
    new = np.array([[TQ.FP8_MAX, 2 * TQ.FP8_MAX], [7.0, 0.0]], np.float32)
    steps = [new] + [np.zeros((2, 2), np.float32)] * TQ.FP8_AMAX_HISTORY
    for amax in steps:
        th = TQ.fp8_update_hist(th, torch.from_numpy(amax))
        jh = JQ.fp8_update_hist(jh, amax)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(TQ.fp8_realize_scales(th).numpy(),
                                      np.asarray(JQ.fp8_realize_scales(jh)))
    # the spike fell out of the window: unit scales again
    np.testing.assert_array_equal(TQ.fp8_realize_scales(th).numpy(),
                                  np.ones((2, 2), np.float32))


def test_fp8_apply_dot_trace_contract():
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 8).astype(np.float32))
    w = torch.from_numpy(rs.randn(8, 5).astype(np.float32))
    assert not TQ.fp8_tracing()
    assert TQ.fp8_apply_dot(x, w, label="fc") is None
    with TQ.fp8_trace() as tr:
        assert TQ.fp8_tracing()
        out = TQ.fp8_apply_dot(x, w, label="fc", w_dim=0)
        assert out is not None and tuple(out.shape) == (4, 5)
        # shape-ineligible operands decline inside the trace too
        assert TQ.fp8_apply_dot(x, torch.zeros(3, 3), w_dim=0) is None
        assert tr.names == ["fc"] and len(tr.amax) == 1
        assert tuple(tr.amax[0].shape) == (2,)
    assert not TQ.fp8_tracing()
    # discovery scales are 1.0: the e4m3 fake-cast product
    want = (x.to(torch.float8_e4m3fn).float()
            @ w.to(torch.float8_e4m3fn).float())
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_fp8_apply_dot_respects_layer_optout(monkeypatch):
    monkeypatch.setenv("MXNET_FP8_LAYERS", "fc1")
    x, w = torch.ones(2, 4), torch.ones(4, 3)
    with TQ.fp8_trace() as tr:
        assert TQ.fp8_apply_dot(x, w, label="fc2", w_dim=0) is None
        assert TQ.fp8_apply_dot(x, w, label="fc1", w_dim=0) is not None
    assert tr.names == ["fc1"]


def test_fp8_dot_grads_flow_scales_inert():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(4, 8).astype(np.float32))
    w = torch.from_numpy(rs.randn(8, 5).astype(np.float32))
    s = torch.ones(1, 2, requires_grad=True)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    with TQ.fp8_trace(s) as tr:
        (TQ.fp8_apply_dot(xg, wg, label="fc", w_dim=0) ** 2).sum().backward()
    assert s.grad is None or not s.grad.any()
    rx, rw = x.clone().requires_grad_(), w.clone().requires_grad_()
    ((rx @ rw) ** 2).sum().backward()
    for got, ref in ((xg.grad, rx.grad), (wg.grad, rw.grad)):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= 0.35 * ref.abs().max()
    assert not tr.amax[0].requires_grad


def test_executor_labels_nodes_only_under_a_trace():
    from mxnet_tpu_torch.executor import _trace_fn
    from mxnet_tpu_torch.ops import registry

    seen = []
    op = registry.get("FullyConnected")
    orig = op.compute

    def spy(attrs, *ins):
        seen.append(attrs.get("__node_name__"))
        return orig(attrs, *ins)

    sym = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                                 name="fc")
    fn, _, _ = _trace_fn(sym, is_train=False)
    args = {"data": torch.ones(2, 4), "fc_weight": torch.ones(3, 4),
            "fc_bias": torch.zeros(3)}
    op.compute = spy
    try:
        fn(args, {}, None)
        with TQ.fp8_trace() as tr:
            fn(args, {}, None)
    finally:
        op.compute = orig
    assert seen == [None, "fc"] and tr.names == ["fc"]


# -- fp8 through TrainStep: the history rides the carried state -----------

def _mlp(pkg):
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=5, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _batch():
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 8),
                                     "float32"))
    return {"data": X,
            "softmax_label": np.tile(np.arange(5.0, dtype="float32"),
                                     4)[:16]}


def _port_step(**kw):
    """The port's TrainStep over the 2-FC MLP from a numpy-seeded state
    (no JAX run)."""
    step = fused.TrainStep(_mlp(tmx), optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1},
                           device="cpu", **kw)
    rs = np.random.RandomState(4)
    params = {"fc1_weight": 0.5 * rs.randn(16, 8), "fc1_bias": np.zeros(16),
              "fc2_weight": 0.5 * rs.randn(5, 16), "fc2_bias": np.zeros(5)}
    p, a, s = fused.state_from_numpy(
        {k: v.astype(np.float32) for k, v in params.items()}, {},
        dict.fromkeys(params), device="cpu")
    return step, p, a, s


def _pair(**kw):
    """A JAX and a port TrainStep over the 2-FC MLP from one numpy state
    (the JAX package's init_state)."""
    jkw = dict(kw)
    tkw = dict(kw)
    for k in ("health",):
        if k in kw and kw[k] is not None:
            sc = kw[k]
            jkw[k] = JHealth(scaler=JScaler(**sc)) if sc else JHealth()
            tkw[k] = THealth(scaler=TScaler(**sc)) if sc else THealth()
    jstep = JStep(_mlp(jmx), optimizer="sgd",
                  optimizer_params={"learning_rate": 0.1}, **jkw)
    shapes = {"data": (16, 8), "softmax_label": (16,)}
    jp, ja, js = jstep.init_state(shapes)
    tstep = fused.TrainStep(_mlp(tmx), optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1},
                            device="cpu", **tkw)
    tp, ta, ts = fused.state_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()},
        {k: np.asarray(v) for k, v in ja.items()},
        jax.tree.map(np.asarray, js), device="cpu")
    return (jstep, jp, ja, js), (tstep, tp, ta, ts)


def _run(pair, batch, n, K=1):
    (jstep, jp, ja, js), (tstep, tp, ta, ts) = pair
    rng = jax.random.PRNGKey(0)
    if K > 1:
        batch = {k: np.stack([v] * K) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(n):
        jp, ja, js, _ = jstep(jp, ja, js, batch, rng)
        tp, ta, ts, _ = tstep(tp, ta, ts, tb, torch.Generator()
                              .manual_seed(i))
    return ({k: np.asarray(v) for k, v in jp.items()},
            {k: v.numpy() for k, v in tp.items()})


def test_fp8_off_keeps_the_state_free_step(monkeypatch):
    monkeypatch.setenv("MXNET_FP8", "off")
    step, p, a, s = _port_step()
    assert not step._fp8 and not step._use_hstate
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    outs = []
    for _ in range(2):
        q = p
        for i in range(3):
            q, _, _, _ = step(q, a, s, b, torch.Generator().manual_seed(i))
        outs.append(q)
    assert step._hstate is None and step.last_health is None
    for k in p:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_fp8_on_trains_and_rolls_amax_history_like_jax(monkeypatch):
    monkeypatch.setenv("MXNET_FP8", "on")
    pair = _pair()
    tstep = pair[1][0]
    assert tstep._fp8 and tstep._use_hstate
    start = [{k: v.clone() for k, v in d.items()} for d in pair[1][1:3]]
    p0 = start[0]["fc1_weight"].numpy().copy()
    want, got = _run(pair, _batch(), 5)
    # the clean step from the same state
    monkeypatch.setenv("MXNET_FP8", "off")
    clean = fused.TrainStep(_mlp(tmx), optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1},
                            device="cpu")
    ref, a, s = start[0], start[1], dict.fromkeys(start[0])
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for i in range(5):
        ref, a, s, _ = clean(ref, a, s, b, torch.Generator().manual_seed(i))
    ref = {k: v.numpy() for k, v in ref.items()}
    assert tstep._fp8_sites == pair[0][0]._fp8_sites == 2  # fc1 + fc2
    hist = tstep._hstate["fp8_hist"].numpy()
    assert hist.shape == (2, 2, TQ.FP8_AMAX_HISTORY)
    assert (hist[:, :, :5] > 0).all() and (hist[:, :, 5:] == 0).all()
    np.testing.assert_allclose(hist, np.asarray(pair[0][0]._hstate[
        "fp8_hist"]), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # it trained, and not as the clean step did
    assert not np.array_equal(got["fc1_weight"], ref["fc1_weight"])
    assert not np.array_equal(got["fc1_weight"], p0)


def test_fp8_layers_filters_sites(monkeypatch):
    monkeypatch.setenv("MXNET_FP8", "on")
    monkeypatch.setenv("MXNET_FP8_LAYERS", "fc1")
    pair = _pair()
    want, got = _run(pair, _batch(), 2)
    assert pair[1][0]._fp8_sites == 1  # fc2 opted out
    assert tuple(pair[1][0]._hstate["fp8_hist"].shape) == \
        (1, 2, TQ.FP8_AMAX_HISTORY)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_fp8_composes_with_scaler_and_multistep_like_jax(monkeypatch):
    """fp8 history and the loss scaler share the carried state through a
    K = 3 call: the history advances 3 slots and the scale grows once,
    as in the JAX package's scan."""
    monkeypatch.setenv("MXNET_FP8", "on")
    pair = _pair(health=dict(init_scale=8.0, growth=2.0,
                             growth_interval=3, max_scale=64.0),
                 steps_per_call=3)
    want, got = _run(pair, _batch(), 1, K=3)
    tstep, jstep = pair[1][0], pair[0][0]
    assert sorted(tstep._hstate) == ["fp8_hist", "good_steps", "loss_scale"]
    hist = tstep._hstate["fp8_hist"].numpy()
    assert (hist[:, :, :3] > 0).all() and (hist[:, :, 3:] == 0).all()
    assert tstep.loss_scale == jstep.loss_scale == 16.0
    assert tuple(tstep.last_health["loss"].shape) == (3,)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
    # the carried state round-trips through export/load
    snap = tstep.export_hstate()
    tstep.load_hstate(snap)
    np.testing.assert_array_equal(tstep.export_hstate()["fp8_hist"],
                                  snap["fp8_hist"])
