"""The port's TrainStep against the JAX package's, on the CPU.

The small transformer LM (vocab 64, 2 layers, d_model 32, 4 heads,
seq_len 40, batch 2) with ``MXNET_ATTN_BLOCK=16`` in both packages, so
the attention blocks are ragged (40 = 16 + 16 + 8).  Both packages start
from one state — the JAX package's ``init_state`` carried over with
``state_from_numpy`` — and take the same numpy-seeded batches.

Tolerances:
* fp32, 3 SGD-momentum steps: outputs and parameters within rtol/atol
  1e-5 after each step (the packages sum in other orders, ~1e-7 drift
  per step).
* bf16 compute, 2 steps: the output probabilities within 2e-2 relative
  L2 of the JAX package's, and the parameter update (new - old) of
  every tensor within 1e-1 (5e-2 in the mean over tensors).  The two
  frameworks round to bf16 (8 mantissa bits) at other places — their
  CPU matmuls accumulate in other orders, PyTorch's softmax, GELU and
  LayerNorm round once where XLA rounds after each step — so single
  entries differ by a few bf16 steps, and the differences compound
  through two layers, the loss head and the momentum of the first step
  (measured here: 1-3 % after step 1, 1-6 % after step 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.fused import TrainStep as JaxStep
from mxnet_tpu.models import transformer as jtransformer
from mxnet_tpu_torch import fused
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttransformer

CFG = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
           seq_len=40)
BATCH = 2
OPT = dict(learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / BATCH)


@pytest.fixture(autouse=True)
def _ragged_blocks(monkeypatch):
    monkeypatch.setenv("MXNET_ATTN_BLOCK", "16")
    monkeypatch.delenv("MXNET_ATTN_IMPL", raising=False)


def _steps(cfg, compute_dtype):
    shapes = {"data": (BATCH, cfg["seq_len"]),
              "softmax_label": (BATCH, cfg["seq_len"])}
    jstep = JaxStep(jtransformer.get_symbol(**cfg), optimizer="sgd",
                    optimizer_params=OPT, compute_dtype=compute_dtype)
    tstep = fused.TrainStep(ttransformer.get_symbol(**cfg), optimizer="sgd",
                            optimizer_params=OPT, compute_dtype=compute_dtype,
                            device="cpu")
    jstate = jstep.init_state(shapes)
    host = [{k: None if v is None else np.asarray(v) for k, v in d.items()}
            for d in jstate]
    tstate = fused.state_from_numpy(*host, device="cpu")
    return jstep, tstep, jstate, tstate, host


def _batch(seed, vocab, shape=(BATCH, CFG["seq_len"])):
    rs = np.random.RandomState(seed)
    data = rs.randint(0, vocab, shape).astype(np.float32)
    label = rs.randint(0, vocab, shape).astype(np.float32)
    return data, label


def _run(jstep, tstep, jstate, tstate, data, label):
    jout = jstep(*jstate, {"data": jnp.asarray(data),
                           "softmax_label": jnp.asarray(label)},
                 jax.random.PRNGKey(0))
    tout = tstep(*tstate, {"data": torch.from_numpy(data),
                           "softmax_label": torch.from_numpy(label)}, None)
    return jout, tout


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_fp32_three_momentum_steps_match():
    jstep, tstep, jstate, tstate, _ = _steps(CFG, None)
    for step in range(3):
        data, label = _batch(step, CFG["vocab_size"])
        (jp, ja, js, jo), (tp, ta, ts, to) = _run(jstep, tstep, jstate,
                                                  tstate, data, label)
        assert len(to) == len(jo) == 1
        np.testing.assert_allclose(_f32(to[0]), _f32(jo[0]), rtol=1e-5,
                                   atol=1e-5)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_allclose(_f32(ts[k]), _f32(js[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        jstate, tstate = (jp, ja, js), (tp, ta, ts)
    assert tstep._t == 3


def test_bf16_compute_two_steps_match():
    jstep, tstep, jstate, tstate, host = _steps(CFG, "bfloat16")
    before = host[0]
    for step in range(2):
        data, label = _batch(10 + step, CFG["vocab_size"])
        (jp, ja, js, jo), (tp, ta, ts, to) = _run(jstep, tstep, jstate,
                                                  tstate, data, label)
        assert to[0].dtype == torch.bfloat16
        assert _rel_l2(_f32(to[0]), _f32(jo[0])) < 2e-2
        rels = {}
        for k in jp:
            assert tp[k].dtype == torch.float32
            rels[k] = _rel_l2(_f32(tp[k]) - before[k],
                              _f32(jp[k]) - before[k])
        assert max(rels.values()) < 1e-1, rels
        assert np.mean(list(rels.values())) < 5e-2, rels
        before = {k: _f32(v) for k, v in jp.items()}
        jstate, tstate = (jp, ja, js), (tp, ta, ts)


def test_bf16_token_id_rounding_gives_the_same_nan_pattern():
    """The JAX package's bf16 step casts the float token ids to bf16 too
    (``cast_compute``, ``mxnet_tpu/fused.py:341-343, 357-359``): at vocab
    320, id 319 rounds to 320, out of range, so its embedding row is NaN
    (``jnp.take``'s fill mode) and NaN spreads through attention and the
    update.  The JAX package is the reference, so the port reproduces
    the defect: the same NaN pattern in outputs, parameters and
    momentum, and never an out-of-range index on the card."""
    cfg = dict(CFG, vocab_size=320)
    jstep, tstep, jstate, tstate, _ = _steps(cfg, "bfloat16")
    data, label = _batch(3, 250)
    data[1, 30] = 319.0
    (jp, _, js, jo), (tp, _, ts, to) = _run(jstep, tstep, jstate, tstate,
                                            data, label)
    out_nan = np.isnan(_f32(jo[0]))
    assert out_nan.any() and not out_nan.all()
    assert np.array_equal(np.isnan(_f32(to[0])), out_nan)
    for k in jp:
        for want, got in ((jp[k], tp[k]), (js[k], ts[k])):
            mask = np.isnan(_f32(want))
            assert np.array_equal(np.isnan(_f32(got)), mask), k
    # rows of the token table that no in-range id touched stay finite
    assert not np.isnan(_f32(tp["tok_embed_weight"])[300]).any()


def test_init_state_follows_the_jax_rules():
    cfg = dict(CFG, seq_len=8)
    shapes = {"data": (BATCH, 8), "softmax_label": (BATCH, 8)}
    jsym = jtransformer.get_symbol(**cfg)
    jshapes = dict(zip(jsym.list_arguments(), jsym.infer_shape(**shapes)[0]))
    tstep = fused.TrainStep(ttransformer.get_symbol(**cfg), optimizer="sgd",
                            optimizer_params=OPT, device="cpu")
    tp, ta, ts = tstep.init_state(shapes, seed=0)
    assert list(tp) == [k for k in jshapes if k not in shapes] and ta == {}
    for k in tp:
        assert tuple(tp[k].shape) == tuple(jshapes[k]), k
        assert torch.count_nonzero(ts[k]) == 0
        if k.endswith("_gamma"):
            assert torch.equal(tp[k], torch.ones_like(tp[k]))
        elif k.endswith(("_bias", "_beta")):
            assert torch.equal(tp[k], torch.zeros_like(tp[k]))
        elif tp[k].numel() >= 1024:
            shp = tuple(tp[k].shape)
            fan_in = int(np.prod(shp[1:])) if len(shp) > 1 else shp[0]
            std = (2.0 / fan_in) ** 0.5
            assert abs(float(tp[k].std()) / std - 1) < 0.1, k
    # same seed, same draws; another seed, other draws
    again = tstep.init_state(shapes, seed=0)[0]
    other = tstep.init_state(shapes, seed=1)[0]
    assert torch.equal(again["lm_head_weight"], tp["lm_head_weight"])
    assert not torch.equal(other["lm_head_weight"], tp["lm_head_weight"])


def test_state_from_numpy_keeps_optimizer_structure():
    params = {"w": np.ones((2, 3), np.float32)}
    states = {"w": (np.zeros((2, 3), np.float32), None)}
    p, a, s = fused.state_from_numpy(params, {}, states, device="cpu")
    assert p["w"].dtype == torch.float32 and a == {}
    assert isinstance(s["w"], tuple) and s["w"][1] is None
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(MXNetError, match="device"):
            fused.state_from_numpy(params, {}, states)


@pytest.mark.parametrize("kwargs,env", [
    (dict(mesh=object()), {}),
    (dict(zero="on"), {}),
    (dict(zero=None), {"MXNET_ZERO": "3"}),
    (dict(plan="data=2"), {}),
    (dict(), {"MXNET_PLAN": "data=2"}),
    (dict(zero="3"), {}),
    (dict(), {"MXNET_ZERO": "on"}),
    (dict(param_sharding="fsdp"), {}),
    (dict(param_sharding="tp"), {}),
])
def test_options_outside_the_slice_raise(monkeypatch, kwargs, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    sym = ttransformer.get_symbol(**CFG)
    with pytest.raises(MXNetError, match="later slice"):
        fused.TrainStep(sym, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(moe_experts=4), dict(dropout=0.1)])
def test_model_options_outside_the_slice_raise(kwargs):
    with pytest.raises(MXNetError, match="later slice"):
        ttransformer.get_symbol(**CFG, **kwargs)


def test_optimizer_surface():
    from mxnet_tpu_torch import optimizer as opt

    with pytest.raises(MXNetError, match="not registered"):
        opt.create("lamb")
    with pytest.raises(MXNetError, match="must be > 0"):
        opt.create("sgd", clip_global_norm=0.0)
    assert opt.create("sgd", clip_global_norm=1.0).clip_global_norm == 1.0
    assert opt.create("adam").supports_fused
    sgd = opt.create("SGD", momentum=0.5, rescale_grad=2.0, clip_gradient=1.0,
                     wd=0.1)
    assert sgd.supports_fused
    w, g = torch.tensor([1.0, -2.0]), torch.tensor([0.25, 3.0])
    mom = sgd.init_fused_state(w)
    new_w, new_mom = sgd.fused_update(w, g, mom, 0.5, 0.1, 1, None)
    # g = clip(2 g, -1, 1) = [0.5, 1]; mom = -0.5 (g + 0.1 w)
    torch.testing.assert_close(new_mom, torch.tensor([-0.3, -0.4]))
    torch.testing.assert_close(new_w, w + new_mom)
    mp = opt.SGD(momentum=0.9, multi_precision=True)
    wb = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    st = mp.init_fused_state(wb)
    assert st[0].dtype == st[1].dtype == torch.float32
    nw, (m2, w32) = mp.fused_update(wb, torch.ones(2), st, 0.5, 0.0, 1, None)
    assert nw.dtype == torch.bfloat16
    torch.testing.assert_close(w32, torch.tensor([0.5, 1.5]))
