"""Multi-step dispatch (``steps_per_call=K``) in the port against the JAX
package, on the CPU: ``TrainStep``, ``DevicePrefetchIter``,
``prefetch_to_device``, ``Module.init_optimizer`` and ``Module.fit``;
the recompile guard that counts a multi-step step's captures.

On the CPU a K-step call runs its K steps one after another through the
code a CUDA graph captures on the card (``TrainStep.run_eager``); the
card's capture is held against that loop bit for bit in
``tests/test_torch_cuda.py``.

Tolerances: ``tests/test_prefetch.py``'s for the K = 4 fit (rtol 1e-5,
atol 1e-6: two epochs of SGD on a small MLP, fp32 matmuls summed in
other orders); rtol 1e-5, atol 1e-6 for three Adam steps.  Packed
batches copy values and must be equal.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import fused
from mxnet_tpu_torch.base import MXNetError, RecompileStorm
from mxnet_tpu_torch.compile_cache import (diff_signatures, registry,
                                           signature_of)

TOL = dict(rtol=1e-5, atol=1e-6)


def _data(n=160, d=6, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype("float32")
    w = rs.randn(d, 3).astype("float32")
    return X, (X @ w).argmax(axis=1).astype("float32")


def _mlp(pkg, name="softmax"):
    net = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(net, num_hidden=8, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name=name, normalization="batch")


def _state(seed=5):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": 0.5 * rs.randn(8, 6), "fc1_bias": 0.1 * rs.randn(8),
            "fc2_weight": 0.5 * rs.randn(3, 8), "fc2_bias": 0.1 * rs.randn(3)}


def _fit(pkg, steps_per_call, epochs=2, **kwargs):
    X, y = _data()
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    acc = pkg.metric.Accuracy()
    marks = []
    mod.fit(pkg.io.NDArrayIter(X, y, batch_size=20), num_epoch=epochs,
            optimizer="sgd", eval_metric=acc,
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            arg_params={k: pkg.nd.array(v.astype(np.float32), pkg.cpu())
                        for k, v in _state().items()},
            prefetch_to_device=True, steps_per_call=steps_per_call,
            batch_end_callback=lambda p: marks.append(p.nbatch), **kwargs)
    return mod, acc, marks


def test_fit_steps_per_call_matches_jax():
    jmod, jacc, _ = _fit(jmx, 4, metric_sync_period=3)
    tmod, tacc, marks = _fit(tmx, 4, metric_sync_period=3)
    want, got = jmod.get_params()[0], tmod.get_params()[0]
    for k in want:
        np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                   err_msg=k, **TOL)
    # one metric update an inner step, the callback once a call, nbatch
    # by K, the update count by K
    assert tacc.num_inst == jacc.num_inst == 160
    assert tacc.get()[1] == pytest.approx(jacc.get()[1])
    assert marks == [0, 4] * 2
    assert tmod._optimizer.num_update == jmod._optimizer.num_update == 16


def test_fit_steps_per_call_equals_single_steps_on_the_cpu():
    one, _, _ = _fit(tmx, 1, epochs=1)
    four, _, _ = _fit(tmx, 4, epochs=1)
    assert four._optimizer.num_update == 8
    assert four._fused.steps_per_call == 4
    for k, v in one.get_params()[0].items():
        np.testing.assert_array_equal(four.get_params()[0][k].asnumpy(),
                                      v.asnumpy(), err_msg=k)


def test_train_step_three_adam_steps_match_jax_single_steps():
    from mxnet_tpu.fused import TrainStep as JaxStep

    opt = dict(learning_rate=0.05, wd=0.01, clip_global_norm=0.5,
               epsilon=1e-6)
    shapes = {"data": (5, 6), "softmax_label": (5,)}
    jstep = JaxStep(_mlp(jmx), optimizer="adam", optimizer_params=opt)
    tstep = fused.TrainStep(_mlp(tmx), optimizer="adam",
                            optimizer_params=opt, steps_per_call=3,
                            device="cpu")
    jstate = jstep.init_state(shapes)
    host = [{k: None if v is None else
             (tuple(np.asarray(e) for e in v) if isinstance(v, tuple)
              else np.asarray(v)) for k, v in d.items()} for d in jstate]
    tstate = fused.state_from_numpy(*host, device="cpu")
    X, y = _data(n=15)
    X, y = X.reshape(3, 5, 6), y.reshape(3, 5)
    outs = []
    for k in range(3):
        *jstate, jo = jstep(*jstate, {"data": jnp.asarray(X[k]),
                                      "softmax_label": jnp.asarray(y[k])},
                            jax.random.PRNGKey(0))
        outs.append(np.asarray(jo[0]))
    tp, ta, ts, to = tstep(*tstate, {"data": torch.from_numpy(X),
                                     "softmax_label": torch.from_numpy(y)},
                           None)
    assert tstep._t == 3 and to[0].shape == (3, 5, 3)
    np.testing.assert_allclose(to[0].numpy(), np.stack(outs), **TOL)
    jp, _, js = jstate
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **TOL)
        for a, b in zip(ts[k], js[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=k,
                                       **TOL)
    # the next call continues the step count: t = 4, 5, 6
    tstep(tp, ta, ts, {"data": torch.from_numpy(X),
                       "softmax_label": torch.from_numpy(y)}, None)
    assert tstep._t == 6


def test_train_step_refuses_a_batch_without_the_k_axis():
    step = fused.TrainStep(_mlp(tmx), steps_per_call=2, device="cpu")
    p, a, s = step.init_state({"data": (4, 6), "softmax_label": (4,)})
    with pytest.raises(MXNetError, match=r"\(2, batch, \.\.\.\)"):
        step(p, a, s, {"data": torch.zeros(4, 6),
                       "softmax_label": torch.zeros(4)}, None)
    with pytest.raises(MXNetError, match="steps_per_call must be >= 1"):
        fused.TrainStep(_mlp(tmx), steps_per_call=0, device="cpu")


@pytest.mark.parametrize("n,pack", [(100, 2), (160, 4), (60, 1)])
def test_super_batches_match_jax_packing(caplog, n, pack):
    X, y = _data(n=n)
    got, want = [], []
    with caplog.at_level(logging.WARNING):
        for pkg, out in ((tmx, got), (jmx, want)):
            it = pkg.io.prefetch_to_device(
                pkg.io.NDArrayIter(X, y, batch_size=20), steps_per_call=pack,
                context=pkg.cpu())
            assert pkg.io.prefetch_to_device(it, steps_per_call=pack) is it
            assert it.provide_data[0].shape == (20, 6)
            assert it.provide_label[0].shape == (20,)
            for _ in range(2):  # two epochs: the warning comes once
                for b in it:
                    assert b.staged
                    out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                                b.pad, b.index is None))
                it.reset()
            it.close()
    assert len(got) == len(want) == 2 * ((n // 20) // pack)
    for (gd, gl, gp, gi), (wd, wl, wp, wi) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gd.shape == ((pack, 20, 6) if pack > 1 else (20, 6))
        assert (gp, gi) == (wp, wi)
    drops = [r for r in caplog.records if "dropping" in r.getMessage()
             and "mxnet_tpu_torch" in r.pathname]
    assert len(drops) == (1 if (n // 20) % pack else 0)


def test_steps_per_call_is_refused_under_a_monitor_and_the_split_path(
        monkeypatch):
    X, y = _data(n=40)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    it = tmx.io.NDArrayIter(X, y, batch_size=20)
    with pytest.raises(MXNetError, match="incompatible with a Monitor"):
        mod.fit(it, num_epoch=1, steps_per_call=2, monitor=object())
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    with pytest.raises(MXNetError, match="steps_per_call=2 was requested"):
        mod.fit(it, num_epoch=1, steps_per_call=2)
    monkeypatch.setenv("MXNET_STEPS_PER_CALL", "2")
    with pytest.raises(MXNetError, match="steps_per_call=2 was requested"):
        tmx.mod.Module(_mlp(tmx), context=tmx.cpu()).fit(it, num_epoch=1)
    monkeypatch.delenv("MXNET_FUSED_STEP")
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(it, num_epoch=1)  # MXNET_STEPS_PER_CALL=2 on the fused step
    assert mod._fused.steps_per_call == 2
    assert mod._optimizer.num_update == 2


def test_guard_counts_signatures_and_raises_a_storm(monkeypatch):
    name = "multistep_guard_probe"  # a guard of its own in the registry
    label = name + "_label"
    step = fused.TrainStep(_mlp(tmx, name), steps_per_call=2,
                           label_names=(label,), device="cpu")
    guard = step._recompile_guard
    assert guard.name.startswith("TrainStep(%s:" % name)
    assert fused.TrainStep(_mlp(tmx, name), steps_per_call=2,
                           label_names=(label,),
                           device="cpu")._recompile_guard is guard
    state = step.init_state({"data": (4, 6), label: (4,)})

    def call(batch):
        return step(*state, {"data": torch.zeros(2, batch, 6),
                             label: torch.zeros(2, batch)}, None)

    call(4)
    call(4)
    assert (guard.traces, guard.calls, guard.signatures) == (1, 2, 1)
    call(3)
    assert (guard.traces, guard.signatures) == (2, 2)
    stats = step.compile({"data": (4, 6), label: (4,)})
    assert stats["steps_per_call"] == 2 and guard.signatures == 2
    monkeypatch.setenv("MXNET_RECOMPILE_WARN", "2")
    monkeypatch.setenv("MXNET_RECOMPILE_ERROR", "1")
    with pytest.raises(RecompileStorm) as err:
        call(5)
    assert err.value.signatures == 3 and err.value.name == guard.name
    assert any("(2, 5, 6)" in line for line in err.value.diff)
    assert registry.report()[guard.name]["traces"] == 3
    a = signature_of({"w": torch.zeros(2)}, 1.0)
    b = signature_of({"w": torch.zeros(3)}, 1.0)
    assert a != b and len(diff_signatures(a, b)) == 1
