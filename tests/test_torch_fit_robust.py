"""Robust training in the port, on the CPU: ``Module.fit``'s checkpoint,
resume, preemption, health and loss-scale options, the optimizer-state
files, and ``TrainStep(remat=)``.

* Twins of ``tests/test_fault_tolerance.py:138-252``: the manager's use
  by ``fit``; a resumed fit, after a checkpoint or a SIGTERM mid-epoch or
  on an epoch's last batch, equal to the uninterrupted fit bit for bit
  (inside the port: the same code on the same seeds, so any difference
  is a resume that lost state); ``save_optimizer_states`` /
  ``load_optimizer_states`` and ``Trainer.save_states`` / ``load_states``
  round-tripped exactly.
* Twins of ``tests/test_health.py``'s fit cases: a poisoned batch
  skipped and the run still converging, a typed divergence, a rollback
  to the last good checkpoint with the learning rate backed off, the
  dynamic loss scale, and the step watchdog inside ``fit``.
* ``remat`` equal to no remat bit for bit with dropout on, for every
  policy the port maps, with and without fp8 and in a K-step call.
* The gates that stand: several devices and the monitor.
"""
import os
import signal

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import fused
from mxnet_tpu_torch.base import (MXNetError, StepHung, TrainingDiverged,
                                  TrainingPreempted)
from mxnet_tpu_torch.health import HealthMonitor
from mxnet_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("MXNET_FAULT_INJECT", "MXNET_FP8", "MXNET_FP8_LAYERS",
                "MXNET_HEALTH_MONITOR", "MXNET_LOSS_SCALE"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    yield
    os.environ.pop("MXNET_FAULT_INJECT", None)
    faults.reset()


@pytest.fixture(autouse=True)
def _keep_global_rng():
    """Leave the port's, numpy's and torch's global random state as found:
    later test files in the same worker draw from it."""
    st = tmx.random._get()
    saved = (st.seed_value, st.counter, np.random.get_state(),
             torch.random.get_rng_state())
    yield
    st.seed_value, st.counter = saved[0], saved[1]
    np.random.set_state(saved[2])
    torch.random.set_rng_state(saved[3])


def _mlp(dropout=0.0):
    net = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(net, num_hidden=8, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu")
    if dropout:
        net = tmx.sym.Dropout(net, p=dropout)
    net = tmx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return tmx.sym.SoftmaxOutput(net, name="softmax")


def _data(n=64):
    rs = np.random.RandomState(0)
    X = rs.randn(n, 8).astype("float32")
    w = rs.randn(8, 3).astype("float32")
    return X, (X @ w).argmax(axis=1).astype("float32")


def _fit(num_epoch, X, y, **kw):
    it = tmx.io.NDArrayIter(X, y, batch_size=8, shuffle=True, seed=42)
    np.random.seed(7)
    tmx.random.seed(7)
    mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
    mod.fit(it, num_epoch=num_epoch, optimizer="sgd",
            initializer=tmx.init.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9}, **kw)
    return mod


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _accuracy(mod, X, y):
    it = tmx.io.NDArrayIter(X, y, batch_size=8)
    return dict(mod.score(it, tmx.metric.Accuracy()))["accuracy"]


def _manager(tmp_path):
    return ckpt.CheckpointManager(str(tmp_path), prefix="m")


# -- checkpoint, resume and preemption -----------------------------------

def test_fit_checkpoints_through_the_manager(tmp_path):
    X, y = _data()
    mgr = _manager(tmp_path)
    mod = _fit(1, X, y, checkpoint=mgr)
    state = mgr.load(device="cpu")
    assert (state.epoch, state.nbatch, state.num_update) == (1, 0, 8)
    assert state.states_path is not None and \
        os.path.exists(state.states_path)
    for k, v in _params(mod).items():
        np.testing.assert_array_equal(v, state.arg_params[k].asnumpy())


def test_resume_reproduces_uninterrupted_run_bitwise(tmp_path):
    X, y = _data()
    ref = _params(_fit(3, X, y))
    mgr = _manager(tmp_path)
    _fit(1, X, y, checkpoint=mgr, checkpoint_period=1)
    res = _params(_fit(3, X, y, resume_from=mgr))
    for k in ref:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)


ROBUST = dict(health="skip", loss_scale="dynamic", steps_per_call=2,
              step_timeout_s=60.0)


@pytest.mark.parametrize("kill_at,where,fp8,opts", [
    (3, (0, 3), False, {}), (8, (0, 8), False, {}),
    (2, (0, 4), True, ROBUST)])
def test_preemption_checkpoints_and_resumes_bitwise(tmp_path, monkeypatch,
                                                    kill_at, where, fp8,
                                                    opts):
    """SIGTERM at a batch boundary mid-epoch, and on the epoch's last
    batch (the resume then starts the next epoch): the final checkpoint
    holds the position, and the resumed fit equals the uninterrupted
    one.  Under fp8 with the loss scaler, the monitor and 2-step calls
    the checkpoint also carries the step's health state (scale, streak,
    amax history), so the resumed fp8 scales are the uninterrupted
    run's."""
    if fp8:
        monkeypatch.setenv("MXNET_FP8", "on")
    X, y = _data()  # 64 rows / batch 8 = 8 batches an epoch
    ref = _params(_fit(2, X, y, **opts))
    mgr = _manager(tmp_path)
    count = [0]

    def kill_self(param):
        count[0] += 1
        if count[0] == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(TrainingPreempted) as ei:
        _fit(2, X, y, batch_end_callback=kill_self, checkpoint=mgr, **opts)
    assert ei.value.signum == signal.SIGTERM
    assert (ei.value.epoch, ei.value.nbatch) == where
    state = mgr.load(device="cpu")
    assert (state.epoch, state.nbatch, state.num_update) == \
        where + (where[1],)
    assert (state.hstate is not None) == fp8
    if fp8:
        assert np.asarray(state.hstate["fp8_hist"]).shape == (2, 2, 16)
    res = _params(_fit(2, X, y, resume_from=mgr, **opts))
    for k in ref:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)


@pytest.mark.parametrize("fused_step", [True, False])
def test_optimizer_states_round_trip(tmp_path, monkeypatch, fused_step):
    if not fused_step:
        monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    X, y = _data(16)
    it = tmx.io.NDArrayIter(X, y, batch_size=8)

    def module():
        tmx.random.seed(3)
        mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(initializer=tmx.init.Xavier())
        mod.init_optimizer(optimizer="adam", kvstore=None,
                           optimizer_params={"learning_rate": 0.01})
        return mod

    a = module()
    assert (a._fused is not None) == fused_step
    it.reset()
    for batch in it:
        a.forward_backward(batch)
        a.update()
    fname = str(tmp_path / "opt.states")
    a.save_optimizer_states(fname)
    b = module()
    b.set_params(*a.get_params())
    b.load_optimizer_states(fname)
    it.reset()
    batch = next(iter(it))
    for mod in (a, b):
        mod._optimizer.num_update = 2
        mod._optimizer.begin_num_update = 2
        mod._optimizer._index_update_count = {}
        mod.forward_backward(batch)
        mod.update()
    pa, pb = _params(a), _params(b)
    for k in pa:
        np.testing.assert_array_equal(pb[k], pa[k], err_msg=k)


def test_trainer_states_round_trip(tmp_path):
    def net_and_trainer():
        tmx.random.seed(1)
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        return net, tmx.gluon.Trainer(net.collect_params(), "adam",
                                      {"learning_rate": 0.01})

    with tmx.cpu():
        x = tmx.nd.array(np.random.RandomState(2).randn(5, 4))
    net, trainer = net_and_trainer()
    for _ in range(2):
        with tmx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(5)
    fname = str(tmp_path / "trainer.states")
    trainer.save_states(fname)
    _, other = net_and_trainer()
    other.load_states(fname)
    assert sorted(other._updater.states) == sorted(trainer._updater.states)
    for i, st in trainer._updater.states.items():
        for a, b in zip(st, other._updater.states[i]):
            np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())


# -- run health inside fit -------------------------------------------------

def _quiet_monitor(**kw):
    kw.setdefault("loss_spike", 1e9)
    kw.setdefault("grad_spike", 1e9)
    kw.setdefault("lag", 0)
    kw.setdefault("warmup", 2)
    return HealthMonitor(**kw)


def test_fit_skips_poisoned_step_and_completes(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "numerics:nan:after=5")
    faults.reset()
    X, y = _data()
    mon = _quiet_monitor(policy="skip")
    mod = _fit(6, X, y, health=mon)
    assert mon.total_skips == 1 and mon.consecutive_skips == 0
    for k, v in _params(mod).items():
        assert np.isfinite(v).all(), k
    assert _accuracy(mod, X, y) > 0.8


@pytest.mark.parametrize("policy,match", [
    ("skip", "MXNET_HEALTH_POLICY=rollback"), ("rollback", "checkpoint")])
def test_fit_diverges_typed(monkeypatch, policy, match):
    """Sticky NaNs: under 'skip' the skip budget runs out; under
    'rollback' without a checkpoint there is nothing to roll back to."""
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "numerics:nan:after=3:sticky=1")
    faults.reset()
    X, y = _data()
    with pytest.raises(TrainingDiverged, match=match) as ei:
        _fit(2, X, y, health=_quiet_monitor(policy=policy, max_skips=2))
    assert ei.value.epoch == 0 and ei.value.nbatch == 3


def test_fit_rollback_restores_and_converges(tmp_path, monkeypatch):
    X, y = _data()
    ref_acc = _accuracy(_fit(8, X, y), X, y)
    # 4 poisoned batches in a row from epoch 1 batch 3
    monkeypatch.setenv(
        "MXNET_FAULT_INJECT",
        "numerics:nan:after=12,numerics:nan:after=13,"
        "numerics:nan:after=14,numerics:nan:after=15")
    faults.reset()
    mon = _quiet_monitor(policy="rollback", max_skips=3, max_rollbacks=3,
                         lr_backoff=0.8)
    mod = _fit(8, X, y, health=mon, checkpoint=_manager(tmp_path))
    assert mon.total_rollbacks == 1
    assert mod._optimizer.lr == pytest.approx(0.1 * 0.8)
    assert _accuracy(mod, X, y) >= ref_acc - 0.15


def test_fit_dynamic_loss_scale_trains():
    X, y = _data()
    mod = _fit(6, X, y, loss_scale="dynamic")
    assert mod._fused is not None and mod._fused.loss_scale == 2.0 ** 15
    assert _accuracy(mod, X, y) > 0.8


def test_fit_step_watchdog_raises_step_hung(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_HEALTH_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_FAULT_INJECT", "step:hang:after=3:seconds=20")
    faults.reset()
    X, y = _data()
    with pytest.raises(StepHung) as ei:
        _fit(1, X, y, step_timeout_s=1.0)
    assert ei.value.dump_path and os.path.exists(ei.value.dump_path)
    assert "epoch 0 batch 2" in (ei.value.note or "")


# -- remat ----------------------------------------------------------------

def _remat_run(remat, fp8, K, monkeypatch):
    monkeypatch.setenv("MXNET_FP8", "on" if fp8 else "off")
    step = fused.TrainStep(_mlp(dropout=0.5), optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9},
                           steps_per_call=K, remat=remat, device="cpu")
    p, a, s = step.init_state({"data": (16, 8), "softmax_label": (16,)})
    X, y = _data(16)
    batch = {"data": torch.from_numpy(X), "softmax_label": torch.from_numpy(y)}
    if K > 1:
        batch = {k: torch.stack([v] * K) for k, v in batch.items()}
    for i in range(3):
        p, a, s, outs = step(p, a, s, batch, torch.Generator().manual_seed(i))
    return p, s, outs


@pytest.mark.parametrize("remat", [True, "full", "nothing_saveable",
                                   "dots_saveable",
                                   "dots_with_no_batch_dims_saveable",
                                   "everything_saveable"])
@pytest.mark.parametrize("fp8,K", [(False, 1), (True, 1), (False, 2)])
def test_remat_equals_no_remat_bitwise(monkeypatch, remat, fp8, K):
    """Dropout at 0.5: the recomputed forward draws the masks the first
    one drew, so the update is the one without remat, bit for bit."""
    want = _remat_run(None, fp8, K, monkeypatch)
    got = _remat_run(remat, fp8, K, monkeypatch)
    for w, g in zip(want[:2], got[:2]):
        for k in w:
            if w[k] is not None:
                assert torch.equal(g[k], w[k]), k
    for w, g in zip(want[2], got[2]):
        assert torch.equal(g, w)


def test_remat_unknown_policy_raises():
    with pytest.raises(MXNetError, match="unknown remat policy"):
        fused.TrainStep(_mlp(), remat="save_only_these_names",
                        device="cpu")
    with pytest.raises(MXNetError, match="unknown remat policy"):
        fused.TrainStep(_mlp(), remat="checkpoint_everything",
                        device="cpu")


# -- what still raises ----------------------------------------------------

@pytest.mark.parametrize("kwargs", [dict(zero="on"), dict(plan="data=2"),
                                    dict(elastic=True),
                                    dict(param_sharding="fsdp"),
                                    dict(monitor=object()),
                                    dict(kvstore="dist_sync")])
def test_multi_device_and_monitor_gates_stand(kwargs):
    X, y = _data(16)
    mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
    with pytest.raises(MXNetError, match="later slice"):
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
                **kwargs)
