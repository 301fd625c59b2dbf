"""The port's run health (mxnet_tpu_torch/health.py) against
mxnet_tpu/health.py, on the CPU.

* The step watchdog: a stalled loop gets its stacks dumped to a JSON
  artifact in the JAX package's schema (tools/diagnose.py renders it)
  and StepHung delivered into the watched thread; kicks and a pause keep
  it quiet.
* Twins of tests/test_health.py:90-446: the loss scaler's schedule
  equals the JAX package's exactly over clean and poisoned steps; a
  poisoned step is skipped bit for bit (params, optimizer states, aux);
  a static scale's trajectory equals the unscaled one (rtol 1e-5, atol
  1e-6: scale and unscale are powers of two, the rest fp32 order);
  clip_global_norm halves a plain-SGD update (rtol 1e-4, atol 1e-7);
  HealthMonitor's decisions, counters and errors equal the JAX
  package's on the same stats; the split path's pass zeroes poisoned
  gradients.
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import health as jhealth
from mxnet_tpu.fused import TrainStep as JStep
from mxnet_tpu_torch import fused, health
from mxnet_tpu_torch.base import MXNetError, StepHung, TrainingDiverged
from mxnet_tpu_torch.health import (DynamicLossScaler, HealthMonitor,
                                    StepHealth)

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


TOOL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "tools", "diagnose.py")


def test_watchdog_dumps_and_raises_step_hung(tmp_path):
    wd = health.StepWatchdog(0.2, stats_cb=lambda: {"step": 7},
                             dump_dir=str(tmp_path)).start()
    try:
        with pytest.raises(StepHung):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        wd.stop()
    assert wd.fired and wd.dump_path.startswith(str(tmp_path))
    assert wd.target is threading.current_thread()
    assert wd.fired_note == "startup (no step dispatched yet)"
    payload = json.loads(open(wd.dump_path).read())
    assert payload["kind"] == "mxnet_tpu-watchdog-dump"
    assert payload["health"] == {"step": 7}
    assert "test_watchdog_dumps_and_raises_step_hung" in \
        payload["traceback"]
    assert health.last_hang_details()["dump_path"] == wd.dump_path
    res = subprocess.run([sys.executable, TOOL, wd.dump_path],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr


def test_watchdog_kick_pause_and_validation(tmp_path):
    with pytest.raises(MXNetError, match="> 0"):
        health.StepWatchdog(0)
    # a 1 s timeout: a 50 ms sleep stays far inside it on a loaded CPU
    wd = health.StepWatchdog(1.0, dump_dir=str(tmp_path)).start()
    try:
        for _ in range(8):  # kicked well inside the timeout: never fires
            time.sleep(0.05)
            wd.kick("step")
        wd.pause()  # paused across a long stretch: never fires
        time.sleep(1.5)
        assert not wd.fired and wd.alive
    finally:
        wd.stop()
    assert not wd.alive
    assert not any(t.name.startswith(health.WATCHDOG_THREAD_PREFIX)
                   for t in threading.enumerate())


# -- DynamicLossScaler ---------------------------------------------------

@pytest.mark.parametrize("spec", [None, "", "dynamic", 128, "64.0"])
def test_loss_scaler_from_spec_matches_jax(spec):
    got = DynamicLossScaler.from_spec(spec)
    want = jhealth.DynamicLossScaler.from_spec(spec)
    if want is None:
        assert got is None
        return
    assert vars(got) == vars(want)


def test_loss_scaler_validation_and_instances():
    scaler = DynamicLossScaler(init_scale=4.0)
    assert DynamicLossScaler.from_spec(scaler) is scaler
    static = DynamicLossScaler.from_spec(128)
    assert static.min_scale == static.max_scale == 128.0  # never moves
    with pytest.raises(MXNetError, match="init_scale"):
        DynamicLossScaler(init_scale=-1)
    with pytest.raises(MXNetError, match="StepHealth"):
        fused.TrainStep(_mlp(tmx), health=object(), device="cpu")


# -- the fused step's in-step numerics ----------------------------------

def _mlp(pkg):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _batch(nan=False):
    X = np.random.RandomState(0).randn(16, 8).astype("float32")
    if nan:
        X[0, 0] = np.nan
    return {"data": X, "softmax_label": np.zeros((16,), "float32")}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _make_step(jax_too=False, scaler=None, **kw):
    """A port TrainStep (and with ``jax_too`` the JAX package's) over the
    MLP from one numpy state: ``scaler`` a dict of DynamicLossScaler
    arguments, ``kw`` more TrainStep arguments (``health=True`` for a
    plain StepHealth)."""
    kw.setdefault("optimizer_params", {"learning_rate": 0.1,
                                       "momentum": 0.9})
    want_health = kw.pop("health", None) or scaler is not None
    jkw, tkw = dict(kw), dict(kw)
    if want_health:
        jkw["health"] = jhealth.StepHealth(
            scaler=jhealth.DynamicLossScaler(**scaler) if scaler else None)
        tkw["health"] = StepHealth(
            scaler=DynamicLossScaler(**scaler) if scaler else None)
    tstep = fused.TrainStep(_mlp(tmx), optimizer="sgd", device="cpu",
                            **tkw)
    rs = np.random.RandomState(5)
    state = {"fc1_weight": 0.5 * rs.randn(8, 8),
             "fc1_bias": 0.1 * rs.randn(8),
             "fc2_weight": 0.5 * rs.randn(3, 8),
             "fc2_bias": 0.1 * rs.randn(3)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    moms = {k: np.zeros_like(v) for k, v in state.items()}
    tp, ta, ts = fused.state_from_numpy(state, {}, moms, device="cpu")
    if not jax_too:
        return tstep, tp, ta, ts
    jstep = JStep(_mlp(jmx), optimizer="sgd", **jkw)
    import jax.numpy as jnp

    jp = {k: jnp.asarray(v) for k, v in state.items()}
    js = {k: jnp.asarray(v) for k, v in moms.items()}
    return (tstep, tp, ta, ts), (jstep, jp, {}, js)


def _gen(i=0):
    return torch.Generator().manual_seed(i)


def test_fused_health_stats_reported():
    step, p, a, s = _make_step(health=True)
    step(p, a, s, _tb(_batch()), _gen())
    stats = step.last_health
    assert float(stats["grad_norm"]) > 0
    assert np.isfinite(float(stats["loss"]))
    assert not bool(stats["nonfinite"])


def test_fused_skip_is_bit_exact():
    """A NaN-poisoned batch leaves params AND optimizer states
    bit-identical: the device-side select, not a small update."""
    step, p, a, s = _make_step(health=True)
    p, a, s, _ = step(p, a, s, _tb(_batch()), _gen())
    p2, a2, s2, _ = step(p, a, s, _tb(_batch(nan=True)), _gen(1))
    assert bool(step.last_health["nonfinite"])
    for k in p:
        assert torch.equal(p2[k], p[k]), k
        assert torch.equal(s2[k], s[k]), k
    # and the step still trains on the next clean batch
    p3, _, _, _ = step(p2, a2, s2, _tb(_batch()), _gen(2))
    assert not torch.equal(p3["fc1_weight"], p["fc1_weight"])


def _tree_equal(a, b):
    if a is None or b is None:
        return a is b
    if isinstance(a, tuple):
        return all(_tree_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _tree_clone(a):
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_tree_clone(x) for x in a)
    return a.clone()


@pytest.mark.parametrize("name", ["adam", "nadam", "rmsprop", "test"])
def test_fused_skip_keeps_every_optimizers_states(name):
    """The skip writes its select over the update's fresh tensors; an
    optimizer that returns one tensor as weight and state (``test``) or
    a state tuple (Adam, Nadam's schedule, RMSProp) keeps its old bits
    all the same."""
    step, p, a, s = _make_step(health=True, optimizer_params={})
    step = fused.TrainStep(_mlp(tmx), optimizer=name, device="cpu",
                           health=StepHealth())
    s = {k: step.optimizer.init_fused_state(v) for k, v in p.items()}
    p, a, s, _ = step(p, a, s, _tb(_batch()), _gen())
    before = {k: v.clone() for k, v in p.items()}
    states = {k: _tree_clone(v) for k, v in s.items()}
    p2, _, s2, _ = step(p, a, s, _tb(_batch(nan=True)), _gen(1))
    assert bool(step.last_health["nonfinite"])
    for k in p:
        assert torch.equal(p2[k], before[k]), k
        assert _tree_equal(s2[k], states[k]), k


def test_fused_loss_scaler_schedule_matches_jax():
    """Growth after every 2 clean steps, back-off and skip on each
    poisoned one, bounded to [1, 64]: the scale after every step is the
    JAX package's exactly, and the parameters follow its (rtol 1e-5)."""
    sc = dict(init_scale=8.0, growth=2.0, backoff=0.5, growth_interval=2,
              min_scale=1.0, max_scale=64.0)
    (tstep, tp, ta, ts), (jstep, jp, ja, js) = _make_step(True, sc)
    rng = jax.random.PRNGKey(0)
    pattern = [0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0] + [1] * 7 + [0, 0]
    got, want = [], []
    for i, bad in enumerate(pattern):
        b = _batch(nan=bool(bad))
        tp, ta, ts, _ = tstep(tp, ta, ts, _tb(b), _gen(i))
        jp, ja, js, _ = jstep(jp, ja, js, b, rng)
        got.append((tstep.loss_scale,
                    bool(tstep.last_health["nonfinite"])))
        want.append((jstep.loss_scale,
                     bool(jax.device_get(jstep.last_health["nonfinite"]))))
    assert got == want
    assert max(s for s, _ in got) == 64.0 and min(s for s, _ in got) == 1.0
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_fused_scaled_matches_unscaled():
    step, p, a, s = _make_step()
    for i in range(3):
        p, a, s, _ = step(p, a, s, _tb(_batch()), _gen(i))
    step2, p2, a2, s2 = _make_step(scaler=dict(
        vars(DynamicLossScaler.from_spec(1024.0))))
    for i in range(3):
        p2, a2, s2, _ = step2(p2, a2, s2, _tb(_batch()), _gen(i))
    assert step2.loss_scale == 1024.0
    for k in p:
        np.testing.assert_allclose(p2[k].numpy(), p[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_clip_global_norm_fused():
    """Clipping at half the raw norm exactly halves a plain-SGD update;
    the reported norm is the pre-clip one."""
    plain = {"learning_rate": 0.1}
    step, p0, a, s = _make_step(health=True, optimizer_params=plain)
    pa, _, _, _ = step(p0, a, s, _tb(_batch()), _gen())
    gnorm = float(step.last_health["grad_norm"])
    step2, _, a2, s2 = _make_step(
        health=True, optimizer_params=dict(plain, clip_global_norm=gnorm / 2))
    pb, _, _, _ = step2(p0, a2, s2, _tb(_batch()), _gen())
    assert float(step2.last_health["grad_norm"]) == pytest.approx(
        gnorm, rel=1e-5)
    for k in p0:
        np.testing.assert_allclose((pb[k] - p0[k]).numpy(),
                                   (pa[k] - p0[k]).numpy() / 2.0,
                                   rtol=1e-4, atol=1e-7, err_msg=k)


# -- HealthMonitor: the same decisions as the JAX package's ---------------

def _quiet(mod, **kw):
    kw.setdefault("loss_spike", 1e9)
    kw.setdefault("grad_spike", 1e9)
    kw.setdefault("lag", 0)
    kw.setdefault("warmup", 2)
    return mod.HealthMonitor(**kw)


NAN = float("nan")
# (monitor kwargs, events): ("obs", kwargs) observes one step,
# ("tick", stats) queues one, ("flush",), ("rollback",) notes a rollback
# and soft-resets, as fit does
SCENARIOS = {
    "skip_then_diverge": (dict(policy="skip", max_skips=3), [
        ("obs", dict(loss=1.0, grad_norm=1.0)),
        ("obs", dict(loss=NAN, grad_norm=1.0)), ("obs", dict(nonfinite=True)),
        ("obs", dict(loss=1.0, grad_norm=1.0)),
        ("obs", dict(nonfinite=True)), ("obs", dict(nonfinite=True)),
        ("obs", dict(nonfinite=True))]),
    "warn_never_raises": (dict(policy="warn", max_skips=2),
                          [("obs", dict(nonfinite=True))] * 10),
    "rollback_exhausted": (dict(policy="rollback", max_skips=2,
                                max_rollbacks=2), [
        ("obs", dict(nonfinite=True)), ("obs", dict(nonfinite=True)),
        ("rollback",),
        ("obs", dict(nonfinite=True)), ("obs", dict(nonfinite=True)),
        ("rollback",),
        ("obs", dict(nonfinite=True)), ("obs", dict(nonfinite=True))]),
    "loss_spike_warns": (dict(policy="skip", loss_spike=10.0, warmup=3,
                              ema_decay=0.5),
                         [("obs", dict(loss=1.0, grad_norm=1.0))] * 5 +
                         [("obs", dict(loss=100.0, grad_norm=1.0))]),
    "spike_rolls_back": (dict(policy="rollback", loss_spike=10.0),
                         [("obs", dict(loss=1.0, grad_norm=1.0))] * 4 +
                         [("obs", dict(loss=100.0, grad_norm=1.0))]),
    "grad_spike": (dict(policy="skip", grad_spike=5.0, warmup=2),
                   [("obs", dict(loss=1.0, grad_norm=1.0))] * 3 +
                   [("obs", dict(loss=1.0, grad_norm=50.0))]),
    "lag_queue_and_flush": (dict(policy="skip", lag=2), [
        ("tick", {"loss": NAN, "grad_norm": 1.0, "nonfinite": True})] * 3 +
        [("flush",)]),
    "stacked_inner_steps": (dict(policy="skip"), [
        ("tick", {"loss": [1.0, NAN, 1.0], "grad_norm": [1.0, 1.0, 1.0],
                  "nonfinite": [False, True, False]})]),
    "split_stats_without_loss": (dict(policy="skip"), [
        ("tick", {"grad_norm": 1.0, "nonfinite": False})] * 30 + [
        ("tick", {"grad_norm": NAN, "nonfinite": True})]),
}


def _play(mod, kwargs, events, as_tensor):
    mon = _quiet(mod, **kwargs)
    log = []
    for ev in events:
        try:
            if ev[0] == "obs":
                log.append(mon.observe(**ev[1]))
            elif ev[0] == "tick":
                stats = {k: (torch.tensor(v) if as_tensor else np.asarray(v))
                         for k, v in ev[1].items()}
                log.append(mon.tick(stats, step=len(log)))
            elif ev[0] == "flush":
                log.append(mon.flush())
            else:
                mon.note_rollback()
                mon.soft_reset()
                log.append("noted")
        except (TrainingDiverged, jhealth.TrainingDiverged) as e:
            log.append(("diverged", str(e)))
            break
    snap = mon.snapshot()
    snap.pop("last_stats")
    return log, snap, getattr(mon, "_last_anomaly", None)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_monitor_decisions_match_jax(name):
    kwargs, events = SCENARIOS[name]
    want = _play(jhealth, kwargs, events, as_tensor=False)
    got = _play(health, kwargs, events, as_tensor=True)
    assert got == want
    assert any(a != "ok" for a in got[0])


def test_split_health_pass_zeroes_nonfinite_grads(monkeypatch):
    """The split path's skip selects zero for poisoned gradients: a
    multiplicative 0 * NaN would leak NaN into the optimizer."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    X, _ = _batch()["data"], None
    y = np.zeros(16, "float32")
    it = tmx.io.NDArrayIter(X, y, batch_size=8)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=tmx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1},
                       kvstore=None, health="skip")
    assert mod._fused is None
    mod.forward_backward(next(iter(it)))
    before = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    g = mod._exec.grad_dict["fc1_weight"]
    g._set_data(torch.full(g.shape, float("nan")))
    mod.update()
    for name, arr in mod.get_params()[0].items():
        np.testing.assert_array_equal(arr.asnumpy(), before[name],
                                      err_msg=name)
    assert bool(mod._last_health_stats["nonfinite"])


def test_resolve_monitor_forms(monkeypatch):
    monkeypatch.delenv("MXNET_HEALTH_MONITOR", raising=False)
    assert health.resolve_monitor(None) is None
    assert health.resolve_monitor(False) is None
    mon = health.resolve_monitor("rollback")
    assert isinstance(mon, HealthMonitor) and mon.policy == "rollback"
    assert health.resolve_monitor(mon) is mon
    monkeypatch.setenv("MXNET_HEALTH_MONITOR", "1")
    monkeypatch.setenv("MXNET_HEALTH_POLICY", "warn")
    auto = health.resolve_monitor(None)
    assert isinstance(auto, HealthMonitor) and auto.policy == "warn"
    with pytest.raises(MXNetError, match="policy"):
        HealthMonitor(policy="explode")
