"""The port's replica supervisor against the JAX package's, at
test_serve.py's sizes (vocab 61, 2 layers, d_model 32, 2 heads, page 8):
twins of tests/test_serve_supervisor.py and tests/test_serve_failover.py
over the port's sessions on the CPU.

The invariant everywhere: a completed response from a run with replica
kills is bit-identical to the same trace on a never-failed single
session, and here also equal, token for token, to the JAX package's
ReplicaSet on the same weights and requests.

Determinism notes the chaos specs rely on (as in the JAX tests):
``serve_replica_kill`` fires at the top of every live replica's tick in
replica-index order, so while two replicas are live the site's hits
alternate r0 (odd), r1 (even); a raising spec entry skips the hit count
of every entry after it, so specs that must fire on consecutive hits
list descending ``after=`` values.
"""
import json
import os
import subprocess
import sys
import types

import pytest

from mxnet_tpu_torch import serve as tserve
from mxnet_tpu_torch.base import MXNetError, StepHung
from mxnet_tpu_torch.serve import model as tmodel
from mxnet_tpu_torch.testing import faults

CFG = tserve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                         num_heads=2, max_len=64)
SCONF = dict(slots=3, page_size=8, buckets=(8, 16), max_new=8, exact=True)
TOOL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "tools", "diagnose.py")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Ticks here time against watchdog timeouts: torch's intra-op pool
    on a loaded machine stretches a tick of these tiny shapes from ~10
    ms to over a second, one thread keeps it at ~10 ms."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch, tmp_path):
    monkeypatch.delenv("MXNET_FAULT_INJECT", raising=False)
    # incident files and watchdog dumps land in the test's own directory
    monkeypatch.setenv("MXNET_HEALTH_DIR", str(tmp_path))
    for var in ("MXNET_SERVE_REPLICAS", "MXNET_SERVE_STEP_TIMEOUT_S",
                "MXNET_SERVE_DEADLINE_MS", "MXNET_SERVE_BREAKER_K"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def np_params():
    """Seeded weights, drawn by the port's init_params and handed to
    both packages as numpy."""
    return {k: v.numpy() for k, v in
            tmodel.init_params(CFG, seed=3, device="cpu").items()}


def _session(np_params, **kw):
    conf = dict(SCONF)
    conf.update(kw)
    return tserve.InferenceSession(np_params, num_heads=CFG.num_heads,
                                   config=tserve.ServeConfig(**conf),
                                   device="cpu")


@pytest.fixture(scope="module")
def _pool(np_params):
    return [_session(np_params) for _ in range(3)]


@pytest.fixture
def pool(_pool):
    yield _pool
    for sess in _pool:
        sess.reset_cold()


def _mk(n=8, max_new=6, api=tserve):
    return [api.Request(rid=i, prompt=[1 + i, 2, 3], max_new=max_new)
            for i in range(n)]


@pytest.fixture(scope="module")
def oracle(_pool):
    """rid -> stream of a plain single-session run of 12 requests."""
    out, _ = tserve.Scheduler(_pool[2]).run(_mk(12))
    assert all(not r.failed for r in out)
    for sess in _pool:
        sess.reset_cold()
    return {r.rid: list(r.tokens) for r in out}


@pytest.fixture(scope="module")
def jax_streams(np_params):
    """rid -> stream of the JAX package's two-replica ReplicaSet on the
    same weights and requests."""
    from mxnet_tpu import serve as jserve

    sessions = [jserve.InferenceSession(
        np_params, num_heads=CFG.num_heads,
        config=jserve.ServeConfig(**SCONF)) for _ in range(2)]
    out, _ = jserve.ReplicaSet(sessions=sessions).run(_mk(12, api=jserve))
    assert all(not r.failed for r in out)
    return {r.rid: list(r.tokens) for r in out}


# ---------------------------------------------------------------------------
# construction + env knobs
# ---------------------------------------------------------------------------

def test_env_knobs_and_validation(monkeypatch, pool):
    monkeypatch.setenv("MXNET_SERVE_REPLICAS", "0")
    with pytest.raises(MXNetError, match=">= 1 replica"):
        tserve.ReplicaSet(params="x", num_heads=2)
    monkeypatch.delenv("MXNET_SERVE_REPLICAS")
    with pytest.raises(MXNetError, match="params"):
        tserve.ReplicaSet(replicas=2)
    monkeypatch.setenv("MXNET_SERVE_DEADLINE_MS", "250")
    monkeypatch.setenv("MXNET_SERVE_STEP_TIMEOUT_S", "7.5")
    monkeypatch.setenv("MXNET_SERVE_BREAKER_K", "4")
    rs = tserve.ReplicaSet(sessions=pool[:2])
    assert (rs.deadline_ms, rs.step_timeout_s, rs.breaker_k) \
        == (250.0, 7.5, 4)
    assert rs.queue_cap == 4 * 2 * SCONF["slots"]
    with pytest.raises(MXNetError, match="breaker K"):
        tserve.ReplicaSet(sessions=pool[:2], breaker_k=0)


def test_mismatched_configs_rejected():
    mk = lambda slots: types.SimpleNamespace(config=tserve.ServeConfig(
        slots=slots, page_size=8, buckets=(8, 16)))
    with pytest.raises(MXNetError, match="share one ServeConfig"):
        tserve.ReplicaSet(sessions=[mk(2), mk(3)])


def test_replicaset_builds_its_sessions_from_params(np_params):
    rs = tserve.ReplicaSet(np_params, CFG.num_heads,
                           config=tserve.ServeConfig(**SCONF), replicas=2,
                           device="cpu")
    assert [r.session.device.type for r in rs.replicas] == ["cpu", "cpu"]
    assert rs.replicas[0].session is not rs.replicas[1].session
    out, _ = rs.run(_mk(4))
    assert all(not r.failed and len(r.tokens) == 6 for r in out)


# ---------------------------------------------------------------------------
# dispatch: multi-replica runs complete bit-exactly
# ---------------------------------------------------------------------------

def test_two_replicas_equal_single_session_and_jax(pool, oracle,
                                                   jax_streams):
    rs = tserve.ReplicaSet(sessions=pool[:2])
    out, makespan = rs.run(_mk(12))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 12 and s["failed"] == 0
    assert rs.incident_path is None and rs.events == []
    got = {r.rid: r.tokens for r in out}
    assert got == oracle
    assert got == jax_streams
    assert rs.executables_per_replica() == [len(SCONF["buckets"]) + 1] * 2


def test_followup_requests_flow_through_dispatcher(pool):
    spawned = []

    def followup(req, now_s):
        if req.rid < 2 and not spawned:
            nxt = tserve.Request(rid=100, prompt=[7, 8, 9], max_new=4,
                                 arrival_s=now_s)
            spawned.append(nxt)
            return nxt
        return None

    rs = tserve.ReplicaSet(sessions=pool[:2])
    out, makespan = rs.run(_mk(4), followup=followup)
    s = tserve.summarize(out, makespan)
    assert len(spawned) == 1 and s["completed"] == 5
    assert any(r.rid == 100 and r.done_s >= 0 for r in out)


# ---------------------------------------------------------------------------
# overload protection: bounded queue + deadline-aware shedding
# ---------------------------------------------------------------------------

def test_queue_cap_sheds_typed(pool):
    rs = tserve.ReplicaSet(sessions=pool[:2], queue_cap=2)
    out, makespan = rs.run(_mk(12))
    s = tserve.summarize(out, makespan)
    assert s["shed"] > 0 and s["faulted"] == 0
    assert s["completed"] + s["shed"] == 12
    for r in out:
        if r.failed:
            assert r.shed and "ServeOverloaded" in r.error \
                and "queue full" in r.error
    assert rs.counters["shed"] == rs.counters["shed_queue"] == s["shed"]
    assert rs.counters["shed_deadline"] == 0
    assert s["shed_queue"] == s["shed"] and s["shed_deadline"] == 0
    assert all(r.shed_kind == "queue" for r in out if r.shed)
    shed_events = [e for e in rs.events if e["event"] == "shed"]
    assert len(shed_events) == s["shed"]
    assert all(e["kind"] == "queue" for e in shed_events)


def test_deadline_lapse_sheds_typed(pool):
    rs = tserve.ReplicaSet(sessions=pool[:2], deadline_ms=1e-3)
    out, makespan = rs.run(_mk(8))
    s = tserve.summarize(out, makespan)
    assert s["shed"] == 8 and s["completed"] == 0
    assert all("deadline lapsed" in r.error or "projected TTFT" in r.error
               for r in out)
    assert rs.counters["shed_deadline"] == 8
    assert rs.counters["shed_queue"] == 0
    assert s["shed_deadline"] == 8 and s["shed_queue"] == 0
    assert all(r.shed_kind == "deadline" for r in out)


def test_per_request_deadline_overrides_default(pool):
    rs = tserve.ReplicaSet(sessions=pool[:2])
    reqs = _mk(8)
    reqs[5].deadline_ms = 1e-3
    out, makespan = rs.run(reqs)
    s = tserve.summarize(out, makespan)
    assert s["shed"] == 1 and s["completed"] == 7
    assert next(r for r in out if r.rid == 5).shed


def test_summarize_surfaces_robustness_counters(pool):
    rs = tserve.ReplicaSet(sessions=pool[:2], queue_cap=1)
    out, makespan = rs.run(_mk(10))
    s = tserve.summarize(out, makespan)
    for key in ("shed", "shed_queue", "shed_deadline", "faulted",
                "cancelled", "preemptions", "resumes"):
        assert key in s
    assert s["failed"] == s["shed"] + s["faulted"] + s["cancelled"]
    assert s["shed"] == s["shed_queue"] + s["shed_deadline"]
    assert s["cancelled"] == 0
    assert s["resumes"] == sum(r.resumes for r in out)


# ---------------------------------------------------------------------------
# chaos: dispatch faults, breaker, watchdog, rejoin
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_dispatch_fault_fails_one_request_typed(monkeypatch, pool):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "serve_dispatch:raise:after=3")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2])
    out, makespan = rs.run(_mk(8))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 7 and s["faulted"] == 1 and s["shed"] == 0
    bad = [r for r in out if r.failed]
    assert len(bad) == 1 and "FaultInjected" in bad[0].error
    assert rs.counters["dispatch_faults"] == 1


@pytest.mark.chaos
def test_breaker_tolerates_faults_below_k(monkeypatch, pool):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:raise:after=3,"
                       "serve_replica_kill:raise:after=1")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], breaker_k=3,
                           rejoin_backoff_s=30.0)
    out, makespan = rs.run(_mk(8))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 8 and rs.counters["deaths"] == 0
    evs = [e for e in rs.events if e["event"] == "breaker_fault"]
    assert [e["replica"] for e in evs] == [0, 0]
    assert evs[-1]["consecutive"] == 2


@pytest.mark.chaos
def test_breaker_ejects_at_k_consecutive(monkeypatch, pool, oracle):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:raise:after=5,"
                       "serve_replica_kill:raise:after=3,"
                       "serve_replica_kill:raise:after=1")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], breaker_k=3,
                           rejoin_backoff_s=30.0)
    out, makespan = rs.run(_mk(8))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 8 and s["failed"] == 0
    assert rs.counters["deaths"] == 1
    death = next(e for e in rs.events if e["event"] == "death")
    assert death["replica"] == 0 and "circuit breaker" in death["detail"]
    assert all(oracle[r.rid] == r.tokens for r in out)


@pytest.mark.chaos
def test_watchdog_marks_hung_replica_dead(monkeypatch, pool, oracle,
                                         tmp_path):
    # r0 wedges at its 2nd tick; the watchdog delivers StepHung into
    # the supervisor loop, r0 is ejected, r1 finishes everything.  The
    # 1 s timeout sits far above a healthy CPU tick on a loaded machine
    # (a slower healthy tick would rightly be ejected as stalled)
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:hang:after=3:seconds=5")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], step_timeout_s=1.0,
                           rejoin_backoff_s=30.0,
                           incident_dir=str(tmp_path))
    out, makespan = rs.run(_mk(8))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 8 and s["failed"] == 0
    death = next(e for e in rs.events if e["event"] == "death")
    assert death["replica"] == 0 and "watchdog" in death["detail"]
    assert rs._watchdog is None
    assert all(oracle[r.rid] == r.tokens for r in out)


@pytest.mark.chaos
def test_rejoin_probe_backoff_then_cold_rejoin(monkeypatch, pool):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:after=1,"
                       "serve_rejoin:raise:after=2,"
                       "serve_rejoin:raise:after=1")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=0.002)
    out, makespan = rs.run(_mk(12))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 12 and s["failed"] == 0
    assert rs.counters["probes_failed"] == 2
    assert rs.counters["rejoins"] == 1
    assert rs.replicas[0].state == "live"
    pf = [e for e in rs.events if e["event"] == "probe_failed"]
    assert pf[1]["next_backoff_s"] == pytest.approx(
        2 * pf[0]["next_backoff_s"])


def _raise_once(target, name, when=lambda *a, **k: True):
    """Make ``target.name`` raise StepHung on its first call for which
    ``when(*args)`` holds — the watchdog's exception, landed there."""
    real = getattr(target, name)
    fired = []

    def wrapper(*args, **kw):
        if not fired and when(*args, **kw):
            fired.append(1)
            raise StepHung()
        return real(*args, **kw)

    setattr(target, name, wrapper)
    return fired


def test_step_hung_inside_a_prefill_fails_over_not_the_request(
        monkeypatch, pool, oracle):
    """A StepHung landing in a replica's prefill is the replica's stall:
    the scheduler's boundaries re-raise it, the replica is ejected, and
    the request caught between its queue and its slot fails over with
    the rest — nothing lost, streams unchanged."""
    fired = _raise_once(pool[0], "prefill")
    rs = tserve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=30.0)
    out, makespan = rs.run(_mk(8))
    monkeypatch.delattr(pool[0], "prefill")
    s = tserve.summarize(out, makespan)
    assert fired and s["completed"] == 8 and s["failed"] == 0
    death = next(e for e in rs.events if e["event"] == "death")
    assert death["replica"] == 0 and "watchdog" in death["detail"]
    assert all(oracle[r.rid] == r.tokens for r in out)
    assert pool[0].active_slots() == [] and \
        pool[0].cache.free_slots == SCONF["slots"]


def test_step_hung_outside_the_guarded_tick_ejects_the_replica_kicked_last(
        monkeypatch, pool, oracle):
    """Delivered asynchronously, StepHung may land after the stalled
    replica's tick returned (here: in the failover placement that
    follows the ticks): the replica kicked last is ejected."""
    rs = tserve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=30.0)
    fired = _raise_once(rs, "_place_failover")
    out, makespan = rs.run(_mk(8))
    s = tserve.summarize(out, makespan)
    assert fired and s["completed"] == 8 and s["failed"] == 0
    death = next(e for e in rs.events if e["event"] == "death")
    assert death["replica"] == 1 and "watchdog" in death["detail"]
    assert all(oracle[r.rid] == r.tokens for r in out)


def test_step_hung_in_the_response_boundary_completes_the_request(pool):
    """A StepHung between a finished request leaving its slot and its
    response: drain() completes it (every token is committed) and
    releases its slot."""
    sched = tserve.Scheduler(pool[0])
    reqs = _mk(1, max_new=2)
    sched.begin(reqs)
    _raise_once(sched, "_boundary",
                lambda req, slot, site: site == "serve_respond")
    with pytest.raises(StepHung):
        sched.tick(wait=False)
    resumable, fresh = sched.drain()
    assert resumable == [] and fresh == []
    assert reqs[0].finished and not reqs[0].failed
    assert len(reqs[0].tokens) == 2
    assert pool[0].active_slots() == []


def test_reset_cold_drops_slots_and_prefix_index(np_params):
    sess = _session(np_params, prefix_pages=-1)
    reqs = [tserve.Request(rid=i, prompt=[5, 4, 3, 2, 1, 2, 3, 4],
                           max_new=4) for i in range(2)]
    out, _ = tserve.Scheduler(sess).run(reqs)
    assert all(not r.failed for r in out)
    assert len(sess.cache._key_of) > 0
    slot = sess.try_alloc(3, 4)
    sess.prefill(slot, [1, 2, 3])
    assert sess.active_slots() == [slot]
    sess.reset_cold()
    assert sess.active_slots() == []
    assert len(sess.cache._key_of) == 0
    assert len(sess.cache._retained) == 0
    assert sess.cache.free_pages == sess.cache.num_pages
    # the executables still serve after a cold reset
    again, _ = tserve.Scheduler(sess).run(
        [tserve.Request(rid=9, prompt=[5, 4, 3, 2, 1, 2, 3, 4],
                        max_new=4)])
    assert again[0].tokens == out[0].tokens


# ---------------------------------------------------------------------------
# failover: the kill-phase matrix and its edge cases
# ---------------------------------------------------------------------------

# With max_new=6 a request commits 2 tokens on r0's tick 1 (prefill plus
# that tick's step) and one more a tick after: hit 1 = r0 tick 1 (fresh
# requeue), hit 5 = r0 tick 3 (mid-decode resume), hit 9 = r0 tick 5
# (5 of 6 committed: the resume replays the last, then decodes one)
@pytest.mark.chaos
@pytest.mark.parametrize("after,phase", [(1, "during-prefill"),
                                         (5, "mid-decode"),
                                         (9, "final-token")])
def test_kill_phase_matrix_zero_lost_bit_exact(monkeypatch, pool, oracle,
                                               after, phase):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:after=%d" % after)
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=30.0)
    out, makespan = rs.run(_mk(8))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 8 and s["failed"] == 0, (phase, s)
    assert rs.counters["deaths"] == 1
    assert all(oracle[r.rid] == r.tokens for r in out), phase
    if phase == "during-prefill":
        death = next(e for e in rs.events if e["event"] == "death")
        assert death["drained_resumable"] == 0
        assert rs.counters["failover_requests"] == 0
    else:
        assert rs.counters["failover_requests"] > 0
        assert s["resumes"] == rs.counters["failover_requests"]
    assert rs.executables_per_replica() == [len(SCONF["buckets"]) + 1] * 2


@pytest.mark.chaos
def test_kill_with_all_survivor_slots_busy(monkeypatch, pool, oracle):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:after=5")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=30.0)
    out, makespan = rs.run(_mk(12))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 12 and s["failed"] == 0 and s["shed"] == 0
    assert all(oracle[r.rid] == r.tokens for r in out)


@pytest.mark.chaos
def test_last_replica_dying_raises_typed(monkeypatch, pool):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:sticky=1")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:1], rejoin_backoff_s=30.0)
    reqs = _mk(4)
    with pytest.raises(tserve.ServeUnavailable) as ei:
        rs.run(reqs)
    assert ei.value.replicas == 1 and ei.value.outstanding == 4
    assert isinstance(ei.value, MXNetError)
    assert all(r.failed and "ServeUnavailable" in r.error for r in reqs)
    assert rs.incident_path is not None


@pytest.mark.chaos
def test_both_replicas_die_then_unavailable(monkeypatch, pool):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:after=2,"
                       "serve_replica_kill:kill:after=1")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=30.0)
    reqs = _mk(8)
    with pytest.raises(tserve.ServeUnavailable):
        rs.run(reqs)
    assert rs.counters["deaths"] == 2
    assert all(r.failed for r in reqs)


@pytest.mark.chaos
def test_mini_soak_kill_and_rejoin(monkeypatch, pool, oracle):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:after=5")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:3], rejoin_backoff_s=0.005)
    out, makespan = rs.run(_mk(12))
    s = tserve.summarize(out, makespan)
    assert s["completed"] == 12 and s["failed"] == 0
    assert rs.counters["deaths"] == 1 and rs.counters["rejoins"] == 1
    assert all(oracle[r.rid] == r.tokens for r in out)
    assert rs.executables_per_replica() == [len(SCONF["buckets"]) + 1] * 3
    for sess in pool[:3]:
        assert sess.fallback_count() == 0
        assert sess.active_slots() == []


def test_scheduler_drain_splits_resumable_from_fresh(pool):
    sched = tserve.Scheduler(pool[0])
    sched.begin(_mk(5))
    sched.tick(wait=False)
    resumable, fresh = sched.drain()
    assert [r.rid for r in resumable] == [0, 1, 2]
    assert all(len(r.tokens) == 2 for r in resumable)
    assert [r.rid for r in fresh] == [3, 4]
    assert not sched.outstanding and sched.load == 0
    assert pool[0].active_slots() == []


def test_resume_replay_divergence_is_fatal(pool):
    sched = tserve.Scheduler(pool[0])
    sched.begin(_mk(1))
    sched.tick(wait=False)
    resumable, _ = sched.drain()
    req = resumable[0]
    req.tokens[-1] = (req.tokens[-1] + 1) % CFG.vocab_size
    sched.submit(req, parked=True)
    with pytest.raises(MXNetError, match="resume replay diverged"):
        sched.tick(wait=False)


def test_scheduler_submit_mid_run(pool):
    sched = tserve.Scheduler(pool[0])
    sched.begin(_mk(2))
    sched.tick(wait=False)
    late = tserve.Request(rid=50, prompt=[9, 8, 7], max_new=4)
    sched.submit(late)
    while sched.tick(wait=False):
        pass
    assert late.done_s >= 0 and len(late.tokens) == 4


# ---------------------------------------------------------------------------
# incident artifact + diagnose tool
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_incident_artifact_rendered_by_diagnose(monkeypatch, pool,
                                                tmp_path):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:after=5")
    faults.reset()
    rs = tserve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=30.0,
                           incident_dir=str(tmp_path))
    rs.run(_mk(8))
    assert rs.incident_path is not None \
        and rs.incident_path.startswith(str(tmp_path))
    payload = json.loads(open(rs.incident_path).read())
    assert payload["kind"] == "mxnet_tpu-serve-incident"
    assert payload["counters"]["deaths"] == 1
    assert sorted(payload) == sorted(
        ["kind", "pid", "time", "replicas", "slots_per_replica",
         "deadline_ms", "step_timeout_s", "breaker_k", "counters",
         "replica_states", "timeline"])
    assert [e["event"] for e in payload["timeline"]].count("failover") \
        == payload["counters"]["failover_requests"]
    res = subprocess.run([sys.executable, TOOL, str(tmp_path)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert "SERVE INCIDENT" in res.stdout
    assert "death" in res.stdout and "failover" in res.stdout
    assert "chaos-killed" in res.stdout
