"""Replicated serving with deadline-supervised failover and load
shedding.

Counterpart of ``mxnet_tpu/serve/supervisor.py``, which holds no JAX:
the same dispatcher, shed rules, breaker, watchdog, rejoin and incident
schema over the port's sessions.  A :class:`ReplicaSet` runs N
:class:`~mxnet_tpu_torch.serve.InferenceSession` replicas — in one
process, one :class:`~mxnet_tpu_torch.serve.ServeConfig`, shared
weights; on one card each replica keeps its own KV pools and its own
CUDA graphs in its own graph pool — behind a dispatcher, and treats
replica failure and overload as the steady state:

* **Deadline-supervised liveness.** Every replica is driven at decode
  boundaries through its own :class:`~mxnet_tpu_torch.serve.Scheduler`
  in tick form; a :class:`~mxnet_tpu_torch.health.StepWatchdog`, kicked
  once per replica boundary, trips when a replica makes no progress for
  ``MXNET_SERVE_STEP_TIMEOUT_S``: the asynchronously delivered
  :class:`~mxnet_tpu_torch.base.StepHung` lands in the supervisor's
  loop and the wedged replica is marked dead.  A replica that raises
  out of its step loop or is chaos-killed (``serve_replica_kill``) dies
  the same way.  In tick form (a gateway's dispatch thread) the
  watchdog is re-armed on the first tick for the thread that ticks, so
  ``StepHung`` lands where the wedged replica runs.  Its clock runs only
  inside a replica's tick (kicked at the boundary, paused after the
  replicas' ticks), so an idle server never trips it.  A ``StepHung``
  is the replica's, never a request's: the scheduler's fault boundaries
  re-raise it, ``drain()`` recovers a request caught between a queue
  and its slot, and one delivered after the guarded tick returned
  ejects the replica the watchdog saw stall
  (:meth:`ReplicaSet.handle_step_hung`).

* **Failover is the scheduler's resume path.** A dead replica's
  in-flight requests are drained and re-admitted on survivors as
  *parked* requests: their transcript (prompt + committed tokens)
  re-prefills and the replayed token is asserted equal to the last
  committed one, so every completed response is bit-identical to a
  never-failed run.  Before the drain the dead replica's device work is
  synchronised: a ``StepHung`` can land right after a replay was
  enqueued, and nothing of the dead replica may still be writing while
  its slots are released.  Requests it had queued but not prefilled
  re-enter the dispatcher queue with their arrival seniority.

* **Overload protection.** A bounded admission queue with
  deadline-aware shedding: a request is refused with a typed
  :class:`ServeOverloaded` when the queue is full, when its deadline
  (``MXNET_SERVE_DEADLINE_MS``) lapses while it queues, or when the
  queue's projected TTFT (the observed TTFT EMA scaled by queue depth
  over live capacity) already exceeds its budget.

* **Circuit breaker + cold rejoin.** ``MXNET_SERVE_BREAKER_K``
  consecutive step faults eject a replica; an ejected replica is probed
  for rejoin under exponential backoff (``serve_rejoin`` fault site),
  and on success rejoins cold (:meth:`InferenceSession.reset_cold`:
  slots empty, prefix index dropped, graphs kept).

* **The last replica dying raises** a typed :class:`ServeUnavailable`;
  the outstanding requests are failed with the same error first.

Every run that sheds, kills or rejoins writes an incident artifact
(``serve-incident-<pid>-<ms>.json`` under ``MXNET_HEALTH_DIR``) in the
JAX package's schema; ``tools/diagnose.py`` renders it.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
import time

from ..base import MXNetError, StepHung, get_env, logger
from ..health import StepWatchdog
from ..testing import faults
from .scheduler import Scheduler, mark_cancelled
from .session import InferenceSession

__all__ = ["ReplicaSet", "ServeOverloaded", "ServeUnavailable"]


class ServeOverloaded(MXNetError):
    """A request the dispatcher refused: queue full, deadline lapsed in
    queue, or projected TTFT beyond the deadline budget.  Typed so
    callers (and the shed accounting) can tell load shedding apart from
    faults."""

    def __init__(self, msg, rid=None, reason=""):
        super().__init__(msg)
        self.rid = rid
        self.reason = reason


class ServeUnavailable(MXNetError):
    """Every replica is dead with work outstanding.  Raised instead of
    hanging; the outstanding requests are failed with this same typed
    error first, so accounting never loses them."""

    def __init__(self, msg, replicas=0, outstanding=0):
        super().__init__(msg)
        self.replicas = replicas
        self.outstanding = outstanding


class _Replica(object):
    """One replica's supervisor-side record."""

    __slots__ = ("index", "session", "scheduler", "state", "faults",
                 "deaths", "probe_at", "probe_backoff_s")

    def __init__(self, index, session, policy):
        self.index = index
        self.session = session
        self.scheduler = Scheduler(session, policy=policy)
        self.state = "live"
        self.faults = 0       # consecutive step faults (breaker input)
        self.deaths = 0
        self.probe_at = 0.0
        self.probe_backoff_s = 0.0

    @property
    def headroom(self):
        return self.session.config.slots - self.scheduler.load


class ReplicaSet(object):
    """N in-process session replicas behind a shedding dispatcher.

    Build from shared weights (``ReplicaSet(params, num_heads,
    config=..., device=...)`` builds one session per replica, each
    capturing its own graphs) or hand it pre-built identical-config
    ``sessions=[...]`` — identical configs share recompile guards, so
    the executables-per-replica count stays frozen either way.  Drive
    it exactly like a :class:`Scheduler`: ``run(requests, followup=...)``
    returns ``(requests, makespan_s)`` and the result feeds
    :func:`~mxnet_tpu_torch.serve.summarize`.
    """

    def __init__(self, params=None, num_heads=None, config=None,
                 replicas=None, sessions=None, policy="continuous",
                 deadline_ms=None, step_timeout_s=None, breaker_k=None,
                 queue_cap=None, rejoin_backoff_s=0.05,
                 rejoin_backoff_max_s=5.0, incident_dir=None,
                 device=None):
        if sessions:
            self.replicas = [_Replica(i, s, policy)
                             for i, s in enumerate(sessions)]
        else:
            n = int(replicas) if replicas is not None else \
                get_env("MXNET_SERVE_REPLICAS", 2, int)
            if n < 1:
                raise MXNetError("ReplicaSet needs >= 1 replica (got %d)"
                                 % n)
            if params is None or num_heads is None:
                raise MXNetError("ReplicaSet needs params + num_heads "
                                 "(or pre-built sessions=)")
            self.replicas = [
                _Replica(i, InferenceSession(params, num_heads,
                                             config=config, device=device),
                         policy)
                for i in range(n)]
        cfgs = {r.session.config for r in self.replicas}
        if len(cfgs) != 1:
            raise MXNetError(
                "ReplicaSet replicas must share one ServeConfig "
                "(failover re-prefill is only bit-exact across identical "
                "capacity/precision); got %d distinct configs" % len(cfgs))
        self.config = self.replicas[0].session.config
        self.deadline_ms = float(deadline_ms) if deadline_ms is not None \
            else get_env("MXNET_SERVE_DEADLINE_MS", 0.0, float)
        self.step_timeout_s = float(step_timeout_s) \
            if step_timeout_s is not None \
            else get_env("MXNET_SERVE_STEP_TIMEOUT_S", 0.0, float)
        self.breaker_k = int(breaker_k) if breaker_k is not None \
            else get_env("MXNET_SERVE_BREAKER_K", 1, int)
        if self.breaker_k < 1:
            raise MXNetError("breaker K must be >= 1 (got %d)"
                             % self.breaker_k)
        total_slots = self.config.slots * len(self.replicas)
        self.queue_cap = int(queue_cap) if queue_cap is not None \
            else 4 * total_slots
        self.rejoin_backoff_s = float(rejoin_backoff_s)
        self.rejoin_backoff_max_s = float(rejoin_backoff_max_s)
        self._incident_dir = incident_dir or get_env(
            "MXNET_HEALTH_DIR", tempfile.gettempdir(), str)
        self.events = []
        self.counters = {"deaths": 0, "failover_requests": 0, "shed": 0,
                         "shed_queue": 0, "shed_deadline": 0,
                         "cancelled": 0, "rejoins": 0, "probes_failed": 0,
                         "dispatch_faults": 0}
        self.incident_path = None
        self._watchdog = None
        self._kicked = None  # the replica whose boundary was kicked last
        self._user_followup = None
        self._ema_ttft_s = 0.0
        self._t0 = None
        self._waiting = []   # trace requests not yet past their arrival_s
        self._queue = []     # admitted, not yet assigned (arrival order)
        self._failover = []  # drained resumable requests awaiting a home
        self._all = []

    # -- introspection ----------------------------------------------------
    def live_replicas(self):
        return [r for r in self.replicas if r.state == "live"]

    def executables_per_replica(self):
        """Compiled-executable count per replica — frozen for the set's
        lifetime; the chaos soak asserts it never moves across kills,
        failovers, and rejoins."""
        return [len(r.session.executables) for r in self.replicas]

    def _now(self):
        return time.perf_counter() - self._t0

    def _event(self, event, replica=None, **detail):
        rec = {"t": round(self._now(), 4), "event": event,
               "replica": replica}
        rec.update(detail)
        self.events.append(rec)

    # -- dispatcher -------------------------------------------------------
    def _submit(self, req, now):
        """One request enters the dispatcher: cross the
        ``serve_dispatch`` fault boundary (a fault fails THAT request,
        typed), enforce the bounded queue, stamp the deadline."""
        self._all.append(req)
        try:
            faults.inject("serve_dispatch")
        except faults.WorkerKilled as exc:
            self._fail_dispatch(req, exc)
            return
        except Exception as exc:
            # a dispatch fault (typed or not) fails THAT request; the
            # dispatcher itself must keep admitting the rest of the trace
            self._fail_dispatch(req, exc)
            return
        if len(self._queue) >= self.queue_cap:
            self._shed(req, "admission queue full (cap %d)"
                       % self.queue_cap, kind="queue")
            return
        budget_ms = float(getattr(req, "deadline_ms", 0.0)
                          or self.deadline_ms)
        req._deadline_s = (req.arrival_s + budget_ms / 1000.0) \
            if budget_ms > 0 else None
        bisect.insort(self._queue,
                      ((req.arrival_s, req.rid), req))

    def _fail_dispatch(self, req, exc):
        req.failed = True
        req.error = "%s: %s" % (type(exc).__name__, exc)
        self.counters["dispatch_faults"] += 1
        self._event("dispatch_fault", rid=req.rid, detail=req.error)

    def _shed(self, req, why, kind):
        """Refuse one request typed.  ``kind`` splits the accounting:
        ``"queue"`` (the bounded admission queue overflowed — capacity)
        vs ``"deadline"`` (its TTFT budget lapsed or is projected to —
        latency), which ``summarize()`` and the incident artifact keep
        as separate counters."""
        exc = ServeOverloaded(
            "request %d shed: %s" % (req.rid, why), rid=req.rid,
            reason=why)
        req.failed = True
        req.shed = True
        req.shed_kind = kind
        req.error = "%s: %s" % (type(exc).__name__, exc)
        self.counters["shed"] += 1
        self.counters["shed_" + kind] += 1
        self._event("shed", rid=req.rid, detail=why, kind=kind)

    def _live_capacity(self):
        return sum(max(r.headroom, 0) for r in self.live_replicas()) \
            + self.config.slots * len(self.live_replicas())

    def _shed_pass(self, now):
        """Deadline-aware shedding over the queued (unassigned)
        requests: refuse what already blew its budget, and what the
        queue's *projected* TTFT says cannot make it — the observed
        TTFT EMA scaled by queue depth over live capacity.  Refusing
        early spends the slots on requests that still count."""
        if not self._queue:
            return
        slots = max(self.config.slots * len(self.live_replicas()), 1)
        keep = []
        for pos, (key, req) in enumerate(self._queue):
            deadline = getattr(req, "_deadline_s", None)
            if deadline is None:
                keep.append((key, req))
                continue
            if now >= deadline:
                self._shed(req, "deadline lapsed after %.0f ms in queue"
                           % ((now - req.arrival_s) * 1e3),
                           kind="deadline")
                continue
            projected = now + self._ema_ttft_s * (1.0 + pos / slots)
            if self._ema_ttft_s > 0.0 and projected > deadline:
                self._shed(req, "projected TTFT %.0f ms exceeds the "
                           "%.0f ms budget"
                           % ((projected - req.arrival_s) * 1e3,
                              (deadline - req.arrival_s) * 1e3),
                           kind="deadline")
                continue
            keep.append((key, req))
        self._queue = keep

    def _assign(self):
        """Hand queued requests to live replicas with slot headroom —
        least-loaded first, ties to the lowest replica id, so identical
        traffic lands identically run over run."""
        while self._queue:
            live = [r for r in self.live_replicas() if r.headroom > 0]
            if not live:
                return
            best = min(live, key=lambda r: (-r.headroom, r.index))
            _, req = self._queue.pop(0)
            best.scheduler.submit(req)

    def _place_failover(self):
        """Re-admit drained requests on survivors via the park/resume
        path — the scheduler re-prefills their transcript and asserts
        the replayed token against the last committed one, so the
        completed stream is bit-identical to a never-failed run."""
        while self._failover:
            live = self.live_replicas()
            if not live:
                return
            best = min(live, key=lambda r: (r.scheduler.load, r.index))
            req = self._failover.pop(0)
            best.scheduler.submit(req, parked=True)
            self.counters["failover_requests"] += 1
            self._event("failover", replica=best.index, rid=req.rid,
                        committed=len(req.tokens))

    # -- replica lifecycle ------------------------------------------------
    def _eject(self, rep, reason, now):
        rep.state = "dead"
        rep.deaths += 1
        rep.faults = 0
        _quiesce(rep.session)
        resumable, fresh = rep.scheduler.drain()
        self._failover.extend(resumable)
        for req in fresh:
            # queued-not-yet-prefilled work keeps arrival seniority
            bisect.insort(self._queue, ((req.arrival_s, req.rid), req))
        rep.probe_backoff_s = max(self.rejoin_backoff_s, 1e-3)
        rep.probe_at = now + rep.probe_backoff_s
        self.counters["deaths"] += 1
        self._event("death", replica=rep.index, detail=reason,
                    drained_resumable=len(resumable),
                    drained_fresh=len(fresh),
                    committed=[len(r.tokens) for r in resumable])
        logger.warning("serve replica %d marked dead (%s): drained %d "
                       "in-flight + %d queued requests for failover",
                       rep.index, reason, len(resumable), len(fresh))

    def _probe(self, rep, now):
        """One rejoin probe of an ejected replica.  A fault at
        ``serve_rejoin`` fails the probe and doubles the backoff; on
        success the replica rejoins cold (slots empty, prefix index
        dropped) and warms its cache from live traffic."""
        try:
            faults.inject("serve_rejoin")
        except (Exception, faults.WorkerKilled) as exc:
            # a failed probe never escapes: the replica just stays dead
            # and the backoff doubles
            rep.probe_backoff_s = min(rep.probe_backoff_s * 2.0,
                                      self.rejoin_backoff_max_s)
            rep.probe_at = now + rep.probe_backoff_s
            self.counters["probes_failed"] += 1
            self._event("probe_failed", replica=rep.index,
                        detail="%s: %s" % (type(exc).__name__, exc),
                        next_backoff_s=round(rep.probe_backoff_s, 4))
            return
        rep.session.reset_cold()
        rep.scheduler.begin([], followup=self._on_finish, t0=self._t0)
        rep.state = "live"
        rep.faults = 0
        self.counters["rejoins"] += 1
        self._event("rejoin", replica=rep.index)
        logger.warning("serve replica %d rejoined cold after %d "
                       "death(s)", rep.index, rep.deaths)

    def _arm_watchdog(self):
        if self.step_timeout_s <= 0:
            return
        if self._watchdog is not None:
            self._watchdog.stop()

        def _stats():
            return {"replicas": [
                {"index": r.index, "state": r.state,
                 "load": r.scheduler.load, "faults": r.faults}
                for r in self.replicas]}

        self._watchdog = StepWatchdog(
            self.step_timeout_s, stats_cb=_stats,
            dump_dir=self._incident_dir).start()
        # its clock runs only inside a replica's tick (kick ... pause)
        self._watchdog.pause()

    def _on_finish(self, req, now_s):
        """Every completion flows through here: the TTFT EMA feeds the
        projected-TTFT shed rule, and closed-loop followup requests
        re-enter through the dispatcher (bounded queue, shed rules,
        ``serve_dispatch``) instead of bypassing it."""
        if req.ttft_s >= 0.0:
            self._ema_ttft_s = req.ttft_s if self._ema_ttft_s == 0.0 \
                else 0.7 * self._ema_ttft_s + 0.3 * req.ttft_s
        if self._user_followup is not None:
            nxt = self._user_followup(req, now_s)
            if nxt is not None:
                for r in (nxt if isinstance(nxt, (list, tuple))
                          else [nxt]):
                    self._submit(r, now_s)
        return None

    # -- the supervision loop ---------------------------------------------
    def _outstanding(self, waiting):
        return bool(waiting or self._queue or self._failover
                    or any(r.scheduler.outstanding
                           for r in self.live_replicas()))

    # -- tick form (the gateway's dispatch-thread hook) --------------------
    def begin(self, requests=(), followup=None, t0=None):
        """Arm the set for tick-form driving without stepping it: reset
        counters/events, arm every replica's scheduler on one shared
        clock, start the watchdog.  ``requests`` is an optional
        ``arrival_s``-stamped trace; mid-run work enters via
        :meth:`submit`.  Pair with :meth:`tick` and :meth:`finish` —
        :meth:`run` is exactly that loop."""
        self._t0 = time.perf_counter() if t0 is None else t0
        self._user_followup = followup
        self._waiting = sorted(requests,
                               key=lambda r: (r.arrival_s, r.rid))
        self._queue = []
        self._failover = []
        self._all = []
        self.events = []
        self.counters = {k: 0 for k in self.counters}
        self.incident_path = None
        for rep in self.replicas:
            rep.scheduler.begin([], followup=self._on_finish, t0=self._t0)
        self._arm_watchdog()
        return self

    def now(self):
        return self._now()

    @property
    def outstanding(self):
        """True while unfinished requests remain anywhere."""
        return self._outstanding(self._waiting)

    def submit(self, request):
        """One request enters the dispatcher mid-run (the gateway
        path): crosses ``serve_dispatch``, the bounded queue, and the
        deadline stamp exactly like a trace arrival."""
        self._submit(request, self._now())

    def cancel(self, rid, reason="cancelled by client"):
        """Cancel one request wherever it lives — the dispatcher's
        waiting/queued/failover holdings, or a live replica's scheduler
        (which releases its slot refcount-aware at the decode
        boundary).  A late cancel of a finished or unknown request is a
        no-op; returns True when something was cancelled.  Call between
        ticks — the tick loop owns the replicas."""
        def _take(seq, get=lambda item: item):
            for i, item in enumerate(seq):
                if get(item).rid == rid and not get(item).finished:
                    del seq[i]
                    return get(item)
            return None

        req = _take(self._waiting)
        if req is not None:
            self._all.append(req)  # never reached _submit's accounting
        else:
            req = _take(self._queue, get=lambda kv: kv[1]) \
                or _take(self._failover)
        if req is not None:
            mark_cancelled(req, reason)
            self.counters["cancelled"] += 1
            self._event("cancel", rid=rid, detail=reason)
            return True
        for rep in self.replicas:
            if rep.state == "live" and rep.scheduler.cancel(rid, reason):
                self.counters["cancelled"] += 1
                self._event("cancel", replica=rep.index, rid=rid,
                            detail=reason)
                return True
        return False

    def tick(self):
        """One supervision iteration; returns True when any replica
        made decode-boundary progress.  Raises
        :class:`ServeUnavailable` when every replica is dead with work
        outstanding."""
        try:
            return self._tick()
        except StepHung:
            # delivered asynchronously, it may land just after the
            # stalled replica's guarded tick returned
            self.handle_step_hung()
            return True

    def handle_step_hung(self):
        """Eject the replica the watchdog saw stall (the one its last
        kick named when it fired, else the one kicked last) and re-arm
        the watchdog: for a :class:`StepHung` caught outside a replica's
        guarded tick (here, or in a tick-form caller such as the
        gateway's dispatch thread)."""
        wd = self._watchdog
        rep = next((r for r in self.replicas if wd is not None
                    and wd.fired_note == _kick_note(r)), self._kicked)
        if rep is not None and rep.state == "live":
            self._eject(rep, "watchdog: no decode-boundary progress for "
                        "%.1fs (MXNET_SERVE_STEP_TIMEOUT_S)"
                        % self.step_timeout_s, self._now())
        self._arm_watchdog()

    def _tick(self):
        now = self._now()
        # 1) arrivals enter the dispatcher
        while self._waiting and self._waiting[0].arrival_s <= now:
            self._submit(self._waiting.pop(0), now)
        # 2) overload protection over the queued tail
        self._shed_pass(now)
        # 3) queued work to replicas with headroom
        self._assign()
        # 4) one decode boundary per live replica
        progressed = self._tick_replicas()
        # 5) total outage is a typed failure, never a hang
        if not self.live_replicas() \
                and self._outstanding(self._waiting):
            self._raise_unavailable(self._waiting)
        # 6) drained requests re-admit on survivors
        self._place_failover()
        # 7) ejected replicas probe for rejoin (backoff-gated)
        now = self._now()
        for rep in self.replicas:
            if rep.state == "dead" and now >= rep.probe_at:
                self._probe(rep, now)
        return progressed

    def finish(self):
        """Stop the watchdog and persist the incident artifact — the
        tail of :meth:`run`, called by tick-form callers when their
        loop ends (the gateway's drain path)."""
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        self._write_incident()

    def run(self, requests, followup=None):
        """Serve ``requests`` (an ``arrival_s``-stamped trace) across
        the replica set to completion; returns ``(requests,
        makespan_s)`` with followup-generated requests included.
        Raises :class:`ServeUnavailable` if every replica dies with
        work outstanding."""
        self.begin(requests, followup=followup)
        try:
            while True:
                progressed = self.tick()
                if not self.outstanding:
                    break
                if not progressed:
                    # idle: waiting on an arrival or a rejoin probe
                    time.sleep(0.002)
        finally:
            self.finish()
        return self._all, self._now()

    def _tick_replicas(self):
        """Cross ``serve_replica_kill`` and run one scheduler tick per
        live replica.  Death modes: ``kill``/``StepHung`` eject
        immediately; a raise counts against the circuit breaker and
        ejects at K consecutive faults.  A clean tick resets the
        breaker."""
        progressed = False
        if self._watchdog is not None and \
                self._watchdog.target is not threading.current_thread():
            # tick form: StepHung must land in the thread that ticks (a
            # gateway's dispatch thread), not the one that called begin()
            self._arm_watchdog()
        for rep in self.replicas:
            if rep.state != "live":
                continue
            self._kicked = rep
            if self._watchdog is not None:
                self._watchdog.kick(_kick_note(rep))
            now = self._now()
            try:
                faults.inject("serve_replica_kill")
                if rep.scheduler.outstanding:
                    rep.scheduler.tick(wait=False)
                    progressed = True
                rep.faults = 0
            except faults.WorkerKilled as exc:
                self._eject(rep, "chaos-killed: %s" % exc, now)
            except StepHung as exc:
                # the watchdog fired into this thread mid-tick; its
                # daemon thread has exited — re-arm for the survivors
                self._eject(rep, "watchdog: no decode-boundary progress "
                            "for %.1fs (MXNET_SERVE_STEP_TIMEOUT_S)"
                            % self.step_timeout_s, now)
                self._arm_watchdog()
            except MXNetError as exc:
                rep.faults += 1
                self._event("breaker_fault", replica=rep.index,
                            detail="%s: %s" % (type(exc).__name__, exc),
                            consecutive=rep.faults)
                if rep.faults >= self.breaker_k:
                    self._eject(rep, "circuit breaker: %d consecutive "
                                "step fault(s), K=%d"
                                % (rep.faults, self.breaker_k), now)
        if self._watchdog is not None:
            self._watchdog.pause()
        return progressed

    def _raise_unavailable(self, waiting):
        outstanding = list(waiting) + [req for _, req in self._queue] \
            + list(self._failover)
        waiting.clear()
        self._queue = []
        self._failover = []
        exc = ServeUnavailable(
            "all %d replicas are dead with %d request(s) outstanding — "
            "the incident timeline is in %r (tools/diagnose.py)"
            % (len(self.replicas), len(outstanding),
               self._incident_dir),
            replicas=len(self.replicas), outstanding=len(outstanding))
        for req in outstanding:
            req.failed = True
            req.error = "%s: %s" % (type(exc).__name__, exc)
        raise exc

    # -- incident artifact ------------------------------------------------
    def incident_report(self):
        """JSON-able incident summary: counters plus the chronological
        per-replica timeline."""
        return {
            "kind": "mxnet_tpu-serve-incident",
            "pid": os.getpid(),
            "time": time.time(),
            "replicas": len(self.replicas),
            "slots_per_replica": self.config.slots,
            "deadline_ms": self.deadline_ms,
            "step_timeout_s": self.step_timeout_s,
            "breaker_k": self.breaker_k,
            "counters": dict(self.counters),
            "replica_states": [
                {"index": r.index, "state": r.state, "deaths": r.deaths}
                for r in self.replicas],
            "timeline": list(self.events),
        }

    def _write_incident(self):
        """Persist the timeline when anything noteworthy happened —
        a clean run writes nothing."""
        if not self.events:
            return
        payload = self.incident_report()
        try:
            os.makedirs(self._incident_dir, exist_ok=True)
            path = os.path.join(
                self._incident_dir, "serve-incident-%d-%d.json"
                % (os.getpid(), int(time.time() * 1e3)))
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
            self.incident_path = path
        except OSError as e:  # diagnostics must never mask the run
            logger.warning("serve incident artifact write failed: %s", e)


def _quiesce(session):
    """Wait for a session's queued device work: a dead replica's last
    replay must have finished before its slots are released."""
    device = getattr(session, "device", None)
    if device is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _kick_note(rep):
    return "serve replica %d decode boundary" % rep.index
