"""Request queue + batching policies over an :class:`InferenceSession`.

Counterpart of ``mxnet_tpu/serve/scheduler.py``, which holds no JAX: the
same policies, fault boundaries, preemption and tick form over the
port's session.  A boundary is one decode step, or on a speculative
session (``spec_k > 0``) one verify step that commits 1..K+1 tokens a
request.

Three policies, all running the *same* compiled executables so the
bench comparison isolates scheduling:

* ``serial`` — one request at a time, admitted only when the previous
  one finished.  The baseline every serving system is measured against.
* ``static`` — classic static batching: admit up to ``slots`` requests
  only when the batch is empty, run them to completion together.  Head
  of-line blocking both ways (late arrivals wait for the batch to
  drain; the batch waits for its slowest member).
* ``continuous`` — in-flight batching: at *every* decode-step boundary,
  finished requests are evicted and newly-arrived ones are prefilled
  into freed slots, so the decode executable runs as full as the
  arrival process allows.

Requests replay an open-loop arrival trace (``arrival_s`` offsets from
run start) — the scheduler never back-pressures arrivals, so queueing
delay shows up in TTFT exactly as a production load balancer would see
it.

Preemption and resume (oversubscribed sessions,
``session.config.oversub``): before every step the scheduler probes the
session's page shortfall for the coming boundary; when shortfall plus
the configured watermark exceeds the pool's reclaimable pages it
preempts the *coldest* active request — least queue seniority, i.e.
latest arrival (ties: highest rid) — releasing its pages (refcount-
aware, so shared prefix pages survive for their other holders) and
parking it.  Parked requests resume with top priority: their transcript
(prompt + committed tokens) re-prefills through the chunked offset
prefill, and because prefill is deterministic and decode M-invariant
exact, the recomputed stream is bit-identical to a never-evicted one —
the resume asserts it by checking the replayed token against the last
committed one.  Oversubscription changes capacity, never content.

Hybrid stacks (windowed/SSM layers) ride the same resume path with no
extra bookkeeping: eviction releases only pages (a slot's window rings
and SSM state stay physically allocated but become garbage), and the
re-prefill deterministically reconstructs both — ring rows are a pure
function of the replayed tokens and their positions, and the SSM
recurrence replays from its zero alloc state through the identical
chunked scan — so the bit-exact divergence assert above pins ring and
state reconstruction exactly as it pins page contents.

SLO-aware admission (``session.config.ttft_slo_ms`` > 0): arrivals are
admitted can-still-meet-the-TTFT-budget first (FIFO within each class),
so a burst spends its slots on requests that still count toward
goodput; :func:`summarize` reports ``goodput_rps`` and
``slo_attainment`` when given the budget.

Closed-loop driving: ``run(requests, followup=...)`` calls ``followup(
finished_request, now_s)`` at every completion; returned requests join
the arrival queue — that is how the bench holds concurrency constant
instead of replaying a fixed open-loop trace.

Tick form (the replica supervisor's hook, ``serve/supervisor.py``):
``run()`` is ``begin(requests)`` followed by ``tick()`` until no work
remains — one ``tick()`` is exactly one decode-boundary iteration
(resume parked, admit arrivals, step every active slot once).  A
the JAX package's ``ReplicaSet`` drives N schedulers
tick-by-tick from one thread, all sharing the supervisor's ``t0`` so
arrival offsets stay comparable, and on replica death calls
:meth:`drain` to pull the unfinished requests out for re-admission on
a survivor — requests with committed tokens re-enter a survivor's
parked list and replay through the same resume path preemption uses.

Fault sites (``testing/faults.py``): every admit / decode-step /
response boundary crosses ``serve_queue`` plus a phase-specific site
(``serve_admit`` / ``serve_decode``, ``serve_verify`` on a speculative
session / ``serve_respond``), and the
preemption machinery adds ``serve_evict`` (before a victim's pages are
released) and
``serve_resume`` (before a parked request re-prefills).  A fault fails
*that request only*: its slot is released and surviving slots keep
decoding — the chaos tests assert exactly this isolation, including
that a faulted eviction/resume leaves shared prefix pages and the
survivors' streams intact.
"""
from __future__ import annotations

import dataclasses
import time

from ..base import MXNetError, StepHung
from ..testing import faults

__all__ = ["Request", "Scheduler", "ServeCancelled", "summarize"]

_POLICIES = ("serial", "static", "continuous")

_FRESH_STATS = {"preemptions": 0, "resumes": 0, "peak_active": 0,
                "faulted": 0, "cancelled": 0}


class ServeCancelled(MXNetError):
    """A request cancelled before completion — client disconnect,
    per-request deadline, or a gateway drain force-cancel.  Typed so
    accounting can tell deliberate cancellation apart from faults and
    load sheds: a cancelled request is neither lost nor shed."""

    def __init__(self, msg, rid=None, reason=""):
        super().__init__(msg)
        self.rid = rid
        self.reason = reason


def mark_cancelled(req, reason):
    """Stamp one request as typed-cancelled (shared by
    :meth:`Scheduler.cancel`, the replica dispatcher, and the gateway's
    drain force-cancel, so the error string is uniform)."""
    exc = ServeCancelled("request %d cancelled: %s" % (req.rid, reason),
                         rid=req.rid, reason=reason)
    req.failed = True
    req.cancelled = True
    req.error = "%s: %s" % (type(exc).__name__, exc)


@dataclasses.dataclass
class Request:
    """One generation request plus its measured lifecycle."""

    rid: int
    prompt: list
    max_new: int
    arrival_s: float = 0.0
    eos_id: int = -1  # -1: never stops early
    # -- filled in by the scheduler --
    tokens: list = dataclasses.field(default_factory=list)
    ttft_s: float = -1.0
    done_s: float = -1.0
    failed: bool = False
    error: str = ""
    preemptions: int = 0  # times this request was evicted and parked
    resumes: int = 0      # times its transcript re-prefilled (park or
    #                       failover — both cross the same resume path)
    shed: bool = False    # refused by overload protection (typed error)
    shed_kind: str = ""   # "queue" | "deadline" when shed is set
    cancelled: bool = False  # typed-cancelled (disconnect / deadline /
    #                          drain) — deliberate, not a fault

    @property
    def finished(self):
        return self.failed or self.done_s >= 0.0


class Scheduler(object):
    """Drives a session through an arrival trace under one policy."""

    def __init__(self, session, policy="continuous"):
        if policy not in _POLICIES:
            raise MXNetError("unknown policy %r (one of %s)"
                             % (policy, ", ".join(_POLICIES)))
        self.session = session
        self.policy = policy
        self.stats = dict(_FRESH_STATS)
        self._followup = None
        self._pending = []
        self._queue = []
        self._parked = []
        self._active = {}
        # (request, slot) while a request is out of every queue but not
        # yet in a slot (its prefill) or leaving one (its response): a
        # StepHung landing there must not lose it (drain() returns it)
        self._transit = None
        self._t0 = None

    # -- fault boundaries -------------------------------------------------
    def _boundary(self, req, slot, site):
        """Cross a fault boundary for one request; a fault fails the
        request (releasing its slot if held) and the run continues."""
        try:
            faults.inject("serve_queue")
            faults.inject(site)
            return True
        except StepHung:
            raise  # the replica is stalled, not this request
        except faults.WorkerKilled as exc:
            self._fail(req, slot, exc)
            return False
        except Exception as exc:  # FaultInjected / MXNetError
            self._fail(req, slot, exc)
            return False

    def _prefill(self, req, slot, seq):
        """Run one request's prefill with the same isolation as a
        boundary crossing: a session-raised fault (e.g. the ``kv_quant``
        chaos site, which fires before any of the request's quantized
        pages/scales are written) fails THAT request, releases its slot,
        and the run continues.  Returns the first token, or None when
        the request failed."""
        try:
            first, _ = self.session.prefill(slot, seq)
            return first
        except StepHung:
            raise  # the replica is stalled, not this request
        except faults.WorkerKilled as exc:
            self._fail(req, slot, exc)
            return None
        except MXNetError as exc:
            self._fail(req, slot, exc)
            return None

    def _fail(self, req, slot, exc):
        req.failed = True
        req.error = "%s: %s" % (type(exc).__name__, exc)
        self.stats["faulted"] += 1
        if slot is not None:
            try:
                self.session.release(slot)
            except MXNetError:
                pass

    # -- tick-form state machine ------------------------------------------
    def begin(self, requests, followup=None, t0=None):
        """Arm the scheduler for a run without stepping it: sort the
        trace, reset the stats, record the clock origin.  ``t0`` (a
        ``time.perf_counter()`` value) lets a supervisor share one clock
        across many schedulers so ``arrival_s`` offsets line up."""
        self._queue = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        self._pending = list(self._queue)
        self._parked = []  # preempted requests, in eviction order
        self._active = {}  # slot -> Request
        self.stats = dict(_FRESH_STATS)
        self._followup = followup
        self._t0 = time.perf_counter() if t0 is None else t0
        return self

    def now(self):
        return time.perf_counter() - self._t0

    @property
    def outstanding(self):
        """True while unfinished requests remain anywhere (pending,
        parked, or active)."""
        return bool(self._pending or self._parked or self._active)

    @property
    def load(self):
        """Requests this scheduler currently owns (pending + parked +
        active) — the supervisor's least-loaded dispatch key."""
        return len(self._pending) + len(self._parked) + len(self._active)

    def submit(self, request, parked=False):
        """Enqueue one request mid-run.  ``parked=True`` re-admits a
        request that already holds committed tokens (replica failover)
        through the resume path: its transcript re-prefills and the
        replayed token is asserted against the last committed one."""
        self._queue.append(request)
        if parked:
            self._parked.append(request)
        else:
            self._pending.append(request)

    def drain(self):
        """Pull every unfinished request out (replica death): returns
        ``(resumable, fresh)`` — requests with committed tokens, and
        requests not yet prefilled.  Active slots are released
        best-effort (in-process the host-side bookkeeping is still
        reachable; a real dead replica's memory is gone with it).  A
        request a :class:`~mxnet_tpu_torch.base.StepHung` caught between
        a queue and its slot is returned too (its slot released), or
        completed when every token of it was already committed: the
        boundaries re-raise StepHung rather than fail the request, since
        the stall is the replica's."""
        resumable, fresh = [], []
        if self._transit is not None:
            req, slot = self._transit
            self._transit = None
            if slot is not None and slot not in self._active:
                try:
                    self.session.release(slot)
                except MXNetError:
                    pass
            if not req.finished:
                if len(req.tokens) >= req.max_new or (
                        req.tokens and req.tokens[-1] == req.eos_id):
                    req.done_s = self.now()  # every token committed
                else:
                    (resumable if req.tokens else fresh).append(req)
        for slot in sorted(self._active):
            req = self._active[slot]
            try:
                self.session.release(slot)
            except MXNetError:
                pass
            (resumable if req.tokens else fresh).append(req)
        resumable.extend(self._parked)
        fresh.extend(self._pending)
        self._active = {}
        self._parked = []
        self._pending = []
        return resumable, fresh

    def cancel(self, rid, reason="cancelled by client"):
        """Cancel one request at the current decode boundary: drop it
        from wherever it lives (pending / parked / active) and mark it
        with a typed :class:`ServeCancelled`.  An active request's slot
        is released refcount-aware — shared prefix pages survive for
        their other holders — so pool occupancy returns to its
        pre-request baseline.  Cancelling an unknown or already-finished
        request is a no-op (a response that already completed stays
        completed); returns True when something was actually cancelled.

        Call between ticks: the tick loop owns the session, so the
        caller (the gateway's dispatch thread, or any single-threaded
        loop) must not race a tick in flight."""
        for bucket in (self._pending, self._parked):
            for req in bucket:
                if req.rid == rid and not req.finished:
                    bucket.remove(req)
                    mark_cancelled(req, reason)
                    self.stats["cancelled"] += 1
                    return True
        for slot in sorted(self._active):
            req = self._active[slot]
            if req.rid != rid:
                continue
            if req.finished:  # finish already accounted the slot
                return False
            del self._active[slot]
            try:
                self.session.release(slot)  # refcount-aware
            except MXNetError:
                pass
            mark_cancelled(req, reason)
            self.stats["cancelled"] += 1
            return True
        return False

    # -- the run loop -----------------------------------------------------
    def run(self, requests, followup=None):
        """Replay ``requests`` (sorted by ``arrival_s``) to completion;
        returns ``(requests, makespan_s)``.  ``followup(request,
        now_s)``, when given, is called as each request finishes and may
        return a new :class:`Request` (or list of them) to enqueue —
        the closed-loop driving hook; generated requests are included
        in the returned list."""
        self.begin(requests, followup=followup)
        while self.tick():
            pass
        return self._queue, self.now()

    def tick(self, wait=True):
        """One decode-boundary iteration: resume parked requests, admit
        arrivals, cross every fault boundary, preempt on the watermark,
        and run one fixed-shape step.  Returns :attr:`outstanding`.
        ``wait=False`` skips the idle open-loop sleep (a supervisor
        interleaving many schedulers owns the clock)."""
        sess = self.session
        pending, parked, active = self._pending, self._parked, self._active
        now = self.now
        if not self.outstanding:
            return False

        slo_s = float(getattr(sess.config, "ttft_slo_ms", 0.0)) / 1000.0
        oversub = bool(getattr(sess.config, "oversub", False))

        # 0) resume parked requests first — they hold queue
        # seniority over fresh arrivals, and their transcript pages
        # often still sit in the prefix cache
        for req in list(parked):
            if not self._boundary(req, None, "serve_resume"):
                parked.remove(req)
                continue
            seq = list(req.prompt) + req.tokens[:-1]
            budget = req.max_new - len(req.tokens) + 1
            slot = sess.try_alloc(len(seq), budget, tokens=seq,
                                  resume=True)
            if slot is None:
                if not active and not pending:
                    raise MXNetError(
                        "parked request %d cannot resume into an "
                        "idle session — pool smaller than one "
                        "request's worst case" % req.rid)
                break
            parked.remove(req)
            self._transit = (req, slot)
            first = self._prefill(req, slot, seq)
            self._transit = None
            if first is None:
                continue
            if first != req.tokens[-1]:
                raise MXNetError(
                    "resume replay diverged for request %d: "
                    "re-prefill produced token %d, committed stream "
                    "holds %d — determinism bug"
                    % (req.rid, first, req.tokens[-1]))
            active[slot] = req
            req.resumes += 1
            self.stats["resumes"] += 1

        # 1) admit whatever the policy allows right now
        arrived = [r for r in pending if r.arrival_s <= now()]
        if slo_s > 0:
            # requests that can still meet the TTFT budget first
            # (FIFO within each class): a burst spends its slots on
            # goodput, not on arrivals that already blew the budget
            t = now()
            arrived.sort(key=lambda r: ((t - r.arrival_s) > slo_s,
                                        r.arrival_s, r.rid))
        if self.policy == "serial":
            admit_cap = 1 if not active else 0
        elif self.policy == "static":
            admit_cap = sess.config.slots if not active else 0
        else:
            admit_cap = sess.config.slots - len(active)
        for req in arrived[:max(admit_cap, 0)]:
            if not self._boundary(req, None, "serve_admit"):
                pending.remove(req)
                continue
            slot = sess.try_alloc(len(req.prompt), req.max_new,
                                  tokens=req.prompt)
            if slot is None:
                break  # pool full: stays queued for a later boundary
            pending.remove(req)
            self._transit = (req, slot)
            first = self._prefill(req, slot, req.prompt)
            self._transit = None
            if first is None:
                continue
            req.ttft_s = now() - req.arrival_s
            req.tokens.append(first)
            active[slot] = req
            if len(req.tokens) >= req.max_new or first == req.eos_id:
                self._finish(req, slot, active, now)
        self.stats["peak_active"] = max(self.stats["peak_active"],
                                        len(active))

        if not active:
            if wait and pending and not parked:
                # idle until the next arrival (open-loop replay)
                idle = min(r.arrival_s for r in pending) - now()
                if idle > 0:
                    time.sleep(min(idle, 0.05))
            return self.outstanding

        # 2) per-request step boundaries (deterministic slot order)
        spec = getattr(sess.config, "spec_k", 0) > 0
        site = "serve_verify" if spec else "serve_decode"
        for slot in sorted(active):
            req = active[slot]
            if not self._boundary(req, slot, site):
                del active[slot]

        if not active:
            return self.outstanding

        # 2b) watermark preemption: if the coming step's page
        # growth would drain the pool below the watermark, evict
        # the coldest request(s) — latest arrival, ties highest rid
        # — park them, and let the survivors step.  The last active
        # request is never evicted (it can always finish: one
        # request's worst case fits the pool by construction).
        if oversub:
            rows = sess.config.spec_window if spec else 1
            wm = max(int(getattr(sess.config, "watermark", 0)), 0)
            while (len(active) > 1
                   and sess.pages_short(rows) + wm
                   > sess.cache.reclaimable_pages):
                victim_slot = max(
                    active, key=lambda s: (active[s].arrival_s,
                                           active[s].rid))
                victim = active.pop(victim_slot)
                if not self._boundary(victim, victim_slot,
                                      "serve_evict"):
                    continue  # fault: failed + slot released
                sess.release(victim_slot)  # shared pages survive
                victim.preemptions += 1
                parked.append(victim)
                self.stats["preemptions"] += 1

        if not active:
            return self.outstanding

        # 3) one fixed-shape step advances every survivor — by one
        # token (decode) or by 1..K+1 committed tokens (verify)
        if spec:
            limits = {slot: active[slot].max_new
                      - len(active[slot].tokens) for slot in active}
            committed = sess.spec_step(limits=limits)
            for slot in sorted(active):
                req = active[slot]
                for tok in committed[slot]:
                    req.tokens.append(tok)
                    if (len(req.tokens) >= req.max_new
                            or tok == req.eos_id):
                        # EOS inside the speculated window: the
                        # committed tail past it is dropped, exactly
                        # where non-speculative decode would stop
                        self._finish(req, slot, active, now)
                        break
        else:
            step_tokens, _ = sess.step()
            for slot in sorted(active):
                req = active[slot]
                req.tokens.append(step_tokens[slot])
                if (len(req.tokens) >= req.max_new
                        or step_tokens[slot] == req.eos_id):
                    self._finish(req, slot, active, now)

        return self.outstanding

    def _finish(self, req, slot, active, now):
        self._transit = (req, slot)
        active.pop(slot, None)
        if self._boundary(req, slot, "serve_respond"):
            req.done_s = now()
            self.session.release(slot)
        self._transit = None
        if self._followup is not None:
            nxt = self._followup(req, now())
            if nxt is not None:
                for r in (nxt if isinstance(nxt, (list, tuple)) else [nxt]):
                    self._pending.append(r)
                    self._queue.append(r)


def _percentile(values, pct):
    vals = sorted(values)
    if not vals:
        return 0.0
    idx = min(int(round((pct / 100.0) * (len(vals) - 1))), len(vals) - 1)
    return float(vals[idx])


def summarize(requests, makespan_s, ttft_slo_ms=0.0):
    """Latency/throughput rollup the bench emits per policy.  With a
    TTFT budget (``ttft_slo_ms`` > 0) it additionally reports
    ``goodput_rps`` — completed requests that met the budget, per
    second — and ``slo_attainment``, the met-budget fraction of
    completions (the closed-loop bench's primary metric).

    Robustness counters always ride along so chaos A/Bs can assert on
    them: ``preemptions``/``resumes`` (watermark evictions and
    transcript replays, failover resumes included), ``shed`` (requests
    the dispatcher refused with a typed ``ServeOverloaded``) split into
    ``shed_queue`` (bounded admission queue overflowed) and
    ``shed_deadline`` (lapsed or projected-TTFT budget), ``cancelled``
    (typed :class:`ServeCancelled` — client disconnects and drain
    force-cancels, deliberate by definition), and ``faulted`` —
    failures that were NEITHER sheds nor cancels, i.e. a fault or
    crash ate the request.  ``failed`` stays the historical total
    (faulted + shed + cancelled), so existing ``failed == 0``
    assertions keep their meaning."""
    done = [r for r in requests if r.done_s >= 0.0 and not r.failed]
    failed = [r for r in requests if r.failed]
    shed = [r for r in failed if getattr(r, "shed", False)]
    cancelled = [r for r in failed if getattr(r, "cancelled", False)
                 and not getattr(r, "shed", False)]
    ttfts = [r.ttft_s for r in done if r.ttft_s >= 0.0]
    per_token = []
    total_tokens = 0
    for r in done:
        total_tokens += len(r.tokens)
        if len(r.tokens) > 1 and r.ttft_s >= 0.0:
            decode_span = (r.done_s - r.arrival_s) - r.ttft_s
            per_token.append(decode_span / (len(r.tokens) - 1))
    out = {
        "completed": len(done),
        "failed": len(failed),
        "shed": len(shed),
        "shed_queue": sum(1 for r in shed
                          if getattr(r, "shed_kind", "") == "queue"),
        "shed_deadline": sum(1 for r in shed
                             if getattr(r, "shed_kind", "") == "deadline"),
        "cancelled": len(cancelled),
        "faulted": len(failed) - len(shed) - len(cancelled),
        "preemptions": sum(r.preemptions for r in requests),
        "resumes": sum(getattr(r, "resumes", 0) for r in requests),
        "total_tokens": total_tokens,
        "makespan_s": float(makespan_s),
        "tokens_per_sec": (total_tokens / makespan_s) if makespan_s > 0
        else 0.0,
        "ttft_p50_s": _percentile(ttfts, 50),
        "ttft_p99_s": _percentile(ttfts, 99),
        "per_token_p50_s": _percentile(per_token, 50),
        "per_token_p99_s": _percentile(per_token, 99),
    }
    if ttft_slo_ms > 0:
        slo_s = float(ttft_slo_ms) / 1000.0
        good = sum(1 for r in done if 0.0 <= r.ttft_s <= slo_s)
        out["ttft_slo_ms"] = float(ttft_slo_ms)
        out["goodput_rps"] = (good / makespan_s) if makespan_s > 0 else 0.0
        out["slo_attainment"] = (good / float(len(done))) if done else 0.0
    return out
