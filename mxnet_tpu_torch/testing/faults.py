"""Deterministic fault injection, driven by ``MXNET_FAULT_INJECT``.

Production code calls :func:`inject` at a named *site*; the env var
decides whether anything happens there, so the hooks are free when the
variable is unset.  Grammar (entries separated by ``,`` or ``;``, fields
by ``:``)::

    MXNET_FAULT_INJECT = "<site>:<action>[:key=value]*[,...]"

Actions:

* ``raise`` — raise :class:`FaultInjected` (an ``MXNetError``) at the
  site.  In a prefetch worker this models a crashing decode thread whose
  error must surface at the consumer's next ``next()``.
* ``kill``  — raise :class:`WorkerKilled`.  Worker loops catch it
  *explicitly* and return without enqueueing anything, modeling a thread
  that dies silently (OOM-killed, segfaulted C extension); the consumer
  must detect the dead worker instead of blocking on the queue forever.
  ``WorkerKilled`` deliberately subclasses ``BaseException`` so generic
  ``except Exception`` error-forwarding paths cannot swallow it into the
  "clean error" channel.
* ``delay`` — sleep ``seconds`` at the site, modeling a wedged peer or a
  slow network; used to trip the ``MXNET_KV_TIMEOUT_S`` watchdogs.
* ``hang`` — sleep ``seconds`` in short slices, modeling a wedged step;
  used to trip the ``MXNET_STEP_TIMEOUT_S`` step watchdog.  The sliced
  sleep gives the watchdog's asynchronously-raised
  ``StepHung`` a bytecode boundary to land on, so
  the "hung" thread dies the way a wedged-but-interruptible one would.
* ``nan`` / ``inf`` — *value* injection: :func:`inject` RETURNS
  ``float('nan')`` / ``float('inf')`` instead of raising, and the site
  folds it into its data (``Module`` poisons one element of the batch at
  site ``numerics``, which flows through forward/backward into the loss
  and every gradient).  Callers that ignore the return value are
  unaffected.
* ``bitflip`` / ``truncate`` — *file* corruption: the site passes the
  just-written file via ``inject(site, path=...)`` and the action XORs
  one bit in the middle byte / truncates the file to half its length.
  Models silent disk corruption after a successful write — exactly what
  the checkpoint verifier's SHA-256 pass must catch.  Only valid at
  sites that supply a path (today: ``checkpoint_corrupt``).

Keys:

* ``after=N``  — fire on the Nth hit of the site (default 1).  Hits are
  counted per spec entry, so ``prefetch:raise:after=3`` lets exactly two
  batches through first — deterministic by construction.
* ``seconds=S`` — sleep length for ``delay`` (default 1.0).
* ``sticky=1`` — keep firing on every hit >= ``after`` instead of once.
* ``prob=P``   — probabilistic trigger: every hit >= ``after`` fires
  independently with probability ``P`` from a *seeded per-spec RNG
  stream* (sha256 of site/action/``seed``), so soak tests can inject
  sustained random faults that replay identically run over run.
  :func:`reset` re-seeds the stream, so re-arming the same spec string
  replays the same fire pattern.  ``seed=N`` (default 0) picks a
  different deterministic stream.

Sites instrumented today: ``device_prefetch`` / ``prefetch`` (the io.py
worker loops), ``checkpoint_io`` (between temp-file write and the atomic
rename), ``shard_write`` (inside the v2 shard writer, bytes down but the
shard not yet published — kill/raise/delay here model a host dying
mid-checkpoint), ``checkpoint_corrupt`` (after a shard is published,
with ``path=`` — ``bitflip``/``truncate`` here model post-write disk
rot), ``collective`` (kvstore DCN barrier / cross-replica sum),
``numerics`` (Module's fused step — poison one batch element with the
returned nan/inf), ``step`` (top of every fit batch — ``hang`` here
trips the step watchdog), ``zero_update`` (around the ZeRO-sharded
fused dispatch — the gradient reduce-scatter going in and the
parameter all-gather coming out; arming it also bounds the dispatch,
so ``delay`` past ``MXNET_KV_TIMEOUT_S`` surfaces the collective
timeout with the kvstore's peer report attached even single-process),
``zero_gather`` (same contract for the ZeRO-3 step: around the
bucketed parameter all-gathers — the per-bucket forward gathers and
the backward re-gathers all run inside the one bounded dispatch, so a
``delay`` past ``MXNET_KV_TIMEOUT_S`` reports the gather as the stuck
collective by name), ``serve_queue`` (the serving scheduler —
crossed at *every* request boundary) plus its phase-specific companions
``serve_admit`` / ``serve_decode`` / ``serve_verify`` /
``serve_respond`` (admission, per-request decode-step, per-request
speculative propose/verify-step, and response boundaries; a fault fails
that one request and releases its slot — surviving slots keep decoding,
the isolation the serve chaos tests assert), and the oversubscription
machinery's ``serve_evict`` (watermark preemption, before the victim's
pages are released — a fault fails the victim alone; its release is
refcount-aware, so shared prefix pages stay intact for other holders)
and ``serve_resume`` (parked-request resume, before the re-prefill — a
fault fails the parked request alone and survivors keep decoding).
The serve sites fire in deterministic slot order each step, so
``after=N`` picks a specific request.  The replica supervisor
(``serve/supervisor.py``) adds three coarser sites: ``serve_replica_kill``
fires at the top of every replica's decode-boundary tick — ``kill``
hard-kills that replica (drain + failover), ``raise`` counts against its
circuit breaker, ``hang`` wedges it until the per-replica step watchdog
trips — ``serve_dispatch`` fires per request at dispatcher admission (a
fault fails that one request, typed), and ``serve_rejoin`` fires at each
ejected replica's rejoin probe (a fault fails the probe and doubles its
backoff).  ``data_decode`` fires inside each data-service decode task
(in the worker *process* with ``num_workers > 0`` — hits are counted
per process — or inline on the consumer thread with 0): ``raise``
surfaces as a typed error at the consumer's ``next()``, ``kill``
hard-exits the worker so the consumer-side dead-worker detection must
fire instead of hanging the ring, ``delay`` models slow decode.
``data_service`` fires at the consumer's ``next()`` itself.  The four
``elastic_*`` sites cross the live-migration phases in order
(``elastic_quiesce`` / ``elastic_rendezvous`` / ``elastic_reshard`` /
``elastic_resume``, see ``parallel/elastic.py``): a ``raise`` at any of
them must leave the job falling back to the last good checkpoint, a
``kill`` must leave it resumable — the chaos matrix in
``tests/test_elastic.py`` asserts exactly that at every phase.  The
network gateway (``serve/gateway.py``) adds four sites at its failure
boundaries: ``gateway_read`` (after a connection's bytes are read,
before parsing — a fault fails that connection typed, isolated from
every other stream), ``gateway_write`` (before each streamed chunk —
a fault is treated as the client vanishing, so the request is
cancelled and its state freed), ``gateway_cancel`` (cancel
propagation — a fault fails the cancel alone and the request decodes
to completion, whose normal finish still frees the slot), and
``gateway_drain`` (drain start — a fault collapses the grace window,
force-cancelling in-flight streams typed immediately).

The parsed spec auto-refreshes when the env var string changes; call
:func:`reset` to re-arm counters when reusing the same string (tests).
"""
from __future__ import annotations

import os
import threading
import time

from ..base import MXNetError

__all__ = ["FaultInjected", "WorkerKilled", "inject", "reset", "active",
           "rearm_after_fork", "SITES", "sites"]

ENV_VAR = "MXNET_FAULT_INJECT"

_ACTIONS = ("raise", "kill", "delay", "hang", "nan", "inf",
            "bitflip", "truncate")

# The fault-site catalog.  Every *production* ``inject(site)`` literal
# must name an entry here, and every entry must be exercised by at
# least one test — mxlint MX005 enforces both statically (tests may
# still inject ad-hoc sites when testing this module itself).  The
# prose above stays the narrative; this dict is the contract.
SITES = {
    "prefetch": "io.py PrefetchingIter worker loop",
    "device_prefetch": "io.py DevicePrefetchIter staging worker loop",
    "checkpoint_io": "between checkpoint temp-file write and the "
                     "atomic rename",
    "shard_write": "inside the v2 shard writer, before publish",
    "checkpoint_corrupt": "after a shard publishes (path= for "
                          "bitflip/truncate disk rot)",
    "collective": "kvstore DCN barrier / cross-replica sum",
    "numerics": "Module fused step — poison one batch element",
    "step": "top of every fit batch (hang trips the step watchdog)",
    "zero_update": "around the ZeRO-sharded fused dispatch",
    "zero_gather": "around the ZeRO-3 bucketed parameter all-gathers",
    "serve_queue": "serving scheduler, every request boundary",
    "serve_admit": "serving scheduler admission boundary",
    "serve_decode": "serving scheduler per-request decode step",
    "serve_verify": "serving scheduler per-request speculative "
                    "propose/verify step",
    "serve_respond": "serving scheduler response boundary",
    "serve_evict": "serving scheduler watermark preemption, before the "
                   "victim's pages are released",
    "serve_resume": "serving scheduler parked-request resume, before "
                    "the re-prefill",
    "serve_replica_kill": "replica supervisor, top of every replica's "
                          "decode-boundary tick (kill = replica death, "
                          "raise = breaker fault, hang = watchdog trip)",
    "serve_dispatch": "replica supervisor dispatcher, per-request "
                      "admission into the bounded queue",
    "serve_rejoin": "replica supervisor rejoin probe of an ejected "
                    "replica (a fault fails the probe, doubling its "
                    "backoff)",
    "kv_quant": "quantized-KV prefill, before the request's pages/"
                "scales are written",
    "kv_window": "hybrid-stack prefill, before any windowed-layer ring "
                 "row or SSM state update is written",
    "data_decode": "inside each data-service decode task (worker "
                   "process, or inline with num_workers=0)",
    "data_service": "data-service consumer next()",
    "elastic_quiesce": "elastic migration quiesce phase, after the "
                       "last-good checkpoint and before the in-memory "
                       "state capture",
    "elastic_rendezvous": "elastic migration re-form phase, before the "
                          "bounded peer-heartbeat wait",
    "elastic_reshard": "elastic migration reshard phase, before the "
                       "captured windows move onto the new plan's "
                       "layout",
    "elastic_resume": "elastic migration resume phase, before the data "
                      "service seeks back to the quiesce boundary",
    "gateway_read": "serve gateway, after a connection's request bytes "
                    "are read and before parsing (a fault fails that "
                    "connection typed; kill drops it abruptly)",
    "gateway_write": "serve gateway, before each streamed chunk is "
                     "written (a fault is treated as the client "
                     "vanishing: the request is cancelled, state freed)",
    "gateway_cancel": "serve gateway cancel propagation, before the "
                      "backend releases the request's slot (a fault "
                      "fails the cancel alone; the request decodes to "
                      "completion, which still frees its state)",
    "gateway_drain": "serve gateway drain start (a fault collapses the "
                     "grace window: in-flight streams are force-"
                     "cancelled typed immediately)",
}


def sites():
    """The registered site catalog (name -> where it fires)."""
    return dict(SITES)


class FaultInjected(MXNetError):
    """The error an injected ``raise`` fault throws (an ``MXNetError`` so
    production error paths treat it exactly like an organic failure)."""


class WorkerKilled(BaseException):
    """Injected silent-death signal for worker threads.  BaseException on
    purpose: it must bypass ``except Exception`` error-forwarding so the
    worker dies without leaving a breadcrumb, like a real hard kill."""


_lock = threading.RLock()
_env_snapshot = None   # env string the current specs were parsed from
_specs = []            # list of spec dicts
_hits = []             # per-spec hit counters, parallel to _specs


def _parse(raw):
    specs = []
    for entry in raw.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        fields = entry.split(":")
        if len(fields) < 2 or not fields[0] or fields[1] not in _ACTIONS:
            raise MXNetError(
                "bad %s entry %r: want <site>:<action>[:key=value]* with "
                "action one of %s" % (ENV_VAR, entry, ", ".join(_ACTIONS)))
        spec = {"site": fields[0], "action": fields[1], "after": 1,
                "seconds": 1.0, "sticky": False, "prob": None, "seed": 0}
        for kv in fields[2:]:
            key, sep, val = kv.partition("=")
            if key == "after" and sep:
                spec["after"] = int(val)
            elif key == "seconds" and sep:
                spec["seconds"] = float(val)
            elif key == "sticky" and sep:
                spec["sticky"] = val not in ("0", "false", "False")
            elif key == "prob" and sep:
                spec["prob"] = float(val)
                if not 0.0 < spec["prob"] <= 1.0:
                    raise MXNetError(
                        "bad %s field %r in entry %r: prob must be in "
                        "(0, 1]" % (ENV_VAR, kv, entry))
            elif key == "seed" and sep:
                spec["seed"] = int(val)
            else:
                raise MXNetError(
                    "bad %s field %r in entry %r (want after=N, seconds=S, "
                    "sticky=0/1, prob=P or seed=N)" % (ENV_VAR, kv, entry))
        if spec["prob"] is not None:
            spec["rng"] = _spec_rng(spec)
        specs.append(spec)
    return specs


def _spec_rng(spec):
    """Seeded per-spec RNG stream for ``prob=`` triggers.  sha256 of
    site/action/seed — NOT the builtin ``hash``, which is salted per
    process and would break replayability."""
    import hashlib
    import random

    digest = hashlib.sha256(
        ("%s:%s:%d" % (spec["site"], spec["action"],
                       spec["seed"])).encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def _refresh_locked():
    global _env_snapshot, _specs, _hits

    raw = os.environ.get(ENV_VAR, "")
    if raw != _env_snapshot:
        # parse BEFORE committing the snapshot: a malformed spec must
        # keep raising on every hook hit, not raise once and then be
        # silently ignored because the snapshot already matched
        specs = _parse(raw) if raw else []
        _specs = specs
        _hits = [0] * len(specs)
        _env_snapshot = raw


def reset():
    """Re-parse the env var and zero all hit counters (tests re-arming
    the same spec string between cases)."""
    global _env_snapshot

    with _lock:
        _env_snapshot = None
        _refresh_locked()


def rearm_after_fork():
    """Replace the module lock in a freshly forked child.  A fork can
    land while another parent thread holds ``_lock``; the child inherits
    the locked state with no owner, so every later :func:`inject` there
    would deadlock.  Decode worker processes call this first."""
    global _lock

    _lock = threading.RLock()


def active(site=None):
    """True when any fault spec (optionally: for ``site``) is armed."""
    with _lock:
        _refresh_locked()
        return any(s["site"] == site or site is None for s in _specs)


def inject(site, path=None):
    """Fault hook.  No-op unless ``MXNET_FAULT_INJECT`` names ``site``;
    otherwise counts the hit and fires the configured action when the
    counter reaches ``after`` (every later hit too with ``sticky=1``).
    Returns the poison value for ``nan``/``inf`` actions, else None.
    ``path`` names the file the ``bitflip``/``truncate`` corruption
    actions mutate; sites that cannot supply one reject those actions.
    """
    if not os.environ.get(ENV_VAR) and _env_snapshot in (None, ""):
        return None  # fast path: nothing armed, nothing to refresh
    delays = []
    hangs = []
    corruptions = []
    poison = None
    with _lock:
        _refresh_locked()
        for i, spec in enumerate(_specs):
            if spec["site"] != site:
                continue
            _hits[i] += 1
            n = _hits[i]
            if spec["prob"] is not None:
                # probabilistic trigger: every hit >= after rolls the
                # spec's seeded stream; the roll happens for skipped
                # pre-`after` hits too so the stream position — and
                # therefore the replayed fire pattern — depends only on
                # the hit count, never on the `after` offset
                if spec["rng"].random() >= spec["prob"] \
                        or n < spec["after"]:
                    continue
            elif n != spec["after"] and not (spec["sticky"] and
                                             n > spec["after"]):
                continue
            if spec["action"] == "delay":
                delays.append(spec["seconds"])
            elif spec["action"] == "hang":
                hangs.append(spec["seconds"])
            elif spec["action"] == "nan":
                poison = float("nan")
            elif spec["action"] == "inf":
                poison = float("inf")
            elif spec["action"] in ("bitflip", "truncate"):
                corruptions.append(spec["action"])
            elif spec["action"] == "kill":
                raise WorkerKilled(
                    "injected worker kill at site %r (hit %d)" % (site, n))
            else:
                raise FaultInjected(
                    "injected fault at site %r (hit %d, %s=%r)"
                    % (site, n, ENV_VAR, _env_snapshot))
    for action in corruptions:  # file I/O outside the lock
        _corrupt_file(action, path, site)
    for s in delays:  # sleep outside the lock: a delay must not serialize
        time.sleep(s)  # other sites behind it
    for s in hangs:
        # sliced sleep: the step watchdog delivers StepHung with
        # PyThreadState_SetAsyncExc, which lands at the next bytecode
        # boundary — a single long time.sleep would swallow it until
        # the full hang elapsed
        deadline = time.monotonic() + s
        while time.monotonic() < deadline:
            time.sleep(0.02)
    return poison


def _corrupt_file(action, path, site):
    """Apply a ``bitflip``/``truncate`` corruption to ``path`` in place —
    after the atomic publish, like real disk rot would."""
    if path is None:
        raise MXNetError(
            "fault action %r at site %r needs a file: the site must call "
            "inject(site, path=...)" % (action, site))
    size = os.path.getsize(path)
    if action == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        return
    with open(path, "r+b") as f:  # bitflip: XOR one bit mid-file
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([(byte[0] if byte else 0) ^ 0x01]))
