"""The network edge: a fault-hardened streaming HTTP gateway.

Counterpart of ``mxnet_tpu/serve/gateway.py``, which holds no JAX, with
the same wire protocol, counters, chaos sites and incident schema.  A
stdlib-``asyncio`` HTTP/1.1 server fronts a
:class:`~mxnet_tpu_torch.serve.ReplicaSet` (or a single
:class:`~mxnet_tpu_torch.serve.InferenceSession` behind a
:class:`~mxnet_tpu_torch.serve.Scheduler`) and streams tokens as they
commit, designed failure-first: every failure mode a real socket brings that an
in-process harness never exercises has an explicit, typed, *asserted*
behavior.

Wire protocol (one request per connection, ``Connection: close``):

* ``POST /v1/generate`` — JSON body ``{"prompt": [ints],
  "max_new": N, "rid": int?, "stream": bool?, "eos_id": int?,
  "deadline_ms": float?, "idempotency_key": str?}``.  With
  ``stream`` (the default) the response is chunked-transfer SSE:
  one ``data: {"rid": R, "token": T}`` event per committed token and a
  final ``data: {"rid": R, "done": true, "tokens": [...]}`` event, so a
  client holds the full stream AND a checksummable final transcript.
  Errors mid-stream arrive as a terminal ``data: {..., "error": ...,
  "status": S}`` event; errors before the first byte use plain HTTP
  statuses.  ``stream: false`` waits and returns one JSON body.
* ``GET /healthz`` — liveness: 200 while the process serves at all.
* ``GET /readyz`` — readiness: 200 only while accepting new work;
  flips to 503 the moment a drain begins or the backend goes
  unavailable (the rolling-restart / load-balancer contract).

The failure-first contract:

* **Cancellation.** A client disconnect or a lapsed per-request
  ``deadline_ms`` propagates to the backend's ``cancel(rid)`` —
  :meth:`~mxnet_tpu_torch.serve.Scheduler.cancel` releases the slot and its
  refcount-aware pages at the next decode boundary, so shared prefix
  pages survive and pool occupancy returns to its pre-request baseline
  (the tests assert the session ``state_report()`` round-trips).
* **Graceful drain.** SIGTERM (or :meth:`drain`) flips ``/readyz``
  *first*, stops admitting work, lets in-flight streams finish for up
  to ``MXNET_GW_DRAIN_S`` seconds, then force-cancels the stragglers
  with a typed :class:`~mxnet_tpu_torch.serve.ServeCancelled` — a rolling
  restart never truncates a stream silently.  A second SIGTERM
  force-exits immediately, after writing the incident artifact.
* **Overload.** A typed :class:`~mxnet_tpu_torch.serve.ServeOverloaded` from
  the dispatcher surfaces as ``429`` + ``Retry-After``;
  :class:`~mxnet_tpu_torch.serve.ServeUnavailable` (every replica dead) as
  ``503``.  Reads and writes carry per-connection timeouts
  (``MXNET_GW_READ_TIMEOUT_S``) and each connection's kernel write
  buffer is capped at ``MXNET_GW_WRITE_BUF_KB`` — a reader that stops
  draining its socket is shed typed (its request cancelled, its state
  freed) instead of wedging anything: the ReplicaSet tick runs in its
  own worker thread and never touches a socket, so the slowest reader
  cannot block another stream's decode.
* **Exactly-once retries.** A request carrying an idempotency key that
  completes after its client vanished parks its transcript for
  ``MXNET_GW_IDEMPOTENCY_S`` seconds; a retry under the same key
  replays the completed response byte-for-byte instead of re-decoding
  (and a retry racing the original simply waits for it).  Keyless
  disconnects cancel instead — the key is the client's declaration
  that it will retry.
* **Incidents.** Abnormal exits (force drain, backend outage, a second
  SIGTERM) write ``gateway-incident-<pid>-<ms>.json`` under
  ``MXNET_HEALTH_DIR`` — counters, open connections, drain outcome,
  full timeline; pretty-print with ``tools/diagnose.py``.

Threading model: the asyncio event loop runs in one worker thread and
owns every socket; the dispatch loop runs in a second thread and owns
the backend (``tick()`` / ``submit()`` / ``cancel()`` under one lock,
which the dispatch loop hands to any waiting thread between ticks, so a
submit or a cancel waits for one tick at most).
On a card the dispatch thread first makes the sessions' device its
current one, so every graph replays on the device it was captured for;
it only replays — the sessions captured every graph when they were
built, on the thread that built them, and nothing is captured here.
Committed tokens cross from the dispatch thread to the loop via
``call_soon_threadsafe`` — the loop never blocks on the model and the
model never blocks on a socket.

Chaos sites (``testing/faults.py``): ``gateway_read`` (post-read,
pre-parse — fails that connection typed), ``gateway_write`` (before
each streamed chunk — treated as the client vanishing), and
``gateway_cancel`` / ``gateway_drain`` on the two control paths.
"""
from __future__ import annotations

import asyncio
import json
import os
import signal
import tempfile
import threading
import time

from ..base import MXNetError, StepHung, get_env, logger
from ..testing import faults
from .scheduler import Scheduler, Request
from .session import InferenceSession
from .supervisor import ReplicaSet, ServeUnavailable

__all__ = ["Gateway"]

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}

GATEWAY_THREAD_PREFIX = "mxtpu-gw-"


class _SchedulerBackend(object):
    """A single session (or pre-built scheduler) behind the gateway.
    No admission queue, so nothing sheds — overload waits in the
    scheduler's pending list."""

    def __init__(self, target):
        self.sched = target if isinstance(target, Scheduler) \
            else Scheduler(target)
        self.sched.begin([])

    def now(self):
        return self.sched.now()

    def submit(self, req):
        self.sched.submit(req)

    def tick(self):
        return self.sched.tick(wait=False)

    def cancel(self, rid, reason):
        return self.sched.cancel(rid, reason)

    def ready(self):
        return True

    def session(self):
        return self.sched.session

    def hung(self):
        return False  # no watchdog watches a lone scheduler

    @property
    def outstanding(self):
        return self.sched.outstanding

    def finish(self):
        pass


class _ReplicaSetBackend(object):
    """A full :class:`ReplicaSet` behind the gateway: bounded admission
    queue, deadline shedding, breaker, failover — the gateway only adds
    the sockets."""

    def __init__(self, rs):
        self.rs = rs
        rs.begin()

    def now(self):
        return self.rs.now()

    def submit(self, req):
        self.rs.submit(req)

    def tick(self):
        return self.rs.tick()

    def cancel(self, rid, reason):
        return self.rs.cancel(rid, reason)

    def ready(self):
        return bool(self.rs.live_replicas())

    def session(self):
        return self.rs.replicas[0].session

    def hung(self):
        self.rs.handle_step_hung()
        return True

    @property
    def outstanding(self):
        return self.rs.outstanding

    def finish(self):
        self.rs.finish()


class _TickLock(object):
    """The backend's lock, handed over fairly.  A plain lock released
    and re-taken at once by the busy dispatch thread is rarely won by a
    waiter (the releasing thread keeps running), so a submit or a
    cancel from the event loop could wait until the backend goes idle:
    a disconnect's cancel would then land only after the request had
    decoded to its end.  Here the dispatch thread, before it takes the
    lock for the next tick, lets every thread already waiting go
    first."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = threading.Lock()
        self._waiting = 0

    def acquire(self, blocking=True, timeout=-1):
        with self._count:
            self._waiting += 1
        try:
            return self._lock.acquire(blocking, timeout)
        finally:
            with self._count:
                self._waiting -= 1

    def release(self):
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def yield_to_waiters(self, limit_s=0.05):
        """Wait (at most ``limit_s``) until no other thread is waiting
        for the lock."""
        deadline = time.monotonic() + limit_s
        while self._waiting and time.monotonic() < deadline:
            time.sleep(1e-4)


class _Stream(object):
    """Loop-side view of one in-flight request: the dispatch thread
    pushes committed tokens in; the handler coroutine writes them out."""

    __slots__ = ("req", "key", "peer", "loop", "pushed", "flushed",
                 "tokens", "done", "event", "orphaned")

    def __init__(self, req, key, peer, loop):
        self.req = req
        self.key = key
        self.peer = peer
        self.loop = loop
        self.pushed = 0      # dispatch-side: req.tokens consumed so far
        self.flushed = False  # dispatch-side: terminal push sent
        self.tokens = []     # loop-side: tokens awaiting the writer
        self.done = False    # loop-side: terminal state arrived
        self.event = asyncio.Event()
        self.orphaned = False  # client vanished; decode continues

    def push_threadsafe(self, toks, done):
        self.loop.call_soon_threadsafe(self._push, toks, done)

    def _push(self, toks, done):
        self.tokens.extend(toks)
        self.done = self.done or done
        self.event.set()


class Gateway(object):
    """Serve a backend over real sockets; see the module docstring for
    the failure contract.  ``backend`` is a :class:`ReplicaSet`, an
    :class:`InferenceSession`, or a pre-armed :class:`Scheduler`.
    ``start()`` binds and returns self; ``stop()`` tears everything
    down (joining both worker threads); ``drain()`` is the rolling-
    restart path.  Knob defaults come from ``MXNET_GW_*`` env vars,
    each overridable per instance."""

    def __init__(self, backend, host="127.0.0.1", port=None,
                 drain_s=None, read_timeout_s=None, write_buf_kb=None,
                 idempotency_s=None, incident_dir=None,
                 on_force_exit=None):
        if isinstance(backend, ReplicaSet):
            self._backend = _ReplicaSetBackend(backend)
        elif isinstance(backend, (InferenceSession, Scheduler)):
            self._backend = _SchedulerBackend(backend)
        else:
            raise MXNetError(
                "Gateway fronts a ReplicaSet, InferenceSession, or "
                "Scheduler (got %r)" % type(backend).__name__)
        self.host = host
        self.port = int(port) if port is not None \
            else get_env("MXNET_GW_PORT", 0, int)
        self.drain_s = float(drain_s) if drain_s is not None \
            else get_env("MXNET_GW_DRAIN_S", 5.0, float)
        self.read_timeout_s = float(read_timeout_s) \
            if read_timeout_s is not None \
            else get_env("MXNET_GW_READ_TIMEOUT_S", 30.0, float)
        self.write_buf_kb = int(write_buf_kb) \
            if write_buf_kb is not None \
            else get_env("MXNET_GW_WRITE_BUF_KB", 64, int)
        self.idempotency_s = float(idempotency_s) \
            if idempotency_s is not None \
            else get_env("MXNET_GW_IDEMPOTENCY_S", 30.0, float)
        self._incident_dir = incident_dir or get_env(
            "MXNET_HEALTH_DIR", tempfile.gettempdir(), str)
        self._on_force_exit = on_force_exit
        self.counters = {
            "connections": 0, "requests": 0, "streams_completed": 0,
            "cancelled": 0, "cancel_faults": 0, "disconnects": 0,
            "shed_429": 0, "unavailable_503": 0, "draining_503": 0,
            "slow_reader_sheds": 0, "deadline_cancels": 0,
            "idempotent_replays": 0, "read_timeouts": 0,
            "read_faults": 0, "force_cancelled": 0}
        self.events = []
        self.incident_path = None
        self._t0 = time.monotonic()
        self._tick_lock = _TickLock()
        self._streams = {}   # rid -> _Stream (open server-side)
        self._idem = {}      # key -> replay record (loop thread only)
        self._rid_seq = [1 << 40]
        self._ready = False
        self._draining = False
        self._drain_fut = None
        self._drain_clean = None
        self._unavailable = None
        self._abnormal = False
        self._stop_evt = threading.Event()
        self._work_evt = threading.Event()
        self._loop = None
        self._server = None
        self._boot_err = None
        self._loop_thread = None
        self._dispatch_thread = None
        self._prev_sigterm = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Bind the listener, start the loop + dispatch threads; the
        actual port (ephemeral with port 0) is in ``self.port``."""
        booted = threading.Event()
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop_main, args=(booted,),
            name=GATEWAY_THREAD_PREFIX + "loop", daemon=True)
        self._loop_thread.start()
        if not booted.wait(timeout=30):
            raise MXNetError("gateway event loop failed to start")
        if self._boot_err is not None:
            self._loop_thread.join(timeout=5)
            raise MXNetError("gateway bind failed on %s:%d: %s"
                             % (self.host, self.port, self._boot_err))
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop,
            name=GATEWAY_THREAD_PREFIX + "dispatch", daemon=True)
        # ready before the thread runs: an outage it meets at once must
        # not be overwritten
        self._ready = True
        self._event("start", port=self.port)
        self._dispatch_thread.start()
        return self

    def _loop_main(self, booted):
        asyncio.set_event_loop(self._loop)

        async def _boot():
            try:
                self._server = await asyncio.start_server(
                    self._handle, self.host, self.port)
                self.port = self._server.sockets[0].getsockname()[1]
            except OSError as exc:
                self._boot_err = exc

        self._loop.run_until_complete(_boot())
        booted.set()
        if self._boot_err is not None:
            self._loop.close()
            return
        try:
            self._loop.run_forever()
        finally:
            try:
                self._loop.run_until_complete(
                    self._loop.shutdown_asyncgens())
            finally:
                self._loop.close()

    def stop(self):
        """Tear down: cancel whatever is still streaming (typed), close
        the listener and every connection, stop both threads (joined
        with timeouts), finish the backend, and write the incident
        artifact when anything abnormal happened."""
        if self._loop is None:
            return
        with self._tick_lock:
            leftovers = [rid for rid, st in self._streams.items()
                         if not st.req.finished]
            for rid in leftovers:
                self._backend.cancel(rid, "gateway stopped")
                self.counters["cancelled"] += 1
        self._ready = False
        self._stop_evt.set()
        self._work_evt.set()
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout=10)
        if self._loop.is_running():
            fut = asyncio.run_coroutine_threadsafe(
                self._shutdown_async(), self._loop)
            try:
                fut.result(timeout=10)
            except (asyncio.TimeoutError, OSError,
                    RuntimeError) as exc:
                logger.warning("gateway shutdown incomplete: %s", exc)
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
        self._backend.finish()
        self._event("stop")
        if self._abnormal:
            self._write_incident()
        self._loop = None

    async def _shutdown_async(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        me = asyncio.current_task()
        pending = [t for t in asyncio.all_tasks(self._loop)
                   if t is not me and not t.done()]
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)

    # -- drain + signals ---------------------------------------------------
    def drain(self, wait=True):
        """Begin a graceful drain: readiness flips immediately (before
        anything else — the load balancer must see it first), new work
        is refused 503, in-flight streams get up to ``drain_s`` seconds
        to finish, stragglers are force-cancelled typed."""
        if self._loop is None:
            return
        if self._drain_fut is None:
            self._ready = False
            self._draining = True
            self._drain_fut = asyncio.run_coroutine_threadsafe(
                self._drain_async(), self._loop)
        if wait:
            return self._drain_fut.result(timeout=self.drain_s + 30)
        return None

    async def _drain_async(self):
        self._event("drain_begin", deadline_s=self.drain_s)
        grace = self.drain_s
        try:
            faults.inject("gateway_drain")
        except (MXNetError, faults.WorkerKilled) as exc:
            # a fault here collapses the grace window: straight to the
            # typed force-cancel, never a silent truncation
            grace = 0.0
            self._abnormal = True
            self._event("drain_fault",
                        detail="%s: %s" % (type(exc).__name__, exc))
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            with self._tick_lock:
                open_streams = any(not st.req.finished
                                   for st in self._streams.values())
            if not open_streams:
                break
            self._work_evt.set()
            await asyncio.sleep(0.01)
        with self._tick_lock:
            leftovers = [rid for rid, st in self._streams.items()
                         if not st.req.finished]
            for rid in leftovers:
                self._backend.cancel(rid, "gateway drain deadline "
                                          "lapsed")
        self.counters["force_cancelled"] += len(leftovers)
        self._drain_clean = not leftovers
        if leftovers:
            self._abnormal = True
        self._event("drain_end", clean=self._drain_clean,
                    force_cancelled=len(leftovers))
        # let the dispatch thread flush the terminal events out
        self._work_evt.set()
        return self._drain_clean

    def install_signal_handlers(self):
        """Route SIGTERM to :meth:`handle_sigterm` (first: drain;
        second: force-exit with an incident artifact).  Main thread
        only, per the signal module; returns the previous handler."""
        self._prev_sigterm = signal.signal(
            signal.SIGTERM, lambda signum, frame: self.handle_sigterm())
        return self._prev_sigterm

    def handle_sigterm(self):
        """First SIGTERM: begin the graceful drain in the background.
        Second SIGTERM: force — cancel everything typed, write the
        incident artifact, and exit (``on_force_exit(path)`` when
        injected, else ``os._exit(1)``)."""
        if not self._draining:
            self._event("sigterm")
            self.drain(wait=False)
            return None
        self._event("sigterm_force")
        self._abnormal = True
        with self._tick_lock:
            for rid, st in list(self._streams.items()):
                if not st.req.finished:
                    self._backend.cancel(rid, "gateway force exit")
                    self.counters["force_cancelled"] += 1
        path = self._write_incident()
        if self._on_force_exit is not None:
            self._on_force_exit(path)
            return path
        os._exit(1)

    # -- the dispatch thread ----------------------------------------------
    def _dispatch_loop(self):
        """Owns the backend: one tick per iteration, then pump every
        open stream's newly committed tokens to the event loop.  No
        socket is ever touched here, so no reader can stall a tick."""
        try:
            self._bind_device()
        except Exception as exc:
            self._note_unavailable(MXNetError(
                "gateway dispatch thread could not bind the sessions' "
                "device: %s: %s" % (type(exc).__name__, exc)))
            return
        while not self._stop_evt.is_set():
            progressed = False
            self._tick_lock.yield_to_waiters()
            try:
                with self._tick_lock:
                    if self._backend.outstanding:
                        progressed = bool(self._backend.tick())
                    self._pump_locked()
            except ServeUnavailable as exc:
                with self._tick_lock:
                    self._pump_locked()
                self._note_unavailable(exc)
                continue
            except StepHung as exc:
                # the replica watchdog's exception, delivered after the
                # stalled replica's tick had returned: the replica set
                # ejects it and fails its requests over
                with self._tick_lock:
                    handled = self._backend.hung()
                if not handled:
                    self._note_unavailable(exc)
                continue
            except MXNetError as exc:
                self._note_unavailable(exc)
                continue
            except Exception as exc:
                # the dispatch thread dying silently would wedge every
                # open stream; convert to a typed outage instead
                self._note_unavailable(MXNetError(
                    "gateway dispatch loop crashed: %s: %s"
                    % (type(exc).__name__, exc)))
                continue
            if not progressed:
                self._work_evt.wait(timeout=0.005)
                self._work_evt.clear()

    def _bind_device(self):
        """Make the sessions' card this thread's current device, so every
        replay runs where its graph was captured."""
        session = self._backend.session()
        device = getattr(session, "device", None)
        if device is None or device.type != "cuda":
            return
        import torch

        if device.index is None:  # "cuda": the card its tensors are on
            device = session.cache.k_pool.device
        torch.cuda.set_device(device)

    def _pump_locked(self):
        """Move newly committed tokens (and terminal states) from each
        request to its loop-side stream.  Caller holds the tick lock."""
        for rid in list(self._streams):
            st = self._streams[rid]
            req = st.req
            n = len(req.tokens)
            fin = req.finished
            if n > st.pushed or (fin and not st.flushed):
                new = list(req.tokens[st.pushed:n])
                st.pushed = n
                if fin:
                    st.flushed = True
                st.push_threadsafe(new, fin)
            if fin:
                del self._streams[rid]
                if st.key:
                    self._loop.call_soon_threadsafe(
                        self._park_idempotent, st)

    def _note_unavailable(self, exc):
        if self._unavailable is None:
            self._unavailable = "%s: %s" % (type(exc).__name__, exc)
            self._ready = False
            self._abnormal = True
            self._event("unavailable", detail=self._unavailable)
            logger.warning("gateway backend unavailable: %s",
                           self._unavailable)

    # -- cancel propagation -----------------------------------------------
    def _cancel_backend(self, rid, reason, counter="cancelled"):
        """Propagate one cancel to the backend across the
        ``gateway_cancel`` chaos site.  A fault here fails the *cancel*
        alone: the request keeps decoding and its normal completion
        still frees the slot — a lost cancel must never leak state."""
        try:
            faults.inject("gateway_cancel")
        except (MXNetError, faults.WorkerKilled) as exc:
            self.counters["cancel_faults"] += 1
            self._event("cancel_fault", rid=rid,
                        detail="%s: %s" % (type(exc).__name__, exc))
            return False
        with self._tick_lock:
            ok = self._backend.cancel(rid, reason)
        if ok:
            self.counters[counter] += 1
            self._event("cancel", rid=rid, detail=reason)
            self._work_evt.set()
        return ok

    # -- idempotency window -----------------------------------------------
    def _purge_idem(self):
        now = time.monotonic()
        for key in [k for k, rec in self._idem.items()
                    if rec["expires"] <= now]:
            del self._idem[key]

    def _park_idempotent(self, st):
        """Completion of a keyed request (loop thread): park the
        transcript for replay — only successes; a failed original lets
        the retry decode fresh."""
        rec = self._idem.get(st.key)
        if rec is None:
            return
        if st.req.failed:
            del self._idem[st.key]
        else:
            rec["tokens"] = list(st.req.tokens)
            rec["expires"] = time.monotonic() + self.idempotency_s
        rec["evt"].set()

    # -- the connection handler -------------------------------------------
    async def _handle(self, reader, writer):
        self.counters["connections"] += 1
        transport = writer.transport
        try:
            transport.set_write_buffer_limits(
                high=self.write_buf_kb * 1024)
        except (RuntimeError, AttributeError):
            pass  # transport flavors without watermarks
        try:
            try:
                parsed = await self._read_request(reader)
            except asyncio.TimeoutError:
                self.counters["read_timeouts"] += 1
                self._event("read_timeout")
                return
            except (asyncio.IncompleteReadError, ConnectionError,
                    OSError):
                self.counters["disconnects"] += 1
                return
            if parsed is None:
                return
            method, path, headers, body = parsed
            try:
                faults.inject("gateway_read")
            except faults.WorkerKilled:
                return  # abrupt close, like a dying proxy hop
            except MXNetError as exc:
                self.counters["read_faults"] += 1
                self._event("read_fault", detail="%s: %s"
                            % (type(exc).__name__, exc))
                await self._respond(writer, 500, {
                    "error": "%s: %s" % (type(exc).__name__, exc)})
                return
            if method == "GET" and path == "/healthz":
                await self._respond(writer, 200, {
                    "ok": True, "state": self._state()})
                return
            if method == "GET" and path == "/readyz":
                ready = self._ready and self._backend.ready()
                await self._respond(
                    writer, 200 if ready else 503,
                    {"ready": ready, "state": self._state(),
                     "error": self._unavailable})
                return
            if path != "/v1/generate":
                await self._respond(writer, 404,
                                    {"error": "no route %r" % path})
                return
            if method != "POST":
                await self._respond(writer, 405,
                                    {"error": "POST required"})
                return
            await self._generate(writer, headers, body)
        except (ConnectionError, OSError):
            self.counters["disconnects"] += 1
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError, RuntimeError):
                pass

    async def _read_request(self, reader):
        line = await asyncio.wait_for(reader.readline(),
                                      self.read_timeout_s)
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0], parts[1]
        headers = {}
        while True:
            raw = await asyncio.wait_for(reader.readline(),
                                         self.read_timeout_s)
            if raw in (b"\r\n", b"\n", b""):
                break
            name, _, value = raw.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        length = int(headers.get("content-length", 0) or 0)
        if length > 0:
            body = await asyncio.wait_for(reader.readexactly(length),
                                          self.read_timeout_s)
        return method, path, headers, body

    async def _generate(self, writer, headers, body):
        self.counters["requests"] += 1
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = [int(t) for t in spec["prompt"]]
        except (ValueError, KeyError, TypeError) as exc:
            await self._respond(writer, 400, {
                "error": "bad request body: %s" % exc})
            return
        if self._unavailable is not None:
            self.counters["unavailable_503"] += 1
            await self._respond(writer, 503, {
                "error": self._unavailable}, retry_after=5)
            return
        if self._draining or not self._ready \
                or not self._backend.ready():
            self.counters["draining_503"] += 1
            await self._respond(writer, 503, {
                "error": "ServeUnavailable: gateway is %s"
                         % self._state()}, retry_after=2)
            return
        key = spec.get("idempotency_key") \
            or headers.get("idempotency-key")
        self._purge_idem()
        if key and key in self._idem:
            await self._replay_idempotent(writer, key,
                                          bool(spec.get("stream", True)))
            return
        rid = int(spec["rid"]) if "rid" in spec else self._next_rid()
        req = Request(rid=rid, prompt=prompt,
                      max_new=int(spec.get("max_new", 16)),
                      eos_id=int(spec.get("eos_id", -1)))
        deadline_ms = float(spec.get("deadline_ms", 0.0) or 0.0)
        if deadline_ms > 0:
            req.deadline_ms = deadline_ms  # the dispatcher's shed rule
        st = _Stream(req, key, self._peer(writer), self._loop)
        with self._tick_lock:
            if rid in self._streams:
                dup = True
            else:
                dup = False
                req.arrival_s = self._backend.now()
                self._backend.submit(req)
                if not (req.failed and req.shed):
                    self._streams[rid] = st
        if dup:
            await self._respond(writer, 409, {
                "error": "rid %d is already in flight" % rid})
            return
        self._work_evt.set()
        if req.failed and req.shed:  # synchronous queue-cap shed
            self.counters["shed_429"] += 1
            await self._respond(writer, 429, {"error": req.error},
                                retry_after=1)
            return
        if key:
            self._idem[key] = {
                "expires": time.monotonic() + self.idempotency_s,
                "tokens": None, "rid": rid, "evt": asyncio.Event()}
        if bool(spec.get("stream", True)):
            await self._stream_sse(writer, st, deadline_ms)
        else:
            await self._respond_whole(writer, st, deadline_ms)

    def _next_rid(self):
        self._rid_seq[0] += 1
        return self._rid_seq[0]

    async def _wait_stream(self, st, deadline):
        """Wait for new stream data or the request deadline; returns
        True on deadline expiry (after cancelling the request)."""
        while not st.tokens and not st.done:
            timeout = 0.05
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.counters["deadline_cancels"] += 1
                    self._cancel_backend(
                        st.req.rid, "per-request deadline of %.0f ms "
                        "lapsed mid-stream" % st.req.deadline_ms,
                        counter="cancelled")
                    return True
                timeout = min(timeout, remaining)
            try:
                await asyncio.wait_for(st.event.wait(), timeout)
            except asyncio.TimeoutError:
                continue
            st.event.clear()
        return False

    async def _stream_sse(self, writer, st, deadline_ms):
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n"
                     b"Connection: close\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n")
        deadline = time.monotonic() + deadline_ms / 1e3 \
            if deadline_ms > 0 else None
        req = st.req
        try:
            while True:
                lapsed = await self._wait_stream(st, deadline)
                while st.tokens:
                    tok = st.tokens.pop(0)
                    await self._write_event(writer, {
                        "rid": req.rid, "token": tok})
                if st.done or lapsed:
                    if lapsed and not st.done:
                        # terminal event for a deadline cancel whose
                        # pump hasn't flushed yet
                        await self._write_event(writer, {
                            "rid": req.rid, "done": True,
                            "error": "ServeCancelled: per-request "
                                     "deadline lapsed", "status": 499})
                    elif req.failed:
                        await self._write_event(writer, {
                            "rid": req.rid, "done": True,
                            "error": req.error,
                            "status": self._fail_status(req)})
                    else:
                        await self._write_event(writer, {
                            "rid": req.rid, "done": True,
                            "tokens": list(req.tokens),
                            "n": len(req.tokens)})
                        self.counters["streams_completed"] += 1
                    writer.write(b"0\r\n\r\n")
                    await asyncio.wait_for(writer.drain(),
                                           self.read_timeout_s)
                    return
        except asyncio.TimeoutError:
            # the bounded write buffer stayed full past the timeout:
            # this reader is too slow to keep — shed it typed
            self.counters["slow_reader_sheds"] += 1
            self._event("slow_reader_shed", rid=req.rid,
                        peer=str(st.peer))
            self._cancel_backend(req.rid, "slow reader shed: write "
                                 "buffer full past %.1fs"
                                 % self.read_timeout_s)
            self._abort(writer)
        except (ConnectionError, OSError, MXNetError,
                faults.WorkerKilled):
            # the client vanished (or gateway_write said to pretend it
            # did): keyed requests decode on for the retry window;
            # keyless ones cancel and free their state now
            self.counters["disconnects"] += 1
            if st.key:
                st.orphaned = True
                self._event("orphaned", rid=req.rid, detail="client "
                            "vanished; decoding on for idempotent "
                            "retry")
            else:
                self._cancel_backend(req.rid, "client disconnected "
                                     "mid-stream")
            self._abort(writer)

    async def _respond_whole(self, writer, st, deadline_ms):
        deadline = time.monotonic() + deadline_ms / 1e3 \
            if deadline_ms > 0 else None
        req = st.req
        try:
            while not st.done:
                if await self._wait_stream(st, deadline):
                    break
                st.tokens.clear()
            if req.failed or not req.finished:
                status = self._fail_status(req) if req.failed else 499
                await self._respond(writer, status, {
                    "rid": req.rid,
                    "error": req.error or "ServeCancelled: deadline"})
            else:
                await self._respond(writer, 200, {
                    "rid": req.rid, "tokens": list(req.tokens)})
                self.counters["streams_completed"] += 1
        except (ConnectionError, OSError, asyncio.TimeoutError):
            self.counters["disconnects"] += 1
            if st.key:
                st.orphaned = True
            else:
                self._cancel_backend(req.rid, "client disconnected")
            self._abort(writer)

    async def _replay_idempotent(self, writer, key, stream):
        """Exactly-once retries: wait for the original if it is still
        decoding, then replay its completed transcript byte-for-byte —
        never a second decode."""
        rec = self._idem[key]
        if rec["tokens"] is None:
            try:
                await asyncio.wait_for(rec["evt"].wait(),
                                       self.read_timeout_s)
            except asyncio.TimeoutError:
                await self._respond(writer, 503, {
                    "error": "ServeUnavailable: original request for "
                             "this idempotency key is still running"},
                    retry_after=2)
                return
        rec = self._idem.get(key)
        if rec is None or rec["tokens"] is None:
            # the original failed: nothing completed to replay
            await self._respond(writer, 409, {
                "error": "original request for this idempotency key "
                         "did not complete; retry without the race"})
            return
        self.counters["idempotent_replays"] += 1
        self._event("idempotent_replay", rid=rec["rid"])
        if not stream:
            await self._respond(writer, 200, {
                "rid": rec["rid"], "tokens": list(rec["tokens"]),
                "replayed": True})
            return
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n"
                     b"Connection: close\r\n"
                     b"Transfer-Encoding: chunked\r\n\r\n")
        try:
            for tok in rec["tokens"]:
                await self._write_event(writer, {
                    "rid": rec["rid"], "token": tok})
            await self._write_event(writer, {
                "rid": rec["rid"], "done": True,
                "tokens": list(rec["tokens"]),
                "n": len(rec["tokens"])})
            writer.write(b"0\r\n\r\n")
            await asyncio.wait_for(writer.drain(), self.read_timeout_s)
        except (ConnectionError, OSError, asyncio.TimeoutError,
                MXNetError, faults.WorkerKilled):
            # replays hold no backend state, so a vanished retryer (or
            # a gateway_write fault mid-replay) just closes the socket
            self.counters["disconnects"] += 1
            self._abort(writer)

    # -- wire helpers ------------------------------------------------------
    async def _write_event(self, writer, payload):
        """One SSE event as one HTTP chunk, across the
        ``gateway_write`` chaos site; the awaited drain is where the
        bounded write buffer pushes back on a slow reader."""
        faults.inject("gateway_write")
        data = b"data: " + json.dumps(payload).encode() + b"\n\n"
        writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
        await asyncio.wait_for(writer.drain(), self.read_timeout_s)

    async def _respond(self, writer, status, payload, retry_after=None):
        body = json.dumps(payload).encode()
        head = ["HTTP/1.1 %d %s" % (status,
                                    _REASONS.get(status, "OK")),
                "Content-Type: application/json",
                "Content-Length: %d" % len(body),
                "Connection: close"]
        if retry_after is not None:
            head.append("Retry-After: %d" % retry_after)
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await asyncio.wait_for(writer.drain(), self.read_timeout_s)

    def _abort(self, writer):
        try:
            writer.transport.abort()
        except (RuntimeError, AttributeError, OSError):
            pass

    def _peer(self, writer):
        try:
            return writer.get_extra_info("peername")
        except (RuntimeError, OSError):
            return None

    @staticmethod
    def _fail_status(req):
        if getattr(req, "shed", False):
            return 429
        if getattr(req, "cancelled", False):
            return 499  # nginx's "client closed request"
        if "ServeUnavailable" in (req.error or ""):
            return 503
        return 500

    # -- introspection + incident artifact ---------------------------------
    def _state(self):
        if self._unavailable is not None:
            return "unavailable"
        if self._draining:
            return "draining"
        return "serving" if self._ready else "stopped"

    def _event(self, event, **detail):
        rec = {"t": round(time.monotonic() - self._t0, 4),
               "event": event}
        rec.update(detail)
        self.events.append(rec)

    def open_streams(self):
        with self._tick_lock:
            return sorted(self._streams)

    def incident_report(self):
        """JSON-able incident summary: counters, open connections, and
        the drain outcome — ``tools/diagnose.py`` renders it."""
        with self._tick_lock:
            open_conns = [
                {"rid": rid, "peer": str(st.peer),
                 "tokens_sent": st.pushed, "keyed": bool(st.key),
                 "orphaned": st.orphaned}
                for rid, st in sorted(self._streams.items())]
        return {
            "kind": "mxnet_tpu-gateway-incident",
            "pid": os.getpid(),
            "time": time.time(),
            "host": self.host,
            "port": self.port,
            "state": self._state(),
            "counters": dict(self.counters),
            "open_connections": open_conns,
            "drain": {"requested": self._draining,
                      "deadline_s": self.drain_s,
                      "clean": self._drain_clean},
            "timeline": list(self.events),
        }

    def _write_incident(self):
        payload = self.incident_report()
        try:
            os.makedirs(self._incident_dir, exist_ok=True)
            path = os.path.join(
                self._incident_dir, "gateway-incident-%d-%d.json"
                % (os.getpid(), int(time.time() * 1e3)))
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
            self.incident_path = path
            return path
        except OSError as e:  # diagnostics must never mask the exit
            logger.warning("gateway incident artifact write failed: %s",
                           e)
            return None
