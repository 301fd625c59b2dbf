"""The port's streaming gateway over real sockets: twins of
tests/test_gateway.py over the port's sessions on the CPU, at
test_serve.py's sizes (vocab 61, 2 layers, d_model 32, 2 heads, page 8).

The failure-first contract end to end — streams equal to the in-process
oracle (and to the JAX package's Gateway on the same request),
cancellation that frees per-request state (``state_report()``
round-trips), slow-reader isolation, typed 429/503, drain and SIGTERM,
idempotent replays, the four ``gateway_*`` fault sites and the
``Scheduler.cancel`` edge cases underneath.  Every wait on a socket, a
thread or a future carries its own timeout.

Four reference tests race: the write-fault and drain-fault tests
expect a request to still be decoding when the fault lands, and a CPU
decode of 8 tokens can finish first; their twins slow each backend tick
(``_slow_ticks``), so the request is in flight by construction.  The
oracle-stream test reads a counter the server bumps after its client
holds the response, and the drain test sleeps 10 ms for its stream to
open; their twins wait for the counter and for the stream.
"""
import contextlib
import http.client
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

from mxnet_tpu_torch import serve
from mxnet_tpu_torch.serve import gateway as gw_mod
from mxnet_tpu_torch.serve import model as serve_model
from mxnet_tpu_torch.testing import faults

CFG = serve.ModelConfig(vocab_size=61, num_layers=2, d_model=32,
                        num_heads=2, max_len=64)
SCONF = serve.ServeConfig(slots=3, page_size=8, buckets=(8, 16),
                          max_new=8, exact=True)
HOST = "127.0.0.1"


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
    for var in ("MXNET_GW_PORT", "MXNET_GW_DRAIN_S",
                "MXNET_GW_READ_TIMEOUT_S", "MXNET_GW_WRITE_BUF_KB",
                "MXNET_GW_IDEMPOTENCY_S"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def params():
    return {k: v.numpy() for k, v in
            serve_model.init_params(CFG, seed=3, device="cpu").items()}


def _session(params, config=SCONF):
    return serve.InferenceSession(params, num_heads=CFG.num_heads,
                                  config=config, device="cpu")


@pytest.fixture(scope="module")
def _pool(params):
    return [_session(params) for _ in range(2)]


@pytest.fixture
def pool(_pool):
    yield _pool
    for sess in _pool:
        sess.reset_cold()


@pytest.fixture
def oracle(pool):
    """rid -> token list for the standard 3-request trace, from a plain
    in-process Scheduler run (the gateway must match it exactly)."""
    out, _ = serve.Scheduler(pool[1]).run(
        [serve.Request(rid=i, prompt=[1 + i, 2, 3], max_new=8)
         for i in range(3)])
    assert all(not r.failed for r in out)
    pool[1].reset_cold()
    return {r.rid: list(r.tokens) for r in out}


@contextlib.contextmanager
def _gateway(backend, **kw):
    gw = serve.Gateway(backend, host=HOST, port=0, **kw).start()
    try:
        yield gw
    finally:
        gw.stop()


# -- tiny HTTP clients -------------------------------------------------------

def _post(port, payload, timeout=60, method="POST",
          path="/v1/generate"):
    conn = http.client.HTTPConnection(HOST, port, timeout=timeout)
    try:
        body = json.dumps(payload) if payload is not None else None
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(port, path, timeout=30):
    return _post(port, None, timeout=timeout, method="GET", path=path)


def _events(body):
    return [json.loads(ln[len("data: "):])
            for ln in body.decode().split("\n\n")
            if ln.startswith("data: ")]


def _stream_tokens(body):
    return [e["token"] for e in _events(body) if "token" in e]


def _raw_request(payload):
    body = json.dumps(payload).encode()
    return (b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body)) + body


def _connect_stream(port, payload, timeout=30):
    """Open a raw socket, send the request, read up to the first SSE
    event, and hand the still-open socket back."""
    s = socket.create_connection((HOST, port), timeout=timeout)
    s.sendall(_raw_request(payload))
    seen = b""
    while b"data: " not in seen:
        chunk = s.recv(4096)
        assert chunk, "server closed before the first event: %r" % seen
        seen += chunk
    return s, seen


def _rst_close(s):
    """Close with an RST so the server's next write fails immediately —
    a crashed client, not a polite FIN."""
    s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                 struct.pack("ii", 1, 0))
    s.close()


def _read_to_close(s):
    out = b""
    while True:
        try:
            chunk = s.recv(4096)
        except (ConnectionError, socket.timeout, OSError):
            break
        if not chunk:
            break
        out += chunk
    return out


def _dechunk(raw):
    """Strip the HTTP header and chunked framing from a raw byte read."""
    body = raw.split(b"\r\n\r\n", 1)[1] if b"\r\n\r\n" in raw else raw
    out, rest = b"", body
    while b"\r\n" in rest:
        size, _, rest = rest.partition(b"\r\n")
        try:
            n = int(size, 16)
        except ValueError:
            break
        if n == 0:
            break
        out += rest[:n]
        rest = rest[n + 2:]
    return out


def _wait(predicate, timeout=30, every=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(every)
    return False


def _quiesce(gw):
    assert _wait(lambda: not gw._backend.outstanding), \
        "backend never went idle"


@contextlib.contextmanager
def _slow_ticks(gw, seconds=0.05):
    """Each backend tick takes at least ``seconds``: a request stays in
    flight for its whole stream, however fast the CPU decodes."""
    tick = gw._backend.tick

    def slow():
        time.sleep(seconds)
        return tick()

    gw._backend.tick = slow
    try:
        yield
    finally:
        gw._backend.tick = tick


# ---------------------------------------------------------------------------
# streaming correctness: the wire adds nothing and loses nothing
# ---------------------------------------------------------------------------

def test_stream_matches_in_process_oracle(pool, oracle):
    with _gateway(pool[0]) as gw:
        for rid in sorted(oracle):
            status, headers, body = _post(gw.port, {
                "rid": rid, "prompt": [1 + rid, 2, 3], "max_new": 8})
            assert status == 200
            assert headers["Content-Type"] == "text/event-stream"
            assert _stream_tokens(body) == oracle[rid]
            done = _events(body)[-1]
            assert done["done"] and done["tokens"] == oracle[rid]
        # non-stream mode returns the identical transcript as one body
        status, _, body = _post(gw.port, {
            "rid": 77, "prompt": [1, 2, 3], "max_new": 8,
            "stream": False})
        assert status == 200
        assert json.loads(body)["tokens"] == oracle[0]
        # the server counts a whole-body response once its write has
        # drained, which can be just after the client holds the bytes
        assert _wait(lambda: gw.counters["streams_completed"] == 4,
                     timeout=10)
    assert gw.incident_path is None  # clean runs write no artifact


def test_stream_equals_jax_gateway(params, pool, oracle):
    """The same request through the JAX package's Gateway over the same
    weights streams the same tokens and the same final event."""
    from mxnet_tpu import serve as jserve

    jsess = jserve.InferenceSession(params, num_heads=CFG.num_heads,
                                    config=jserve.ServeConfig(
                                        slots=3, page_size=8,
                                        buckets=(8, 16), max_new=8,
                                        exact=True))
    payload = {"rid": 2, "prompt": [3, 2, 3], "max_new": 8}
    jgw = jserve.Gateway(jsess, host=HOST, port=0).start()
    try:
        jstatus, jheaders, jbody = _post(jgw.port, payload)
    finally:
        jgw.stop()
    with _gateway(pool[0]) as gw:
        status, headers, body = _post(gw.port, payload)
    assert status == jstatus == 200
    assert headers["Content-Type"] == jheaders["Content-Type"]
    assert _stream_tokens(body) == _stream_tokens(jbody) == oracle[2]
    assert _events(body) == _events(jbody)


def test_concurrent_streams_all_match(pool, oracle):
    results = {}
    with _gateway(pool[0]) as gw:
        def client(rid):
            _, _, body = _post(gw.port, {
                "rid": rid, "prompt": [1 + rid, 2, 3], "max_new": 8})
            results[rid] = _stream_tokens(body)

        threads = [threading.Thread(target=client, args=(rid,))
                   for rid in sorted(oracle)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert results == oracle


def test_healthz_readyz_and_routing(pool):
    with _gateway(pool[0]) as gw:
        assert _get(gw.port, "/healthz")[0] == 200
        status, _, body = _get(gw.port, "/readyz")
        assert status == 200 and json.loads(body)["ready"]
        assert _get(gw.port, "/nope")[0] == 404
        assert _get(gw.port, "/v1/generate")[0] == 405
        assert _post(gw.port, {"no_prompt": True})[0] == 400


# ---------------------------------------------------------------------------
# cancellation frees state: every disconnect returns the session to baseline
# ---------------------------------------------------------------------------

def test_disconnect_cycles_return_state_to_baseline(pool):
    sess = pool[0]
    baseline = sess.state_report()
    with _gateway(sess) as gw:
        for i in range(6):
            s, _ = _connect_stream(gw.port, {
                "rid": 900 + i, "prompt": [1 + i, 2, 3], "max_new": 8})
            _rst_close(s)  # crash mid-stream, token 1 of 8
        _quiesce(gw)
        # every disconnect either propagated to a backend cancel or
        # lost the race to natural completion — both free state, and
        # with 7 of 8 tokens unstreamed at the RST the cancel path must
        # win at least once across six cycles
        assert gw.counters["cancelled"] >= 1
        assert gw.counters["cancelled"] \
            + gw.counters["streams_completed"] \
            + gw.counters["disconnects"] >= 6
        # the core assertion: nothing leaked — pool bytes, free pages,
        # free slots and retained pages all back to pre-traffic values
        assert sess.state_report() == baseline
        assert sess.active_slots() == []
    assert sess.state_report() == baseline


def test_deadline_cancel_mid_stream_frees_state(pool):
    sess = pool[0]
    baseline = sess.state_report()
    with _gateway(sess) as gw:
        status, _, body = _post(gw.port, {
            "rid": 5, "prompt": [9, 2, 3], "max_new": 8,
            "deadline_ms": 0.001})
        assert status == 200  # headers flush before the budget check
        done = _events(body)[-1]
        assert done.get("error") and "ServeCancelled" in done["error"]
        assert done["status"] == 499
        _quiesce(gw)
        assert gw.counters["deadline_cancels"] == 1
        assert sess.state_report() == baseline


# ---------------------------------------------------------------------------
# slow readers: bounded buffers, typed sheds, zero cross-stream impact
# ---------------------------------------------------------------------------

def test_slow_reader_does_not_delay_other_streams(pool, oracle):
    sess = pool[0]
    with _gateway(sess, write_buf_kb=1) as gw:
        # the slow reader opens a stream and then never reads again
        slow = socket.create_connection((HOST, gw.port), timeout=30)
        slow.sendall(_raw_request({"rid": 50, "prompt": [9, 8, 7],
                                   "max_new": 8}))
        t0 = time.monotonic()
        _, _, body = _post(gw.port, {"rid": 0, "prompt": [1, 2, 3],
                                     "max_new": 8})
        fast_s = time.monotonic() - t0
        assert _stream_tokens(body) == oracle[0]
        # the asserted bound: a wedged reader cannot push another
        # stream's wall time anywhere near the write timeout
        assert fast_s < 10.0, "fast stream stalled %.1fs behind a " \
                              "slow reader" % fast_s
        _rst_close(slow)
        _quiesce(gw)


def test_slow_reader_is_shed_typed(pool):
    """Unit-level: a writer whose socket never drains trips the write
    timeout, and the gateway sheds that reader typed — request
    cancelled, transport aborted, nothing else touched."""
    import asyncio

    class _StuckWriter(object):
        def __init__(self):
            self.aborted = False
            self.transport = self

        def write(self, data):
            pass

        async def drain(self):
            await asyncio.sleep(3600)

        def abort(self):
            self.aborted = True

    gw = serve.Gateway(pool[0], read_timeout_s=0.2)
    req = serve.Request(rid=7, prompt=[1, 2, 3], max_new=4)
    req.arrival_s = gw._backend.now()
    gw._backend.submit(req)
    writer = _StuckWriter()

    async def scenario():
        st = gw_mod._Stream(req, None, None,
                            asyncio.get_running_loop())
        st._push([5], False)
        await gw._stream_sse(writer, st, 0)

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(scenario())
    finally:
        loop.close()
    assert gw.counters["slow_reader_sheds"] == 1
    assert writer.aborted
    assert req.cancelled and "slow reader shed" in req.error
    assert not gw._backend.outstanding
    gw.stop()  # never started: must be a safe no-op


# ---------------------------------------------------------------------------
# overload: 429 with Retry-After, 503 when the backend is gone
# ---------------------------------------------------------------------------

def test_queue_cap_overload_surfaces_429(pool, oracle):
    rs = serve.ReplicaSet(sessions=pool[:1], queue_cap=1)
    statuses, bodies = [], []
    lock = threading.Lock()
    with _gateway(rs) as gw:
        barrier = threading.Barrier(12)

        def client(i):
            barrier.wait(timeout=30)
            status, headers, body = _post(gw.port, {
                "rid": 700 + i, "prompt": [1, 2, 3], "max_new": 8,
                "stream": False})
            with lock:
                statuses.append((status, headers))
                bodies.append(body)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        _quiesce(gw)
    assert len(statuses) == 12  # nothing lost, every client answered
    shed = [(s, h) for s, h in statuses if s == 429]
    ok = [(s, h) for s, h in statuses if s == 200]
    assert len(shed) + len(ok) == 12
    assert shed, "queue_cap=1 under a 12-client burst must shed"
    for _, headers in shed:
        assert "Retry-After" in headers
    for body in bodies:
        payload = json.loads(body)
        if "error" in payload:
            assert "ServeOverloaded" in payload["error"]
        else:
            # every accepted stream is still bit-exact under overload
            assert payload["tokens"] == oracle[0]


@pytest.mark.chaos
def test_backend_outage_surfaces_503_and_incident(monkeypatch, pool,
                                                  tmp_path):
    monkeypatch.setenv("MXNET_FAULT_INJECT",
                       "serve_replica_kill:kill:sticky=1")
    faults.reset()
    rs = serve.ReplicaSet(sessions=pool[:1], rejoin_backoff_s=1e9,
                          incident_dir=str(tmp_path))
    with _gateway(rs, incident_dir=str(tmp_path)) as gw:
        # the only replica dies on the first tick of this stream: the
        # in-flight request fails typed, mid-stream, not silently
        status, _, body = _post(gw.port, {
            "rid": 1, "prompt": [1, 2, 3], "max_new": 8})
        assert status == 200
        done = _events(body)[-1]
        assert "ServeUnavailable" in done["error"]
        assert done["status"] == 503
        assert _wait(lambda: gw._unavailable is not None)
        # readiness reflects the outage; new work is refused typed
        assert _get(gw.port, "/readyz")[0] == 503
        status, headers, body = _post(gw.port, {
            "prompt": [1, 2, 3], "max_new": 4})
        assert status == 503 and "Retry-After" in headers
        assert "ServeUnavailable" in json.loads(body)["error"]
        assert gw.counters["unavailable_503"] == 1
    # an abnormal exit writes the gateway incident artifact
    assert gw.incident_path is not None
    payload = json.loads(open(gw.incident_path).read())
    assert payload["kind"] == "mxnet_tpu-gateway-incident"
    assert payload["state"] == "unavailable"
    assert any(e["event"] == "unavailable"
               for e in payload["timeline"])


# ---------------------------------------------------------------------------
# graceful drain + SIGTERM: the rolling-restart contract
# ---------------------------------------------------------------------------

def test_drain_finishes_inflight_then_reports_clean(pool, oracle):
    with _gateway(pool[0]) as gw:
        got = {}

        def client():
            _, _, body = _post(gw.port, {"rid": 0, "prompt": [1, 2, 3],
                                         "max_new": 8})
            got["tokens"] = _stream_tokens(body)

        t = threading.Thread(target=client)
        t.start()
        # let the stream open (a fixed sleep loses the race to the drain
        # on a loaded machine, and the request then meets a 503)
        assert _wait(lambda: gw.open_streams() or got, timeout=30)
        gw.drain(wait=True)
        t.join(timeout=60)
        # readiness flipped, the stream finished whole, drain was clean
        assert _get(gw.port, "/readyz")[0] == 503
        assert got["tokens"] == oracle[0]
        assert gw._drain_clean is True
        assert gw.counters["force_cancelled"] == 0
        # new work is refused while draining
        status, _, body = _post(gw.port, {"prompt": [1], "max_new": 2})
        assert status == 503
        assert "draining" in json.loads(body)["error"]
        assert gw.counters["draining_503"] == 1


def test_sigterm_drains_then_second_forces_with_incident(pool,
                                                         tmp_path):
    forced = []
    gw = serve.Gateway(pool[0], host=HOST, port=0,
                       incident_dir=str(tmp_path),
                       on_force_exit=forced.append).start()
    prev = gw.install_signal_handlers()
    try:
        assert _get(gw.port, "/readyz")[0] == 200
        os.kill(os.getpid(), signal.SIGTERM)
        # the handler runs at the next bytecode boundary of this thread
        assert _wait(lambda: gw._draining, timeout=10)
        # readiness flips BEFORE the listener closes: the drain window
        # keeps serving 503s so the balancer can see it
        assert _get(gw.port, "/readyz")[0] == 503
        assert _get(gw.port, "/healthz")[0] == 200
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait(lambda: forced, timeout=10)
        path = forced[0]
        assert path and os.path.exists(path)
        payload = json.loads(open(path).read())
        assert payload["kind"] == "mxnet_tpu-gateway-incident"
        assert any(e["event"] == "sigterm_force"
                   for e in payload["timeline"])
        # ... and tools/diagnose.py renders it
        tool = os.path.join(os.path.dirname(__file__), "..", "tools",
                            "diagnose.py")
        res = subprocess.run([sys.executable, tool, path],
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        assert "GATEWAY INCIDENT" in res.stdout
        assert "sigterm_force" in res.stdout
    finally:
        signal.signal(signal.SIGTERM, prev)
        gw.stop()


@pytest.mark.chaos
def test_drain_fault_collapses_grace_to_typed_force_cancel(
        monkeypatch, pool, tmp_path):
    sess = pool[0]
    baseline = sess.state_report()
    with _gateway(sess, incident_dir=str(tmp_path)) as gw, \
            _slow_ticks(gw):
        socks = [_connect_stream(gw.port, {
            "rid": 80 + i, "prompt": [2 + i, 3, 4], "max_new": 8})[0]
            for i in range(2)]
        # hold the tick lock so the streams cannot finish decoding
        # before the collapsed drain reaches them — the force-cancel
        # is then deterministic, not a race against a fast decode
        gw._tick_lock.acquire()
        try:
            monkeypatch.setenv("MXNET_FAULT_INJECT",
                               "gateway_drain:raise")
            faults.reset()
            gw.drain(wait=False)
        finally:
            gw._tick_lock.release()
        gw._drain_fut.result(timeout=60)
        # the fault collapsed the grace window: in-flight streams were
        # force-cancelled typed instead of silently truncated
        assert gw._drain_clean is False
        assert gw.counters["force_cancelled"] >= 1
        # (raw bytes: each SSE event is one contiguous chunk, and the
        # first event was already consumed by _connect_stream)
        tails = [_read_to_close(s) for s in socks]
        for s in socks:
            s.close()
        assert any(b"ServeCancelled" in t for t in tails)
        _quiesce(gw)
        assert sess.state_report() == baseline
    assert gw.incident_path is not None
    payload = json.loads(open(gw.incident_path).read())
    assert payload["drain"]["requested"] \
        and payload["drain"]["clean"] is False
    assert any(e["event"] == "drain_fault"
               for e in payload["timeline"])


# ---------------------------------------------------------------------------
# exactly-once retries: the idempotency window
# ---------------------------------------------------------------------------

def test_idempotent_retry_replays_identical_stream(pool, oracle):
    with _gateway(pool[0]) as gw:
        first = _post(gw.port, {"rid": 0, "prompt": [1, 2, 3],
                                "max_new": 8, "idempotency_key": "k1"})
        retry = _post(gw.port, {"prompt": [1, 2, 3], "max_new": 8,
                                "idempotency_key": "k1"})
        assert _stream_tokens(first[2]) == oracle[0]
        # byte-identical replay: same events, same transcript, and the
        # backend decoded exactly once
        assert _stream_tokens(retry[2]) == oracle[0]
        assert gw.counters["idempotent_replays"] == 1
        status, _, body = _post(gw.port, {
            "prompt": [1, 2, 3], "max_new": 8, "stream": False,
            "idempotency_key": "k1"})
        assert status == 200 and json.loads(body)["replayed"]
        assert gw.counters["requests"] == 3
        assert gw._backend.sched.stats["cancelled"] == 0


def test_orphaned_keyed_request_completes_for_retry(pool, oracle):
    sess = pool[0]
    baseline = sess.state_report()
    with _gateway(sess) as gw:
        s, _ = _connect_stream(gw.port, {
            "prompt": [1, 2, 3], "max_new": 8,
            "idempotency_key": "k-orphan"})
        _rst_close(s)  # the client crashes after token 1
        _quiesce(gw)
        # keyed orphans decode to completion instead of cancelling —
        # the key is the client's declaration that it will retry
        assert gw.counters["cancelled"] == 0
        status, _, body = _post(gw.port, {
            "prompt": [1, 2, 3], "max_new": 8, "stream": False,
            "idempotency_key": "k-orphan"})
        assert status == 200
        payload = json.loads(body)
        assert payload["replayed"] and payload["tokens"] == oracle[0]
        assert gw.counters["idempotent_replays"] == 1
        assert sess.state_report() == baseline


# ---------------------------------------------------------------------------
# chaos matrix: the four gateway fault sites
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_gateway_read_fault_fails_one_connection_typed(monkeypatch,
                                                       pool):
    with _gateway(pool[0]) as gw:
        monkeypatch.setenv("MXNET_FAULT_INJECT", "gateway_read:raise")
        faults.reset()
        status, _, body = _post(gw.port, {"prompt": [1, 2, 3],
                                          "max_new": 4})
        assert status == 500
        assert "FaultInjected" in json.loads(body)["error"]
        assert gw.counters["read_faults"] == 1
        monkeypatch.delenv("MXNET_FAULT_INJECT")
        faults.reset()
        # one poisoned connection, zero blast radius
        assert _post(gw.port, {"prompt": [1, 2, 3],
                               "max_new": 4})[0] == 200


@pytest.mark.chaos
def test_gateway_read_kill_drops_connection_abruptly(monkeypatch,
                                                     pool):
    with _gateway(pool[0]) as gw:
        monkeypatch.setenv("MXNET_FAULT_INJECT", "gateway_read:kill")
        faults.reset()
        s = socket.create_connection((HOST, gw.port), timeout=30)
        s.sendall(_raw_request({"prompt": [1, 2, 3], "max_new": 4}))
        assert _read_to_close(s) == b""  # no status line, just gone
        s.close()


@pytest.mark.chaos
def test_gateway_write_fault_cancels_like_a_vanished_client(
        monkeypatch, pool):
    sess = pool[0]
    baseline = sess.state_report()
    with _gateway(sess) as gw, _slow_ticks(gw):
        monkeypatch.setenv("MXNET_FAULT_INJECT",
                           "gateway_write:raise:after=2")
        faults.reset()
        s = socket.create_connection((HOST, gw.port), timeout=30)
        s.sendall(_raw_request({"rid": 31, "prompt": [1, 2, 3],
                                "max_new": 8}))
        raw = _read_to_close(s)
        s.close()
        events = [json.loads(ln[len("data: "):])
                  for ln in _dechunk(raw).decode().split("\n\n")
                  if ln.startswith("data: ")]
        # the stream was cut mid-flight: tokens but no done event
        assert len(events) < 9
        assert not any(e.get("done") for e in events)
        _quiesce(gw)
        assert gw.counters["cancelled"] == 1
        assert sess.state_report() == baseline


@pytest.mark.chaos
def test_gateway_cancel_fault_is_a_lost_cancel_not_a_leak(
        monkeypatch, pool):
    """A fault in cancel propagation fails the *cancel* alone — the
    request decodes to completion, and that completion still frees
    every page and slot it held."""
    sess = pool[0]
    baseline = sess.state_report()
    gw = serve.Gateway(sess)  # never started: driven by hand
    req = serve.Request(rid=61, prompt=[4, 2, 3], max_new=6)
    req.arrival_s = gw._backend.now()
    gw._backend.submit(req)
    monkeypatch.setenv("MXNET_FAULT_INJECT", "gateway_cancel:raise")
    faults.reset()
    assert gw._cancel_backend(61, "client gone") is False
    assert gw.counters["cancel_faults"] == 1
    monkeypatch.delenv("MXNET_FAULT_INJECT")
    faults.reset()
    while gw._backend.outstanding:
        gw._backend.tick()
    assert req.finished and not req.failed and not req.cancelled
    assert len(req.tokens) == 6
    assert sess.state_report() == baseline
    gw.stop()


# ---------------------------------------------------------------------------
# Scheduler.cancel edge cases (the primitive under all of the above)
# ---------------------------------------------------------------------------

def _tick_until(sched, pred, cap=500):
    for _ in range(cap):
        if pred():
            return True
        sched.tick(wait=False)
    return pred()


def test_cancel_pending_request_before_prefill(pool):
    sess = pool[0]
    baseline = sess.state_report()
    sched = serve.Scheduler(sess).begin([])
    req = serve.Request(rid=1, prompt=[1, 2, 3], max_new=4)
    sched.submit(req)
    assert sched.cancel(1) is True
    assert req.cancelled and req.failed
    assert isinstance(req.error, str) and "ServeCancelled" in req.error
    assert sched.stats["cancelled"] == 1
    assert not sched.outstanding
    assert sess.state_report() == baseline  # never touched the cache
    assert sched.cancel(1) is False  # second cancel is a no-op


def test_cancel_active_request_mid_decode_releases_slot(pool):
    sess = pool[0]
    baseline = sess.state_report()
    sched = serve.Scheduler(sess).begin([])
    req = serve.Request(rid=2, prompt=[5, 2, 3], max_new=8)
    sched.submit(req)
    assert _tick_until(sched, lambda: len(req.tokens) >= 2)
    assert sess.active_slots() != []
    assert sched.cancel(2) is True
    assert req.cancelled and 2 <= len(req.tokens) < 8
    # the slot and its refcount-held pages came back at the boundary
    assert sess.active_slots() == []
    assert sess.state_report() == baseline
    sched.tick(wait=False)  # ticking past a cancel must be harmless
    assert not sched.outstanding


def test_cancel_after_final_token_is_noop(pool):
    sess = pool[0]
    sched = serve.Scheduler(sess).begin([])
    req = serve.Request(rid=3, prompt=[1, 2, 3], max_new=4)
    sched.submit(req)
    assert _tick_until(sched, lambda: req.finished)
    tokens = list(req.tokens)
    assert sched.cancel(3) is False
    assert not req.cancelled and not req.failed
    assert req.tokens == tokens  # transcript untouched
    assert sched.stats["cancelled"] == 0


def test_cancel_parked_request_under_oversubscription(params):
    # 5 pages for 3 growing slots forces a watermark preemption; the
    # victim sits in _parked holding no slot — cancelling it must not
    # touch the cache and the survivors must still complete
    sess = _session(params, serve.ServeConfig(
        slots=3, page_size=8, buckets=(8, 16), max_new=8, exact=True,
        num_pages=5, oversub=True))
    baseline = sess.state_report()
    sched = serve.Scheduler(sess).begin([])
    reqs = [serve.Request(rid=i, prompt=[1 + i, 2, 3, 4, 5, 6, 7, 8],
                          max_new=8) for i in range(3)]
    for r in reqs:
        sched.submit(r)
    assert _tick_until(sched, lambda: sched._parked), \
        "no preemption: the fixture no longer forces a park"
    victim = sched._parked[0]
    assert victim.preemptions >= 1
    assert sched.cancel(victim.rid) is True
    assert victim.cancelled and victim.resumes == 0
    while sched.outstanding:
        sched.tick(wait=False)
    done = [r for r in reqs if not r.failed]
    assert len(done) == 2 and all(len(r.tokens) == 8 for r in done)
    assert sess.state_report() == baseline


def test_cancel_under_speculative_decode_keeps_draft_lockstep(params):
    # a real draft model (layers:2) gives the session a second paged
    # cache; cancel must release BOTH at the same boundary or the next
    # occupant of the slot desyncs
    sess = _session(params, serve.ServeConfig(
        slots=3, page_size=8, buckets=(8, 16), max_new=8, exact=True,
        spec_k=2, draft="layers:%d" % CFG.num_layers))
    baseline = sess.state_report()
    assert "draft_free_pages" in baseline
    sched = serve.Scheduler(sess).begin([])
    keep = serve.Request(rid=10, prompt=[1, 2, 3], max_new=8)
    kill = serve.Request(rid=11, prompt=[7, 2, 3], max_new=8)
    sched.submit(keep)
    sched.submit(kill)
    assert _tick_until(sched, lambda: len(kill.tokens) >= 1)
    assert sched.cancel(11) is True
    while sched.outstanding:
        sched.tick(wait=False)
    assert keep.finished and not keep.failed
    assert len(keep.tokens) == 8
    # both caches back to baseline: target pages AND draft pages
    assert sess.state_report() == baseline
    # the freed slot is reusable without a draft desync
    again = serve.Request(rid=12, prompt=[7, 2, 3], max_new=8)
    sched.submit(again)
    while sched.outstanding:
        sched.tick(wait=False)
    assert again.finished and not again.failed
    assert sess.state_report() == baseline


# ---------------------------------------------------------------------------
# supervisor cancel: waiting / queued / live-replica holdings
# ---------------------------------------------------------------------------

def test_replicaset_cancel_covers_every_holding_place(pool):
    rs = serve.ReplicaSet(sessions=pool[:2])
    rs.begin()
    try:
        # queued-at-dispatcher cancel (before any tick places it)
        early = serve.Request(rid=40, prompt=[1, 2, 3], max_new=8,
                              arrival_s=rs.now())
        rs.submit(early)
        assert rs.cancel(40) is True
        assert early.cancelled and rs.counters["cancelled"] == 1
        # placed-on-replica cancel, mid-decode
        live = serve.Request(rid=41, prompt=[2, 2, 3], max_new=8,
                             arrival_s=rs.now())
        rs.submit(live)
        for _ in range(200):
            rs.tick()
            if len(live.tokens) >= 1:
                break
        assert rs.cancel(41) is True
        assert live.cancelled and rs.counters["cancelled"] == 2
        assert rs.cancel(99) is False  # unknown rid: typed no-op
        while rs.outstanding:
            rs.tick()
    finally:
        rs.finish()
    assert all(s.active_slots() == [] for s in pool[:2])


def test_tick_lock_hands_over_between_ticks(pool):
    """A cancel from another thread waits for one tick at most, however
    busy the dispatch loop is (the lock is handed to waiters between
    ticks rather than re-taken at once)."""
    sess = pool[0]
    baseline = sess.state_report()
    with _gateway(sess) as gw, _slow_ticks(gw, 0.05):
        req = serve.Request(rid=71, prompt=[4, 2, 3], max_new=8)
        with gw._tick_lock:
            req.arrival_s = gw._backend.now()
            gw._backend.submit(req)
        gw._work_evt.set()
        assert _wait(lambda: len(req.tokens) >= 2, timeout=30)
        t0 = time.monotonic()
        assert gw._cancel_backend(71, "test cancel") is True
        assert time.monotonic() - t0 < 0.5
        assert req.cancelled and len(req.tokens) < 8
        _quiesce(gw)
        assert sess.state_report() == baseline


@pytest.mark.chaos
def test_replica_watchdog_in_the_dispatch_thread(monkeypatch, pool,
                                                 oracle, tmp_path):
    """Behind a gateway the replica set ticks in the dispatch thread: an
    idle gateway never trips the watchdog, and a wedged replica's
    StepHung lands in the dispatch thread, which ejects the replica
    while the survivor finishes the stream."""
    # the 1 s timeout sits far above a healthy CPU tick on a loaded
    # machine; the hang far above the timeout
    rs = serve.ReplicaSet(sessions=pool[:2], step_timeout_s=1.0,
                          rejoin_backoff_s=30.0, incident_dir=str(tmp_path))
    with _gateway(rs, incident_dir=str(tmp_path)) as gw:
        time.sleep(2.5)  # idle for 2.5 timeouts: the clock is paused
        assert rs._watchdog is not None and not rs._watchdog.fired
        assert _get(gw.port, "/readyz")[0] == 200
        monkeypatch.setenv("MXNET_FAULT_INJECT",
                           "serve_replica_kill:hang:after=1:seconds=5")
        faults.reset()
        status, _, body = _post(gw.port, {"rid": 0, "prompt": [1, 2, 3],
                                          "max_new": 8})
        assert status == 200 and _stream_tokens(body) == oracle[0]
        death = next(e for e in rs.events if e["event"] == "death")
        assert death["replica"] == 0 and "watchdog" in death["detail"]
        assert gw._unavailable is None
        _quiesce(gw)


def test_dispatch_thread_that_cannot_bind_its_device_is_an_outage(
        monkeypatch, pool, tmp_path):
    """A dispatch thread that cannot make the sessions' card current
    serves nothing: the gateway reports the outage typed (503 on
    /readyz and on generate) instead of wedging every stream."""
    def fail(self):
        raise RuntimeError("no such device")

    monkeypatch.setattr(gw_mod.Gateway, "_bind_device", fail)
    with _gateway(pool[0], incident_dir=str(tmp_path)) as gw:
        assert _wait(lambda: gw._unavailable is not None, timeout=10)
        assert "could not bind" in gw._unavailable
        assert _get(gw.port, "/readyz")[0] == 503
        status, headers, _ = _post(gw.port, {"prompt": [1, 2, 3],
                                             "max_new": 4})
        assert status == 503 and "Retry-After" in headers
    assert gw.incident_path.startswith(str(tmp_path))


def test_tick_lock_stress_keeps_mutual_exclusion():
    """More threads than cores on the tick lock, at a shortened switch
    interval: every read-modify-write under it survives, the waiter
    count returns to zero, and the dispatch side's hand-over neither
    loses nor deadlocks anything."""
    lock = gw_mod._TickLock()
    box = {"n": 0}
    stop = threading.Event()
    per, workers = 300, 2 * (os.cpu_count() or 4)

    def worker():
        for _ in range(per):
            with lock:
                v = box["n"]
                time.sleep(0)
                box["n"] = v + 1

    def dispatcher():
        while not stop.is_set():
            lock.yield_to_waiters(0.001)
            with lock:
                box["n"] += 0

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(workers)]
        disp = threading.Thread(target=dispatcher)
        disp.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        disp.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not disp.is_alive() and not any(t.is_alive() for t in threads)
    assert box["n"] == per * workers
    assert lock._waiting == 0


def test_step_hung_in_the_dispatch_thread_outside_a_tick(pool, oracle):
    """The replica watchdog's StepHung can land in the dispatch thread
    after the stalled replica's tick returned (here: while pumping
    tokens): the replica set ejects the replica kicked last, its stream
    fails over and completes, and the gateway stays ready."""
    rs = serve.ReplicaSet(sessions=pool[:2], rejoin_backoff_s=30.0)
    with _gateway(rs) as gw:
        real = gw._pump_locked
        calls = []

        def pump():
            calls.append(1)
            if len(calls) == 3:
                raise gw_mod.StepHung()
            return real()

        gw._pump_locked = pump
        status, _, body = _post(gw.port, {"rid": 0, "prompt": [1, 2, 3],
                                          "max_new": 8})
        assert status == 200 and _stream_tokens(body) == oracle[0]
        assert rs.counters["deaths"] == 1
        assert gw._unavailable is None
        assert _get(gw.port, "/readyz")[0] == 200
        _quiesce(gw)
