"""The port's async HTTP ingress: the cases of the JAX package's
``tests/test_serve_ingress.py`` (keep-alive pipelining order, typed
error mapping on the event-loop path, typed terminal events for streams
that die mid-flight, promise-ref hygiene when clients disconnect, the
threaded backend) run against ``ray_tpu_torch.serve`` on
``init(num_cpus=4, num_gpus=8, max_process_workers=2)``. The reference's
sanitizer run of the suite waits for the port's ``devtools``.

Raw sockets on purpose: urllib serializes requests per connection, and
the pipelining / mid-stream-disconnect contracts are only observable
at the wire level.
"""

import json
import os
import socket
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import serve_stats

from tests.test_torch_serve_batching import assert_serve_settled


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    """A small single-host runtime (2 process workers, 8 GPUs of
    resource; no card is needed for work that demands none)."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_instance(ray_start_regular):
    serve_stats.reset()
    yield serve
    serve.shutdown()


# ---------------------------------------------------------------------------
# wire helpers

def _connect():
    host, port = serve.http_address()
    s = socket.create_connection((host, port), timeout=30)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _post(name, payload, stream=False, headers=()):
    body = json.dumps(payload).encode()
    lines = [f"POST /{name}{'?stream=1' if stream else ''} HTTP/1.1",
             "Host: t", "Content-Type: application/json",
             f"Content-Length: {len(body)}"]
    lines += list(headers)
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def _read_response(f):
    """One full HTTP/1.1 response (Content-Length or chunked) off a
    buffered socket file. Returns (status, headers, body_bytes)."""
    line = f.readline()
    assert line, "connection closed before a response arrived"
    status = int(line.split()[1])
    headers = {}
    while True:
        ln = f.readline().strip()
        if not ln:
            break
        k, _, v = ln.partition(b":")
        headers[k.strip().lower().decode()] = v.strip().decode()
    if headers.get("transfer-encoding") == "chunked":
        body = bytearray()
        for blob in _iter_chunks(f):
            body += blob
        return status, headers, bytes(body)
    clen = int(headers.get("content-length", 0))
    return status, headers, f.read(clen)


def _read_stream_head(f):
    """Status line + headers only — the caller then consumes chunks."""
    line = f.readline()
    assert line, "connection closed before the stream head"
    status = int(line.split()[1])
    headers = {}
    while True:
        ln = f.readline().strip()
        if not ln:
            break
        k, _, v = ln.partition(b":")
        headers[k.strip().lower().decode()] = v.strip().decode()
    return status, headers


def _iter_chunks(f):
    while True:
        size = int(f.readline().strip(), 16)
        if size == 0:
            f.readline()
            return
        yield f.read(size)
        f.readline()    # chunk trailer CRLF


# ---------------------------------------------------------------------------
# keep-alive pipelining

def test_pipelined_keepalive_responses_in_request_order(serve_instance):
    """Ten requests pipelined down ONE connection in a single write:
    ten responses come back on that same connection, strictly in
    request order, regardless of router completion order."""

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            return {"i": x}

    serve.run(Echo.bind())
    s = _connect()
    try:
        s.sendall(b"".join(_post("Echo", i) for i in range(10)))
        f = s.makefile("rb")
        for i in range(10):
            status, _hdrs, body = _read_response(f)
            assert status == 200
            assert json.loads(body) == {"i": i}
    finally:
        s.close()


def test_status_endpoint_keepalive(serve_instance):
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return x

    serve.run(Echo.bind())
    s = _connect()
    try:
        req = b"GET /-/routes HTTP/1.1\r\nHost: t\r\n\r\n"
        s.sendall(req + req)    # two GETs, one connection
        f = s.makefile("rb")
        for _ in range(2):
            status, _hdrs, body = _read_response(f)
            assert status == 200
            assert json.loads(body)["Echo"]["state"] == "HEALTHY"
    finally:
        s.close()


# ---------------------------------------------------------------------------
# typed error mapping on the async path

def test_async_shed_503_typed_with_retry_after(serve_instance):
    """Overload on the event-loop path: pipelined burst past
    max_queued_requests sheds with 503 + Retry-After >= 1 and the
    taxonomy name in X-RTPU-Error-Type — and the 503s ride the same
    ordered response stream as the 200s (no worker thread occupied)."""

    @serve.deployment(num_replicas=1, max_queued_requests=2)
    class Slow:
        @serve.batch(max_batch_size=1, batch_wait_timeout_ms=1)
        async def __call__(self, items):
            import asyncio
            await asyncio.sleep(0.3)
            return items

    serve.run(Slow.bind())
    s = _connect()
    try:
        s.sendall(b"".join(_post("Slow", i) for i in range(12)))
        f = s.makefile("rb")
        statuses, retry_after = [], []
        for _ in range(12):
            status, hdrs, _body = _read_response(f)
            statuses.append(status)
            if status == 503:
                assert hdrs["x-rtpu-error-type"] == "BackpressureError"
                retry_after.append(int(hdrs["retry-after"]))
        assert 200 in statuses, statuses
        assert 503 in statuses, statuses
        assert retry_after and all(ra >= 1 for ra in retry_after)
    finally:
        s.close()


def test_user_error_maps_to_500_with_type_header(serve_instance):
    @serve.deployment
    class Boom:
        def __call__(self, x):
            raise ValueError(f"bad input {x}")

    serve.run(Boom.bind())
    s = _connect()
    try:
        s.sendall(_post("Boom", 7))
        status, hdrs, body = _read_response(s.makefile("rb"))
        assert status == 500
        assert hdrs["x-rtpu-error-type"] == "ValueError"
        rec = json.loads(body)
        assert rec["error_type"] == "ValueError"
        assert "bad input 7" in rec["detail"]
    finally:
        s.close()


def test_unknown_deployment_404_and_bad_json_400(serve_instance):
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return x

    serve.run(Echo.bind())
    s = _connect()
    try:
        s.sendall(_post("Nope", 1))
        bad = (b"POST /Echo HTTP/1.1\r\nHost: t\r\n"
               b"Content-Type: application/json\r\n"
               b"Content-Length: 3\r\n\r\n{x}")
        s.sendall(bad)
        f = s.makefile("rb")
        status, _h, _b = _read_response(f)
        assert status == 404
        status, _h, _b = _read_response(f)
        assert status == 400
    finally:
        s.close()


def test_large_raw_body_roundtrip(serve_instance):
    """A multi-MB opaque body rides the router's zero-copy promote
    path (docs/serve.md §Zero-copy) and round-trips intact."""

    @serve.deployment
    class Size:
        def __call__(self, blob):
            return {"n": len(blob), "head": blob[:4].decode()}

    serve.run(Size.bind())
    payload = b"RTPU" + os.urandom(2 * 1024 * 1024)
    head = (f"POST /Size HTTP/1.1\r\nHost: t\r\n"
            f"Content-Type: application/octet-stream\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n").encode()
    s = _connect()
    try:
        s.sendall(head + payload)
        status, _h, body = _read_response(s.makefile("rb"))
        assert status == 200
        assert json.loads(body) == {"n": len(payload), "head": "RTPU"}
    finally:
        s.close()


# ---------------------------------------------------------------------------
# streaming: typed terminals, chaos, disconnect hygiene

def test_stream_user_error_yields_typed_terminal(serve_instance):
    """A generator that raises mid-stream: delivered items arrive,
    then ONE terminal record naming the taxonomy type (never an
    anonymous error chunk), then a clean chunked terminator."""

    @serve.deployment
    class Gen:
        def __call__(self, n):
            for i in range(n):
                yield {"i": i}
                if i == 1:
                    raise RuntimeError("replica gave up")

    serve.run(Gen.bind())
    s = _connect()
    try:
        s.sendall(_post("Gen", 5, stream=True))
        f = s.makefile("rb")
        status, hdrs = _read_stream_head(f)
        assert status == 200
        assert hdrs["content-type"] == "application/x-ndjson"
        records = [json.loads(c) for c in _iter_chunks(f)]
        assert records[:2] == [{"i": 0}, {"i": 1}]
        term = records[-1]
        assert term["terminal"] is True
        assert term["error_type"] == "RuntimeError"
        assert "replica gave up" in term["error"]
        # the ingress closes an errored stream's connection
        assert f.read(1) == b""
    finally:
        s.close()
    assert serve_stats.snapshot()["stream_errors"] >= 1


def test_stream_sse_terminal_event(serve_instance):
    """Accept: text/event-stream flips the stream to SSE framing and
    the terminal surfaces as an ``event: error`` SSE event."""

    @serve.deployment
    class Gen:
        def __call__(self, n):
            yield {"i": 0}
            raise RuntimeError("dead")

    serve.run(Gen.bind())
    s = _connect()
    try:
        s.sendall(_post("Gen", 1, headers=("Accept: text/event-stream",)))
        f = s.makefile("rb")
        status, hdrs = _read_stream_head(f)
        assert status == 200
        assert hdrs["content-type"] == "text/event-stream"
        chunks = list(_iter_chunks(f))
        assert chunks[0].startswith(b"data: ")
        assert chunks[-1].startswith(b"event: error\ndata: ")
        term = json.loads(chunks[-1].split(b"data: ", 1)[1])
        assert term["terminal"] is True and term["error_type"] == \
            "RuntimeError"
    finally:
        s.close()


def test_chaos_kill_mid_stream_surfaces_typed_terminal(serve_instance):
    """ACCEPTANCE: a replica killed mid-stream NEVER truncates
    silently — the client sees a typed terminal event naming a
    death-taxonomy error within seconds, and serve gauges return to
    baseline afterwards."""

    @serve.deployment(num_replicas=1)
    class Gen:
        def __call__(self, n):
            yield {"i": 0}
            for i in range(1, n):
                time.sleep(0.2)
                yield {"i": i}

        def pid(self):
            return os.getpid()

    serve.run(Gen.bind())
    victim = serve._controller._deployments["Gen"].replicas[0]
    s = _connect()
    try:
        s.sendall(_post("Gen", 200, stream=True))
        f = s.makefile("rb")
        status, _hdrs = _read_stream_head(f)
        assert status == 200
        it = _iter_chunks(f)
        first = json.loads(next(it))
        assert first == {"i": 0}        # stream provably live
        ray_tpu_torch.kill(victim)
        t0 = time.monotonic()
        term = None
        for blob in it:                 # remaining items, then terminal
            rec = json.loads(blob)
            if rec.get("terminal"):
                term = rec
                break
        took = time.monotonic() - t0
        assert term is not None, "stream ended without a terminal record"
        assert took < 5.0, f"terminal took {took:.1f}s"
        assert term["error_type"] in (
            "ActorDiedError", "ActorUnavailableError",
            "WorkerCrashedError", "OwnerDiedError", "ObjectLostError"), term
    finally:
        s.close()
    assert serve_stats.snapshot()["stream_errors"] >= 1
    assert_serve_settled("Gen", timeout=20)


def test_client_disconnect_mid_stream_releases_refs(serve_instance):
    """A client that walks away mid-stream must not leak: the parked
    readiness callbacks drain, the stream's promise/item refs release,
    and the deployment's gauges return to baseline."""

    @serve.deployment(num_replicas=1)
    class Gen:
        def __call__(self, n):
            for i in range(n):
                time.sleep(0.05)
                yield {"i": i}

    serve.run(Gen.bind())
    from ray_tpu_torch._private.worker import global_worker
    w = global_worker()
    s = _connect()
    s.sendall(_post("Gen", 40, stream=True))
    f = s.makefile("rb")
    status, _hdrs = _read_stream_head(f)
    assert status == 200
    first = json.loads(next(_iter_chunks(f)))
    assert first == {"i": 0}
    s.close()                           # walk away mid-stream

    def _parked_drained() -> bool:
        with w._ready_cb_lock:
            return len(w._ready_callbacks) == 0

    assert_serve_settled(
        "Gen", timeout=30,
        extra_probes=[("parked ready-callbacks == 0", _parked_drained)])


def test_first_token_gauge_populated(serve_instance):
    @serve.deployment
    class Gen:
        def __call__(self, n):
            for i in range(n):
                yield i

    serve.run(Gen.bind())
    s = _connect()
    try:
        s.sendall(_post("Gen", 3, stream=True))
        f = s.makefile("rb")
        status, _hdrs = _read_stream_head(f)
        assert status == 200
        assert [json.loads(c) for c in _iter_chunks(f)] == [0, 1, 2]
    finally:
        s.close()
    assert serve_stats.first_token_ms() > 0.0
    assert serve_stats.snapshot()["streams"] >= 1
    assert serve_stats.snapshot()["stream_items"] >= 3
    from ray_tpu_torch.util import metrics
    line = [ln for ln in metrics.prometheus_text().splitlines()
            if ln.startswith("ray_tpu_serve_first_token_ms")]
    assert line and float(line[0].split()[-1]) > 0.0


# ---------------------------------------------------------------------------
# threaded backend keeps the same typed contracts

def test_threaded_backend_stream_typed_terminal(serve_instance):
    """The legacy thread-per-request backend (serve_http_ingress=
    threaded) emits the SAME typed terminal record and closes the
    connection — no anonymous {"error": ...} chunk."""
    from ray_tpu_torch.serve._private.http_proxy import HttpProxy

    @serve.deployment
    class Gen:
        def __call__(self, n):
            yield {"i": 0}
            raise ValueError("threaded boom")

    serve.run(Gen.bind())
    proxy = HttpProxy(serve._controller, backend="threaded")
    try:
        host, port = proxy.address
        s = socket.create_connection((host, port), timeout=30)
        try:
            s.sendall(_post("Gen", 1, stream=True))
            f = s.makefile("rb")
            status, hdrs = _read_stream_head(f)
            assert status == 200
            records = [json.loads(c) for c in _iter_chunks(f)]
            assert records[0] == {"i": 0}
            term = records[-1]
            assert term["terminal"] is True
            assert term["error_type"] == "ValueError"
            assert f.read(1) == b""     # errored stream closes the conn
        finally:
            s.close()
        assert serve_stats.snapshot()["stream_errors"] >= 1
    finally:
        proxy.shutdown()


def test_threaded_backend_typed_unary_errors(serve_instance):
    from ray_tpu_torch.serve._private.http_proxy import HttpProxy

    @serve.deployment
    class Boom:
        def __call__(self, x):
            raise KeyError("missing")

    serve.run(Boom.bind())
    proxy = HttpProxy(serve._controller, backend="threaded")
    try:
        host, port = proxy.address
        s = socket.create_connection((host, port), timeout=30)
        try:
            s.sendall(_post("Boom", 1))
            status, hdrs, body = _read_response(s.makefile("rb"))
            assert status == 500
            assert hdrs["x-rtpu-error-type"] == "KeyError"
            assert json.loads(body)["error_type"] == "KeyError"
        finally:
            s.close()
    finally:
        proxy.shutdown()
