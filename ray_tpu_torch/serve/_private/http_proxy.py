"""HTTP ingress: in-driver (test) and worker-hosted (deployable).

Reference: ``python/ray/serve/_private/proxy.py`` (uvicorn/starlette
proxy actors, streaming responses over chunked transfer) [UNVERIFIED —
mount empty, SURVEY.md §0].

Two placements share one server backend (the ``serve_http_ingress``
knob picks it: ``async`` — the event-loop ingress in ``ingress.py``,
the default — or ``threaded`` — the stdlib thread-per-request server
defined here, kept for comparison benchmarks and as an escape hatch):

- ``HttpProxy``: ingress in the driver process — zero-setup for tests
  and notebooks.
- ``ProxyActor``: the same ingress hosted in a WORKER process (the
  reference's proxy-actor topology): HTTP parsing/serialization runs
  off the driver's threads, and the controller pushes route-table
  updates to it as replica membership changes.

Overload (docs/serve.md): a shed at the router — the deployment's
queue hit ``max_queued_requests`` — surfaces as the PR-3
``BackpressureError``; the handler maps it to **503 + Retry-After**
so well-behaved clients back off instead of hammering a saturated
tier.

Shutdown is deterministic: both placements count in-flight requests
and ``shutdown``/``prepare_shutdown`` stop the listener, then wait
(bounded) for that count to drain before closing the socket — an
in-flight request races neither the socket teardown nor (for the
worker proxy) the ``ray_tpu_torch.kill``.

Streaming: ``POST /<deployment>?stream=1`` (or the
``X-RTPU-Stream: 1`` header / ``Accept: text/event-stream``) responds
with chunked transfer encoding — one JSON line per yielded item,
written as the replica produces them.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class _CountingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that tracks in-flight request handlers so
    shutdown can drain them deterministically."""

    daemon_threads = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    def request_entered(self) -> None:
        with self._inflight_lock:
            self._inflight += 1

    def request_left(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def drain(self, timeout_s: float = 10.0) -> int:
        """Stop accepting, then wait (bounded) for in-flight handlers
        to finish. Returns the count still running at the deadline
        (0 = fully drained)."""
        self.shutdown()           # serve_forever exits; no new accepts
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.inflight() == 0:
                return 0
            time.sleep(0.02)
        return self.inflight()


def _make_handler(get_replica_set: Callable[[str], Optional[object]],
                  status_fn: Callable[[], dict]):
    """One handler class over any route-table source (controller in the
    driver, pushed table in a proxy worker)."""
    import ray_tpu_torch
    from ray_tpu_torch._private import serve_stats
    from ray_tpu_torch.serve._private.ingress import (
        classify_error,
        terminal_record,
    )

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # NOTE: no socket timeout — it would also reset a slow client
        # mid-upload. Idle keep-alive handler threads are daemon and
        # do not count as in-flight (only active processing does), so
        # the shutdown drain never waits on them.

        def log_message(self, *a):  # noqa: ANN002 - silence stdlib
            pass

        def do_POST(self):  # noqa: N802 - stdlib naming
            # count only ACTIVE processing (not keep-alive idling
            # between requests): the drain in shutdown() waits on this
            self.server.request_entered()
            try:
                self._do_post_inner()
            finally:
                self.server.request_left()

        def do_GET(self):  # noqa: N802
            self.server.request_entered()
            try:
                self._do_get_inner()
            finally:
                self.server.request_left()

        def _wants_stream(self) -> bool:
            if "stream=1" in (self.path.partition("?")[2] or ""):
                return True
            if self.headers.get("X-RTPU-Stream") == "1":
                return True
            return "text/event-stream" in self.headers.get("Accept", "")

        def _send_typed_error(self, e: Exception) -> None:
            """Typed error mapping, shared with the async ingress
            (docs/serve.md §Ingress): overload → 503 + Retry-After
            (router backoff hint), replica/worker death → 502, other
            exceptions → 500 — every branch names the taxonomy class
            in ``X-RTPU-Error-Type`` instead of erasing it into an
            anonymous ``send_error(500)``."""
            status, reason, extra, body = classify_error(e)
            blob = json.dumps(body).encode()
            self.send_response(status, reason)
            for k, v in extra:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _do_post_inner(self):
            path = self.path.partition("?")[0]
            name = path.strip("/").split("/")[0]
            replica_set = get_replica_set(name)
            if replica_set is None:
                self.send_error(404, f"no deployment {name!r}")
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            ctype = self.headers.get("Content-Type", "")
            try:
                if "json" in ctype and body:
                    args = (json.loads(body),)
                elif body:
                    args = (body,)
                else:
                    args = ()
                if self._wants_stream():
                    self._stream_response(replica_set, args)
                    return
                ref = replica_set.assign("__call__", args, {})
                result = ray_tpu_torch.get(ref, timeout=120)
            except Exception as e:  # noqa: BLE001 - typed mapping
                self._send_typed_error(e)
                return
            blob = json.dumps(result, default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _stream_response(self, replica_set, args) -> None:
            """Chunked transfer: one JSON line per streamed item,
            flushed as the replica yields it — the client reads items
            before the producer finishes. A mid-stream failure (user
            exception, replica death) ends the stream with a TYPED
            terminal record — ``error_type`` carries the taxonomy
            class, ``terminal: true`` marks it unambiguous — then the
            chunked terminator, and the connection closes so the
            client never mistakes truncation for success."""
            gen = replica_set.assign("__call__", args, {}, stream=True)
            serve_stats.incr("streams")
            sse = "text/event-stream" in self.headers.get("Accept", "")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/event-stream" if sse
                             else "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(blob: bytes) -> None:
                self.wfile.write(f"{len(blob):x}\r\n".encode()
                                 + blob + b"\r\n")
                self.wfile.flush()

            t0, n = time.monotonic(), 0
            try:
                try:
                    for ref in gen:
                        item = ray_tpu_torch.get(ref, timeout=120)
                        n += 1
                        if n == 1:
                            serve_stats.observe_first_token(
                                (time.monotonic() - t0) * 1e3)
                        serve_stats.incr("stream_items")
                        blob = json.dumps(item, default=str).encode()
                        if sse:
                            chunk(b"data: " + blob + b"\n\n")
                        else:
                            chunk(blob + b"\n")
                except Exception as e:  # noqa: BLE001 - typed terminal
                    serve_stats.incr("stream_errors")
                    blob = json.dumps(terminal_record(e)).encode()
                    if sse:
                        chunk(b"event: error\ndata: " + blob + b"\n\n")
                    else:
                        chunk(blob + b"\n")
                    self.close_connection = True
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except OSError:
                # client went away mid-stream: drop the generator (its
                # remaining refs release with it) and end the handler
                self.close_connection = True

        def _do_get_inner(self):
            if self.path.rstrip("/") in ("", "/-", "/-/routes"):
                blob = json.dumps(status_fn()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)
            else:
                self._do_post_inner()

    return _Handler


def _resolve_backend(backend: Optional[str]) -> str:
    """``async`` (event-loop ingress, the default) or ``threaded``
    (stdlib thread-per-request, kept for comparison benchmarks and as
    an escape hatch via the ``serve_http_ingress`` knob)."""
    if backend is None:
        from ray_tpu_torch._private.config import get_config
        backend = get_config().serve_http_ingress
    if backend not in ("async", "threaded"):
        raise ValueError(
            f"serve_http_ingress must be 'async' or 'threaded', "
            f"got {backend!r}")
    return backend


class HttpProxy:
    """In-driver ingress (tests/notebooks)."""

    def __init__(self, controller, host: str = "127.0.0.1", port: int = 0,
                 backend: Optional[str] = None):
        self._controller = controller
        self._thread = None
        if _resolve_backend(backend) == "async":
            from ray_tpu_torch.serve._private.ingress import AsyncIngress
            self._server = AsyncIngress(controller.get_replica_set,
                                        controller.status,
                                        host=host, port=port)
            self.address = self._server.address
        else:
            handler = _make_handler(controller.get_replica_set,
                                    controller.status)
            self._server = _CountingHTTPServer((host, port), handler)
            self.address = self._server.server_address
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.1},
                daemon=True, name="rtpu-serve-http")
            self._thread.start()

    def shutdown(self, drain_timeout_s: float = 10.0) -> None:
        """Deterministic teardown: stop accepting, join the listener
        thread, DRAIN in-flight handlers (bounded), then close the
        socket — a request in flight during shutdown gets its response
        instead of a reset socket."""
        try:
            left = self._server.drain(drain_timeout_s)
            if left:
                logger.warning(
                    "http proxy closed with %d requests still in "
                    "flight after %.0fs drain", left, drain_timeout_s)
            if self._thread is not None:
                self._thread.join(timeout=5)
            self._server.server_close()
        except Exception:
            pass    # double-shutdown / already-closed socket


class ProxyActor:
    """Worker-hosted ingress: the HTTP server lives in this actor's
    worker process, so request parsing/serialization never contends
    with the driver's scheduling threads. The controller pushes
    ``update_routes`` whenever a deployment's replica membership
    changes (the pushed ReplicaSet pickles as a snapshot with fresh
    local in-flight counts)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backend: Optional[str] = None):
        self._routes = {}            # name -> ReplicaSet snapshot
        self._lock = threading.Lock()
        self._thread = None
        if _resolve_backend(backend) == "async":
            from ray_tpu_torch.serve._private.ingress import AsyncIngress
            self._server = AsyncIngress(self._get_replica_set,
                                        self._status,
                                        host=host, port=port)
            self._addr = self._server.address
        else:
            handler = _make_handler(self._get_replica_set, self._status)
            self._server = _CountingHTTPServer((host, port), handler)
            self._addr = self._server.server_address
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.1},
                daemon=True, name="rtpu-serve-http-worker")
            self._thread.start()

    def _get_replica_set(self, name: str):
        with self._lock:
            return self._routes.get(name)

    def _status(self) -> dict:
        with self._lock:
            return {name: {"live_replicas": rs.num_replicas(),
                           "ongoing_requests": rs.total_inflight()}
                    for name, rs in self._routes.items()}

    def ongoing(self, name: str) -> int:
        """In-flight requests this proxy currently has against one
        deployment (the controller aggregates these into its
        autoscaling signal — proxy traffic is otherwise invisible to
        the driver-side ReplicaSet)."""
        with self._lock:
            rs = self._routes.get(name)
        return rs.total_inflight() if rs is not None else 0

    def update_routes(self, name: str, replica_set) -> str:
        """Controller push: replace (or drop, when None) one
        deployment's routing snapshot."""
        with self._lock:
            if replica_set is None:
                self._routes.pop(name, None)
            else:
                self._routes[name] = replica_set
        return "ok"

    def prepare_shutdown(self, drain_timeout_s: float = 10.0) -> int:
        """serve.shutdown step 2: stop accepting and drain in-flight
        HTTP requests while replicas are still alive — the subsequent
        ``ray_tpu_torch.kill`` then hits an idle actor, never a request in
        flight. Returns how many handlers were still running at the
        drain deadline (0 = clean)."""
        left = self._server.drain(drain_timeout_s)
        try:
            self._server.server_close()
        except Exception:  # noqa: BLE001
            pass    # socket already closed
        return left

    def address(self):
        return tuple(self._addr)

    def ping(self) -> str:
        return "pong"
