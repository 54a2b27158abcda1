"""Async HTTP ingress: a selector event loop feeding the batched router.

Reference: ``python/ray/serve/_private/proxy.py`` (the dedicated async
proxy — uvicorn/ASGI event loop in front of the router) [UNVERIFIED —
mount empty, SURVEY.md §0]. The stdlib thread-per-request server
(http_proxy.py, kept as the ``threaded`` backend) parks one thread in
a blocking ``get`` per request — at wire speed the front door, not the
router, becomes the bottleneck (ROADMAP open item 3). This module
replaces it with ONE event-loop thread and zero per-request threads:

- **Non-blocking HTTP/1.1** with keep-alive and pipelining: many
  requests ride one connection; responses are written strictly in
  request order per connection (the pipelining contract) no matter
  what order the router completes them in.
- **Promise-ref dispatch**: each parsed request goes through
  ``ReplicaSet.assign_promised`` — the PR-9 batched plane reserves an
  ObjectRef immediately (no admission wait on this thread), and the
  gather layers + PR-7 coalesced frames carry it to a replica.
- **Completion callbacks, not parked threads**: the owner's
  ``on_object_ready`` hook (driver) or one shared wait-poller thread
  (worker-hosted proxy) enqueues finished responses back to the loop.
- **Typed errors end-to-end**: ``SystemOverloadError`` subclasses map
  to 503 + Retry-After, actor/worker-death errors to 502 with the
  taxonomy name in ``X-RTPU-Error-Type``, everything else to 500 with
  the same header — never an anonymous ``send_error(500)``.
- **Streaming without blocking**: items from a replica's streaming
  generator land in the owner's store via the worker stream-reply
  frames; the loop chains readiness callbacks per item (plus the done
  marker) instead of a per-item blocking ``get``. Mid-stream replica
  death surfaces as a TYPED terminal event (SSE ``error`` event /
  ndjson terminal record carrying the taxonomy name) followed by a
  clean chunked terminator — never a silent truncation. First-token
  latency feeds the ``ray_tpu_serve_first_token_ms`` gauge.

Backpressure is structural at every layer: a connection with
``serve_http_pipeline_max`` responses outstanding stops being read
(TCP pushes back on the client); a connection buffering more than
``serve_http_write_buffer_bytes`` outbound pauses its stream's item
consumption until the client drains; the router sheds with
``BackpressureError`` past ``max_queued_requests`` and the loop
answers 503 + Retry-After without ever occupying a worker thread.
"""

from __future__ import annotations

import json
import logging
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from ray_tpu_torch._private import serve_stats
from ray_tpu_torch.exceptions import (
    ActorError,
    BackpressureError,
    ObjectLostError,
    SystemOverloadError,
    TaskError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

# request-head hygiene bounds (parser state stays finite even against
# a hostile or broken client)
_MAX_HEAD_BYTES = 65536
_MAX_BODY_BYTES = 1 << 30

_WANT_HDRS = (b"content-length", b"content-type", b"accept",
              b"connection", b"x-rtpu-stream", b"expect")

# The ingress boundary contract, as one literal the error-flow pass
# machine-checks both ways (docs/static_analysis.md §14): every key
# must name a taxonomy class, and every shippable taxonomy class must
# resolve to a row via its base chain. Semantics: overload → 503
# (retryable with a Retry-After hint), replica/worker death → 502
# (bad gateway: the tier behind the ingress failed; a fresh request
# may well succeed on a replacement), anything else → 500. The
# `RayTpuError` row is the base-chain catch-all that keeps the table
# closed over future taxonomy classes.
_HTTP_STATUS_BY_TAXONOMY = {
    "SystemOverloadError": 503,
    "ActorError": 502,
    "WorkerCrashedError": 502,
    "ObjectLostError": 502,
    "RayTpuError": 500,
}

# replica/worker-death taxonomy (the 502 rows above, plus the builtin
# ConnectionError, which is not a taxonomy class and so cannot sit in
# the table): kept as a tuple for the isinstance classification.
_DEATH_ERRORS = (ActorError, WorkerCrashedError, ObjectLostError,
                 ConnectionError)


def _status_for(e: BaseException) -> int:
    """Resolve the response status through the taxonomy table by base
    chain — the runtime twin of the error-flow pass's static walk."""
    for klass in type(e).__mro__:
        if klass.__name__ == "RayTpuError":
            # catch-all row: defer past the builtin check, so an
            # `as_instanceof_cause` derivative of a user-defined
            # ConnectionError still classifies as replica death
            break
        status = _HTTP_STATUS_BY_TAXONOMY.get(klass.__name__)
        if status is not None:
            return status
    if isinstance(e, ConnectionError):
        return 502
    return _HTTP_STATUS_BY_TAXONOMY["RayTpuError"]


# ---------------------------------------------------------------------------
# shared error mapping (both ingress backends)

def _type_name(e: BaseException) -> str:
    """The USER-FACING exception class name: a TaskError (or an
    ``as_instanceof_cause`` derivative, whose synthetic class is named
    ``TaskError_KeyError``) reports its cause's class."""
    if isinstance(e, TaskError) and e.cause is not None:
        return type(e.cause).__name__
    return type(e).__name__


def _detail(e: BaseException) -> str:
    """Short human-readable message: the cause's own message for task
    errors (str(TaskError) is a full traceback), capped at 500."""
    if isinstance(e, TaskError) and e.cause is not None:
        return str(e.cause)[:500]
    return str(e)[:500]


def classify_error(e: BaseException):
    """Map an exception to ``(status, reason, extra_headers, body)``
    preserving the PR-2/3/4 taxonomy instead of erasing it into a
    bare 500: overload → 503 + Retry-After (router backoff hint),
    replica/worker death → 502, anything else → 500; every branch
    carries the taxonomy name in ``X-RTPU-Error-Type``."""
    if isinstance(e, TaskError) and e.cause is not None:
        e = e.as_instanceof_cause()
    name = _type_name(e)
    status = _status_for(e)
    if status == 503 and isinstance(e, SystemOverloadError):
        retry_after = max(1, int(round(
            getattr(e, "backoff_s", 0.0) or 1.0)))
        body = {"error": ("backpressure" if isinstance(e, BackpressureError)
                          else "overload"),
                "error_type": name,
                "retryable": bool(getattr(e, "retryable", True)),
                "detail": _detail(e)}
        return (503, "Service Unavailable",
                [("Retry-After", str(retry_after)),
                 ("X-RTPU-Error-Type", name)], body)
    if status == 502 and isinstance(e, _DEATH_ERRORS):
        body = {"error": "replica_failure", "error_type": name,
                "retryable": True, "detail": _detail(e)}
        return (502, "Bad Gateway", [("X-RTPU-Error-Type", name)], body)
    body = {"error": "internal", "error_type": name,
            "detail": _detail(e)}
    return (500, "Internal Server Error",
            [("X-RTPU-Error-Type", name)], body)


def terminal_record(e: BaseException) -> dict:
    """The TYPED terminal record for a stream that dies mid-flight:
    carries the taxonomy name so clients can distinguish a retryable
    replica death from a user exception — instead of an anonymous
    ``{"error": ...}`` chunk after a 200."""
    if isinstance(e, TaskError) and e.cause is not None:
        e = e.as_instanceof_cause()
    return {"error": _detail(e),
            "error_type": _type_name(e),
            "retryable": bool(getattr(e, "retryable", False)),
            "terminal": True}


# ---------------------------------------------------------------------------
# response rendering

_RESP200 = (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/json\r\nContent-Length: ")


def _render(status: int, reason: str, blob: bytes, keep_alive: bool,
            extra: List[Tuple[str, str]] = ()) -> bytes:
    if status == 200 and not extra:
        tail = (b"\r\n\r\n" if keep_alive
                else b"\r\nConnection: close\r\n\r\n")
        return _RESP200 + str(len(blob)).encode() + tail + blob
    head = [f"HTTP/1.1 {status} {reason}".encode(),
            b"Content-Type: application/json",
            b"Content-Length: " + str(len(blob)).encode()]
    for k, v in extra:
        head.append(f"{k}: {v}".encode())
    if not keep_alive:
        head.append(b"Connection: close")
    return b"\r\n".join(head) + b"\r\n\r\n" + blob


def _render_error(e: BaseException, keep_alive: bool) -> bytes:
    status, reason, extra, body = classify_error(e)
    return _render(status, reason, json.dumps(body).encode(),
                   keep_alive, extra)


def _chunk(blob: bytes) -> bytes:
    return f"{len(blob):x}\r\n".encode() + blob + b"\r\n"


_CHUNK_END = b"0\r\n\r\n"

_STREAM_HEAD_NDJSON = (b"HTTP/1.1 200 OK\r\n"
                       b"Content-Type: application/x-ndjson\r\n"
                       b"Transfer-Encoding: chunked\r\n\r\n")
_STREAM_HEAD_SSE = (b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: text/event-stream\r\n"
                    b"Cache-Control: no-cache\r\n"
                    b"Transfer-Encoding: chunked\r\n\r\n")


def _item_event(value, sse: bool) -> bytes:
    blob = json.dumps(value, default=str).encode()
    if sse:
        return _chunk(b"data: " + blob + b"\n\n")
    return _chunk(blob + b"\n")


def _terminal_event(e: BaseException, sse: bool) -> bytes:
    blob = json.dumps(terminal_record(e)).encode()
    if sse:
        return _chunk(b"event: error\ndata: " + blob + b"\n\n")
    return _chunk(blob + b"\n")


# ---------------------------------------------------------------------------
# connection / request state

_PENDING, _READY, _STREAM, _DEAD = 0, 1, 2, 3


class _Req:
    __slots__ = ("method", "target", "clen", "ctype", "accept",
                 "keep_alive", "stream", "sse", "expect_continue")


class _Slot:
    """One pipelined request's response slot. Slots resolve in any
    order; ``_pump`` writes them back strictly in request order."""

    __slots__ = ("state", "keep_alive", "data", "t0", "ref", "cb",
                 "stream", "head", "sbuf", "attached", "stream_done",
                 "close_after", "accounted", "cancelled")

    def __init__(self, keep_alive: bool):
        self.state = _PENDING
        self.keep_alive = keep_alive
        self.data = b""
        self.t0 = time.monotonic()
        self.ref = None           # promise ref (held until resolved)
        self.cb = None            # driver-mode readiness callback
        self.stream = None        # _StreamState when streaming
        self.head = b""           # stream response head (status+hdrs)
        self.sbuf = bytearray()   # stream chunks before head-of-line
        self.attached = False     # stream head+chunks moved to wbuf
        self.stream_done = False
        self.close_after = False
        self.accounted = True     # counted in the server's _active
        self.cancelled = False    # worker-mode stream thread signal


class _StreamState:
    __slots__ = ("task_id", "done_ref", "i", "t0", "sse", "waiting",
                 "paused", "finished", "discard")

    def __init__(self, task_id, done_ref, sse: bool):
        self.task_id = task_id
        self.done_ref = done_ref
        self.i = 0                # items consumed so far
        self.t0 = time.monotonic()
        self.sse = sse
        self.waiting = None       # ((oids...), cb) pending readiness
        self.paused = False       # write buffer above high-water mark
        self.finished = False
        self.discard = False      # client gone: drain without writing


class _Conn:
    __slots__ = ("sock", "addr", "rbuf", "wbuf", "slots", "cur",
                 "body_need", "closed", "paused_read",
                 "close_after_write", "registered")

    def __init__(self, sock, addr):
        self.sock = sock
        self.addr = addr
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        # response slots in request order
        # unbounded-ok: parsing stops (and the socket stops being
        # read) once len(slots) reaches serve_http_pipeline_max, so
        # depth is capped by that knob
        self.slots: deque = deque()
        self.cur: Optional[_Req] = None
        self.body_need: Optional[int] = None
        self.closed = False
        self.paused_read = False
        self.close_after_write = False
        self.registered = False


class AsyncIngress:
    """The event-loop HTTP server. One loop thread owns every socket
    and all connection state; other threads (completion callbacks,
    the worker-mode poller) only append to ``_ready`` and wake the
    loop through a socketpair."""

    def __init__(self, get_replica_set: Callable[[str], object],
                 status_fn: Callable[[], dict],
                 host: str = "127.0.0.1", port: int = 0):
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch._private.worker import global_worker
        cfg = get_config()
        self._get_replica_set = get_replica_set
        self._status_fn = status_fn
        self._worker = global_worker()
        # driver: owner-store readiness hooks; worker-hosted proxy:
        # a NestedClient (wait/get RPCs) — one poller thread instead
        self._driver_mode = hasattr(self._worker, "on_object_ready")
        self._pipeline_max = max(1, cfg.serve_http_pipeline_max)
        self._write_hw = max(65536, cfg.serve_http_write_buffer_bytes)
        self._req_timeout = cfg.serve_http_request_timeout_s

        self._sel = selectors.DefaultSelector()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(256)
        self._lsock.setblocking(False)
        self.address = self._lsock.getsockname()
        self._sel.register(self._lsock, selectors.EVENT_READ, "listen")

        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")

        self._ready_lock = threading.Lock()
        # completion events from callbacks / the poller, drained by
        # the loop every iteration
        # unbounded-ok: one entry per admitted in-flight request (or
        # stream step) — admission is bounded by the router's
        # max_queued_requests shed and the per-connection pipeline cap
        self._ready: deque = deque()    # guarded-by: _ready_lock
        self._wake_sent = False         # guarded-by: _ready_lock

        self._conns: set = set()
        self._draining_streams: set = set()   # discard-drain slots
        self._active = 0        # unresolved response slots (drain())
        self._draining = False
        self._shutdown = False
        self._last_sweep = time.monotonic()

        # worker-hosted proxy: pending unary refs polled by ONE
        # shared thread (w.wait), never a thread per request
        self._poll_lock = threading.Lock()
        self._poll_entries = {}         # guarded-by: _poll_lock
        self._poll_evt = threading.Event()
        self._poller: Optional[threading.Thread] = None

        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="rtpu-serve-ingress")
        self._thread.start()

    # -- cross-thread signalling ---------------------------------------

    def _push(self, item) -> None:
        with self._ready_lock:
            self._ready.append(item)
            need_wake = not self._wake_sent
            self._wake_sent = True
        if need_wake:
            try:
                self._wake_w.send(b"\x01")
            except OSError:
                pass    # loop already tearing down

    # -- event loop ----------------------------------------------------

    def _loop(self) -> None:
        # no-deadline: daemon service loop — bounded by the _shutdown
        # flag (server_close) and the select timeout below
        while not self._shutdown:
            try:
                events = self._sel.select(timeout=0.5)
            except OSError:
                break
            for key, mask in events:
                data = key.data
                if data == "listen":
                    self._accept()
                elif data == "wake":
                    self._drain_wake()
                else:
                    conn = data
                    if mask & selectors.EVENT_WRITE and not conn.closed:
                        self._flush(conn)
                    if mask & selectors.EVENT_READ and not conn.closed:
                        self._on_readable(conn)
            self._drain_ready()
            now = time.monotonic()
            if self._draining and self._lsock is not None:
                self._close_listener()
            if now - self._last_sweep >= 1.0:
                self._sweep(now)
        # teardown: close everything owned by the loop
        self._close_listener()
        for conn in list(self._conns):
            self._close_conn(conn)
        try:
            self._sel.close()
        except Exception:  # noqa: BLE001
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _close_listener(self) -> None:
        if self._lsock is None:
            return
        try:
            self._sel.unregister(self._lsock)
        except (KeyError, ValueError):
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        self._lsock = None

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            return
        with self._ready_lock:
            self._wake_sent = False

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self._draining:
                sock.close()
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, addr)
            self._conns.add(conn)
            self._sel.register(sock, selectors.EVENT_READ, conn)
            conn.registered = True

    def _update_events(self, conn: _Conn) -> None:
        if conn.closed:
            return
        mask = 0
        if not conn.paused_read:
            mask |= selectors.EVENT_READ
        if conn.wbuf:
            mask |= selectors.EVENT_WRITE
        if mask == 0:
            if conn.registered:
                try:
                    self._sel.unregister(conn.sock)
                except (KeyError, ValueError):
                    pass
                conn.registered = False
            return
        if conn.registered:
            self._sel.modify(conn.sock, mask, conn)
        else:
            self._sel.register(conn.sock, mask, conn)
            conn.registered = True

    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        self._conns.discard(conn)
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.registered = False
        try:
            conn.sock.close()
        except OSError:
            pass
        # release every outstanding slot: pending unary requests drop
        # their promise ref + readiness hook (the router still
        # resolves the promise exactly once; the value is freed on
        # ref-zero); streams flip to discard-drain so their items and
        # done marker are consumed and released through the normal
        # machinery (no parked refs, gauges return to baseline)
        for slot in conn.slots:
            self._uncount(slot)
            slot.cancelled = True
            if slot.state == _PENDING:
                self._release_pending(slot)
                slot.state = _DEAD
            elif slot.state == _STREAM and not slot.stream_done:
                st = slot.stream
                if st is not None and not st.finished:
                    st.discard = True
                    self._draining_streams.add(slot)
                    if self._driver_mode and st.waiting is None:
                        self._advance_stream(conn, slot)
        conn.slots.clear()
        conn.rbuf.clear()
        conn.wbuf.clear()

    def _uncount(self, slot: _Slot) -> None:
        if slot.accounted:
            slot.accounted = False
            self._active -= 1

    def _release_pending(self, slot: _Slot) -> None:
        """Drop a pending unary slot's completion hook and ref."""
        if slot.ref is not None:
            if self._driver_mode and slot.cb is not None:
                self._worker.discard_object_ready(slot.ref.id(), slot.cb)
            elif not self._driver_mode:
                with self._poll_lock:
                    self._poll_entries.pop(slot.ref.id(), None)
        slot.ref = None
        slot.cb = None

    # -- reading / parsing ---------------------------------------------

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(262144)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        conn.rbuf += data
        self._parse(conn)
        self._update_events(conn)

    def _parse(self, conn: _Conn) -> None:
        # a consumed-prefix cursor instead of del-per-request: a recv
        # chunk carrying hundreds of pipelined requests is trimmed
        # ONCE on exit, not shifted per request (that rewrite-per-
        # request was quadratic in the chunk and dominated the loop)
        pos = 0
        try:
            while not conn.closed and not conn.close_after_write:
                if len(conn.slots) >= self._pipeline_max:
                    # pipeline cap: stop reading — TCP backpressure
                    # does the rest; _pump resumes once responses drain
                    conn.paused_read = True
                    return
                if conn.body_need is not None:
                    if len(conn.rbuf) - pos < conn.body_need:
                        return
                    body = bytes(conn.rbuf[pos:pos + conn.body_need])
                    pos += conn.body_need
                    req, conn.cur, conn.body_need = conn.cur, None, None
                    self._handle(conn, req, body)
                    continue
                idx = conn.rbuf.find(b"\r\n\r\n", pos)
                if idx < 0:
                    if len(conn.rbuf) - pos > _MAX_HEAD_BYTES:
                        self._reject(conn, 431,
                                     "Request Header Fields Too Large")
                    return
                head = bytes(conn.rbuf[pos:idx])
                pos = idx + 4
                req = self._parse_head(conn, head)
                if req is None:
                    return
                if req.expect_continue:
                    conn.wbuf += b"HTTP/1.1 100 Continue\r\n\r\n"
                    self._flush(conn)
                if req.clen:
                    if req.clen > _MAX_BODY_BYTES:
                        self._reject(conn, 413, "Payload Too Large")
                        return
                    conn.cur, conn.body_need = req, req.clen
                else:
                    self._handle(conn, req, b"")
        finally:
            if pos and not conn.closed:
                del conn.rbuf[:pos]

    def _parse_head(self, conn: _Conn, head: bytes) -> Optional[_Req]:
        lines = head.split(b"\r\n")
        parts = lines[0].split(None, 2)
        if len(parts) < 3:
            self._reject(conn, 400, "Bad Request")
            return None
        req = _Req()
        req.method, req.target, version = parts[0], parts[1], parts[2]
        hdrs = {}
        for ln in lines[1:]:
            k, _, v = ln.partition(b":")
            k = k.strip().lower()
            if k in _WANT_HDRS:
                hdrs[k] = v.strip()
        try:
            req.clen = int(hdrs.get(b"content-length", 0))
        except ValueError:
            self._reject(conn, 400, "Bad Request")
            return None
        req.ctype = hdrs.get(b"content-type", b"")
        req.accept = hdrs.get(b"accept", b"")
        conn_h = hdrs.get(b"connection", b"").lower()
        if version.startswith(b"HTTP/1.1"):
            req.keep_alive = conn_h != b"close"
        else:
            req.keep_alive = conn_h == b"keep-alive"
        query = req.target.partition(b"?")[2]
        req.sse = b"text/event-stream" in req.accept
        req.stream = (b"stream=1" in query
                      or hdrs.get(b"x-rtpu-stream") == b"1"
                      or req.sse)
        req.expect_continue = \
            hdrs.get(b"expect", b"").lower() == b"100-continue"
        return req

    def _reject(self, conn: _Conn, status: int, reason: str) -> None:
        blob = json.dumps({"error": reason}).encode()
        conn.wbuf += _render(status, reason, blob, False)
        conn.close_after_write = True
        conn.rbuf.clear()
        self._flush(conn)

    # -- request handling ----------------------------------------------

    def _handle(self, conn: _Conn, req: _Req, body: bytes) -> None:
        slot = _Slot(req.keep_alive)
        conn.slots.append(slot)
        self._active += 1
        path = req.target.partition(b"?")[0]
        if req.method == b"GET" and path.rstrip(b"/") in (b"", b"/-",
                                                          b"/-/routes"):
            blob = json.dumps(self._status_fn()).encode()
            self._set_ready(conn, slot,
                            _render(200, "OK", blob, slot.keep_alive))
            return
        name = path.strip(b"/").split(b"/")[0].decode("latin-1")
        replica_set = self._get_replica_set(name)
        if replica_set is None:
            blob = json.dumps({"error": f"no deployment {name!r}"}).encode()
            self._set_ready(conn, slot, _render(404, "Not Found", blob,
                                                slot.keep_alive))
            return
        try:
            if body and b"json" in req.ctype:
                args = (json.loads(body),)
            elif body:
                args = (body,)
            else:
                args = ()
        except ValueError:
            blob = json.dumps({"error": "invalid JSON body"}).encode()
            self._set_ready(conn, slot, _render(400, "Bad Request", blob,
                                                slot.keep_alive))
            return
        if req.stream:
            self._start_stream(conn, slot, replica_set, args, req.sse)
            return
        try:
            if len(args) == 1:
                # the batched promise plane — also for undecorated
                # methods (handle_request_batch isolates per-item
                # errors); never blocks this thread
                ref = replica_set.assign_promised("__call__", args[0])
            else:
                ref = replica_set.assign("__call__", args, {},
                                         nowait=True)
        except Exception as e:  # noqa: BLE001 - typed mapping
            self._set_ready(conn, slot,
                            _render_error(e, slot.keep_alive))
            return
        slot.ref = ref
        if self._driver_mode:
            def _cb(_oid, c=conn, s=slot, r=ref):
                self._push(("resp", c, s, r))

            slot.cb = _cb
            self._worker.on_object_ready(ref.id(), _cb)
        else:
            self._poll_add(ref, conn, slot)

    def _set_ready(self, conn: _Conn, slot: _Slot, data: bytes,
                   pump: bool = True) -> None:
        if slot.state == _DEAD:
            return
        slot.data = data
        slot.state = _READY
        if pump and not conn.closed:
            self._pump(conn)

    # -- ordered response writing (the pipelining contract) ------------

    def _pump(self, conn: _Conn) -> None:
        slots = conn.slots
        while slots:
            s = slots[0]
            if s.state == _READY:
                conn.wbuf += s.data
                s.data = b""
                self._uncount(s)
                if not s.keep_alive:
                    conn.close_after_write = True
                slots.popleft()
                continue
            if s.state == _DEAD:
                slots.popleft()
                continue
            if s.state == _STREAM:
                if not s.attached:
                    conn.wbuf += s.head
                    conn.wbuf += s.sbuf
                    s.head, s.sbuf = b"", bytearray()
                    s.attached = True
                if s.stream_done:
                    self._uncount(s)
                    if s.close_after or not s.keep_alive:
                        conn.close_after_write = True
                    slots.popleft()
                    continue
                break   # live stream holds the line; chunks append
            break       # head-of-line response still pending
        if conn.paused_read and len(slots) < self._pipeline_max \
                and not conn.close_after_write:
            conn.paused_read = False
            self._parse(conn)
        self._flush(conn)

    def _flush(self, conn: _Conn) -> None:
        if conn.closed:
            return
        if conn.wbuf:
            try:
                n = conn.sock.send(conn.wbuf)
            except (BlockingIOError, InterruptedError):
                n = 0
            except OSError:
                self._close_conn(conn)
                return
            if n:
                del conn.wbuf[:n]
        if not conn.wbuf:
            if conn.close_after_write:
                self._close_conn(conn)
                return
            self._resume_streams(conn)
        self._update_events(conn)

    def _buffered(self, conn: _Conn, slot: _Slot) -> int:
        return len(conn.wbuf) + len(slot.sbuf)

    def _resume_streams(self, conn: _Conn) -> None:
        for slot in list(conn.slots):
            st = slot.stream
            if (slot.state == _STREAM and st is not None and st.paused
                    and not st.finished):
                if self._driver_mode:
                    self._advance_stream(conn, slot)
        # worker-mode stream threads re-check the buffer themselves

    # -- completion drain ----------------------------------------------

    def _drain_ready(self) -> None:
        while True:
            with self._ready_lock:
                if not self._ready:
                    return
                batch = self._ready
                # unbounded-ok: swap target for the bounded _ready
                # deque above — same per-in-flight-request bound
                self._ready = deque()
            # a completion WAVE (one batched dispatch resolving
            # hundreds of promise refs) marks every slot first, then
            # pumps each touched connection ONCE — one ordered walk +
            # one send() per connection per wave, not per response.
            # Driver mode also materializes the wave's values with ONE
            # store snapshot (get_ready) instead of a get() per ref.
            touched = set()
            entries = {}
            if self._driver_mode:
                oids = [it[3].id() for it in batch if it[0] == "resp"]
                if oids:
                    entries = self._worker.memory_store.get_ready(oids)
            for item in batch:
                kind = item[0]
                if kind == "resp":    # driver: ref ready in owner store
                    _, conn, slot, ref = item
                    entry = entries.get(ref.id())
                    if entry is None:
                        self._finish_unary(conn, slot, ref=ref)
                    else:
                        self._finish_entry(conn, slot, ref, entry)
                    touched.add(conn)
                elif kind == "val":   # worker poller: value landed
                    _, conn, slot, value = item
                    self._finish_unary(conn, slot, value=value)
                    touched.add(conn)
                elif kind == "err":
                    _, conn, slot, e = item
                    self._finish_unary(conn, slot, error=e)
                    touched.add(conn)
                elif kind == "adv":   # driver stream: item/done landed
                    _, conn, slot = item
                    st = slot.stream
                    if st is not None and not st.finished:
                        self._advance_stream(conn, slot)
                elif kind == "schunk":  # worker stream thread: one item
                    _, conn, slot, value = item
                    self._stream_emit(conn, slot, value)
                elif kind == "sdone":   # worker stream thread: terminal
                    _, conn, slot, e = item
                    self._finish_stream(conn, slot, e)
            for conn in touched:
                if not conn.closed:
                    self._pump(conn)

    def _finish_entry(self, conn: _Conn, slot: _Slot, ref, entry) -> None:
        """Wave fast path: materialize a snapshotted store entry
        directly; anything unusual (a lost/spilled entry) falls back
        to the full get() machinery."""
        from ray_tpu_torch._private.worker import _LostObjectSignal
        try:
            value = self._worker._entry_value(ref.id(), entry)
        except _LostObjectSignal:
            self._finish_unary(conn, slot, ref=ref)
            return
        except BaseException as e:  # noqa: BLE001 - typed task error
            self._finish_unary(conn, slot, error=e)
            return
        self._finish_unary(conn, slot, value=value)

    def _finish_unary(self, conn: _Conn, slot: _Slot, ref=None,
                      value=None, error=None) -> None:
        if slot.state != _PENDING:
            return      # timed out / connection closed meanwhile
        if ref is not None:
            try:
                # already in the owner's store: returns immediately
                value = self._worker.get([ref], 30)[0]
            except BaseException as e:  # noqa: BLE001 - typed mapping
                error = e
        slot.ref = slot.cb = None
        if error is not None:
            data = _render_error(error, slot.keep_alive)
        else:
            blob = json.dumps(value, default=str).encode()
            data = _render(200, "OK", blob, slot.keep_alive)
        if conn.closed:
            slot.state = _DEAD
            return
        self._set_ready(conn, slot, data, pump=False)

    # -- streaming (driver: callback-chained; worker: one thread) ------

    def _start_stream(self, conn: _Conn, slot: _Slot, replica_set,
                      args, sse: bool) -> None:
        try:
            gen = replica_set.assign("__call__", args, {}, stream=True,
                                     nowait=True)
        except Exception as e:  # noqa: BLE001 - typed mapping
            self._set_ready(conn, slot, _render_error(e, slot.keep_alive))
            return
        serve_stats.incr("streams")
        slot.state = _STREAM
        slot.head = _STREAM_HEAD_SSE if sse else _STREAM_HEAD_NDJSON
        st = _StreamState(gen._task_id, gen.completed(), sse)
        slot.stream = st
        self._pump(conn)    # head-of-line stream sends headers now
        if self._driver_mode:
            self._advance_stream(conn, slot)
        else:
            t = threading.Thread(
                target=self._worker_stream_loop, args=(conn, slot, gen),
                daemon=True, name="rtpu-serve-ingress-stream")
            t.start()

    def _stream_emit(self, conn: _Conn, slot: _Slot, value) -> None:
        st = slot.stream
        if st is None or st.finished or st.discard or conn.closed:
            return
        st.i += 1
        if st.i == 1:
            serve_stats.observe_first_token(
                (time.monotonic() - st.t0) * 1e3)
        serve_stats.incr("stream_items")
        blob = _item_event(value, st.sse)
        if slot.attached:
            conn.wbuf += blob
            self._flush(conn)
        else:
            slot.sbuf += blob

    def _advance_stream(self, conn: _Conn, slot: _Slot) -> None:
        """Driver mode: consume every already-landed item, then park a
        readiness callback on (next item, done marker) — whichever
        fires re-enters here through the ready queue. No blocking
        ``get`` anywhere; a replica dying mid-stream surfaces on the
        done marker as its typed error."""
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef
        st = slot.stream
        w = self._worker
        if st is None or st.finished:
            return
        if st.waiting is not None:
            oids, cb = st.waiting
            for oid in oids:
                w.discard_object_ready(oid, cb)
            st.waiting = None
        store = w.memory_store
        done_oid = st.done_ref.id()
        while True:
            if not st.discard and self._buffered(conn, slot) > self._write_hw:
                st.paused = True    # slow reader: resume on drain
                return
            st.paused = False
            item_oid = ObjectID.from_index(st.task_id, st.i + 2)
            if store.contains(item_oid):
                ref = ObjectRef(item_oid)
                try:
                    value = w.get([ref], 30)[0]
                except BaseException as e:  # noqa: BLE001 - typed
                    self._finish_stream(conn, slot, e)
                    return
                finally:
                    del ref     # release the item as soon as consumed
                if st.discard:
                    st.i += 1
                else:
                    self._stream_emit(conn, slot, value)
                continue
            if store.contains(done_oid):
                try:
                    count = w.get([st.done_ref], 30)[0]
                except BaseException as e:  # noqa: BLE001 - typed
                    self._finish_stream(conn, slot, e)
                    return
                if st.i >= count:
                    self._finish_stream(conn, slot, None)
                    return
                continue    # item landed between the two checks

            def _cb(_oid, c=conn, s=slot):
                self._push(("adv", c, s))

            st.waiting = ((item_oid, done_oid), _cb)
            w.on_object_ready(item_oid, _cb)
            w.on_object_ready(done_oid, _cb)
            return

    def _finish_stream(self, conn: _Conn, slot: _Slot,
                       error: Optional[BaseException]) -> None:
        st = slot.stream
        if st is None or st.finished:
            return
        st.finished = True
        if st.waiting is not None:
            oids, cb = st.waiting
            for oid in oids:
                self._worker.discard_object_ready(oid, cb)
            st.waiting = None
        st.done_ref = None      # release the completion marker
        discard = st.discard or conn.closed
        if error is not None:
            serve_stats.incr("stream_errors")
        self._draining_streams.discard(slot)
        if discard:
            self._uncount(slot)
            slot.state = _DEAD
            return
        # typed terminal event (on error), then the chunked
        # terminator: the client always sees a well-formed end of
        # stream, never a silent truncation
        tail = bytearray()
        if error is not None:
            tail += _terminal_event(error, st.sse)
            slot.close_after = True
        tail += _CHUNK_END
        if slot.attached:
            conn.wbuf += tail
        else:
            slot.sbuf += tail
        slot.stream_done = True
        self._pump(conn)

    def _worker_stream_loop(self, conn: _Conn, slot: _Slot, gen) -> None:
        """Worker-hosted proxy: ONE thread per ACTIVE stream (not per
        request) iterates the generator through the nested wait/get
        surface and feeds chunks to the loop."""
        st = slot.stream
        try:
            for ref in gen:
                if slot.cancelled:
                    return      # client gone: drop the generator
                value = self._worker.get([ref], 120)[0]
                # backpressure: wait for the client to drain before
                # pulling more items (bounded waits; cancel-checked)
                while (not slot.cancelled
                       and len(conn.wbuf) + len(slot.sbuf)
                       > self._write_hw):
                    time.sleep(0.05)    # no-deadline: bounded by the
                    # client draining or slot.cancelled on disconnect
                if slot.cancelled:
                    return
                self._push(("schunk", conn, slot, value))
            self._push(("sdone", conn, slot, None))
        except BaseException as e:  # noqa: BLE001 - typed terminal
            self._push(("sdone", conn, slot, e))

    # -- worker-mode unary completion poller ---------------------------

    def _poll_add(self, ref, conn: _Conn, slot: _Slot) -> None:
        with self._poll_lock:
            self._poll_entries[ref.id()] = (ref, conn, slot)
            if self._poller is None or not self._poller.is_alive():
                self._poller = threading.Thread(
                    target=self._poll_loop, daemon=True,
                    name="rtpu-serve-ingress-poll")
                self._poller.start()
        self._poll_evt.set()

    def _poll_loop(self) -> None:
        # no-deadline: daemon service loop — bounded by _shutdown;
        # each wait below carries its own timeout
        while not self._shutdown:
            with self._poll_lock:
                refs = [r for r, _c, _s in self._poll_entries.values()]
            if not refs:
                self._poll_evt.wait(timeout=0.25)
                self._poll_evt.clear()
                continue
            try:
                ready, _ = self._worker.wait(refs, 1, 0.25)
            except Exception:  # noqa: BLE001 - runtime tearing down
                time.sleep(0.1)  # no-deadline: bounded by _shutdown
                continue
            for ref in ready:
                with self._poll_lock:
                    entry = self._poll_entries.pop(ref.id(), None)
                if entry is None:
                    continue
                _ref, conn, slot = entry
                try:
                    value = self._worker.get([ref], 30)[0]
                    self._push(("val", conn, slot, value))
                except BaseException as e:  # noqa: BLE001 - typed
                    self._push(("err", conn, slot, e))

    # -- request deadline sweep ----------------------------------------

    def _sweep(self, now: float) -> None:
        self._last_sweep = now
        t = self._req_timeout
        if not t or t <= 0:
            return
        expired = []
        for conn in self._conns:
            for slot in conn.slots:
                if slot.state == _PENDING and now - slot.t0 > t:
                    expired.append((conn, slot))
        for conn, slot in expired:
            self._release_pending(slot)
            blob = json.dumps({
                "error": "request timed out",
                "error_type": "GetTimeoutError",
                "detail": f"no response after {t:.0f}s"}).encode()
            self._set_ready(conn, slot,
                            _render(504, "Gateway Timeout", blob,
                                    slot.keep_alive))

    # -- lifecycle (mirrors _CountingHTTPServer's surface) -------------

    def inflight(self) -> int:
        return max(0, self._active)

    def drain(self, timeout_s: float = 10.0) -> int:
        """Stop accepting, then wait (bounded) for outstanding
        response slots to resolve. Returns the count still pending at
        the deadline (0 = fully drained)."""
        self._draining = True
        self._push(("noop",))   # wake the loop to close the listener
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._active <= 0:
                return 0
            time.sleep(0.02)
        return max(0, self._active)

    def server_close(self) -> None:
        self._shutdown = True
        self._poll_evt.set()
        self._push(("noop",))
        self._thread.join(timeout=5)
