"""Wire RPC layer: framed request/reply + server push over TCP.

Reference analog: ``src/ray/rpc/`` (GrpcServer/ClientCallManager and
the retryable client) [UNVERIFIED — mount empty, SURVEY.md §0]. The
reference generates gRPC services from protos; here the control plane
is a compact framed protocol over TCP sockets — host:port addressable,
so the same code paths serve multi-process-on-one-host (tests) and
multi-host over DCN. Payloads are pickled tuples (the data plane's bulk
bytes ride the same frames; zero-copy within a host stays on the shm
plane, this layer is the *transfer* path between stores).

Frame: 4-byte magic+version ("RTP" + version byte) + 8-byte big-endian
length + pickle. A frame whose magic does not match is a foreign or
stale-version peer: the receiver answers with a ("hello_err", reason)
frame and closes. Messages:
  ("hello", version, token)         client -> server, FIRST frame
  ("hello_ok",) / ("hello_err", r)  server -> client, handshake reply
  ("call",  req_id, method, args[, idem])   client -> server
  ("reply", req_id, ok, payload)    server -> client
  ("oneway", method, args)          client -> server, no reply
  ("push",  topic, payload)         server -> client, no reply

The optional 5th "call" element is an idempotency token: the server
keeps an LRU dedupe cache of token -> recorded reply, so a client that
re-sends a call after a connection loss (RetryingRpcClient) gets the
ORIGINAL outcome replayed instead of a second execution — submits and
puts stay exactly-once across retries. Frames without a token (legacy
peers, oneways) behave exactly as before.

The reply's ``ok`` field is normally True/False; the sentinel
``RESOURCE_EXHAUSTED`` marks an overload shed (the handler raised a
``SystemOverloadError`` subclass — see ``ray_tpu_torch/exceptions.py``).
Clients re-raise the TYPED exception (retryable flag + suggested
backoff intact) instead of wrapping it in RpcError, and the retrying
client does NOT burn its deadline on it: overload is the caller's
backpressure signal, not a transport fault.

Fault tolerance layers here (see docs/fault_tolerance.md):
``RetryingRpcClient`` wraps ``RpcClient`` with transparent reconnect
(exponential backoff + jitter), per-call deadlines, and per-call
idempotency tokens; the chaos plane (``chaos.py``) can drop / delay /
duplicate / sever frames at the ``_send_frame`` / ``_recv_frame`` /
``RpcServer._dispatch`` hook points to prove those layers work.

Trust model (see ARCHITECTURE.md): payloads are pickles, so anyone who
can complete the handshake can execute code in the receiving process.
Connections are gated by a per-session secret token (random, written to
the session dir, inherited by child processes via RTPU_SESSION_TOKEN);
possession of the token == full cluster access. This matches the
reference's posture, where any process that can reach the raylet/GCS
ports participates in the cluster.
"""

from __future__ import annotations

import logging
import os
import pickle
import queue
import random
import socket
import socketserver
import struct
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch._private import chaos, wire_stats
from ray_tpu_torch._private.session_dir import (current_session_link,
                                                session_dir)
from ray_tpu_torch.exceptions import SystemOverloadError

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = 1
_MAGIC = b"RTP" + bytes([PROTOCOL_VERSION])
# Binary small-frame fast path (docs/data_plane.md): same header
# layout, second magic. The body is msgpack (method + token +
# pre-serialized byte payloads packed natively) with NO outer pickle —
# cheaper to encode and, for the control-plane methods it is allowed
# on, safe to decode without running arbitrary reducers. Negotiated at
# handshake; un-negotiated channels never see this magic.
_FAST_MAGIC = b"RTF" + bytes([PROTOCOL_VERSION])
_HDR = struct.Struct(">4sQ")

# Methods/topics whose wire shapes are built from primitives by OUR
# code on both ends (tuple->list normalization under msgpack is
# harmless there). Arbitrary user payloads (exceptions, custom types)
# fail msgpack encoding and fall back to the legacy pickled frame —
# but only frames for these names are even attempted:
_FASTFRAME_SAFE = frozenset((
    "submit", "submit_many", "submit_batch", "register_owner", "ping",
    "task_done", "task_done_many", "task_stream", "actor_ckpt",
    "actor_ready", "actor_died", "report_resources", "heartbeat",
    "cancel_task", "kill_actor",
))
# A reply rides the fast path only when the CALL it answers was
# fastframe-eligible (the server knows the method) — a fast reply to
# an arbitrary handler could silently turn a tuple result into a list.

_TOKEN_ENV = "RTPU_SESSION_TOKEN"
_token_lock = threading.Lock()
_session_token: Optional[str] = None


def set_session_token(token: Optional[str]) -> None:
    """Install the session secret for this process and its children
    (exported via RTPU_SESSION_TOKEN so spawned daemons inherit it)."""
    global _session_token
    with _token_lock:
        _session_token = token
        if token:
            os.environ[_TOKEN_ENV] = token
        else:
            os.environ.pop(_TOKEN_ENV, None)


def get_session_token() -> str:
    with _token_lock:
        if _session_token is not None:
            return _session_token
    return os.environ.get(_TOKEN_ENV, "")


def load_session_token_file(session: Optional[str] = None
                            ) -> Optional[str]:
    """Same-host tooling fallback: the 0600 token file
    ``ensure_session_token`` persisted under the session dir. With no
    session name, follow the ``rtpt_current`` pointer at the most
    recent head session (the reference's ray_current_session analog).
    None when absent/unreadable."""
    if session is not None:
        d = session_dir(session)
    else:
        try:
            link = current_session_link()
            if os.lstat(link).st_uid != os.getuid():
                return None
            d = os.path.realpath(link)
        except OSError:
            return None
    path = os.path.join(d, "session_token")
    try:
        # O_NOFOLLOW + fstat on the OPENED fd: an lstat-then-open pair
        # would be a TOCTOU (the session dir name is predictable,
        # and a dir owner could swap in a symlink between the checks).
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_NOFOLLOW", 0))
        try:
            st = os.fstat(fd)
            import stat as _stat
            if st.st_uid != os.getuid() or not _stat.S_ISREG(st.st_mode):
                return None
            token = os.read(fd, 256).decode().strip()
        finally:
            os.close(fd)
        return token or None
    except OSError:
        return None


def ensure_session_token(session: str) -> str:
    """Mint the process's session token if absent and persist it 0600
    into the session dir for same-host tooling. The file is created
    with O_EXCL-style safety (never follow a pre-existing file or
    symlink planted in the world-writable temp dir)."""
    if not get_session_token():
        set_session_token(os.urandom(16).hex())
    token = get_session_token()
    d = session_dir(session)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "session_token")
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL
                     | getattr(os, "O_NOFOLLOW", 0), 0o600)
    except FileExistsError:
        st = os.lstat(path)
        if not (st.st_uid == os.getuid() and os.path.isfile(path)
                and not os.path.islink(path)):
            raise RuntimeError(
                f"refusing to write session token: {path} exists and is "
                f"not a regular file owned by this user")
        fd = os.open(path, os.O_WRONLY | os.O_TRUNC
                     | getattr(os, "O_NOFOLLOW", 0))
    with os.fdopen(fd, "w") as f:
        f.write(token)
    # point same-host tooling at the freshest session (atomic swap)
    try:
        link = current_session_link()
        tmp_link = f"{link}.{os.getpid()}"
        os.symlink(d, tmp_link)
        os.replace(tmp_link, link)
    except OSError:
        pass
    return token


class ProtocolError(ConnectionError):
    """Peer speaks a different protocol version or failed the token
    handshake."""


def _frame_method(obj) -> str:
    """Chaos-event label of a frame: the RPC method for call/oneway,
    the topic for pushes, ``reply`` for replies."""
    try:
        kind = obj[0]
        if kind == "call":
            return obj[2]
        if kind in ("oneway", "push"):
            return obj[1]
        return kind
    except Exception:  # non-tuple frame (handshake errors etc.)
        return ""


def _hard_close(sock: socket.socket) -> None:
    """Abrupt bidirectional teardown. shutdown() first: it wakes any
    thread blocked in recv on this socket (a bare close can leave it
    hanging); both steps tolerate an already-dead socket."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass    # already closed/reset: close below still applies
    try:
        sock.close()
    except OSError:
        pass    # already closed


def _fastframe_threshold() -> int:
    from ray_tpu_torch._private.config import get_config
    return get_config().fastframe_threshold_bytes


def _encode_frame(obj, fast: bool) -> Tuple[bytes, bool]:
    """(frame bytes, used_fast). ``fast`` means the channel negotiated
    the binary small-frame path AND the caller deemed this frame's
    method eligible; the encoder still falls back to the legacy pickle
    frame when the body doesn't msgpack (arbitrary objects) or exceeds
    the small-frame threshold."""
    if fast:
        threshold = _fastframe_threshold()
        if threshold > 0:
            try:
                data = msgpack.packb(obj, use_bin_type=True)
            except (TypeError, ValueError, OverflowError):
                data = None
            if data is not None and len(data) <= threshold:
                return _HDR.pack(_FAST_MAGIC, len(data)) + data, True
    data = pickle.dumps(obj, protocol=5)
    return _HDR.pack(_MAGIC, len(data)) + data, False


def _send_frame(sock: socket.socket, obj, lock: Optional[threading.Lock],
                component: str = "", fast: bool = False) -> None:
    dup = False
    if chaos._plane.armed:
        action = chaos.fire(component, "send", _frame_method(obj))
        if action == "drop":
            return
        if action == "sever":
            _hard_close(sock)
            raise ConnectionError("chaos: connection severed at send")
        dup = action == "dup"
    frame, used_fast = _encode_frame(obj, fast)
    if component:
        wire_stats.channel(f"rpc:{component}").record(
            1, len(frame), fastframe=used_fast)
    if dup:
        frame = frame + frame
    if lock is not None:
        with lock:
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket, component: str = ""):
    while True:
        magic, length = _HDR.unpack(_recv_exact(sock, _HDR.size))
        if component:
            # inbound wire cost, kept on a separate channel so the
            # send-side payloads/frames coalescing ratio stays pure
            wire_stats.channel(f"rpcin:{component}").record(
                1, _HDR.size + length, fastframe=magic == _FAST_MAGIC)
        if magic == _MAGIC:
            obj = pickle.loads(_recv_exact(sock, length))
        elif magic == _FAST_MAGIC:
            obj = tuple(msgpack.unpackb(_recv_exact(sock, length),
                                        raw=False, strict_map_key=False))
        else:
            if magic[:3] in (_MAGIC[:3], _FAST_MAGIC[:3]):
                raise ProtocolError(
                    f"peer protocol version {magic[3]} != "
                    f"{PROTOCOL_VERSION}")
            raise ProtocolError(f"bad frame magic {magic!r}")
        if chaos._plane.armed:
            action = chaos.fire(component, "recv", _frame_method(obj))
            if action == "drop":
                continue    # vanished in flight: read the next frame
            if action == "sever":
                _hard_close(sock)
                raise ConnectionError(
                    "chaos: connection severed at recv")
        return obj


class RpcError(Exception):
    """Remote handler raised; carries the remote exception."""


# Reply-frame ok-field sentinel: the handler shed this call with a
# typed overload error (BackpressureError / OutOfMemoryError / ...).
RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"


class ConnectionLost(ConnectionError):
    """This client's connection died while a call was in flight (the
    reader thread injects it into every pending waiter). Distinct from
    a ConnectionError RAISED BY the remote handler, which stays wrapped
    in RpcError — only a genuine local loss is safe to retry."""


class _DedupeCache:
    """Idempotency-token -> recorded reply, bounded LRU.

    ``begin`` claims a token: the FIRST claimant executes the handler
    and must ``finish`` with the outcome; any later claimant (a retry
    racing the original, or arriving after it) blocks until that
    outcome exists and gets it replayed. This is what makes a client
    re-send after connection loss exactly-once on the server."""

    _PENDING = object()

    def __init__(self, capacity: int):
        self._capacity = max(2, capacity)
        self._lock = threading.Lock()
        # token -> (event, [outcome]) while pending, (None, [outcome])
        # once finished; OrderedDict for LRU eviction of FINISHED entries
        self._entries: "OrderedDict" = OrderedDict()  # guarded-by: _lock

    def begin(self, token) -> Optional[tuple]:
        """None = caller owns execution; else the recorded (ok, payload)
        to replay (waits for an in-flight original to finish)."""
        with self._lock:
            entry = self._entries.get(token)
            if entry is None:
                self._entries[token] = (threading.Event(), [])
                return None
            self._entries.move_to_end(token)
            event, box = entry
        if event is not None:
            # Original still executing on another thread; bounded wait —
            # a wedged handler must not pin retry threads forever.
            event.wait(timeout=60.0)
        with self._lock:
            entry = self._entries.get(token)
        if entry is None or not entry[1]:
            # evicted or still unfinished after the wait: degrade to
            # re-execution (at-least-once beats a silent hang)
            return None
        return entry[1][0]

    def finish(self, token, ok: bool, payload) -> None:
        with self._lock:
            entry = self._entries.get(token)
            if entry is None:       # cleared/evicted mid-execution
                self._entries[token] = (None, [(ok, payload)])
            else:
                entry[1].append((ok, payload))
                if entry[0] is not None:
                    entry[0].set()
                self._entries[token] = (None, entry[1])
            while len(self._entries) > self._capacity:
                # evict the oldest FINISHED entry; never a pending one
                for tok, (ev, _box) in self._entries.items():
                    if ev is None:
                        self._entries.pop(tok)
                        break
                else:
                    break

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class ConnectionContext:
    """Server-side handle for one client connection; handlers may keep
    it to push messages later (completion callbacks, pubsub)."""

    def __init__(self, sock: socket.socket, peer, component: str = ""):
        self._sock = sock
        self._send_lock = threading.Lock()  # blocking-ok: held across sendall BY DESIGN — frame atomicity on a shared socket
        self.peer = peer
        self.component = component
        self.alive = True
        self.fastframe = False   # negotiated at handshake
        self.meta: Dict[str, Any] = {}   # handler scratch (e.g. node id)

    def push(self, topic: str, payload) -> bool:
        try:
            _send_frame(self._sock, ("push", topic, payload),
                        self._send_lock, component=self.component,
                        fast=self.fastframe and topic in _FASTFRAME_SAFE)
            return True
        except OSError:
            self.alive = False
            return False


class RpcServer:
    """Threaded RPC server. ``register(name, fn)`` exposes
    ``fn(ctx, *args)``; exceptions flow back to the caller as RpcError.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None, component: str = "server"):
        self._handlers: Dict[str, Callable] = {}
        self._disconnect_cb: Optional[Callable[[ConnectionContext], None]] \
            = None
        self._live_lock = threading.Lock()
        self._live: set = set()
        self._token = token
        self._component = component
        from ray_tpu_torch._private.config import get_config
        self._dedupe = _DedupeCache(get_config().rpc_dedupe_cache_size)
        self.dedupe_hits = 0        # replayed replies (observability)
        self.idem_calls = 0         # tokened calls seen (hit-rate denom)
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # noqa: ANN201
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                ctx = ConnectionContext(sock, self.client_address,
                                        component=outer._component)
                if not outer._handshake(sock, ctx):
                    return
                with outer._live_lock:
                    outer._live.add(ctx)
                try:
                    while True:
                        msg = _recv_frame(sock,
                                          component=outer._component)
                        outer._dispatch(ctx, msg)
                except (ConnectionError, OSError, EOFError):
                    pass
                finally:
                    ctx.alive = False
                    with outer._live_lock:
                        outer._live.discard(ctx)
                    if outer._disconnect_cb is not None:
                        try:
                            outer._disconnect_cb(ctx)
                        except Exception:
                            logger.exception("disconnect callback failed")

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"rtpu-rpc-{self.address[1]}")
        self._thread.start()

    def _handshake(self, sock: socket.socket,
                   ctx: Optional[ConnectionContext] = None) -> bool:
        """First frame on every connection must be a matching hello.
        Refusals are explicit (hello_err + close), never silent. The
        handshake runs under a deadline so a silent peer cannot pin a
        handler thread and fd forever. A 4th hello element carries the
        client's feature offer ({"feats": [...]}); the reply echoes
        the intersection, so the binary small-frame fast path only
        runs on channels where BOTH ends opted in (legacy 3-element
        hellos keep working and never see a fast frame)."""
        def refuse(reason: str) -> bool:
            try:
                _send_frame(sock, ("hello_err", reason), None)
            except OSError:
                pass
            return False

        try:
            sock.settimeout(10.0)
            msg = _recv_frame(sock)
            sock.settimeout(None)
        except ProtocolError as e:
            return refuse(str(e))
        except (ConnectionError, OSError, EOFError):
            return False
        # wire-shape-ok: the hello precedes fastframe negotiation, so
        # it can only arrive on the legacy pickled frame — and even a
        # fast frame's OUTER shape is re-tupled by _recv_frame; only
        # NESTED values keep msgpack's list normalization
        if not (isinstance(msg, tuple) and len(msg) in (3, 4)
                and msg[0] == "hello"):
            return refuse("expected hello handshake frame")
        version, token = msg[1], msg[2]
        offered = ()
        if len(msg) == 4 and isinstance(msg[3], dict):
            offered = tuple(msg[3].get("feats") or ())
        if version != PROTOCOL_VERSION:
            return refuse(f"protocol version mismatch: client speaks "
                          f"{version}, server speaks {PROTOCOL_VERSION}")
        expected = self._token if self._token is not None \
            else get_session_token()
        if expected and token != expected:
            return refuse("session token mismatch: connection refused "
                          "(pass the session's RTPU_SESSION_TOKEN)")
        accepted = []
        if "fastframe" in offered and _fastframe_threshold() > 0:
            accepted.append("fastframe")
            if ctx is not None:
                ctx.fastframe = True
        try:
            _send_frame(sock, (("hello_ok", {"feats": accepted})
                               if accepted else ("hello_ok",)), None)
        except OSError:
            return False
        return True

    def register(self, name: str, fn: Callable) -> None:
        self._handlers[name] = fn

    def registered_methods(self) -> Tuple[str, ...]:
        """The live handler table, sorted — the runtime half of the
        rpc-surface static check (graftcheck cross-references the
        statically scanned registrations against this)."""
        return tuple(sorted(self._handlers))

    def on_disconnect(self, cb: Callable[[ConnectionContext], None]) -> None:
        self._disconnect_cb = cb

    def _dispatch(self, ctx: ConnectionContext, msg) -> None:
        kind = msg[0]
        if chaos._plane.armed and kind in ("call", "oneway"):
            action = chaos.fire(self._component, "dispatch",
                                _frame_method(msg))
            if action == "drop":
                return      # request lost after delivery: caller times out
            if action == "sever":
                raise ConnectionError("chaos: connection severed at "
                                      "dispatch")
            if action == "dup":
                # duplicated delivery: the dedupe cache (when the call
                # carries an idempotency token) must collapse these
                self._dispatch_one(ctx, msg)
        self._dispatch_one(ctx, msg)

    def _dispatch_one(self, ctx: ConnectionContext, msg) -> None:
        kind = msg[0]
        if kind == "call":
            req_id, method, args = msg[1], msg[2], msg[3]
            idem = msg[4] if len(msg) > 4 else None
            reply = None
            if idem is not None:
                self.idem_calls += 1
                recorded = self._dedupe.begin(idem)
                if recorded is not None:
                    self.dedupe_hits += 1
                    reply = ("reply", req_id, recorded[0], recorded[1])
            if reply is None:
                fn = self._handlers.get(method)
                if fn is None:
                    ok, payload = False, f"unknown method {method!r}"
                else:
                    try:
                        ok, payload = True, fn(ctx, *args)
                    except SystemOverloadError as e:
                        # First-class shed: the typed error (retryable
                        # flag + suggested backoff) rides the frame.
                        ok, payload = RESOURCE_EXHAUSTED, e
                    except Exception as e:  # noqa: BLE001 - ships to caller
                        logger.debug("handler %s raised", method,
                                     exc_info=True)
                        ok, payload = False, e
                if idem is not None:
                    self._dedupe.finish(idem, ok, payload)
                reply = ("reply", req_id, ok, payload)
            try:
                _send_frame(ctx._sock, reply, ctx._send_lock,
                            component=self._component,
                            fast=(ctx.fastframe
                                  and method in _FASTFRAME_SAFE))
            except OSError:
                raise      # socket is gone; connection teardown handles it
            except Exception as e:  # unpicklable result or exception
                logger.exception("reply to %s not serializable", method)
                _send_frame(ctx._sock,
                            ("reply", req_id, False,
                             RpcError(f"handler {method!r} returned/raised "
                                      f"an unserializable value: {e!r}")),
                            ctx._send_lock,
                            component=self._component)
        elif kind == "oneway":
            _, method, args = msg
            fn = self._handlers.get(method)
            if fn is not None:
                try:
                    fn(ctx, *args)
                except Exception:
                    logger.exception("oneway handler %s failed", method)
        else:
            logger.warning("unknown rpc message kind %r", kind)

    def shutdown(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass    # double-shutdown / already-closed socket
        # socketserver.shutdown only stops the accept loop; live
        # per-connection threads keep serving until their socket dies.
        # Close them so clients see EOF and this server truly stops.
        with self._live_lock:
            live = list(self._live)
        for ctx in live:
            _hard_close(ctx._sock)
        # serve_forever has returned once shutdown() does; join its
        # thread so that a stopped server leaves no thread behind
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)


class RpcClient:
    """Connection to an RpcServer: sync ``call``, fire-and-forget
    ``oneway``, and a push callback for server-initiated messages."""

    def __init__(self, address: Tuple[str, int],
                 on_push: Optional[Callable[[str, Any], None]] = None,
                 connect_timeout: float = 10.0,
                 on_close: Optional[Callable[[], None]] = None,
                 token: Optional[str] = None,
                 component: str = ""):
        self.address = tuple(address)
        self._on_push = on_push
        self._on_close = on_close
        self._component = component
        self.fastframe = False
        hello_token = token if token is not None else get_session_token()
        offer = ["fastframe"] if _fastframe_threshold() > 0 else []
        hello = self._connect_handshake(hello_token, offer,
                                        connect_timeout)
        if hello[0] != "hello_ok":
            reason = hello[1] if len(hello) > 1 else "refused"
            if offer and isinstance(reason, str) \
                    and "expected hello" in reason:
                # Mixed-version channel: a pre-negotiation server
                # refuses the 4-element hello outright. Retry once the
                # legacy way, with the fast path off — old and new
                # peers keep interoperating.
                self._sock.close()
                hello = self._connect_handshake(hello_token, [],
                                                connect_timeout)
            if hello[0] != "hello_ok":
                reason = hello[1] if len(hello) > 1 else "refused"
                self._sock.close()
                raise ProtocolError(
                    f"server at {self.address} refused connection: "
                    f"{reason}")
        if len(hello) > 1 and isinstance(hello[1], dict):
            self.fastframe = "fastframe" in (hello[1].get("feats") or ())
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()  # blocking-ok: held across sendall BY DESIGN — frame atomicity on a shared socket
        self._pending: Dict[int, queue.Queue] = {}
        self._pending_lock = threading.Lock()
        self._req_counter = 0
        self.alive = True
        self._closed_reason: Optional[BaseException] = None
        # Pushes dispatch on their own thread, NOT the reader: a push
        # handler is allowed to issue blocking call()s on this same
        # client, and those replies can only be read by the reader —
        # running handlers there would self-deadlock.
        # unbounded-ok: drained by a dedicated push thread; producers
        # are server pushes already bounded by the peer's buffers, and
        # blocking the reader here would stall reply delivery
        self._push_queue: queue.Queue = queue.Queue()
        if on_push is not None:
            self._push_thread = threading.Thread(
                target=self._push_loop, daemon=True,
                name=f"rtpu-rpc-push-{self.address[1]}")
            self._push_thread.start()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"rtpu-rpc-client-{self.address[1]}")
        self._reader.start()

    def _connect_handshake(self, token: Optional[str], offer,
                           connect_timeout: float):
        """Dial and run the hello exchange; returns the server's hello
        reply frame. A non-empty ``offer`` rides as a 4th hello
        element ({"feats": [...]}) — always on the LEGACY pickled
        frame, since nothing is negotiated yet."""
        self._sock = socket.create_connection(self.address,
                                              timeout=connect_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = (("hello", PROTOCOL_VERSION, token,
                  {"feats": list(offer)})
                 if offer else ("hello", PROTOCOL_VERSION, token))
        _send_frame(self._sock, hello, None)
        try:
            return _recv_frame(self._sock)
        except (ConnectionError, OSError, EOFError) as e:
            self._sock.close()
            if isinstance(e, ProtocolError):
                raise       # bad magic / version: genuinely unretryable
            # A reset/EOF mid-handshake is a TRANSIENT fault (e.g. a
            # reconnect racing a server restart on the same port), not
            # a refusal: surface ConnectionError so retrying clients
            # back off and try again instead of giving the peer up for
            # good. ProtocolError is reserved for explicit refusals
            # (hello_err) and version/magic mismatches.
            raise ConnectionError(
                f"server at {self.address} closed during handshake "
                f"({e})") from e

    def _push_loop(self) -> None:
        while True:
            item = self._push_queue.get()
            if item is None:
                return
            topic, payload = item
            try:
                self._on_push(topic, payload)
            except Exception:
                logger.exception("push callback failed")

    def _read_loop(self) -> None:
        try:
            while True:
                msg = _recv_frame(self._sock, component=self._component)
                if msg[0] == "reply":
                    _, req_id, ok, payload = msg
                    with self._pending_lock:
                        waiter = self._pending.pop(req_id, None)
                    if waiter is not None:
                        waiter.put((ok, payload))
                elif msg[0] == "push":
                    _, topic, payload = msg
                    if self._on_push is not None:
                        self._push_queue.put((topic, payload))
        except (ConnectionError, OSError, EOFError) as e:
            self._closed_reason = e
        finally:
            self.alive = False
            with self._pending_lock:
                pending = list(self._pending.values())
                self._pending.clear()
            # ok=None marks a LOCALLY-injected loss: remote replies
            # only ever carry ok True/False, so a handler-raised
            # ConnectionLost shipped in a payload can never be
            # mistaken for our own connection dying (it must surface
            # as RpcError, not trigger a retry loop).
            for waiter in pending:
                waiter.put((None, ConnectionLost("connection lost")))
            self._push_queue.put(None)
            if self._on_close is not None:
                try:
                    self._on_close()
                except Exception:
                    logger.exception("rpc on_close callback failed")

    def call(self, method: str, *args,
             timeout: Optional[float] = None,
             idem: Optional[str] = None):
        """Sync round-trip. ``idem``: idempotency token shipped with
        the frame; a server that already executed a call with this
        token replays the recorded reply (RetryingRpcClient passes the
        same token across re-sends of one logical call)."""
        if not self.alive:
            raise ConnectionError("rpc connection closed")
        with self._pending_lock:
            self._req_counter += 1
            req_id = self._req_counter
            waiter: queue.Queue = queue.Queue(maxsize=1)
            self._pending[req_id] = waiter
        frame = (("call", req_id, method, args) if idem is None
                 else ("call", req_id, method, args, idem))
        try:
            _send_frame(self._sock, frame, self._send_lock,
                        component=self._component,
                        fast=(self.fastframe
                              and method in _FASTFRAME_SAFE))
        except (ConnectionError, OSError) as e:
            # Send failed: the waiter will never be answered — drop it
            # before surfacing, or the entry leaks in _pending forever.
            with self._pending_lock:
                self._pending.pop(req_id, None)
            self._send_failed(method, e)
        try:
            ok, payload = waiter.get(timeout=timeout)
        except queue.Empty:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise TimeoutError(
                f"rpc call {method!r} timed out after {timeout}s") from None
        if ok is None:
            raise payload           # reader-injected: connection died
        if ok == RESOURCE_EXHAUSTED:
            # Typed overload shed: surface it as-is so the caller's
            # backpressure logic sees retryable/backoff_s. (Checked
            # before the truthiness test — the sentinel is a string.)
            if isinstance(payload, SystemOverloadError):
                raise payload
            raise RpcError(str(payload))
        if ok:
            return payload
        if isinstance(payload, BaseException):
            raise RpcError(str(payload)) from payload
        raise RpcError(str(payload))

    def _send_failed(self, method: str, e: BaseException) -> None:
        """Shared send-failure surface: a broken send means the socket
        is done — tear the client down now (waiters drain, a retrying
        wrapper stops handing out this connection) and surface a
        ConnectionError, never a raw OSError. Always raises."""
        self.close()
        if isinstance(e, ConnectionError):
            raise e
        raise ConnectionError(
            f"rpc send of {method!r} failed: {e}") from e

    def oneway(self, method: str, *args) -> None:
        """Fire-and-forget. Shares ``call``'s error surface: a dead or
        dying connection raises ConnectionError, never a raw OSError."""
        if not self.alive:
            raise ConnectionError("rpc connection closed")
        try:
            _send_frame(self._sock, ("oneway", method, args),
                        self._send_lock, component=self._component,
                        fast=(self.fastframe
                              and method in _FASTFRAME_SAFE))
        except (ConnectionError, OSError) as e:
            self._send_failed(method, e)

    def close(self) -> None:
        self.alive = False
        # shutdown() first wakes the reader blocked in recv (a bare close
        # can leave it hanging until the peer goes)
        _hard_close(self._sock)

    def join(self, timeout: float) -> None:
        """Wait for the reader and the push thread it ends, after
        ``close()``. Not from under a lock that the push callback or the
        reader's ``on_close`` takes."""
        me = threading.current_thread()
        for thread in (self._reader, getattr(self, "_push_thread", None)):
            if thread is not None and thread is not me:
                thread.join(timeout=timeout)


class RetryingRpcClient:
    """Reconnecting facade over ``RpcClient``: transparent reconnect
    with exponential backoff + jitter, per-call overall deadlines, and
    per-call idempotency tokens (server-side dedupe makes re-sends
    exactly-once). The GCS channel, the raylet->GCS channel, and the
    owner->raylet lease channel all ride this.

    Semantics:

    - ``call`` owns a logical deadline (``timeout`` or the configured
      ``rpc_call_deadline_ms``) spanning every reconnect and re-send.
      Connection loss mid-call reconnects and re-sends the SAME token;
      with ``attempt_timeout`` set, a silently dropped frame is also
      re-sent after that slice instead of burning the whole deadline.
    - ``on_reconnect(raw_client)`` runs after EVERY successful
      handshake (including the first): re-subscribe, re-register —
      whatever state the server side keeps per-connection. It receives
      the RAW client and must talk through it (the wrapper's lock is
      held). If it raises, the connect counts as failed and backoff
      continues. ``on_restored()`` fires after a RE-connect only,
      outside the lock — safe to call back into this wrapper (the
      raylet re-registers its node with the GCS there).
    - ``auto_reconnect=True`` restores the connection in the
      background the moment it drops (pushes ride connections, so a
      call-idle client would otherwise never notice); after
      ``reconnect_window`` seconds of failure it calls ``on_give_up``
      (the owner's raylet channel declares the node lost there).
      ``reconnect_window=None`` keeps trying until ``close``.
    """

    def __init__(self, address: Tuple[str, int],
                 on_push: Optional[Callable[[str, Any], None]] = None,
                 token: Optional[str] = None,
                 component: str = "client",
                 on_reconnect: Optional[Callable[[RpcClient], None]] = None,
                 on_restored: Optional[Callable[[], None]] = None,
                 on_give_up: Optional[Callable[[BaseException], None]] = None,
                 should_reconnect: Optional[Callable[[], bool]] = None,
                 connect_timeout: float = 10.0,
                 call_deadline: Optional[float] = None,
                 attempt_timeout: Optional[float] = None,
                 reconnect_window: Optional[float] = 0.0,
                 auto_reconnect: bool = False,
                 seed: Optional[int] = None):
        from ray_tpu_torch._private.config import get_config
        cfg = get_config()
        self.address = tuple(address)
        self._on_push = on_push
        self._token = token
        self._component = component
        self._on_reconnect = on_reconnect
        self._on_restored = on_restored
        self._on_give_up = on_give_up
        # Consulted before every reconnect attempt: False = the peer
        # can never answer (e.g. a spawned raylet process that already
        # EXITED) — fail fast instead of burning the backoff window.
        self._should_reconnect = should_reconnect
        self._connect_timeout = connect_timeout
        self._call_deadline = (call_deadline if call_deadline is not None
                               else cfg.rpc_call_deadline_ms / 1000.0)
        self._attempt_timeout = attempt_timeout
        self._backoff_base = cfg.rpc_reconnect_backoff_base_ms / 1000.0
        self._backoff_cap = cfg.rpc_reconnect_backoff_max_ms / 1000.0
        self._reconnect_window = reconnect_window
        self._auto_reconnect = auto_reconnect
        self._rng = random.Random(seed)
        self._lock = threading.RLock()  # blocking-ok: reconnect lock — the handshake I/O runs under it BY DESIGN so concurrent calls queue behind one dial instead of racing it
        self._inner: Optional[RpcClient] = None  # guarded-by: _lock
        # Background-reconnector handoff state. _bg_active is the
        # LOGICAL liveness of the reconnector (flipped under _lock, so
        # handoff can't race a thread that decided to exit but hasn't
        # finished dying yet — Thread.is_alive() can't give that
        # guarantee); _reconnect_needed latches close events that
        # arrive while a reconnect round is already in flight.
        self._bg_active = False  # guarded-by: _lock
        self._reconnect_needed = False  # guarded-by: _lock
        self._closed = False
        self._ever_connected = False
        self.num_reconnects = 0     # successful re-handshakes after the first
        self._idem_prefix = os.urandom(8).hex()
        self._idem_counter = 0      # guarded-by: _lock
        # The first connect raises to the caller like a plain RpcClient
        # (a server that never existed is a config error, not a blip).
        with self._lock:
            self._connect_locked()

    # -- connection management ----------------------------------------

    # lock-held: _lock
    def _connect_locked(self, budget: Optional[float] = None
                        ) -> RpcClient:
        client = RpcClient(self.address, on_push=self._on_push,
                           connect_timeout=(
                               self._connect_timeout if budget is None
                               else max(0.05, min(self._connect_timeout,
                                                  budget))),
                           on_close=self._on_inner_close,
                           token=self._token, component=self._component)
        first = self._inner is None and self.num_reconnects == 0
        if self._on_reconnect is not None:
            try:
                self._on_reconnect(client)
            except BaseException as e:
                client.close()
                if isinstance(e, ProtocolError):
                    raise
                # Whatever the hook raised (TimeoutError from a
                # stalled peer, RpcError, ...), the CONNECT failed:
                # normalize so the backoff loop keeps retrying instead
                # of the raw error escaping mid-deadline.
                raise ConnectionError(
                    f"connection setup hook failed: {e}") from e
        if not first:
            self.num_reconnects += 1
        self._inner = client
        self._ever_connected = True
        return client

    def _get_client(self, deadline: float) -> RpcClient:
        """The live inner client, reconnecting with backoff+jitter as
        needed (bounded by ``deadline``)."""
        delay = self._backoff_base
        last: Optional[BaseException] = None
        while True:
            client = None
            reconnected = False
            with self._lock:
                if self._closed:
                    raise ConnectionError("rpc client closed")
                if self._inner is not None and self._inner.alive:
                    return self._inner
                if (self._should_reconnect is not None
                        and not self._should_reconnect()):
                    raise ConnectionError(
                        f"peer at {self.address} is gone for good "
                        "(not retrying)")
                budget = deadline - time.monotonic()
                if budget > 0:
                    reconnected = self._inner is not None \
                        or self.num_reconnects > 0
                    try:
                        client = self._connect_locked(budget=budget)
                    except ProtocolError:
                        raise   # refused (token/version): never retryable
                    except (ConnectionError, OSError) as e:
                        last = e
            if client is not None:
                if reconnected and self._on_restored is not None:
                    try:
                        self._on_restored()
                    except Exception:
                        logger.exception("rpc on_restored callback "
                                         "failed")
                return client
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConnectionError(
                    f"reconnect to {self.address} failed within "
                    f"deadline: {last}") from last
            # Backoff with half-jitter (delay/2 .. delay), clamped so
            # one final connect attempt still fits before the deadline
            # instead of giving up with most of a backoff step unused.
            time.sleep(min(delay / 2 + self._rng.random() * delay / 2,
                           max(0.001, remaining - 0.05)))
            delay = min(delay * 2, self._backoff_cap)

    def _on_inner_close(self) -> None:
        # _ever_connected guards the half-built case: a failed
        # __init__ (setup hook raised after the TCP handshake) closes
        # its client, and the reader's on_close must not leave an
        # immortal background reconnector serving an object nobody
        # holds.
        if (not self._auto_reconnect or self._closed
                or not self._ever_connected):
            return
        spawn = None
        with self._lock:
            if self._closed:
                return
            self._reconnect_needed = True
            if not self._bg_active:
                self._bg_active = True
                spawn = threading.Thread(
                    target=self._background_reconnect, daemon=True,
                    name=f"rtpu-rpc-reconnect-{self.address[1]}")
                self._bg_thread = spawn
        if spawn is not None:
            spawn.start()

    def _background_reconnect(self) -> None:
        """One logical reconnector: rounds keep running while close
        events latch _reconnect_needed (the restored connection can
        die again while on_restored is still executing); the exit
        decision and the _bg_active flip are one atomic step under
        _lock, so a close event always finds either an active round
        or a spawnable slot — never a dying thread it can't replace."""
        while True:
            with self._lock:
                if self._closed or not self._reconnect_needed:
                    self._bg_active = False
                    return
                self._reconnect_needed = False
            window = self._reconnect_window
            deadline = (time.monotonic() + window if window is not None
                        else float("inf"))
            try:
                self._get_client(deadline)
            except BaseException as e:  # noqa: BLE001 - routed to give-up
                with self._lock:
                    self._bg_active = False
                if self._closed:
                    return
                logger.warning("rpc channel to %s not restored: %s",
                               self.address, e)
                if self._on_give_up is not None:
                    try:
                        self._on_give_up(e)
                    except Exception:
                        logger.exception("rpc give-up callback failed")
                return
            with self._lock:
                if self._inner is None or not self._inner.alive:
                    # died again before this round even finished
                    self._reconnect_needed = True

    # -- calls ---------------------------------------------------------

    def _next_token(self) -> str:
        with self._lock:
            self._idem_counter += 1
            return f"{self._idem_prefix}:{self._idem_counter}"

    def call(self, method: str, *args,
             timeout: Optional[float] = None,
             idempotent: bool = True):
        deadline = time.monotonic() + (
            timeout if timeout is not None else self._call_deadline)
        token = self._next_token() if idempotent else None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"rpc call {method!r} deadline exceeded")
            client = self._get_client(deadline)
            slice_t = remaining
            if self._attempt_timeout is not None and token is not None:
                slice_t = min(remaining, self._attempt_timeout)
            try:
                return client.call(method, *args, timeout=slice_t,
                                   idem=token)
            except TimeoutError:
                if slice_t >= remaining:
                    raise           # the overall deadline is spent
                continue            # idempotent re-send, same token
            except ProtocolError:
                raise
            except ConnectionLost:
                if token is None:
                    # frame was on the wire and may have executed; a
                    # tokenless re-send could double-execute — surface
                    raise
                continue
            except ConnectionError:
                continue            # nothing sent: reconnect + retry

    def oneway(self, method: str, *args) -> None:
        """Best-effort send; one transparent reconnect+resend. Loss
        tolerated by every oneway user (heartbeats, releases)."""
        for attempt in (0, 1):
            try:
                client = self._get_client(time.monotonic() + 5.0)
                client.oneway(method, *args)
                return
            except ProtocolError:
                raise
            except ConnectionError:
                if attempt:
                    raise

    # -- lifecycle -----------------------------------------------------

    @property
    def alive(self) -> bool:
        with self._lock:
            return (not self._closed and self._inner is not None
                    and self._inner.alive)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            inner = self._inner
        if inner is not None:
            inner.close()
            # _closed is set, so the reader's on_close returns at once:
            # join it, so that a closed client leaves no thread behind
            inner.join(timeout=5.0)


def wait_for_server(address: Tuple[str, int], timeout: float = 10.0) -> None:
    """Block until a server accepts connections at ``address``.
    Exponential backoff between probes (20ms doubling to 500ms); each
    probe's connect timeout is clamped to the remaining deadline."""
    deadline = time.monotonic() + timeout
    last: Optional[Exception] = None
    delay = 0.02
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"no rpc server at {address}: {last}")
        try:
            sock = socket.create_connection(tuple(address),
                                            timeout=min(1.0, remaining))
            sock.close()
            return
        except OSError as e:
            last = e
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"no rpc server at {address}: {last}")
        time.sleep(min(delay, remaining))
        delay = min(delay * 2, 0.5)


# graftsan blocking probes: with RTPU_SANITIZE=1 the frame
# primitives report when called with an instrumented, non-escaped
# lock held (see devtools/sanitizer). `_send_frame` legitimately
# runs under the per-connection `_send_lock` — that lock carries a
# `# blocking-ok:` escape on its definition, so the probe covers
# every OTHER lock accidentally held across a socket write.
if os.environ.get("RTPU_SANITIZE") == "1":
    from ray_tpu_torch.devtools.sanitizer import (
        wrap_blocking as _wrap_blocking)

    _send_frame = _wrap_blocking(_send_frame, "socket", "rpc._send_frame")
    _recv_frame = _wrap_blocking(_recv_frame, "socket", "rpc._recv_frame")
