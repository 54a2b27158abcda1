"""Chunked node-to-node object transfer: the pull/broadcast plane.

Reference: ``src/ray/object_manager/`` — PullManager/PushManager moving
objects between plasma stores in ~5 MiB chunks through
``ObjectBufferPool`` [UNVERIFIED — mount empty, SURVEY.md §0]. Every
node (including the driver) serves its local store over the wire RPC
layer; consumers pull missing objects chunk-by-chunk
(``object_chunk_size_bytes``) and seal them into their own store.
Within a node the shm plane stays zero-copy; this path is only taken
across node boundaries.

This module is the engine behind docs/object_plane.md:

- **PullManager** — at most one in-flight wire fetch per object per
  node: the first caller drives the transfer, late readers attach and
  are woken on seal (``state=deduped``). Chunk calls are
  deadline-budgeted with seeded-jitter backoff (``_private/backoff``),
  dead peers are pruned from ``PeerClients``, and every failure is
  typed (``ObjectTransferError`` taxonomy in ``ray_tpu_torch/exceptions``).
- **Streaming re-serve** — an in-flight pull serves its already
  received chunks to peers (``fetch_chunk`` → ``("wait", filled)``
  while behind), so N consumers form a tree/chain: each node re-serves
  as soon as it holds bytes and no single link carries N copies.
- **Striped pulls** — objects ≥ ``object_stripe_min_bytes`` with ≥ 2
  sealed holders stripe chunk ranges across sources; a source dying
  mid-stripe re-assigns only its remaining ranges to survivors.
- **Re-route** — when every known source fails, the owner's location
  table (``object_locations`` RPC) supplies live holders
  (``state=rerouted``); exhausted + empty twice ⇒ typed
  ``ObjectSourceLostError`` and the owner's lineage reconstruction
  takes over.

Chaos points: ``object.transfer.fetch`` fires before each chunk RPC in
the pulling process (drop/delay/sever); ``object.transfer.seal`` fires
just before a completed pull seals locally (kill = the restart-storm
mid-transfer death).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import backoff, chaos, wire_stats
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStoreFullError as _StoreFull
from ray_tpu_torch._private.rpc import RpcClient, RpcError, RpcServer
from ray_tpu_torch.exceptions import (ObjectSourceLostError, ObjectTransferError,
                                ObjectTransferTimeoutError)

logger = logging.getLogger(__name__)

# Back-compat alias: the untyped ObjectLocationError this module used
# to define is now the typed, pickle-safe taxonomy in exceptions.py.
ObjectLocationError = ObjectSourceLostError

# Transient wire failures a pull retries/re-routes through. RpcError
# (the remote handler raised) counts: a peer mid-teardown answers a
# few calls with handler errors before the socket dies.
_TRANSIENT = (ConnectionError, OSError, TimeoutError, RpcError)


# ---------------------------------------------------------------------------
# pull-state counters (exported as ray_tpu_object_pulls{state=...};
# raylets ship theirs to the driver in heartbeat "pulls" sub-dicts)

_counter_lock = threading.Lock()
_counters = {  # guarded-by: _counter_lock
    "started": 0, "deduped": 0, "rerouted": 0, "striped": 0,
    "failed": 0}


def _bump(state: str, n: int = 1) -> None:
    with _counter_lock:
        _counters[state] += n


def pull_counters() -> Dict[str, int]:
    """Snapshot of this process's cumulative pull-state counters."""
    with _counter_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counter_lock:
        for key in _counters:
            _counters[key] = 0


# ---------------------------------------------------------------------------
# serving side


def serve_store(server: RpcServer,
                get_view: Callable[[bytes], Optional[memoryview]],
                free_fn: Optional[Callable[[bytes], None]] = None,
                progress: Optional[Callable] = None,
                stats: Optional[wire_stats.ChannelStats] = None) -> None:
    """Register object-manager handlers on an RpcServer.

    ``get_view(oid_bytes)`` returns a zero-copy memoryview of the sealed
    object (restoring spilled copies as needed) or None.

    ``progress(oid_bytes, offset, length)`` (normally
    ``PullManager.progress``) lets an in-flight pull re-serve chunks it
    already received — the tree-broadcast streaming hook. ``stats``
    overrides the per-link served-bytes channel (tests give each
    simulated node its own counter; default is this process's
    ``object_serve`` wire channel).
    """
    ch = stats if stats is not None else wire_stats.channel("object_serve")

    def fetch_object(ctx, oid_bytes: bytes, offset: int, length: int):
        # Legacy single-source protocol: bytes, or None when gone.
        view = get_view(oid_bytes)
        if view is None:
            return None
        data = bytes(view[offset:offset + length])
        ch.record(1, len(data))
        return data

    def fetch_chunk(ctx, oid_bytes: bytes, offset: int, length: int):
        """Pull-engine protocol: ``("ok", bytes)`` for a sealed (or
        already-received in-flight) range, ``("wait", filled)`` while
        an in-flight pull is still behind ``offset+length``,
        ``("gone",)`` when this node neither holds nor pulls it."""
        view = get_view(oid_bytes)
        if view is not None:
            data = bytes(view[offset:offset + length])
            ch.record(1, len(data))
            return ("ok", data)
        if progress is not None:
            reply = progress(oid_bytes, offset, length)
            if reply is not None:
                if reply[0] == "ok":
                    ch.record(1, len(reply[1]))
                return reply
        return ("gone",)

    def object_info(ctx, oid_bytes: bytes):
        view = get_view(oid_bytes)
        return None if view is None else len(view)

    def free_object(ctx, oid_bytes: bytes):
        if free_fn is not None:
            free_fn(oid_bytes)

    server.register("fetch_object", fetch_object)
    server.register("fetch_chunk", fetch_chunk)
    server.register("object_info", object_info)
    server.register("free_object", free_object)


# ---------------------------------------------------------------------------
# legacy single-source client (bench baseline + minimal wire client)


def pull_object(client: RpcClient, oid_bytes: bytes, size: int,
                chunk_size: Optional[int] = None,
                timeout: float = 60.0) -> bytes:
    """Pull a whole object from ONE peer in bounded chunks. The
    PullManager is the production path (dedup, retries, striping,
    re-route); this stays as the minimal wire client and the bench's
    pre-broadcast baseline."""
    if chunk_size is None:
        chunk_size = get_config().object_chunk_size_bytes
    buf = bytearray(size)
    off = 0
    oid_hex = oid_bytes.hex()
    while off < size:
        n = min(chunk_size, size - off)
        data = client.call("fetch_object", oid_bytes, off, n,
                           timeout=timeout)
        if not data:
            # None: the peer freed the object between chunks; b"": a
            # truncated read. Both surface typed — with the object and
            # the offset reached — BEFORE any buffer write or offset
            # advance.
            raise ObjectSourceLostError(
                f"peer no longer serves object {oid_hex[:16]} "
                f"(offset {off}/{size})",
                object_id_hex=oid_hex, offset=off)
        buf[off:off + len(data)] = data
        off += len(data)
    return bytes(buf)


class PeerClients:
    """Cache of RpcClients to peer object managers, keyed by address."""

    def __init__(self):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}  # guarded-by: _lock
        self._lock = threading.Lock()  # blocking-ok: dial-once cache — RpcClient() handshakes under the lock BY DESIGN so two pulls never double-dial a peer

    def get(self, addr: Tuple[str, int]) -> RpcClient:
        addr = tuple(addr)
        with self._lock:
            client = self._clients.get(addr)
            if client is None or not client.alive:
                client = RpcClient(addr)
                self._clients[addr] = client
            return client

    def drop(self, addr: Tuple[str, int]) -> None:
        """Prune a dead (or chaos-severed) peer: close and forget its
        cached client so the next ``get`` re-dials."""
        addr = tuple(addr)
        with self._lock:
            client = self._clients.pop(addr, None)
        if client is not None:
            client.close()

    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                client.close()
            self._clients.clear()


# ---------------------------------------------------------------------------
# the pull engine


class _Pull:
    """One in-flight transfer. The driving thread (plus striping
    workers) writes disjoint chunk ranges straight into the local
    store's unsealed segment; attachers block on ``done``; the serving
    side streams already-received chunks out through ``read_range``
    while the pull is in flight (tree broadcast: a node re-serves
    bytes as soon as it holds them)."""

    def __init__(self, oid_bytes: bytes, size: int, chunk_size: int,
                 buf: memoryview):
        self.oid_bytes = oid_bytes
        self.hex = oid_bytes.hex()
        self.size = size
        self.chunk_size = max(1, int(chunk_size))
        self.nchunks = max(1, -(-size // self.chunk_size))
        self._lock = threading.Lock()
        self._buf: Optional[memoryview] = buf  # guarded-by: _lock
        self._chunk_done = bytearray(self.nchunks)  # guarded-by: _lock
        self._prefix_chunks = 0  # guarded-by: _lock
        if size == 0:  # nothing to fetch; seal immediately
            self._chunk_done[0] = 1
            self._prefix_chunks = 1
        self.done = threading.Event()
        self.error: Optional[ObjectTransferError] = None
        self.rerouted = False  # first source switch already counted

    def write(self, idx: int, off: int, data: bytes) -> None:
        with self._lock:
            if self._buf is None or self._chunk_done[idx]:
                return
            self._buf[off:off + len(data)] = data
            self._chunk_done[idx] = 1
            while (self._prefix_chunks < self.nchunks
                   and self._chunk_done[self._prefix_chunks]):
                self._prefix_chunks += 1

    def next_undone(self) -> Optional[int]:
        with self._lock:
            for i in range(self._prefix_chunks, self.nchunks):
                if not self._chunk_done[i]:
                    return i
            return None

    def prefix_bytes(self) -> int:
        with self._lock:
            return min(self.size, self._prefix_chunks * self.chunk_size)

    def read_range(self, off: int, n: int):
        """("ok", bytes) when [off, off+n) is fully received, else
        ("wait", filled_prefix_bytes)."""
        with self._lock:
            filled = min(self.size, self._prefix_chunks * self.chunk_size)
            if self._buf is None:
                return ("wait", filled)
            first = off // self.chunk_size
            last = min(self.nchunks,
                       max(first, (off + max(1, n) - 1) // self.chunk_size)
                       + 1)
            if all(self._chunk_done[i] for i in range(first, last)):
                return ("ok", bytes(self._buf[off:off + n]))
            return ("wait", filled)

    def release_buf(self) -> None:
        """Drop the segment view (before seal or abort) so the store
        can unlink/close the mapping without exported-pointer pins."""
        with self._lock:
            buf, self._buf = self._buf, None
        if buf is not None:
            try:
                buf.release()
            except BufferError:  # pragma: no cover - defensive
                pass  # swallow-ok: a pinned view only defers the store's segment close (its zombie path handles it)


def _normalize_addrs(sources) -> List[Tuple[str, int]]:
    """Accept one ``(host, port)`` or a sequence of them; dedup
    preserving order."""
    if not sources:
        return []
    if (len(sources) == 2 and isinstance(sources[0], str)
            and isinstance(sources[1], int)):
        sources = [sources]
    out: List[Tuple[str, int]] = []
    for addr in sources:
        if not addr:
            continue
        addr = tuple(addr)
        if addr not in out:
            out.append(addr)
    return out


class PullManager:
    """Per-node pull engine: dedup, deadline-budgeted retries, striped
    multi-source pulls, owner re-route, streaming re-serve.

    Concurrency contract (compiled into contracts.json; enforced at
    runtime by graftsan under RTPU_SANITIZE=1):

    - ``_cv`` guards the in-flight map and the admission budget; the
      attach/seal race is resolved entirely under it (an object is
      either sealed in the store, in ``_inflight``, or absent — never
      two of those for one caller).
    - per-pull chunk state is guarded by ``_Pull._lock``.
    - lock-order: PullManager._cv -> _Pull._lock
    - lock-order: PullManager._cv -> ShmStore._lock
    - No RPC is issued and no chunk wait happens under either lock
      (``_cv.wait`` releases it; the drive loop runs lock-free).
    """

    def __init__(self, store, peers: PeerClients,
                 locate: Optional[Callable[[bytes], Sequence]] = None,
                 label: str = ""):
        self._store = store  # ShmStore: begin_create/seal/abort_create
        self._peers = peers
        self._locate = locate  # owner-local location lookup (driver)
        self._label = label
        self._cv = threading.Condition()
        self._inflight: Dict[bytes, _Pull] = {}  # guarded-by: _cv
        self._inflight_bytes = 0  # guarded-by: _cv

    # -- serve-side streaming hook ------------------------------------

    def progress(self, oid_bytes: bytes, offset: int, length: int):
        """``serve_store``'s ``progress`` hook: chunk bytes from an
        in-flight pull, or None when nothing is in flight."""
        # lock-order: PullManager._cv -> _Pull._lock
        with self._cv:
            pull = self._inflight.get(oid_bytes)
            if pull is None:
                return None
            return pull.read_range(offset, length)

    def inflight_bytes(self) -> int:
        with self._cv:
            return self._inflight_bytes

    # -- the pull ------------------------------------------------------

    def pull(self, oid_bytes: bytes, size: int, sources,
             owner_addr=None, deadline_s: Optional[float] = None) -> bool:
        """Ensure the object is sealed in the local store, fetching it
        over the wire if needed. Returns True when a wire transfer was
        driven or attached to, False when the object was already
        local. Raises the ``ObjectTransferError`` taxonomy on failure
        (never an untyped error)."""
        cfg = get_config()
        oid = ObjectID(oid_bytes)
        oid_hex = oid_bytes.hex()
        budget = cfg.object_pull_deadline_s if deadline_s is None \
            else deadline_s
        deadline = time.monotonic() + budget
        srcs = _normalize_addrs(sources)
        pull: Optional[_Pull] = None
        attach: Optional[_Pull] = None
        with self._cv:
            while True:
                if self._store.contains(oid):
                    return False
                attach = self._inflight.get(oid_bytes)
                if attach is not None:
                    break
                cap = cfg.object_pull_max_inflight_bytes
                if self._inflight_bytes and \
                        self._inflight_bytes + size > cap:
                    # Admission: a restart storm of pulls queues here
                    # instead of ballooning unsealed buffers past the
                    # watchdog budget (oversized singles admit alone
                    # once the store drains).
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise self._typed(
                            ObjectTransferTimeoutError,
                            f"pull admission for {oid_hex[:16]} timed "
                            f"out ({self._inflight_bytes} in-flight "
                            f"bytes ahead)", oid_bytes, -1)
                    self._cv.wait(timeout=min(0.5, remaining))
                    continue
                try:
                    buf = self._store.begin_create(oid, size)
                except _StoreFull as e:
                    raise self._typed(
                        ObjectTransferError,
                        f"store cannot admit pull of {oid_hex[:16]} "
                        f"({size} bytes): {e}", oid_bytes, -1) from e
                if buf is None:  # sealed while negotiating
                    return False
                pull = _Pull(oid_bytes, size,
                             cfg.object_chunk_size_bytes, buf)
                self._inflight[oid_bytes] = pull
                self._inflight_bytes += size
                _bump("started")
                break
        if attach is not None:
            _bump("deduped")
            remaining = deadline - time.monotonic()
            if not attach.done.wait(timeout=max(0.0, remaining)):
                raise self._typed(
                    ObjectTransferTimeoutError,
                    f"attached pull of {oid_hex[:16]} exceeded its "
                    f"{budget:.1f}s budget", oid_bytes,
                    attach.prefix_bytes())
            if attach.error is not None:
                raise attach.error
            return True
        try:
            self._drive(pull, srcs, owner_addr, deadline)
            # The restart-storm death: a node dying right before seal,
            # holding a complete unsealed buffer (docs/object_plane.md)
            chaos.fire("object", "transfer", "seal")
            pull.release_buf()
            self._store.seal(oid)
        except ObjectTransferError as e:
            _bump("failed")
            pull.error = e
            pull.release_buf()
            self._store.abort_create(oid)
            raise
        except Exception as e:
            _bump("failed")
            err = self._typed(
                ObjectTransferError,
                f"pull of {oid_hex[:16]} failed: {e!r}", oid_bytes,
                pull.prefix_bytes())
            pull.error = err
            pull.release_buf()
            self._store.abort_create(oid)
            raise err from e
        finally:
            with self._cv:
                self._inflight.pop(oid_bytes, None)
                self._inflight_bytes -= size
                self._cv.notify_all()
            pull.done.set()
        return True

    # -- drive strategies ---------------------------------------------

    def _drive(self, pull: _Pull, sources: List[Tuple[str, int]],
               owner_addr, deadline: float) -> None:
        if pull.next_undone() is None:
            return  # zero-size object
        cfg = get_config()
        if (pull.size >= cfg.object_stripe_min_bytes
                and pull.nchunks >= 2 and len(sources) >= 2):
            holders = self._probe_sealed(pull, sources, deadline)
            if len(holders) >= 2:
                _bump("striped")
                self._drive_striped(pull, holders, deadline)
                if pull.next_undone() is None:
                    return
                # every striped source died mid-transfer: the
                # sequential path below re-routes the remaining ranges
                self._mark_rerouted(pull)
        self._drive_sequential(pull, sources, owner_addr, deadline)

    def _probe_sealed(self, pull: _Pull, sources, deadline: float):
        """Sources holding a SEALED full copy (streaming parents report
        None from ``object_info``) — the stripe fan-in set."""
        cfg = get_config()
        sealed = []
        for addr in sources:
            if len(sealed) >= cfg.object_stripe_max_sources:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                client = self._peers.get(addr)
                info = client.call(
                    "object_info", pull.oid_bytes,
                    timeout=min(cfg.object_pull_chunk_timeout_s,
                                remaining))
            except _TRANSIENT:
                continue
            if info == pull.size:
                sealed.append(addr)
        return sealed

    def _drive_sequential(self, pull: _Pull, sources, owner_addr,
                          deadline: float) -> None:
        """One source at a time: stream behind an in-flight parent
        (tree broadcast), fail over across the source list, refresh it
        from the owner when exhausted."""
        cfg = get_config()
        ch = wire_stats.channel("object_transfer")
        rng = backoff.make_rng()
        srcs = list(sources)
        si = 0
        delay = 0.0
        empty_refreshes = 0
        stall: Optional[Tuple[float, int]] = None  # (since_ts, filled)
        while True:
            idx = pull.next_undone()
            if idx is None:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise self._typed(
                    ObjectTransferTimeoutError,
                    f"pull of {pull.hex[:16]} timed out at offset "
                    f"{pull.prefix_bytes()}/{pull.size}",
                    pull.oid_bytes, pull.prefix_bytes())
            if si >= len(srcs):
                fresh = self._locate_sources(pull, owner_addr)
                if not fresh:
                    empty_refreshes += 1
                    if empty_refreshes >= 2 or (not srcs
                                                and owner_addr is None
                                                and self._locate is None):
                        raise self._typed(
                            ObjectSourceLostError,
                            f"no live holder serves {pull.hex[:16]} "
                            f"(offset {pull.prefix_bytes()}/"
                            f"{pull.size})", pull.oid_bytes,
                            pull.prefix_bytes())
                else:
                    empty_refreshes = 0
                    if fresh != srcs:
                        self._mark_rerouted(pull)
                    srcs = fresh
                si = 0
                delay = backoff.next_backoff(
                    delay, cfg.object_pull_retry_base_s,
                    cfg.object_pull_retry_cap_s)
                self._sleep(backoff.jittered(delay, rng), deadline)
                continue
            addr = srcs[si]
            off = idx * pull.chunk_size
            n = min(pull.chunk_size, pull.size - off)
            action = chaos.fire("object", "transfer", "fetch")
            if action == "drop":
                # the chunk attempt vanishes: transient, same source
                delay = backoff.next_backoff(
                    delay, cfg.object_pull_retry_base_s,
                    cfg.object_pull_retry_cap_s)
                self._sleep(backoff.jittered(delay, rng), deadline)
                continue
            if action == "sever":
                self._peers.drop(addr)  # reconnect on next get()
                delay = backoff.next_backoff(
                    delay, cfg.object_pull_retry_base_s,
                    cfg.object_pull_retry_cap_s)
                self._sleep(backoff.jittered(delay, rng), deadline)
                continue
            try:
                client = self._peers.get(addr)
                reply = client.call(
                    "fetch_chunk", pull.oid_bytes, off, n,
                    timeout=min(cfg.object_pull_chunk_timeout_s,
                                remaining))
            except _TRANSIENT:
                self._fail_source(pull, addr)
                si += 1
                stall = None
                delay = backoff.next_backoff(
                    delay, cfg.object_pull_retry_base_s,
                    cfg.object_pull_retry_cap_s)
                self._sleep(backoff.jittered(delay, rng), deadline)
                continue
            tag = reply[0] if isinstance(reply, tuple) and reply \
                else "gone"
            if tag == "ok":
                data = reply[1]
                if not data:
                    raise self._typed(
                        ObjectSourceLostError,
                        f"peer {addr} returned an empty chunk for "
                        f"{pull.hex[:16]} at offset {off}",
                        pull.oid_bytes, off)
                if len(data) != n:
                    # truncated range: protocol violation, treat the
                    # source as failed rather than sealing torn bytes
                    self._fail_source(pull, addr)
                    si += 1
                    continue
                pull.write(idx, off, data)
                ch.record(1, len(data))
                delay = 0.0
                stall = None
                continue
            if tag == "wait":
                filled = reply[1]
                now = time.monotonic()
                if stall is None or filled > stall[1]:
                    stall = (now, filled)
                elif now - stall[0] > cfg.object_pull_chunk_timeout_s:
                    # parent's own pull stopped making progress: fail
                    # over (its subtree re-roots on a live holder)
                    si += 1
                    stall = None
                    self._mark_rerouted(pull)
                    continue
                self._sleep(0.02, deadline)
                continue
            # "gone": this source neither holds nor pulls the object
            si += 1
            stall = None

    def _drive_striped(self, pull: _Pull, holders, deadline: float) -> None:
        """Stripe chunk ranges across sealed holders; a worker's death
        re-assigns only its remaining ranges (the shared work queue
        drains to survivors)."""
        cfg = get_config()
        ch = wire_stats.channel("object_transfer")
        work = deque(  # unbounded-ok: at most nchunks ints, fixed at pull start
            i for i in range(pull.nchunks)
            if pull.read_range(i * pull.chunk_size, 1)[0] != "ok")
        work_lock = threading.Lock()

        def worker(addr) -> None:
            rng = backoff.make_rng()
            delay = 0.0
            failures = 0
            while time.monotonic() < deadline:
                with work_lock:
                    if not work:
                        return
                    idx = work.popleft()
                off = idx * pull.chunk_size
                n = min(pull.chunk_size, pull.size - off)
                action = chaos.fire("object", "transfer", "fetch")
                if action == "sever":
                    self._peers.drop(addr)
                ok = False
                if action != "drop":
                    try:
                        client = self._peers.get(addr)
                        reply = client.call(
                            "fetch_chunk", pull.oid_bytes, off, n,
                            timeout=min(
                                cfg.object_pull_chunk_timeout_s,
                                max(0.1,
                                    deadline - time.monotonic())))
                        if (isinstance(reply, tuple) and reply
                                and reply[0] == "ok"
                                and len(reply[1]) == n and n):
                            pull.write(idx, off, reply[1])
                            ch.record(1, n)
                            ok = True
                    except _TRANSIENT:
                        pass
                if ok:
                    failures = 0
                    delay = 0.0
                    continue
                with work_lock:
                    work.appendleft(idx)  # re-assign to survivors
                failures += 1
                if failures >= 3:
                    self._fail_source(pull, addr)
                    return  # source dead; its ranges drain to peers
                delay = backoff.next_backoff(
                    delay, cfg.object_pull_retry_base_s,
                    cfg.object_pull_retry_cap_s)
                self._sleep(backoff.jittered(delay, rng), deadline)

        k = min(len(holders), cfg.object_stripe_max_sources)
        threads = [threading.Thread(
            target=worker, args=(addr,), daemon=True,
            name=f"rtpu-pull-stripe-{i}")
            for i, addr in enumerate(holders[:k])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()) + 1.0)

    # -- helpers -------------------------------------------------------

    def _locate_sources(self, pull: _Pull, owner_addr):
        """Fresh live-holder list: owner-local lookup on the driver,
        the owner's ``object_locations`` RPC everywhere else."""
        cfg = get_config()
        if self._locate is not None:
            try:
                return _normalize_addrs(self._locate(pull.oid_bytes))
            except Exception:
                # swallow-ok: the location refresh is advisory — the
                # pull deadline bounds the retry loop either way
                return []
        if owner_addr:
            try:
                client = self._peers.get(tuple(owner_addr))
                fresh = client.call(
                    "object_locations", pull.oid_bytes,
                    timeout=cfg.object_pull_chunk_timeout_s)
                return _normalize_addrs(fresh)
            except _TRANSIENT:
                return []
        return []

    def _fail_source(self, pull: _Pull, addr) -> None:
        self._peers.drop(addr)
        self._mark_rerouted(pull)

    @staticmethod
    def _mark_rerouted(pull: _Pull) -> None:
        if not pull.rerouted:
            pull.rerouted = True
            _bump("rerouted")

    @staticmethod
    def _sleep(delay_s: float, deadline: float) -> None:
        remaining = deadline - time.monotonic()
        if remaining > 0 and delay_s > 0:
            time.sleep(min(delay_s, remaining))

    @staticmethod
    def _typed(cls, msg: str, oid_bytes: bytes,
               offset: int) -> ObjectTransferError:
        err = cls(msg, object_id_hex=oid_bytes.hex(), offset=offset)
        err.oid_bytes = oid_bytes  # the raylet's lost_arg payload key
        return err
