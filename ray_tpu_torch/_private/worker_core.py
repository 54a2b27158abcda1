"""Per-worker core: distributed ownership of objects created in tasks.

Reference: ``src/ray/core_worker/reference_counter.cc`` +
``core_worker/store_provider`` [UNVERIFIED — mount empty, SURVEY.md
§0]. In the reference every worker embeds a CoreWorker that OWNS the
objects it creates: metadata, reference count, and the borrowing
protocol live with the creator, and peers fetch the bytes without the
driver in the path. Round 2 of this runtime proxied all of that
through the single driver; this module decentralizes it:

- ``WorkerCore`` runs inside each worker process (lazily, on first
  ``put``): an owner directory (oid → blob | shm segment), an owner
  RPC port serving peers, and owner-side reference counting (local
  refs + registered borrows).
- ``ObjectRef`` gains an ``owner_addr``; refs serialize WITH the owner
  address, so any process holding the ref knows where to go.
- Borrowers (other workers, the driver) register with the owner when
  a ref crosses into them (deserialization hook / task-arg pinning at
  submission) and release on ref death — the borrowing protocol's
  cheap half. The owner frees the object when its local refs AND
  borrows are both gone.
- **Owner death == object loss** (the reference's semantics: ownership
  is not replicated). A fetch from a dead owner raises
  ``OwnerDiedError``; there is no lineage for put()s, exactly like the
  reference.

The driver stays the scheduling plane (that centralization is this
framework's TPU-first design — see ARCHITECTURE.md §2), but object
bytes now move owner → consumer directly: same-node via the shm
segment name, cross-node as bytes over the owner port.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.exceptions import OwnerDiedError

logger = logging.getLogger(__name__)


class WorkerCore:
    """Owner-side object plane of one worker process."""

    def __init__(self, session: str, max_inline_bytes: int):
        from ray_tpu_torch._private.rpc import RpcServer
        self.session = session
        self.max_inline_bytes = max_inline_bytes
        self.serde = serialization.get_context()
        # Identity: a private task-id namespace for objects this process
        # creates (puts use ObjectID.for_put against it).
        self._self_task_id = TaskID.of(ActorID.of(JobID.from_int(0xFE)))
        self._put_index = 0
        self._cv = threading.Condition()
        # oid -> ("blob", bytes) | ("shm", segment_name, size)
        self._objects: Dict[ObjectID, tuple] = {}
        self._segments: Dict[ObjectID, Any] = {}   # keeps shm alive
        self._local_refs: Dict[ObjectID, int] = {}
        self._borrows: Dict[ObjectID, int] = {}
        # Containment: refs captured inside a stored value stay alive
        # (and thus borrowed/pinned) for the container's lifetime.
        self._contained: Dict[ObjectID, tuple] = {}
        # Inbound compiled-DAG channel values: oid -> [entry, takes_left]
        self._pushed: Dict[ObjectID, list] = {}
        self._zombies: List[Any] = []   # segments with live local views
        self.server = RpcServer()
        self.address: Tuple[str, int] = self.server.address
        s = self.server
        s.register("owner_get", self._h_get)
        s.register("owner_get_many",
                   lambda ctx, oids, timeout:
                   [self._h_get(ctx, b, timeout) for b in oids])
        s.register("owner_get_bytes",
                   lambda ctx, oid_b: self._h_get_bytes(oid_b))
        s.register("owner_wait", self._h_wait)
        s.register("owner_contains", self._h_contains)
        s.register("owner_borrow", self._h_borrow)
        s.register("owner_release", self._h_release)
        s.register("chan_push",
                   lambda ctx, oid_b, entry, takes:
                   self.accept_push(ObjectID(oid_b), tuple(entry), takes))

    # -- owner-side API (called by user code in THIS process) ----------

    def put(self, value: Any):
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private.object_store import create_segment
        ser = self.serde.serialize(value)
        with self._cv:
            self._put_index += 1
            oid = ObjectID.for_put(self._self_task_id, self._put_index)
        size = ser.size_with_header()
        if size <= self.max_inline_bytes:
            entry = ("blob", ser.to_bytes())
            seg = None
        else:
            # Full oid in the name: a truncated prefix would be
            # constant across one owner's puts/channels (it only covers
            # the task-id prefix) and collide under load.
            name = f"rtpt_own_{os.getpid()}_{oid.hex()}"
            seg = create_segment(name, size)
            ser.write_into(seg.buf)
            entry = ("shm", name, size)
        with self._cv:
            self._objects[oid] = entry
            if seg is not None:
                self._segments[oid] = seg
            if ser.contained_refs:
                self._contained[oid] = tuple(ser.contained_refs)
            self._cv.notify_all()
        # Local ref accounting starts when the ObjectRef below is
        # constructed (the object_ref hooks route back here).
        return ObjectRef(oid, owner_addr=self.address)

    def owns(self, oid: ObjectID) -> bool:
        with self._cv:
            return oid in self._objects

    def publish(self, oid: ObjectID, blob, consumers: int,
                kind: str = "blob") -> Optional[str]:
        """Channel publication (compiled DAGs, ``ray_tpu_torch.dag``): store an
        already-serialized value under a PRE-ARRANGED id with a fixed
        consumer budget. Each consumer fetches owner-direct and releases
        one borrow after reading; the last release frees the slot — the
        channel is a single-producer, counted-consumer mailbox.

        Unlike ``put`` there is no local ref: lifetime is exactly the
        consumer budget. ``kind="err"`` publishes a serialized error so
        downstream stages unblock with the producer's failure instead of
        timing out.
        """
        from ray_tpu_torch._private.object_store import create_segment
        blob = blob if isinstance(blob, bytes) else bytes(blob)
        size = len(blob)
        seg = None
        if kind == "blob" and size > self.max_inline_bytes:
            # Full oid in the name: a truncated prefix would be
            # constant across one owner's puts/channels (it only covers
            # the task-id prefix) and collide under load.
            name = f"rtpt_own_{os.getpid()}_{oid.hex()}"
            seg = create_segment(name, size)
            seg.buf[:size] = blob
            entry = ("shm", name, size)
        else:
            entry = (kind, blob)
        with self._cv:
            self._objects[oid] = entry
            if seg is not None:
                self._segments[oid] = seg
            self._borrows[oid] = max(1, int(consumers))
            self._cv.notify_all()
        return entry[1] if seg is not None else None

    # -- push channels (compiled DAGs) ---------------------------------

    def accept_push(self, oid: ObjectID, entry: tuple, takes: int) -> None:
        """Inbound channel value from an upstream stage's worker. The
        entry lands in THIS consumer's directory so its resolve is a
        local cv wait — no round trip on the data path. ``takes`` is the
        number of resolves the consumer will perform (a node may use the
        same upstream value in several arg positions)."""
        with self._cv:
            slot = self._pushed.get(oid)
            if slot is not None:
                # Defensive: a second push for the same channel id adds
                # takes instead of clobbering the first (normally the
                # compiler aggregates pushes per consumer core).
                slot[1] += max(1, int(takes))
            else:
                self._pushed[oid] = [entry, max(1, int(takes))]
            self._cv.notify_all()

    def take_pushed(self, oid: ObjectID, timeout: Optional[float]) -> tuple:
        """Consume one take of a pushed channel value; the last take
        drops it."""
        with self._cv:
            if oid not in self._pushed:
                ok = self._cv.wait_for(lambda: oid in self._pushed,
                                       timeout)
                if not ok:
                    raise TimeoutError(
                        f"channel value {oid} never arrived (upstream "
                        "stage dead or still running)")
            slot = self._pushed[oid]
            slot[1] -= 1
            if slot[1] <= 0:
                del self._pushed[oid]
            return slot[0]

    def get_local_blob(self, oid: ObjectID,
                       timeout: Optional[float] = None) -> tuple:
        """("val"|"err", memoryview) for an object this process owns."""
        with self._cv:
            if oid not in self._objects:
                ok = self._cv.wait_for(lambda: oid in self._objects,
                                       timeout)
                if not ok:
                    raise TimeoutError(f"owned object {oid} not produced")
            entry = self._objects[oid]
        if entry[0] == "blob":
            return ("val", memoryview(entry[1]))
        if entry[0] == "err":
            return ("err", memoryview(entry[1]))
        seg = self._segments[oid]
        return ("val", seg.buf[:entry[2]])

    # -- reference counting --------------------------------------------

    def on_local_ref(self, oid: ObjectID) -> None:
        with self._cv:
            if oid in self._objects:
                self._local_refs[oid] = self._local_refs.get(oid, 0) + 1

    def on_local_unref(self, oid: ObjectID) -> None:
        free = False
        with self._cv:
            if oid not in self._objects:
                return
            n = self._local_refs.get(oid, 1) - 1
            if n <= 0:
                self._local_refs.pop(oid, None)
                free = self._borrows.get(oid, 0) <= 0
            else:
                self._local_refs[oid] = n
        if free:
            self._free(oid)

    def _free(self, oid: ObjectID) -> None:
        with self._cv:
            self._objects.pop(oid, None)
            seg = self._segments.pop(oid, None)
            self._borrows.pop(oid, None)
            self._contained.pop(oid, None)   # drops child refs -> release
        if seg is not None:
            # unlink first: it drops the NAME even while same-process
            # zero-copy views keep the mapping alive; close() would
            # raise BufferError in that case — park the segment and
            # close it at shutdown instead of leaking it in /dev/shm.
            try:
                seg.unlink()
            except Exception:
                pass    # segment name already gone
            try:
                seg.close()
            except BufferError:
                self._zombies.append(seg)
            except Exception:
                pass    # close raced the segment's removal

    # -- peer-facing handlers ------------------------------------------

    def _h_get(self, ctx, oid_b: bytes, timeout):
        """Reply ("val"|"err", bytes) or ("shm", name, size) — the
        borrower tries the same-machine shm fast path first and falls
        back to a bytes fetch; or ("gone",) if freed."""
        oid = ObjectID(oid_b)
        with self._cv:
            entry = self._objects.get(oid)
            if entry is None and timeout:
                self._cv.wait_for(lambda: oid in self._objects, timeout)
                entry = self._objects.get(oid)
        if entry is None:
            return ("gone",)
        if entry[0] == "shm":
            return ("shm", entry[1], entry[2])
        return (("err" if entry[0] == "err" else "val"), entry[1])

    def _h_get_bytes(self, oid_b: bytes):
        oid = ObjectID(oid_b)
        with self._cv:
            entry = self._objects.get(oid)
        if entry is None:
            return ("gone",)
        if entry[0] == "shm":
            seg = self._segments[oid]
            return ("val", bytes(seg.buf[:entry[2]]))
        return (("err" if entry[0] == "err" else "val"), entry[1])

    def _h_wait(self, ctx, oid_bytes_list, num_returns, timeout):
        ids = [ObjectID(b) for b in oid_bytes_list]
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [o for o in ids if o in self._objects]
                if len(ready) >= num_returns or (
                        deadline is not None
                        and time.monotonic() >= deadline):
                    return [o.binary() for o in ready]
                rem = None if deadline is None else max(
                    0.0, deadline - time.monotonic())
                if not self._cv.wait(rem):
                    ready = [o for o in ids if o in self._objects]
                    return [o.binary() for o in ready]

    def _h_contains(self, ctx, oid_b: bytes) -> bool:
        with self._cv:
            return ObjectID(oid_b) in self._objects

    def add_borrow(self, oid: ObjectID) -> bool:
        """Count a borrow held by an external entity (driver entry,
        task-arg pin, message in flight) — also used when that entity
        lives in the owner's own process."""
        with self._cv:
            if oid not in self._objects:
                return False
            self._borrows[oid] = self._borrows.get(oid, 0) + 1
            return True

    def _h_borrow(self, ctx, oid_b: bytes) -> bool:
        return self.add_borrow(ObjectID(oid_b))

    def _h_release(self, ctx, oid_b: bytes) -> None:
        oid = ObjectID(oid_b)
        free = False
        with self._cv:
            if oid not in self._objects:
                return
            n = self._borrows.get(oid, 1) - 1
            if n <= 0:
                self._borrows.pop(oid, None)
                free = self._local_refs.get(oid, 0) <= 0
            else:
                self._borrows[oid] = n
        if free:
            self._free(oid)

    def shutdown(self) -> None:
        for oid in list(self._objects):
            self._free(oid)
        for seg in self._zombies:
            try:
                seg.close()
            except Exception:
                pass    # still-pinned view: process exit reclaims
        self._zombies.clear()
        self.server.shutdown()


# ---------------------------------------------------------------------------
# Process-wide singleton + borrower-side fetch plane

_core: Optional[WorkerCore] = None
_core_lock = threading.Lock()
_core_params: Dict[str, Any] = {"session": "own", "max_inline": None}


def configure(session: str, max_inline_bytes: int) -> None:
    """Called by the worker main loop before any task runs."""
    _core_params["session"] = session
    _core_params["max_inline"] = max_inline_bytes


def get_worker_core() -> WorkerCore:
    global _core
    if _core is None:
        with _core_lock:
            if _core is None:
                max_inline = _core_params["max_inline"]
                if max_inline is None:
                    from ray_tpu_torch._private.config import get_config
                    max_inline = get_config().max_direct_call_object_size
                _core = WorkerCore(_core_params["session"], max_inline)
    return _core


def try_worker_core() -> Optional[WorkerCore]:
    return _core


# Borrower-side peer-connection cache. Entries drop on connection death.
_peers: Dict[Tuple[str, int], Any] = {}
_peers_lock = threading.Lock()  # blocking-ok: dial-once cache — peer connect handshakes under the lock BY DESIGN so borrowers never double-dial


def _peer(addr: Tuple[str, int]):
    from ray_tpu_torch._private.rpc import RpcClient
    addr = tuple(addr)
    with _peers_lock:
        client = _peers.get(addr)
        if client is not None and client.alive:
            return client
        client = RpcClient(addr, connect_timeout=5.0)
        _peers[addr] = client
        return client


def _owner_call(addr, method, *args, timeout=None):
    try:
        return _peer(tuple(addr)).call(method, *args, timeout=timeout)
    except (ConnectionError, OSError, TimeoutError) as e:
        if isinstance(e, TimeoutError):
            raise
        raise OwnerDiedError(
            f"owner at {tuple(addr)} is unreachable — objects it owned "
            f"are lost (ownership is not replicated)") from e


def _blob_from_reply(addr: Tuple[str, int], oid: ObjectID,
                     reply: tuple) -> tuple:
    if reply[0] == "shm":
        # Same-machine fast path: map the owner's segment directly.
        _, name, size = reply
        try:
            from multiprocessing import shared_memory
            seg = shared_memory.SharedMemory(name=name, create=False)
            data = bytes(seg.buf[:size])
            seg.close()
            return ("val", data)
        except Exception:
            reply = _owner_call(addr, "owner_get_bytes", oid.binary())
    if reply[0] == "gone":
        from ray_tpu_torch.exceptions import ObjectLostError
        raise ObjectLostError(
            f"object {oid} was freed by its owner (all references "
            f"released)")
    return reply[0], reply[1]


def fetch_blob_from_owner(addr: Tuple[str, int], oid: ObjectID,
                          timeout: Optional[float] = None) -> tuple:
    """("val"|"err", bytes-like) from the owner at ``addr``; raises
    OwnerDiedError if the owner process is gone, ObjectLostError if
    the owner freed the object."""
    core = try_worker_core()
    if core is not None and tuple(addr) == core.address:
        return core.get_local_blob(oid, timeout)
    reply = _owner_call(addr, "owner_get", oid.binary(), timeout,
                        timeout=None if timeout is None else timeout + 30)
    return _blob_from_reply(addr, oid, reply)


def _value_from_blob(kind: str, blob) -> Any:
    from ray_tpu_torch.exceptions import TaskError
    value, _ = serialization.get_context().deserialize_from_blob(
        memoryview(blob))
    if kind == "err":
        raise value.as_instanceof_cause() \
            if isinstance(value, TaskError) else value
    return value


def fetch_value_from_owner(addr: Tuple[str, int], oid: ObjectID,
                           timeout: Optional[float] = None) -> Any:
    """The one shared owned-ref resolution path: fetch + deserialize +
    raise stored task errors. Raises OwnerDiedError / ObjectLostError /
    TimeoutError."""
    kind, blob = fetch_blob_from_owner(tuple(addr), oid, timeout)
    return _value_from_blob(kind, blob)


def fetch_values_from_owner(addr: Tuple[str, int],
                            oids: Sequence[ObjectID],
                            timeout: Optional[float] = None) -> List[Any]:
    """Batched variant: ONE round trip to the owner for the whole list
    (shm replies still read locally), instead of a blocking RPC per
    ref."""
    addr = tuple(addr)
    core = try_worker_core()
    if core is not None and addr == core.address:
        return [_value_from_blob(*core.get_local_blob(o, timeout))
                for o in oids]
    replies = _owner_call(
        addr, "owner_get_many", [o.binary() for o in oids], timeout,
        timeout=None if timeout is None else timeout + 30)
    return [_value_from_blob(*_blob_from_reply(addr, oid, reply))
            for oid, reply in zip(oids, replies)]


def register_borrow(addr: Tuple[str, int], oid: ObjectID) -> bool:
    core = try_worker_core()
    if core is not None and tuple(addr) == core.address:
        return core.add_borrow(oid)
    try:
        return bool(_owner_call(addr, "owner_borrow", oid.binary(),
                                timeout=30.0))
    except (OwnerDiedError, TimeoutError):
        return False


def release_borrow(addr: Tuple[str, int], oid: ObjectID) -> None:
    core = try_worker_core()
    if core is not None and tuple(addr) == core.address:
        core._h_release(None, oid.binary())
        return
    try:
        _peer(tuple(addr)).oneway("owner_release", oid.binary())
    except Exception:
        pass                  # owner already gone: nothing to release


def push_channel_value(oid: ObjectID, blob: bytes, kind: str,
                       consumers: Sequence[tuple]) -> None:
    """Producer side of a compiled-DAG channel: deliver one serialized
    value to every consumer core as a ONEWAY push (no round trip on the
    data path). ``consumers``: [(core_addr, takes), ...]. Values past
    the inline limit stay in the producer's core as a consumer-counted
    shm segment; consumers get a locator and map it directly."""
    core = get_worker_core()
    big = kind == "blob" and len(blob) > core.max_inline_bytes
    if big:
        total = sum(t for _a, t in consumers)
        name = core.publish(oid, blob, total)
        entry = ("shmref", name, len(blob), core.address)
    else:
        entry = (kind, blob)
    for addr, takes in consumers:
        addr = tuple(addr)
        if addr == core.address:
            core.accept_push(oid, entry, takes)
        else:
            try:
                _peer(addr).oneway("chan_push", oid.binary(), entry,
                                   takes)
            except Exception:
                logger.warning("channel push to %s failed", addr,
                               exc_info=True)
                if big:
                    # That consumer will never release its takes —
                    # drain them now or the segment leaks for the
                    # producer's lifetime.
                    for _ in range(takes):
                        core._h_release(None, oid.binary())


def take_channel_value(oid: ObjectID,
                       timeout: Optional[float] = None) -> Any:
    """Consumer side: wait (locally) for the pushed value, deserialize,
    raise stored producer errors. shm locators release the producer's
    consumer-count after the bytes are read."""
    core = get_worker_core()
    entry = core.take_pushed(oid, timeout)
    if entry[0] == "shmref":
        _, name, size, paddr = entry
        paddr = tuple(paddr)
        # Shared shm-map-with-owner-fallback path (handles a raced-away
        # segment and a "gone" reply with a meaningful error).
        kind, data = _blob_from_reply(paddr, oid, ("shm", name, size))
        release_borrow(paddr, oid)
        return _value_from_blob(kind, data)
    return _value_from_blob("err" if entry[0] == "err" else "val",
                            entry[1])


def drain_channel_args(arg_descs) -> None:
    """Best-effort cleanup when a stage fails before resolving all its
    channel args: consume whatever already arrived so pushed entries
    (and big values' producer-side segments) don't leak. Values that
    arrive after the failure still leak until the worker exits — a
    bounded, documented gap."""
    core = try_worker_core()
    if core is None:
        return
    for desc in arg_descs or ():
        if not desc or desc[0] != "chanp":
            continue
        oid = ObjectID(desc[1])
        try:
            entry = core.take_pushed(oid, timeout=0)
        except TimeoutError:
            continue
        if entry[0] == "shmref":
            release_borrow(tuple(entry[3]), oid)


def owner_contains(addr: Tuple[str, int], oid: ObjectID) -> bool:
    core = try_worker_core()
    if core is not None and tuple(addr) == core.address:
        return core.owns(oid)
    return bool(_owner_call(addr, "owner_contains", oid.binary(),
                            timeout=30.0))
