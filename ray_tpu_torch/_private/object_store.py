"""Per-node object plane: shared-memory store + in-process memory store.

TPU-native re-design of the reference's object plane (royf/ray
``src/ray/object_manager/plasma/`` + core-worker memory store
[UNVERIFIED — mount empty, SURVEY.md §0]):

- ``MemoryStore``: per-process store for small / inlined results (the
  reference inlines results <= ``max_direct_call_object_size`` in the
  task reply rather than round-tripping shared memory).
- ``ShmStore``: per-node store of sealed, immutable blobs in POSIX
  shared memory. One segment per object (the reference carves one big
  mmap with dlmalloc; per-object segments give the same zero-copy
  mmap reads with far less allocator machinery, and the kernel already
  does the page accounting). Readers in other processes attach by
  deterministic name and deserialize aliasing the mapping.
- Spilling: above a capacity threshold, least-recently-used sealed
  primaries are written to the session spill directory and their
  segments unlinked; access restores them (reference:
  ``LocalObjectManager::SpillObjects``).

Device tier: device values (``torch.Tensor``) are not forced through
host shm. ``ray_tpu_torch.put`` of a tensor stores the host
representation only on demand; see ``device_object.py``.

The port's copy of ``ray_tpu/_private/object_store.py``. Its names on
the shared host take the prefix ``rtpt_`` (``rtpu_`` in the reference),
so that the two packages' runtimes can share a host.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.session_dir import session_dir

# Silence the resource tracker for segments we manage ourselves: every
# attach would otherwise register the segment for (double) cleanup.
try:  # Python >= 3.13 (and some 3.12 builds) support track=False
    _probe = shared_memory.SharedMemory(
        name=f"rtpt_probe_{os.getpid()}", create=True, size=8, track=False)
    _probe.close()
    _probe.unlink()
    _TRACK_KW = {"track": False}
except TypeError:  # pragma: no cover - older Python
    _TRACK_KW = {}
    from multiprocessing import resource_tracker

    _orig_register = resource_tracker.register
    _orig_unregister = resource_tracker.unregister

    def _register(name, rtype):  # noqa: ANN001
        if rtype == "shared_memory" and "rtpt_" in name:
            return
        _orig_register(name, rtype)

    def _unregister(name, rtype):  # noqa: ANN001
        if rtype == "shared_memory" and "rtpt_" in name:
            return
        _orig_unregister(name, rtype)

    resource_tracker.register = _register
    resource_tracker.unregister = _unregister


def sweep_orphan_segments(session: str) -> None:
    """End-of-session shm hygiene: unlink segments no live process can
    reach — this session's node-store segments (covers workers killed
    between segment creation and owner adoption) and owner-core
    segments (``rtpt_own_<pid>_*``) whose process is dead (SIGKILL
    bypasses WorkerCore cleanup). Foreign sessions' and live processes'
    segments are untouched."""
    import glob
    for path in glob.glob(f"/dev/shm/rtpt_{session}*"):
        try:
            os.unlink(path)
        except OSError:
            pass
    for path in glob.glob("/dev/shm/rtpt_own_*"):
        try:
            pid = int(os.path.basename(path).split("_")[2])
        except (IndexError, ValueError):
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            try:
                os.unlink(path)
            except OSError:
                pass
        except PermissionError:
            pass       # pid alive under another uid: leave it


def _segment_name(session: str, object_id: ObjectID) -> str:
    # Full hex: an ObjectID's uniqueness lives in its TRAILING bytes
    # (task randomness + return index); any prefix truncation collides.
    return f"rtpt_{session}_{object_id.hex()}"


def create_segment(name: str, size: int) -> shared_memory.SharedMemory:
    """Create an untracked segment (writer side). Untracked matters:
    the stdlib resource tracker would unlink segments when the creating
    worker process exits, destroying objects that outlive their
    creator — exactly what a task result does."""
    return shared_memory.SharedMemory(name=name, create=True,
                                      size=max(size, 1), **_TRACK_KW)


def attach_segment(name: str) -> shared_memory.SharedMemory:
    return shared_memory.SharedMemory(name=name, create=False, **_TRACK_KW)


class ObjectStoreFullError(Exception):
    pass


class ShmStore:
    """Node-local shared-memory store (create/seal/get/free/spill).

    Single-writer (the node's core), many readers (`ShmClient`).
    """

    def __init__(self, session: str, capacity_bytes: int,
                 spill_dir: Optional[str] = None,
                 spill_threshold: float = 0.8):
        self._session = session
        self._capacity = capacity_bytes
        self._spill_threshold = spill_threshold
        self._spill_dir = spill_dir
        # Reentrant: the cyclic garbage collector can run at any
        # allocation inside a critical section, and an ObjectRef it
        # finalizes frees its object through this store on the same
        # thread, which would wait on itself forever with a plain Lock.
        self._lock = threading.RLock()
        self._segments: Dict[ObjectID, shared_memory.SharedMemory] = {}  # guarded-by: _lock
        self._sizes: Dict[ObjectID, int] = {}  # guarded-by: _lock
        # LRU order
        self._sealed: "OrderedDict[ObjectID, float]" = OrderedDict()  # guarded-by: _lock
        # path, size
        self._spilled: Dict[ObjectID, Tuple[str, int]] = {}  # guarded-by: _lock
        self._used = 0  # guarded-by: _lock
        self._zombies: List[shared_memory.SharedMemory] = []  # guarded-by: _lock
        self.num_spilled = 0
        self.num_restored = 0

    # lock-held: _lock
    def _close_or_defer(self, seg: shared_memory.SharedMemory) -> None:
        """Close a segment's mapping; if zero-copy views still alias it
        (BufferError: exported pointers), orphan it — our references to
        the mapping are dropped so the last reader view keeps the mmap
        alive and its dealloc unmaps silently, which is exactly the
        pin-until-released semantics readers rely on. Orphaning (rather
        than keeping the segment open for a later retry) also makes the
        eventual ``SharedMemory.__del__`` a no-op: a close() re-raising
        BufferError during interpreter teardown is an unraisable
        warning we can never order around."""
        try:
            seg.close()
        except BufferError:
            _orphan(seg)
            self._zombies.append(seg)

    def _drain_zombies(self) -> None:  # lock-held: _lock
        still = []
        for seg in self._zombies:
            try:
                seg.close()
            except BufferError:
                still.append(seg)
        self._zombies = still

    # -- write path --------------------------------------------------------

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        with self._lock:
            if object_id in self._segments or object_id in self._spilled:
                raise ValueError(f"object {object_id} already exists")
            self._ensure_capacity(size)
            seg = shared_memory.SharedMemory(
                name=_segment_name(self._session, object_id),
                create=True, size=max(size, 1), **_TRACK_KW)
            self._segments[object_id] = seg
            self._sizes[object_id] = size
            self._used += size
            return seg.buf[:size]

    def seal(self, object_id: ObjectID) -> None:
        with self._lock:
            if object_id not in self._segments:
                raise KeyError(object_id)
            self._sealed[object_id] = time.monotonic()

    def put_blob(self, object_id: ObjectID, blob: bytes) -> None:
        buf = self.create(object_id, len(blob))
        buf[:] = blob
        self.seal(object_id)

    def begin_create(self, object_id: ObjectID,
                     size: int) -> Optional[memoryview]:
        """``create`` for the pull plane: returns None when the object
        is already sealed (or spilled) here — the caller's exactly-once
        seal fast path — and reclaims a stale same-name segment left by
        a previous incarnation of this node (a chaos kill between
        create and seal) instead of failing."""
        try:
            return self.create(object_id, size)
        except ValueError:
            if self.contains(object_id):
                return None
            # unsealed leftover in THIS process (an aborted pull that
            # raced us): free it and take over
            self.free(object_id)
            return self.create(object_id, size)
        except FileExistsError:
            # segment on disk but unknown to this store: a previous
            # incarnation died between create and seal
            seg = attach_segment(_segment_name(self._session, object_id))
            try:
                seg.unlink()
            finally:
                seg.close()
            return self.create(object_id, size)

    def abort_create(self, object_id: ObjectID) -> None:
        """Free a created-but-unsealed segment (a failed pull). Sealed
        objects are left alone — aborting is only legal on the create
        the caller itself began."""
        with self._lock:
            if object_id not in self._sealed:
                self._free_locked(object_id)

    def adopt(self, object_id: ObjectID, size: int) -> None:
        """Take ownership of a segment a worker process already created
        and sealed under the deterministic name for ``object_id`` (the
        write path of remote task results — the worker writes, the node
        store accounts and manages lifetime)."""
        with self._lock:
            if object_id in self._segments:
                return
            self._ensure_capacity(size)
            seg = shared_memory.SharedMemory(
                name=_segment_name(self._session, object_id),
                create=False, **_TRACK_KW)
            self._segments[object_id] = seg
            self._sizes[object_id] = size
            self._used += size
            self._sealed[object_id] = time.monotonic()

    # -- read path ---------------------------------------------------------

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._sealed or object_id in self._spilled

    def segment_for(self, object_id: ObjectID) -> Optional[Tuple[str, int]]:
        """(segment_name, size) for a sealed object, restoring a spilled
        copy first if needed. None if unknown."""
        with self._lock:
            if object_id in self._sealed:
                self._sealed.move_to_end(object_id)
                return (_segment_name(self._session, object_id),
                        self._sizes[object_id])
        if object_id in self._spilled:
            self._restore(object_id)
            return self.segment_for(object_id)
        return None

    def get_local(self, object_id: ObjectID) -> Optional[memoryview]:
        """Zero-copy view for in-process readers."""
        info = self.segment_for(object_id)
        if info is None:
            return None
        with self._lock:
            seg = self._segments.get(object_id)
            if seg is None:       # freed/re-lost between calls
                return None
            return seg.buf[:self._sizes[object_id]]

    # -- lifetime ----------------------------------------------------------

    def free(self, object_id: ObjectID) -> None:
        with self._lock:
            self._free_locked(object_id)

    def _free_locked(self, object_id: ObjectID) -> None:  # lock-held: _lock
        seg = self._segments.pop(object_id, None)
        if seg is not None:
            size = self._sizes.pop(object_id)
            self._sealed.pop(object_id, None)
            self._used -= size
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
            self._close_or_defer(seg)
            self._drain_zombies()
        spilled = self._spilled.pop(object_id, None)
        if spilled is not None:
            try:
                os.unlink(spilled[0])
            except FileNotFoundError:
                pass

    def shutdown(self) -> None:
        with self._lock:
            for oid in list(self._segments):
                self._free_locked(oid)
            for oid in list(self._spilled):
                self._free_locked(oid)
            self._drain_zombies()

    # -- spilling ----------------------------------------------------------

    def _ensure_capacity(self, incoming: int) -> None:  # lock-held: _lock
        if incoming > self._capacity:
            raise ObjectStoreFullError(
                f"object of {incoming} bytes exceeds store capacity "
                f"{self._capacity}")
        limit = self._capacity * self._spill_threshold
        while self._used + incoming > limit and self._sealed:
            victim, _ = next(iter(self._sealed.items()))
            self._spill_locked(victim)
        if self._used + incoming > self._capacity:
            raise ObjectStoreFullError(
                f"store full: used={self._used} incoming={incoming}")

    def _spill_path(self, object_id: ObjectID) -> str:
        d = self._spill_dir or session_dir(self._session, "spill")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, object_id.hex())

    def _spill_locked(self, object_id: ObjectID) -> None:  # lock-held: _lock
        seg = self._segments.pop(object_id)
        size = self._sizes.pop(object_id)
        self._sealed.pop(object_id)
        path = self._spill_path(object_id)
        # non-durable-ok: a torn spill file reads back as a lost
        # object, which lineage reconstruction recovers (tier-1
        # test_reconstruct_lost_spill_file); fsync here would sit on
        # the store's eviction path
        # blocking-ok: spill IS the make-room path — it must complete
        # atomically with the segment/size-table updates around it, or
        # a concurrent create would double-evict into the same hole
        with open(path, "wb") as f:
            f.write(seg.buf[:size])
        seg.unlink()
        self._close_or_defer(seg)
        self._used -= size
        self._spilled[object_id] = (path, size)
        self.num_spilled += 1

    def _restore(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._spilled.pop(object_id, None)
            if entry is None:
                return
            path, size = entry
            self._ensure_capacity(size)
            try:
                f = open(path, "rb")
            except FileNotFoundError:
                # Spill file lost: the object is gone; the owner's
                # lineage reconstruction path takes it from here.
                return
            seg = shared_memory.SharedMemory(
                name=_segment_name(self._session, object_id),
                create=True, size=max(size, 1), **_TRACK_KW)
            with f:
                f.readinto(seg.buf[:size])
            os.unlink(path)
            self._segments[object_id] = seg
            self._sizes[object_id] = size
            self._used += size
            self._sealed[object_id] = time.monotonic()
            self.num_restored += 1

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "used_bytes": self._used,
                "capacity_bytes": self._capacity,
                "num_objects": len(self._sealed),
                "num_spilled": self.num_spilled,
                "num_restored": self.num_restored,
            }


def _orphan(seg: shared_memory.SharedMemory) -> None:
    """Drop our references to a mapping that reader views still alias:
    the last view unmaps it, and ``SharedMemory.__del__`` has nothing
    left to close (a close there would raise BufferError as an
    unraisable warning)."""
    seg._buf = None
    seg._mmap = None  # reader views hold their own mmap refs
    fd = getattr(seg, "_fd", -1)
    if fd >= 0:
        try:
            os.close(fd)
        except OSError:
            pass  # swallow-ok: fd already closed elsewhere
        seg._fd = -1


class ShmClient:
    """Reader-side attach/read for any process on the node."""

    def __init__(self, session: str):
        self._session = session
        self._attached: Dict[str, shared_memory.SharedMemory] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def read(self, segment_name: str, size: int) -> memoryview:
        with self._lock:
            seg = self._attached.get(segment_name)
            if seg is None:
                seg = shared_memory.SharedMemory(name=segment_name,
                                                 create=False, **_TRACK_KW)
                self._attached[segment_name] = seg
            return seg.buf[:size]

    def release(self, segment_name: str) -> None:
        with self._lock:
            seg = self._attached.pop(segment_name, None)
            if seg is not None:
                seg.close()

    def close(self) -> None:
        with self._lock:
            for seg in self._attached.values():
                try:
                    seg.close()
                except BufferError:
                    _orphan(seg)    # exported views pin the mapping
                except Exception:
                    pass    # the kernel reclaims it with the process
            self._attached.clear()

    def __del__(self):
        # a client dropped unclosed (a driver-thread actor's, when the
        # actor goes) would let each segment's own __del__ raise
        try:
            self.close()
        except Exception:
            pass    # interpreter teardown: the kernel reclaims the maps


class MemoryStore:
    """Per-process store for small objects and pending results.

    Doubles as the synchronization point for ``get``: waiters block on a
    condition until the object (or an error) lands.
    """

    def __init__(self):
        self._store: Dict[ObjectID, object] = {}  # guarded-by: _cv
        self._cv = threading.Condition()
        # Waiter count: a put with nobody blocked skips the notify
        # (the kernel futex wake is the expensive half of put).
        self._waiters = 0  # guarded-by: _cv
        # Batched completion handling defers wakeups: entries land
        # immediately (reads stay exact) but blocked getters are woken
        # once per batch, not once per object.
        self._defer_depth = 0  # guarded-by: _cv
        self._defer_dirty = False  # guarded-by: _cv

    def put(self, object_id: ObjectID, value: object) -> None:
        with self._cv:
            self._store[object_id] = value
            if self._waiters:
                if self._defer_depth:
                    self._defer_dirty = True
                else:
                    self._cv.notify_all()

    def deferred_notify(self):
        """Context manager: puts inside the block insert immediately
        but coalesce their wakeups into ONE notify at exit — the
        completion-batch path's half of batched completions (a wave of
        N inline results costs one getter wakeup, not N)."""
        store = self

        class _Defer:
            def __enter__(self):
                with store._cv:
                    store._defer_depth += 1
                return self

            def __exit__(self, *exc):
                with store._cv:
                    store._defer_depth -= 1
                    if store._defer_depth == 0 and store._defer_dirty:
                        store._defer_dirty = False
                        if store._waiters:
                            store._cv.notify_all()
                return False

        return _Defer()

    def contains(self, object_id: ObjectID) -> bool:
        with self._cv:
            return object_id in self._store

    def get_ready(self, object_ids) -> Dict[ObjectID, object]:
        """Snapshot of the already-present subset, one lock
        acquisition for the whole list (the get() fast pre-pass)."""
        with self._cv:
            store = self._store
            return {o: store[o] for o in object_ids if o in store}

    def get(self, object_id: ObjectID,
            timeout: Optional[float] = None) -> object:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while object_id not in self._store:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"timed out waiting for {object_id}")
                self._waiters += 1
                try:
                    self._cv.wait(remaining)
                finally:
                    self._waiters -= 1
            return self._store[object_id]

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float]) -> Tuple[Set[ObjectID], Set[ObjectID]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = {o for o in object_ids if o in self._store}
                if len(ready) >= num_returns:
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                self._waiters += 1
                try:
                    self._cv.wait(remaining)
                finally:
                    self._waiters -= 1
            not_ready = {o for o in object_ids if o not in ready}
            return ready, not_ready

    def free(self, object_id: ObjectID) -> None:
        with self._cv:
            self._store.pop(object_id, None)

    def pop(self, object_id: ObjectID):
        """Remove and return the entry (None when absent) — lets the
        ref-zero path inspect what it freed without a second lock."""
        with self._cv:
            return self._store.pop(object_id, None)

    def __len__(self) -> int:
        with self._cv:
            return len(self._store)
