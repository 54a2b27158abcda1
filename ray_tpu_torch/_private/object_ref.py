"""ObjectRef: a first-class future handle to an object in the cluster.

Reference: ``python/ray/_raylet.pyx`` ObjectRef [UNVERIFIED — mount
empty, SURVEY.md §0]. Ownership semantics: the worker that created the
ref owns the object's metadata and lineage. Serializing a ref inside
another object registers a borrow with the owner via the serialization
context hook.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.ids import ObjectID, TaskID


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "_counted", "__weakref__")

    def __init__(self, object_id: ObjectID,
                 owner_addr: Optional[tuple] = None,
                 _count: bool = True):
        self._id = object_id
        # (host, port) of the owning worker's core port; None = owned by
        # the driver (the round-2 central model, still the default for
        # driver-created objects and task returns).
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._counted = bool(_count)
        if _count:
            _on_ref_created(self)

    # -- identity ----------------------------------------------------------

    def id(self) -> ObjectID:
        return self._id

    def owner_addr(self) -> Optional[tuple]:
        return self._owner_addr

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self) -> TaskID:
        return self._id.task_id()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    # -- future-like -------------------------------------------------------

    def future(self):
        """Wrap into a concurrent.futures.Future resolved via a waiter
        thread (for asyncio interop use ``asyncio.wrap_future``)."""
        import concurrent.futures
        import threading

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _wait():
            from ray_tpu_torch._private.worker import global_worker
            try:
                fut.set_result(global_worker().get([self])[0])
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_wait, daemon=True).start()
        return fut

    def __await__(self):
        import asyncio
        return asyncio.wrap_future(self.future()).__await__()

    # -- lifetime ----------------------------------------------------------

    def __del__(self):
        # Symmetric with creation: only refs that registered a count
        # release one (uncounted refs are transient wire shims).
        if not self._counted:
            return
        try:
            _on_ref_deleted(self)
        except Exception:
            pass    # __del__ during interpreter teardown: the
                    # counter (and process) is going away anyway

    def __reduce__(self):
        # Capturing a ref inside a serialized value => borrow.
        from ray_tpu_torch._private import serialization
        serialization.get_context().note_contained_ref(self)
        return (_deserialize_ref, (self._id.binary(), self._owner_addr))


class ObjectRefGenerator:
    """Handle to a streaming generator task (``num_returns="streaming"``).

    Reference: ``core_worker/generator_waiter.cc`` + streaming refs
    [UNVERIFIED — mount empty, SURVEY.md §0]. Iterating yields an
    ObjectRef per item AS the task produces them; the hidden completion
    marker (return index 1) resolves to the item count — or raises the
    task's error — when the generator finishes. Items occupy return
    indices 2, 3, ...
    """

    def __init__(self, task_id: TaskID, done_ref: ObjectRef):
        self._task_id = task_id
        self._done_ref = done_ref
        self._i = 0

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        from ray_tpu_torch._private.worker import global_worker
        w = global_worker()
        done_oid = self._done_ref.id()
        if hasattr(w, "memory_store"):      # driver: owner-store direct
            while True:
                item_oid = ObjectID.from_index(self._task_id, self._i + 2)
                if w.memory_store.contains(item_oid):
                    self._i += 1
                    return ObjectRef(item_oid)
                if w.memory_store.contains(done_oid):
                    count = w.get([self._done_ref])[0]  # raises task errs
                    if self._i >= count:
                        raise StopIteration
                    continue     # item landed between the two checks
                w.memory_store.wait([item_oid, done_oid], 1, None)
        # Inside a task/actor (nested client): poll the owner through
        # the worker surface — wait releases the blocked parent's CPU
        # so the generator task can run even at pool capacity.
        while True:
            item_ref = ObjectRef(
                ObjectID.from_index(self._task_id, self._i + 2))
            ready, _ = w.wait([item_ref, self._done_ref], 1, None)
            ids = {r.id() for r in ready}
            if item_ref.id() in ids:
                self._i += 1
                return item_ref
            if done_oid in ids:
                count = w.get([self._done_ref])[0]   # raises task errors
                if self._i >= count:
                    raise StopIteration

    def completed(self) -> ObjectRef:
        """The completion marker (resolves to the item count)."""
        return self._done_ref

    def __repr__(self):
        return (f"ObjectRefGenerator(task={self._task_id.hex()[:16]}, "
                f"next_index={self._i})")


def _deserialize_ref(binary: bytes, owner_addr=None) -> "ObjectRef":
    return ObjectRef(ObjectID(binary), owner_addr=owner_addr)


def adopt_preregistered_ref(oid_binary: bytes, owner_addr) -> "ObjectRef":
    """Build a ref whose borrow the SENDER already registered with the
    owner on the recipient's behalf (borrow handed off with the
    message): skip the create-side registration but do release on
    death."""
    ref = ObjectRef(ObjectID(oid_binary), owner_addr=owner_addr,
                    _count=False)
    ref._counted = True
    return ref


def _on_ref_created(ref: ObjectRef) -> None:
    owner = ref._owner_addr
    if owner is not None:
        # Worker-owned object: count at the owner. Local refs in the
        # owner's own process use its WorkerCore counter; refs born in
        # any other process register a borrow over the wire.
        from ray_tpu_torch._private import worker_core
        core = worker_core.try_worker_core()
        if core is not None and owner == core.address:
            core.on_local_ref(ref.id())
        else:
            worker_core.register_borrow(owner, ref.id())
        return
    from ray_tpu_torch._private.worker import try_global_worker
    w = try_global_worker()
    if w is not None:
        w.reference_counter.add_local_reference(ref.id())


def _on_ref_deleted(ref: ObjectRef) -> None:
    object_id = ref._id
    owner = ref._owner_addr
    if owner is not None:
        from ray_tpu_torch._private import worker_core
        core = worker_core.try_worker_core()
        if core is not None and owner == core.address:
            core.on_local_unref(object_id)
        else:
            worker_core.release_borrow(owner, object_id)
        return
    from ray_tpu_torch._private.worker import try_global_worker
    w = try_global_worker()
    if w is not None:
        w.reference_counter.remove_local_reference(object_id)
