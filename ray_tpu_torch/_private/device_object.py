"""Device tier of the object plane: tensors kept where they live.

The port's copy of ``ray_tpu/_private/device_object.py``, whose device
values are ``jax.Array``s in TPU HBM. Here a ``torch.Tensor`` put into
the object store stays where it lives (card memory for a CUDA tensor) and
is served zero-copy to same-process consumers: ``get`` returns the very
tensor object that was put, and a task or actor on a thread of this
process (work that demands ``GPU``) receives it as its argument. (The
reference hands its in-process workers a host copy, which they load back
onto the device.) A host copy is materialized ONLY when demanded:

- a consumer in another process needs the bytes (spill-to-shm on
  dispatch; the host copy is ``t.detach().cpu()``, so a CUDA tensor
  reaches a process worker as a CPU tensor, as a ``jax.Array`` reaches a
  worker's CPU backend in the reference), or
- the owner explicitly spills under memory pressure.

The device copy remains primary; host copies are a cache. Reference
counting frees the tensor exactly like any other object entry: once the
store drops it and the caller holds no handle, the caching allocator
takes its card memory back.

A tensor on the CPU takes this tier too, as a ``jax.Array`` on JAX's CPU
backend does in the reference.

One difference that mutability forces: a ``jax.Array`` is immutable, a
tensor is not. The store holds the tensor itself, not a copy, so a
tensor mutated in place after ``put`` is seen so by a same-process
``get`` (and by a host copy made after the mutation). A caller that
needs a snapshot puts ``t.clone()``.

The same holds on the consumer side. A GPU-demand task or actor gets the
stored tensor itself, so an in-place change it makes to its argument
(``x.add_(...)``, an optimizer step on a passed buffer) changes the
object: every later ``get``, every other consumer of the ref, a retry of
the task and the caller's own handle all see it. Such consumers must not
mutate their arguments; one that needs a scratch buffer clones it. A
process worker gets a host copy and cannot change the object.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ray_tpu_torch._private.ids import ObjectID


def is_device_value(value) -> bool:
    """True for values that should take the device tier (a
    ``torch.Tensor``, on either device). Never imports torch: if torch
    isn't loaded, the value can't be a tensor."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    return isinstance(value, torch.Tensor)


def device_arg_desc(object_id: ObjectID, in_process: bool,
                    ensure_host_copy) -> Optional[tuple]:
    """How a device object reaches a consumer, decided here for every
    dispatch site: a thread of the owner's process takes the tensor
    itself (``("dev", oid)``), any other process its host copy in shm
    (``("shm", oid, segment, size)``, made on demand by
    ``ensure_host_copy``). None when no host copy can be made: the
    object is lost."""
    if in_process:
        return ("dev", object_id.binary())
    info = ensure_host_copy(object_id) if ensure_host_copy else None
    if info is None:
        return None
    return ("shm", object_id.binary(), info[0], info[1])


class DeviceStore:
    """Owner-side map of ObjectID -> ``torch.Tensor``.

    Holding the tensor object pins its storage. ``free`` drops the
    reference and lets the caching allocator reclaim the card's memory
    once no other handle holds it.
    """

    def __init__(self):
        # Reentrant, as ShmStore's: a garbage-collected ObjectRef frees
        # through this store on whatever thread the collection ran.
        self._lock = threading.RLock()
        self._arrays: Dict[ObjectID, object] = {}
        self.num_put = 0
        self.num_spilled_to_host = 0

    def put(self, object_id: ObjectID, array) -> None:
        with self._lock:
            if object_id in self._arrays:
                raise ValueError(f"device object {object_id} already exists")
            self._arrays[object_id] = array
            self.num_put += 1

    def get(self, object_id: ObjectID):
        with self._lock:
            return self._arrays.get(object_id)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._arrays

    def free(self, object_id: ObjectID) -> None:
        with self._lock:
            self._arrays.pop(object_id, None)

    def nbytes(self, object_id: ObjectID) -> Optional[int]:
        with self._lock:
            arr = self._arrays.get(object_id)
        if arr is None:
            return None
        try:
            return int(arr.nbytes)
        except Exception:
            return None

    def shutdown(self) -> None:
        with self._lock:
            self._arrays.clear()

    def stats(self) -> dict:
        with self._lock:
            total = 0
            for arr in list(self._arrays.values()):
                try:
                    total += int(arr.nbytes)
                except Exception:
                    pass    # deleted/donated buffer: skip its bytes
            return {
                "num_objects": len(self._arrays),
                "hbm_bytes": total,
                "num_put": self.num_put,
                "num_spilled_to_host": self.num_spilled_to_host,
            }
