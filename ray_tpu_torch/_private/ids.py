"""Binary IDs for tasks, objects, actors, nodes.

The port's own copy of ``ray_tpu/_private/ids.py``, with the same byte
widths, so that an ID's hex names the same thing in both packages.

Design mirrors the reference's ID scheme (royf/ray ``src/ray/common/id.h``
[UNVERIFIED — reference mount empty; see SURVEY.md §0]): fixed-width binary
IDs where an ObjectID embeds the TaskID that produced it plus a return/put
index, and a TaskID embeds the ActorID (or a nil actor) plus randomness.
This encoding is what makes ownership cheap: given any ObjectID you can
recover the producing task and hence the owning worker without a directory
lookup.

Layout (bytes):
    JobID     4   random per driver
    ActorID  16   = JobID(4) + unique(12)
    TaskID   24   = ActorID(16) + unique(8)
    ObjectID 28   = TaskID(24) + little-endian uint32 index
    NodeID   28   random
    WorkerID 28   random
    PlacementGroupID 18 = JobID(4) + unique(14)
"""

from __future__ import annotations

import os
import random
import threading

_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 16
_TASK_ID_SIZE = 24
_OBJECT_ID_SIZE = 28
_NODE_ID_SIZE = 28
_WORKER_ID_SIZE = 28
_PG_ID_SIZE = 18


_rng = random.Random(os.urandom(16))
_rng_pid = os.getpid()
_rng_lock = threading.Lock()


def _rand_bytes(n: int) -> bytes:
    """Fast random id bytes: ``os.urandom`` is a syscall per call and
    showed up at ~10% of the normal-task hot path; a urandom-seeded
    PRNG has the same collision behavior for ids (distinct seed per
    process; re-seeded after fork) at in-process cost."""
    global _rng, _rng_pid
    pid = os.getpid()
    if pid != _rng_pid:
        _rng = random.Random(os.urandom(16))
        _rng_pid = pid
    with _rng_lock:
        return _rng.getrandbits(n * 8).to_bytes(n, "little")


class BaseID:
    """Immutable fixed-width binary identifier."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))

    @classmethod
    def from_random(cls):
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE
    __slots__ = ()

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "little"))


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + _rand_bytes(_ACTOR_ID_SIZE - _JOB_ID_SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE
    __slots__ = ()

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls.of(ActorID(job_id.binary() + b"\x00" * 12))

    @classmethod
    def of(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + _rand_bytes(_TASK_ID_SIZE - _ACTOR_ID_SIZE))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(job_id.binary() + b"\x00" * (_TASK_ID_SIZE - _JOB_ID_SIZE))

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:_ACTOR_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:_JOB_ID_SIZE])


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE
    __slots__ = ()

    @classmethod
    def from_index(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Return-object index starts at 1; ray.put objects use a distinct
        high-bit-tagged index space so puts and returns never collide."""
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls.from_index(task_id, put_index | 0x8000_0000)

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_ID_SIZE:], "little")

    def is_put(self) -> bool:
        return bool(self.index() & 0x8000_0000)


class NodeID(BaseID):
    SIZE = _NODE_ID_SIZE
    __slots__ = ()


class WorkerID(BaseID):
    SIZE = _WORKER_ID_SIZE
    __slots__ = ()


class PlacementGroupID(BaseID):
    SIZE = _PG_ID_SIZE
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(job_id.binary() + _rand_bytes(_PG_ID_SIZE - _JOB_ID_SIZE))
