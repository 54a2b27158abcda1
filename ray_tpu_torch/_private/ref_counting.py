"""Distributed-reference-counting core (single-owner slice).

Reference: ``src/ray/core_worker/reference_counter.{h,cc}`` [UNVERIFIED
— mount empty, SURVEY.md §0]. This implements the owner-side accounting:
local Python references, in-flight task-argument references, and
containment (object A's value holds a ref to B). When an object's total
count reaches zero it is freed from the node stores and its lineage is
released. The cross-worker borrowing protocol rides the serialization
hook (contained refs recorded per stored object).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Set

from ray_tpu_torch._private.ids import ObjectID


class ReferenceCounter:
    def __init__(self, on_zero: Optional[Callable[[ObjectID], None]] = None):
        self._lock = threading.RLock()
        self._local: Dict[ObjectID, int] = defaultdict(int)
        self._task_args: Dict[ObjectID, int] = defaultdict(int)
        self._contained_in: Dict[ObjectID, int] = defaultdict(int)
        self._children: Dict[ObjectID, List[ObjectID]] = {}
        self._owned: Set[ObjectID] = set()
        self._on_zero = on_zero
        self._frozen = False  # set during shutdown: GC-driven callbacks stop

    def set_on_zero(self, cb: Callable[[ObjectID], None]) -> None:
        self._on_zero = cb

    def freeze(self) -> None:
        self._frozen = True

    # -- ownership ---------------------------------------------------------

    def add_owned_object(self, object_id: ObjectID) -> None:
        with self._lock:
            self._owned.add(object_id)

    def is_owned(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._owned

    # -- counting ----------------------------------------------------------

    def add_local_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            self._local[object_id] += 1

    def remove_local_reference(self, object_id: ObjectID) -> None:
        self._dec(self._local, object_id)

    def add_task_argument(self, object_id: ObjectID) -> None:
        with self._lock:
            self._task_args[object_id] += 1

    def remove_task_argument(self, object_id: ObjectID) -> None:
        self._dec(self._task_args, object_id)

    def add_contained(self, parent: ObjectID,
                      children: List[ObjectID]) -> None:
        with self._lock:
            if not children:
                return
            self._children.setdefault(parent, []).extend(children)
            for c in children:
                self._contained_in[c] += 1

    def _dec(self, table: Dict[ObjectID, int], object_id: ObjectID) -> None:
        to_free: List[ObjectID] = []
        with self._lock:
            if self._frozen:
                return
            table[object_id] -= 1
            if table[object_id] <= 0:
                table.pop(object_id, None)
            self._collect_if_zero(object_id, to_free)
        for oid in to_free:
            if self._on_zero is not None:
                self._on_zero(oid)

    def _collect_if_zero(self, object_id: ObjectID,
                         out: List[ObjectID]) -> None:
        # lock held
        if (self._local.get(object_id, 0) > 0
                or self._task_args.get(object_id, 0) > 0
                or self._contained_in.get(object_id, 0) > 0):
            return
        self._local.pop(object_id, None)
        self._task_args.pop(object_id, None)
        self._contained_in.pop(object_id, None)
        self._owned.discard(object_id)
        out.append(object_id)
        for child in self._children.pop(object_id, []):
            self._contained_in[child] -= 1
            if self._contained_in[child] <= 0:
                self._contained_in.pop(child, None)
                self._collect_if_zero(child, out)

    def count(self, object_id: ObjectID) -> int:
        with self._lock:
            return (self._local.get(object_id, 0)
                    + self._task_args.get(object_id, 0)
                    + self._contained_in.get(object_id, 0))

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_owned": len(self._owned),
                "num_local_tracked": len(self._local),
            }

    def snapshot(self) -> dict:
        """Per-owned-object count breakdown (state API)."""
        with self._lock:
            return {
                oid: {
                    "local_refs": self._local.get(oid, 0),
                    "task_args": self._task_args.get(oid, 0),
                    "contained_in": self._contained_in.get(oid, 0),
                }
                for oid in self._owned
            }
