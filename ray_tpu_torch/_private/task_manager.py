"""Caller-side task manager: pending tasks, retries, lineage.

Reference: ``src/ray/core_worker/task_manager.{h,cc}`` [UNVERIFIED —
mount empty, SURVEY.md §0]. Owns the lifecycle of every submitted task:
records lineage (spec kept while its outputs may need reconstruction),
decides retry vs. fail on completion, and materializes results into the
owner's stores.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch.exceptions import (
    OutOfMemoryError,
    TaskError,
    WorkerCrashedError,
)


@dataclass
class TaskRecord:
    spec: TaskSpec
    retries_left: int
    status: str = "pending"          # pending|running|finished|failed
    attempt: int = 0
    error: Optional[str] = None
    # Lineage re-executions remaining (reference bounds object
    # reconstruction by the task's max_retries, independent of the
    # failure-retry budget: ``object_recovery_manager.cc``).
    reconstructions_left: int = 0
    # Argument pins are taken once at submission and must release
    # exactly once, even when lineage reconstruction re-runs a task
    # that already completed.
    args_released: bool = False
    # ray_tpu_torch.cancel(): a cancelled task's next failure is terminal
    # (no retry) and surfaces as TaskCancelledError; a result that
    # lands anyway wins (best-effort semantics, like the reference).
    cancelled: bool = False
    # Memory-watchdog kills spend THIS budget (``task_oom_retries``),
    # not the failure-retry one: a task repeatedly evicted under
    # pressure must not burn the retries that guard real crashes
    # (reference: the memory monitor's separate OOM retry counter).
    oom_retries_left: int = 0


def _contained_item(c):
    """Normalize a wire contained-ref item. Plain bytes = driver-owned
    (classic containment pinning); a (bytes, owner_addr) pair is a
    worker-owned ref whose borrow the sender pre-registered — adopt a
    ref object so the borrow releases when the container frees.
    Accepts list spellings of the pair too: a completion that rode the
    binary small-frame path (docs/data_plane.md) arrives with msgpack's
    tuple->list normalization applied. A live driver-owned ref (from
    a task on a thread of the driver) passes through: it holds the
    object until the owner has pinned it as contained."""
    if isinstance(c, ObjectRef):
        return c
    if isinstance(c, (tuple, list)) and len(c) == 2 and c[1] is not None:
        from ray_tpu_torch._private.object_ref import adopt_preregistered_ref
        return adopt_preregistered_ref(c[0], tuple(c[1]))
    if isinstance(c, (tuple, list)):
        return ObjectID(c[0])
    return ObjectID(c)


class Entry:
    """A resolved object in the owner's directory (see MemoryStore)."""

    __slots__ = ("kind", "data", "_value", "_has_value", "contained")

    def __init__(self, kind: str, data, contained=()):
        self.kind = kind          # "blob" | "shm" | "err"
        self.data = data
        self.contained = contained
        self._value = None
        self._has_value = False

    def cached_value(self):
        return (self._has_value, self._value)

    def cache_value(self, value):
        self._value = value
        self._has_value = True


class TaskManager:
    def __init__(self,
                 store_result: Callable[[ObjectID, Entry], None],
                 resubmit: Callable[[TaskSpec], None],
                 on_task_arg_release: Callable[[ObjectID], None],
                 on_owned_arg_release: Optional[Callable] = None):
        self._lock = threading.RLock()
        self._tasks: Dict[TaskID, TaskRecord] = {}
        self._lineage: Dict[ObjectID, TaskID] = {}
        # live lineage entries per task — release_lineage must be O(1),
        # not a scan over every retained object (ref churn after a
        # large wave would otherwise go quadratic)
        self._lineage_count: Dict[TaskID, int] = {}
        self._store_result = store_result
        self._resubmit = resubmit
        self._release_arg = on_task_arg_release
        self._release_owned = on_owned_arg_release
        self.num_finished = 0
        self.num_failed = 0
        self.num_retries = 0
        self.num_reconstructions = 0
        self.num_oom_kills = 0      # watchdog kills observed
        self.num_oom_retries = 0    # of those, transparently retried
        self.num_unfinished = 0     # live (pending|running) records
        from ray_tpu_torch._private.backoff import make_rng
        self._backoff_rng = make_rng()   # OOM-retry jitter

    # -- submission --------------------------------------------------------

    def add_pending_task(self, spec: TaskSpec) -> None:
        with self._lock:
            prev = self._tasks.get(spec.task_id)
            if prev is None or prev.status in ("finished", "failed"):
                self.num_unfinished += 1
            self._tasks[spec.task_id] = TaskRecord(
                spec=spec, retries_left=spec.max_retries,
                reconstructions_left=spec.max_retries,
                oom_retries_left=get_config().task_oom_retries)
            # an oid embeds its producing task id, so re-adding the same
            # spec (actor restart) simply restores its full entry set
            for oid in spec.return_ids:
                self._lineage[oid] = spec.task_id
            self._lineage_count[spec.task_id] = len(spec.return_ids)

    def add_stream_lineage(self, object_id: ObjectID,
                           task_id: TaskID) -> None:
        """Register a streamed item under its producing task's lineage
        (items are born at delivery, not submission): a lost item then
        reconstructs by replaying the generator task."""
        with self._lock:
            if object_id not in self._lineage:
                self._lineage[object_id] = task_id
                self._lineage_count[task_id] = \
                    self._lineage_count.get(task_id, 0) + 1

    def mark_running(self, task_id: TaskID) -> None:
        with self._lock:
            rec = self._tasks.get(task_id)
            if rec:
                rec.status = "running"

    def mark_cancelled(self, task_id: TaskID) -> Optional[str]:
        """Flag a task cancelled; returns its status at flag time
        (None when unknown). Completion handling converts the task's
        next failure into a terminal TaskCancelledError. A task that
        already reached a terminal state is NOT flagged — cancel is a
        documented no-op there, and the flag would otherwise poison a
        later lineage-reconstruction re-run of the same record."""
        with self._lock:
            rec = self._tasks.get(task_id)
            if rec is None:
                return None
            if rec.status not in ("finished", "failed"):
                rec.cancelled = True
            return rec.status

    def get_record(self, task_id: TaskID) -> Optional[TaskRecord]:
        with self._lock:
            return self._tasks.get(task_id)

    # -- completion --------------------------------------------------------

    def complete_task(self, task_id: TaskID,
                      results: List[tuple],
                      error_blob: Optional[bytes],
                      system_error: Optional[BaseException] = None) -> None:
        """``results``: [(oid_bytes, kind, data, contained_ref_bytes)].
        ``error_blob``: serialized TaskError (app-level).
        ``system_error``: worker crash etc. — always retryable."""
        # The retry decision runs under _lock; BOTH callbacks run
        # AFTER it releases. _resubmit (Worker) takes _actor_lock,
        # and _actor_lock holders call back into this manager
        # (_resubmit -> _fail_task -> mark_failed_external), so calling
        # out while holding _lock nests the two locks in both orders —
        # the AB/BA deadlock the lock-order pass exists to catch.
        # _store_result (Worker) is just as entangled: it fans out to
        # NodeManagerGroup.on_object_available (takes that group's
        # _lock) while the steal path holds the group lock and calls
        # back into get_record here — graftsan caught that inversion
        # actually executing under test load, through dynamic dispatch
        # the static resolver can't follow.
        stores: List[Tuple[ObjectID, Entry]] = []
        with self._lock:
            resubmit_spec = self._complete_locked(
                task_id, results, error_blob, system_error, stores)
        for oid, entry in stores:
            self._store_result(oid, entry)
        if resubmit_spec is not None:
            self._resubmit(resubmit_spec)

    # lock-held: _lock
    def _complete_locked(self, task_id, results, error_blob,
                         system_error, stores):
        """Terminal-state bookkeeping; returns the spec to resubmit
        and appends result entries to ``stores`` (caller invokes both
        callbacks outside the lock) or None."""
        rec = self._tasks.get(task_id)
        if rec is None:
            return None
        if error_blob is None and system_error is None:
            self._mark_terminal(rec, "finished")
            self.num_finished += 1
            self._release_args(rec)
            # a lineage re-run of this spec starts OOM backoff fresh
            rec.spec._oom_backoff_s = 0.0  # type: ignore[attr-defined]
            kind_map = {"inline": "blob", "shm": "shm",
                        "remote": "remote"}
            for oid_b, kind, data, contained in results:
                entry = Entry(
                    kind_map[kind], data,
                    tuple(_contained_item(c) for c in contained))
                stores.append((ObjectID(oid_b), entry))
            return None
        # failure path
        if rec.cancelled:
            # cancelled: terminal, no retry, canonical error
            from ray_tpu_torch.exceptions import TaskCancelledError
            self._mark_terminal(rec, "failed")
            self.num_failed += 1
            self._release_args(rec)
            blob = serialization.get_context().serialize(
                TaskCancelledError(
                    f"task {rec.spec.repr_name()} was cancelled"
                )).to_bytes()
            for oid in rec.spec.return_ids:
                stores.append((oid, Entry("err", blob)))
            return None
        if isinstance(system_error, OutOfMemoryError):
            # Memory-watchdog kill: its own retry budget
            # (task_oom_retries) with exponential backoff; a
            # non-retryable victim surfaces the typed error.
            self.num_oom_kills += 1
            if system_error.retryable and rec.oom_retries_left > 0:
                from ray_tpu_torch._private.backoff import (jittered,
                                                      next_backoff)
                from ray_tpu_torch._private.config import get_config
                cfg = get_config()
                rec.oom_retries_left -= 1
                rec.attempt += 1
                rec.status = "pending"
                self.num_retries += 1
                self.num_oom_retries += 1
                # shared shed-retry schedule: doubling, capped,
                # jittered (a raylet under real memory pressure
                # evicts MANY tasks at once — they must not all
                # come back in the same tick)
                nxt = next_backoff(
                    getattr(rec.spec, "_oom_backoff_s", 0.0),
                    cfg.backpressure_retry_base_ms / 1000.0,
                    cfg.backpressure_retry_max_ms / 1000.0,
                    hint_s=system_error.backoff_s)
                rec.spec._oom_backoff_s = nxt  # type: ignore[attr-defined]
                rec.spec._resubmit_delay_s = jittered(  # type: ignore[attr-defined]
                    nxt, self._backoff_rng)
                return rec.spec
            self._mark_terminal(rec, "failed")
            self.num_failed += 1
            self._release_args(rec)
            blob = serialization.get_context().serialize(
                system_error).to_bytes()
            for oid in rec.spec.return_ids:
                stores.append((oid, Entry("err", blob)))
            return None
        retryable = system_error is not None
        if error_blob is not None and rec.spec.retry_exceptions:
            retryable = self._error_matches(
                error_blob, rec.spec.retry_exceptions)
        if retryable and rec.retries_left > 0:
            rec.retries_left -= 1
            rec.attempt += 1
            rec.status = "pending"
            self.num_retries += 1
            return rec.spec
        self._mark_terminal(rec, "failed")
        self.num_failed += 1
        self._release_args(rec)
        if error_blob is None:
            from ray_tpu_torch.exceptions import RayTpuError
            if isinstance(system_error, RayTpuError):
                err: BaseException = system_error
            else:
                err = TaskError(
                    system_error, rec.spec.repr_name(),
                    f"{type(system_error).__name__}: {system_error}")
            error_blob = serialization.get_context().serialize(err).to_bytes()
        for oid in rec.spec.return_ids:
            stores.append((oid, Entry("err", error_blob)))

    def mark_failed_external(self, task_id: TaskID) -> None:
        """Record an OUT-OF-BAND terminal failure — the caller stored
        the error entries itself (Worker._fail_task's actor-death /
        lost-object paths, which must bypass retry handling). Without
        this transition the record stays 'pending' forever and
        ``num_unfinished`` — the nested-intake backpressure signal —
        ratchets up by one per such failure until the owner sheds
        everything."""
        with self._lock:
            rec = self._tasks.get(task_id)
            if rec is None or rec.status in ("finished", "failed"):
                return
            self._mark_terminal(rec, "failed")
            self.num_failed += 1
            self._release_args(rec)

    # lock-held: _lock
    def _mark_terminal(self, rec: TaskRecord, status: str) -> None:
        """Status transition that keeps ``num_unfinished`` (the
        owner's nested-intake backpressure signal) exact: a record
        already terminal (late duplicate completion) doesn't double-
        decrement."""
        if rec.status not in ("finished", "failed") \
                and self.num_unfinished > 0:
            self.num_unfinished -= 1
        rec.status = status

    @staticmethod
    def _error_matches(error_blob: bytes, retry_exceptions) -> bool:
        if retry_exceptions is True:
            return True
        try:
            err, _ = serialization.get_context().deserialize_from_blob(
                memoryview(error_blob))
            cause = getattr(err, "cause", None)
            return cause is not None and isinstance(cause,
                                                    tuple(retry_exceptions))
        except Exception:
            return False

    def _release_args(self, rec: TaskRecord) -> None:
        if rec.args_released:
            return
        rec.args_released = True
        for oid in rec.spec.dependencies():
            self._release_arg(oid)
        if self._release_owned is not None:
            for oid, owner in rec.spec.owned_args():
                self._release_owned(owner, oid)

    # -- lineage -----------------------------------------------------------

    def lineage_task_for(self, object_id: ObjectID) -> Optional[TaskSpec]:
        with self._lock:
            tid = self._lineage.get(object_id)
            if tid is None:
                return None
            rec = self._tasks.get(tid)
            return rec.spec if rec else None

    def prepare_reconstruction(self, object_id: ObjectID
                               ) -> Tuple[Optional[TaskSpec], bool]:
        """Transition the creating task back to pending for lineage
        re-execution of a lost object.

        Returns ``(spec, needs_resubmit)``: ``(None, False)`` when
        recovery is impossible (no lineage retained or reconstruction
        budget exhausted); ``(spec, False)`` when the task is already
        pending/running (recovery piggybacks on the in-flight
        execution, no budget consumed); ``(spec, True)`` when the
        caller must resubmit the spec."""
        with self._lock:
            tid = self._lineage.get(object_id)
            if tid is None:
                return None, False
            rec = self._tasks.get(tid)
            if rec is None:
                return None, False
            if rec.status in ("pending", "running"):
                return rec.spec, False   # already being (re)computed
            if rec.reconstructions_left <= 0:
                return None, False
            rec.reconstructions_left -= 1
            rec.attempt += 1
            if rec.status in ("finished", "failed"):
                self.num_unfinished += 1   # terminal -> live again
            rec.status = "pending"
            self.num_reconstructions += 1
            return rec.spec, True

    def release_lineage(self, object_id: ObjectID) -> None:
        with self._lock:
            tid = self._lineage.pop(object_id, None)
            if tid is None:
                return
            left = self._lineage_count.get(tid, 1) - 1
            if left > 0:
                self._lineage_count[tid] = left
                return
            self._lineage_count.pop(tid, None)
            rec = self._tasks.get(tid)
            if rec and rec.status in ("finished", "failed"):
                self._tasks.pop(tid, None)

    def list_records(self) -> List[TaskRecord]:
        with self._lock:
            return list(self._tasks.values())

    def num_pending(self) -> int:
        with self._lock:
            return sum(1 for r in self._tasks.values()
                       if r.status in ("pending", "running"))

    def stats(self) -> dict:
        with self._lock:
            return {
                "pending": self.num_pending(),
                "finished": self.num_finished,
                "failed": self.num_failed,
                "retries": self.num_retries,
                "oom_kills": self.num_oom_kills,
                "oom_retries": self.num_oom_retries,
            }
