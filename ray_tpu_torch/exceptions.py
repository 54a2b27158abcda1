"""Public exception hierarchy (reference: ``python/ray/exceptions.py``
[UNVERIFIED — mount empty, SURVEY.md §0])."""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """An application-level exception raised inside a task.

    Wraps the original traceback text; re-raised at every ``get`` on the
    task's return refs and propagated through dependent tasks.
    """

    def __init__(self, cause: Optional[BaseException] = None,
                 task_repr: str = "", traceback_str: str = ""):
        if not isinstance(cause, BaseException):
            cause = None
        self.cause = cause
        self.task_repr = task_repr
        self.traceback_str = traceback_str or (
            "".join(traceback.format_exception(cause)) if cause else "")
        super().__init__(self.traceback_str)

    def __reduce__(self):
        # The cause may itself be unpicklable; drop it in that case (the
        # traceback text carries the information either way).
        import pickle
        cause = self.cause
        try:
            pickle.dumps(cause)
        except Exception:
            cause = None
        return (TaskError, (cause, self.task_repr, self.traceback_str))

    def __str__(self):
        return (f"Task failed: {self.task_repr}\n"
                f"{self.traceback_str}")

    def as_instanceof_cause(self) -> BaseException:
        """Best-effort: return an exception that is also an instance of
        the user's exception type so `except UserError` works across the
        task boundary."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        # Framework errors normally stay wrapped (their constructors
        # don't all accept the TaskError signature); ones that opt in
        # via _typed_across_tasks (CollectiveAbortError) derive too, so
        # `except CollectiveAbortError` works at the caller's get().
        if cause_cls in (TaskError,) or (
                issubclass(cause_cls, RayTpuError)
                and not getattr(self.cause, "_typed_across_tasks", False)):
            return self
        try:
            derived = type("TaskError_" + cause_cls.__name__,
                           (TaskError, cause_cls), {})
            err = derived(self.cause, self.task_repr, self.traceback_str)
            # The derived instance was built by TaskError.__init__, so
            # the cause's own attributes (CollectiveAbortError's
            # group/epoch, user exception fields) were never set — copy
            # them over, without clobbering the TaskError fields.
            for key, value in vars(self.cause).items():
                if key not in ("cause", "task_repr", "traceback_str"):
                    setattr(err, key, value)
            return err
        except Exception:
            return self


# Back-compat alias matching the reference's name.
RayTaskError = TaskError


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead (crashed, killed, or out of restarts)."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get` exceeded its timeout."""


class ObjectLostError(RayTpuError):
    """Object can no longer be found or reconstructed."""

    def __init__(self, object_id_hex: str, msg: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(msg or f"Object {object_id_hex} was lost")

    def __reduce__(self):
        # type(self): subclasses (ObjectReconstructionFailedError,
        # OwnerDiedError) inherit this __init__, so they must unpickle
        # as themselves — the error frame crosses the RPC reply
        # boundary and the caller's `except OwnerDiedError` must work.
        return (type(self), (self.object_id_hex,
                             self.args[0] if self.args else ""))


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    """The owner of this object died; ownership is not replicated."""


class ObjectTransferError(RayTpuError):
    """Base of the transfer-plane taxonomy (docs/object_plane.md): a
    chunked node-to-node pull failed. Replaces the old untyped
    ``ObjectLocationError``. Carries:

    - ``object_id_hex``: the object being transferred;
    - ``offset``: byte offset reached when the transfer failed (-1 =
      before the first chunk);
    - ``retryable``: always True by contract — a failed pull sealed
      nothing, so re-pulling (from another source) or lineage
      reconstruction is always safe.

    Raised inside tasks it surfaces TYPED at the caller's ``get()``
    (``_typed_across_tasks``); the owner's recovery path treats it as
    a reconstruction trigger, never a task bug."""

    retryable = True
    _typed_across_tasks = True

    def __init__(self, msg: str = "object transfer failed",
                 object_id_hex: str = "", offset: int = -1):
        super().__init__(msg)
        self.object_id_hex = object_id_hex
        self.offset = int(offset)

    def __reduce__(self):
        # type(self): subclasses inherit this __init__/signature, so
        # they must unpickle as themselves — the error crosses task
        # and RPC boundaries and `except ObjectSourceLostError` must
        # keep working on the far side.
        return (type(self), (self.args[0] if self.args else "",
                             self.object_id_hex, self.offset))


class ObjectSourceLostError(ObjectTransferError):
    """Every known holder of the object is gone (died, or freed the
    object between chunks). The owner routes this into lineage
    reconstruction; mid-broadcast it triggers a re-route to live
    holders via the owner's location table."""


class ObjectTransferTimeoutError(ObjectTransferError):
    """The pull's deadline budget elapsed across all sources and
    retries. Distinct from source loss: holders may still exist, the
    transfer just could not complete in budget (congestion, chaos
    delay) — callers may re-issue with a fresh budget."""


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class PendingCallsLimitExceeded(RayTpuError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    """A task/actor bound to a placement group cannot run there
    (group removed, or demand can never fit the bundle)."""


class SystemOverloadError(RayTpuError):
    """Base of the overload-plane taxonomy (reference: the memory
    monitor's retryable ``OutOfMemoryError`` and backpressured task
    submission). Carries:

    - ``retryable``: the failed work is safe to re-run (nothing
      executed, or the execution was killed before side effects were
      owed) — the owner retries it transparently;
    - ``backoff_s``: the raiser's suggested retry delay (0 = use the
      caller's own schedule).

    The RPC layer ships these as a first-class ``RESOURCE_EXHAUSTED``
    reply frame, so callers receive the TYPED error (flags intact)
    rather than a generic ``RpcError`` wrap.
    """

    def __init__(self, msg: str = "system overload",
                 retryable: bool = True, backoff_s: float = 0.0):
        super().__init__(msg)
        self.retryable = bool(retryable)
        self.backoff_s = float(backoff_s)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.retryable, self.backoff_s))


class BackpressureError(SystemOverloadError):
    """A submission was shed at admission (bounded intake full). The
    work never started, so retrying is always safe — a saturated
    cluster costs latency, never results."""


class OutOfMemoryError(SystemOverloadError):
    """The node memory watchdog killed this task to relieve memory
    pressure. ``retryable`` reflects the task's own retry policy
    (``max_retries > 0``); the owner retries retryable victims up to
    ``task_oom_retries`` with exponential backoff, and surfaces this
    error at ``get()`` for non-retryable ones."""


class CapacityInfeasibleError(SystemOverloadError):
    """A scheduling class's pending count exceeds the cluster's
    capacity bound from node TOTALS: even an idle cluster could not
    hold ``pending`` instances of ``demand`` concurrently (the bound
    sums, over nodes whose totals fit one instance, how many each
    could hold — docs/scheduler.md). Distinct from plain
    infeasibility: when ``bound`` is 0 NO node can EVER run one
    instance; when ``bound`` > 0 the surplus is schedulable later, as
    running work finishes or nodes join, so the owner parks the class
    in its unplaceable ledger — released on the next cluster-ledger
    version delta — instead of rescanning it every tick. Retryable by
    construction: nothing ran."""

    def __init__(self, msg: str = "demand exceeds cluster capacity",
                 demand: Optional[dict] = None, bound: int = 0,
                 pending: int = 0):
        super().__init__(msg, retryable=True, backoff_s=0.0)
        self.demand = dict(demand or {})
        self.bound = int(bound)
        self.pending = int(pending)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.demand, self.bound, self.pending))


class UnsatisfiableDemandError(RayTpuError):
    """A demand shape fits NO node type in the autoscaler's catalog:
    no amount of scale-up can ever place it. Distinct from
    CapacityInfeasibleError (whose bound can rise as nodes join) —
    this one is terminal for the shape until the catalog itself
    changes, so the autoscaler records it typed instead of launching
    nodes that could never help (docs/autoscaler.md)."""

    def __init__(self, msg: str = "demand fits no catalog node type",
                 demand: Optional[dict] = None,
                 node_types: Optional[list] = None):
        super().__init__(msg)
        self.demand = dict(demand or {})
        self.node_types = list(node_types or [])

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.demand, self.node_types))


class CollectiveAbortError(RayTpuError):
    """A collective group was aborted mid-operation: a member died (or
    the gang's epoch was fenced off) while this rank was inside a
    rendezvous. Retryable by contract — the operation transferred no
    partial results, and the gang re-forms at a bumped epoch (see
    docs/fault_tolerance.md "Gang semantics"); callers re-issue the
    collective once the gang is ALIVE again.

    ``group``/``epoch`` name the aborted incarnation. Raised inside
    actor methods it surfaces TYPED at the caller's ``get()``
    (``_typed_across_tasks``), so `except CollectiveAbortError` is the
    retry trigger."""

    retryable = True
    _typed_across_tasks = True

    def __init__(self, msg: str = "collective group aborted",
                 group: str = "", epoch: int = 0):
        super().__init__(msg)
        self.group = group
        self.epoch = int(epoch)

    def __reduce__(self):
        return (type(self), (self.args[0] if self.args else "",
                             self.group, self.epoch))
