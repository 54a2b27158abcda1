"""TaskSpecification: the unit the scheduler and workers exchange.

Reference: ``src/ray/common/task/task_spec.h`` [UNVERIFIED — mount
empty, SURVEY.md §0]. A spec carries identity, the function payload
descriptor, argument descriptors (inline value / object reference),
resource demand, retry policy and a scheduling strategy.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2
    DRIVER_TASK = 3


@dataclass(frozen=True)
class FunctionDescriptor:
    """Identifies a remote function / actor class / actor method.

    ``payload`` is the cloudpickled callable; workers cache it by
    ``function_id`` so repeated submissions ship only the 28-byte id.
    """

    function_id: bytes
    module: str
    name: str

    def repr_name(self) -> str:
        return f"{self.module}.{self.name}"


@dataclass
class TaskArg:
    """Either an inline serialized value or a reference to an object."""

    object_id: Optional[ObjectID] = None        # by-reference arg
    inline_blob: Optional[bytes] = None         # serialized small value
    is_inline_plain: bool = False               # blob is raw pickle of value
    # Worker-owned ref (decentralized ownership): the executing worker
    # resolves the bytes straight from this owner core port; the object
    # never enters the driver's stores.
    owner_addr: Optional[Tuple[str, int]] = None

    @staticmethod
    def by_ref(object_id: ObjectID) -> "TaskArg":
        return TaskArg(object_id=object_id)

    @staticmethod
    def by_owned_ref(object_id: ObjectID,
                     owner_addr: Tuple[str, int]) -> "TaskArg":
        return TaskArg(object_id=object_id, owner_addr=tuple(owner_addr))

    @staticmethod
    def by_value(blob: bytes) -> "TaskArg":
        return TaskArg(inline_blob=blob)


class SchedulingStrategy:
    """Base; see ray_tpu_torch.util.scheduling_strategies for public types."""

    kind: str = "DEFAULT"


@dataclass
class TaskOptions:
    num_cpus: Optional[float] = None
    num_tpus: Optional[float] = None
    num_gpus: Optional[float] = None
    memory: Optional[float] = None
    resources: Dict[str, float] = field(default_factory=dict)
    num_returns: int = 1
    max_retries: Optional[int] = None
    retry_exceptions: Any = False   # False | True | list of exc types
    scheduling_strategy: Any = None
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    runtime_env: Optional[dict] = None
    name: Optional[str] = None
    # actors only (None -> config default actor_max_restarts):
    max_restarts: Optional[int] = None
    max_task_retries: int = 0
    max_concurrency: int = 1
    lifetime: Optional[str] = None
    namespace: Optional[str] = None
    get_if_exists: bool = False
    # Checkpointable actors (__ray_save__/__ray_restore__): runtime-
    # driven snapshot every N completed calls; 0 disables autosave
    # (restore-at-creation still applies when checkpoints exist).
    checkpoint_interval: int = 0

    def resource_demand(self, default_cpus: float = 1.0) -> Dict[str, float]:
        demand: Dict[str, float] = {}
        cpus = self.num_cpus if self.num_cpus is not None else default_cpus
        if cpus:
            demand["CPU"] = float(cpus)
        if self.num_tpus:
            demand["TPU"] = float(self.num_tpus)
        if self.num_gpus:
            demand["GPU"] = float(self.num_gpus)
        if self.memory:
            demand["memory"] = float(self.memory)
        for k, v in self.resources.items():
            if k in ("CPU", "TPU", "GPU", "memory"):
                raise ValueError(
                    f"Use the dedicated option for {k!r}, not resources=")
            demand[k] = float(v)
        return demand


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function: FunctionDescriptor
    args: List[TaskArg]
    kwargs_keys: List[str]              # trailing len(kwargs_keys) args are kwargs
    num_returns: int
    resources: Dict[str, float]
    max_retries: int = 0
    retry_exceptions: Any = False
    scheduling_strategy: Any = None
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    # actor fields
    actor_id: Optional[ActorID] = None
    actor_creation_id: Optional[ActorID] = None
    sequence_number: int = 0
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    checkpoint_interval: int = 0     # actors: autosave every N calls
    lifetime: Optional[str] = None   # None | "detached"
    name: str = ""
    runtime_env: Optional[dict] = None
    # Streaming generator task: returns yield incrementally; return_ids
    # holds only the completion marker (stores the item count).
    streaming: bool = False
    # Retry resume point: yielded items below this index were
    # already delivered to the owner by a previous attempt and
    # are skipped (item-index dedup; assumes a deterministic
    # generator prefix, the reference's replay semantics).
    stream_skip: int = 0
    # filled by the driver at submission:
    return_ids: List[ObjectID] = field(default_factory=list)
    depth: int = 0

    def dependencies(self) -> List[ObjectID]:
        """Driver-store dependencies. Worker-owned args are excluded:
        they are complete at submission (puts) and resolve owner-direct
        at execution — the driver's dependency manager never waits on
        them."""
        return [a.object_id for a in self.args
                if a.object_id is not None and a.owner_addr is None]

    def owned_args(self) -> List[Tuple[ObjectID, Tuple[str, int]]]:
        return [(a.object_id, a.owner_addr) for a in self.args
                if a.owner_addr is not None]

    def repr_name(self) -> str:
        return self.name or self.function.repr_name()
