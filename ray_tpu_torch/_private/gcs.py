"""GCS-lite: authoritative cluster state for the single-host slice.

Reference: ``src/ray/gcs/gcs_server/`` — GcsNodeManager, GcsActorManager,
GcsPlacementGroupManager, InternalKVManager, GcsPublisher [UNVERIFIED —
mount empty, SURVEY.md §0]. This is the in-process slice of those
services; the seams (tables keyed by binary ids, a pub/sub channel per
table, a KV namespace) match so a networked GCS can replace it without
touching callers.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, NodeID, PlacementGroupID

logger = logging.getLogger(__name__)


class Publisher:
    """Minimal in-process pub/sub (reference: src/ray/pubsub/)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self._lock = threading.Lock()

    def subscribe(self, channel: str, callback: Callable) -> None:
        with self._lock:
            self._subs[channel].append(callback)

    def publish(self, channel: str, message) -> None:
        with self._lock:
            subs = list(self._subs.get(channel, ()))
        for cb in subs:
            try:
                cb(message)
            except Exception:
                # one bad subscriber must not starve the rest of the
                # channel — log and keep fanning out
                logger.exception("subscriber callback failed on %s",
                                 channel)


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    state: str = "PENDING"   # PENDING|ALIVE|RESTARTING|DEAD
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: str = ""
    creation_spec: object = None
    class_name: str = ""
    # Detached actors (reference: lifetime="detached", GcsActorManager
    # ownership): registered cluster-wide, survive their creating
    # driver; node_id records the hosting raylet so later drivers can
    # route calls, method_names lets get_actor build a handle without
    # the creating driver's function registry.
    lifetime: Optional[str] = None
    node_id: Optional["NodeID"] = None
    method_names: Tuple[str, ...] = ()
    # async actors accept ray_tpu_torch.cancel on in-flight calls (asyncio
    # cancellation); the owner consults this before routing a cancel
    is_async: bool = False

    @property
    def detached(self) -> bool:
        return self.lifetime == "detached"


@dataclass
class GangInfo:
    """One collective gang (TorchElastic-style rendezvous group): its
    members, incarnation epoch, and lifecycle state. Any member-actor
    death observed by ``update_actor_state`` bumps the epoch and marks
    the gang ABORTED — pollers (the driver's gang coordinator, the
    gang gauges) see the transition without a dedicated death RPC."""

    name: str
    members: Tuple[ActorID, ...]
    world_size: int
    epoch: int = 1
    state: str = "FORMING"   # FORMING|ALIVE|ABORTED|DEAD
    max_restarts: int = 0
    num_aborts: int = 0
    num_restarts: int = 0
    death_cause: str = ""


@dataclass
class SliceSetInfo:
    """One multi-slice runtime set (gang-of-gangs; see
    docs/multislice.md): each slice is one collective gang, the
    per-slice leader ranks form a separate DCN-tier group. A slice
    gang's abort fences the DCN tier — ``dcn_epoch`` bumps so the
    restarting slice's stale DCN rank-files are structurally
    unsatisfiable to the surviving slices — without touching any other
    slice's gang."""

    name: str
    slice_gangs: Tuple[str, ...]   # gang name per slice (index = slice id)
    dcn_group: str                 # leader-rank DCN collective group
    world_size: int                # total ranks across all slices
    dcn_epoch: int = 1
    state: str = "FORMING"   # FORMING|ALIVE|DEGRADED|DEAD
    # coordinated restarts per slice (index-aligned with slice_gangs)
    slice_restarts: Tuple[int, ...] = ()
    death_cause: str = ""


@dataclass
class CheckpointInfo:
    """One actor's newest COMMITTED checkpoint (see
    docs/fault_tolerance.md "Checkpoint semantics"). The table records
    only generations whose commit marker landed — a saved-but-never-
    committed generation is invisible here by construction, so readers
    (tests, dashboards, the gang coordinator) can treat every row as
    restorable."""

    actor_id: ActorID
    gen: int
    cursor: int = 0          # highest executed call seq at snapshot
    size_bytes: int = 0
    gang: Optional[str] = None   # committed via gang two-phase commit
    ts: float = 0.0


@dataclass
class NodeInfo:
    node_id: NodeID
    resources_total: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    start_time: float = field(default_factory=time.time)
    # raylet lease/object-manager endpoint (None for in-driver nodes)
    rpc_addr: Optional[Tuple[str, int]] = None


class GcsLite:
    def __init__(self):
        self.publisher = Publisher()
        self._lock = threading.RLock()
        self._nodes: Dict[NodeID, NodeInfo] = {}
        self._actors: Dict[ActorID, ActorInfo] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._gangs: Dict[str, GangInfo] = {}  # guarded-by: _lock
        self._slicesets: Dict[str, SliceSetInfo] = {}  # guarded-by: _lock
        # newest committed checkpoint per actor
        self._checkpoints: Dict[ActorID, CheckpointInfo] = {}  # guarded-by: _lock
        self._kv: Dict[str, Dict[bytes, bytes]] = defaultdict(dict)
        self._job_counter = 0

    # -- jobs --------------------------------------------------------------

    def next_job_id(self) -> int:
        with self._lock:
            self._job_counter += 1
            return self._job_counter

    # -- nodes -------------------------------------------------------------

    def register_node(self, info: NodeInfo) -> None:
        with self._lock:
            prev = self._nodes.get(info.node_id)
            if prev is not None and prev.rpc_addr is not None \
                    and info.rpc_addr is None:
                # A raylet registered itself WITH its serving address;
                # a later addr-less registration (e.g. the driver's
                # bookkeeping one) must not clobber it — tooling
                # (stack/log RPCs, health checks) dials that address.
                info.rpc_addr = prev.rpc_addr
            self._nodes[info.node_id] = info
        self.publisher.publish("NODE", ("ADDED", info))

    def remove_node(self, node_id: NodeID) -> None:
        with self._lock:
            info = self._nodes.get(node_id)
            if info:
                info.alive = False
        self.publisher.publish("NODE", ("REMOVED", node_id))

    def get_all_node_info(self) -> List[NodeInfo]:
        with self._lock:
            return list(self._nodes.values())

    # -- actors ------------------------------------------------------------

    def register_actor(self, info: ActorInfo) -> None:
        with self._lock:
            self._actors[info.actor_id] = info
            if info.name:
                key = (info.namespace, info.name)
                if key in self._named_actors:
                    existing = self._actors.get(self._named_actors[key])
                    if existing is not None and existing.state != "DEAD":
                        raise ValueError(
                            f"actor name {info.name!r} already taken in "
                            f"namespace {info.namespace!r}")
                self._named_actors[key] = info.actor_id

    def update_actor_state(self, actor_id: ActorID, state: str,
                           death_cause: str = "") -> None:
        aborted = []
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return
            info.state = state
            if death_cause:
                info.death_cause = death_cause
            if state in ("DEAD", "RESTARTING"):
                # Gang fencing: a member death aborts every live gang
                # it belongs to and bumps the epoch — the previous
                # incarnation can never rendezvous again. Already
                # ABORTED/DEAD gangs don't re-bump (the coordinated
                # restart marks every member RESTARTING).
                for g in self._gangs.values():
                    if actor_id in g.members and g.state in ("FORMING",
                                                             "ALIVE"):
                        g.state = "ABORTED"
                        g.epoch += 1
                        g.num_aborts += 1
                        g.death_cause = (f"member {actor_id.hex()[:8]} "
                                         f"{state.lower()}")
                        aborted.append((g.name, g.epoch))
        self.publisher.publish("ACTOR", (state, actor_id))
        for name, epoch in aborted:
            self.publisher.publish("GANG", ("ABORTED", name, epoch))

    def record_actor_restart(self, actor_id: ActorID) -> None:
        """Count one restart of an actor, in the table itself: an
        out-of-process GCS hands its callers copies of the actor's
        info, so a caller's own increment would be lost."""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is not None:
                info.num_restarts += 1

    def update_actor_location(self, actor_id: ActorID,
                              node_id: Optional[NodeID]) -> None:
        """Record the raylet hosting this actor (detached-actor
        routing: later drivers resolve the node from here)."""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is not None:
                info.node_id = node_id

    def get_actor_info(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self._lock:
            return self._actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str
                        ) -> Optional[ActorInfo]:
        with self._lock:
            aid = self._named_actors.get((namespace, name))
            return self._actors.get(aid) if aid else None

    def list_actors(self) -> List[ActorInfo]:
        with self._lock:
            return list(self._actors.values())

    # -- gangs (collective groups; see docs/fault_tolerance.md) ------------

    def register_gang(self, info: GangInfo) -> None:
        with self._lock:
            self._gangs[info.name] = info
        self.publisher.publish("GANG", (info.state, info.name, info.epoch))

    def get_gang_info(self, name: str) -> Optional[GangInfo]:
        with self._lock:
            return self._gangs.get(name)

    def list_gangs(self) -> List[GangInfo]:
        with self._lock:
            return list(self._gangs.values())

    def update_gang_state(self, name: str, state: str,
                          death_cause: str = "") -> None:
        """Lifecycle transition by the driver's gang coordinator.
        ABORTED -> FORMING counts one coordinated restart."""
        with self._lock:
            g = self._gangs.get(name)
            if g is None:
                return
            if state == "FORMING" and g.state == "ABORTED":
                g.num_restarts += 1
            g.state = state
            if death_cause:
                g.death_cause = death_cause
            epoch = g.epoch
        self.publisher.publish("GANG", (state, name, epoch))

    def unregister_gang(self, name: str) -> None:
        with self._lock:
            g = self._gangs.pop(name, None)
        if g is not None:
            self.publisher.publish("GANG", ("REMOVED", name, g.epoch))

    # -- slice sets (multi-slice runtime plane; see docs/multislice.md) ----

    def register_sliceset(self, info: SliceSetInfo) -> None:
        with self._lock:
            if not info.slice_restarts:
                info.slice_restarts = (0,) * len(info.slice_gangs)
            self._slicesets[info.name] = info
        self.publisher.publish("SLICESET",
                               (info.state, info.name, info.dcn_epoch))

    def get_sliceset_info(self, name: str) -> Optional[SliceSetInfo]:
        with self._lock:
            return self._slicesets.get(name)

    def list_slicesets(self) -> List[SliceSetInfo]:
        with self._lock:
            return list(self._slicesets.values())

    def update_sliceset(self, name: str, state: Optional[str] = None,
                        dcn_epoch: Optional[int] = None,
                        restarted_slice: Optional[int] = None,
                        death_cause: str = "") -> None:
        """Lifecycle transition by the driver's sliceset coordinator:
        a slice-gang abort lands here as state=DEGRADED + a dcn_epoch
        bump (+ that slice's restart counter); the DCN re-join flips
        it back to ALIVE. The epoch is monotonic, and a state update
        carrying an OLDER epoch is dropped — a rejoin's late ALIVE
        racing a newer fence can never un-fence the tier. (An
        epoch-less state update is trusted: only the fence path bumps
        epochs, and it always sends its epoch.)"""
        with self._lock:
            ss = self._slicesets.get(name)
            if ss is None:
                return
            if ss.state == "DEAD":
                # terminal, like a DEAD gang: the fence's DEAD write
                # carries no epoch, so without this guard a rejoin
                # already past its own DEAD check could flip the row
                # back ALIVE forever (the coordinator's rec.dead
                # blocks every future fence that would correct it)
                return
            stale = (dcn_epoch is not None
                     and int(dcn_epoch) < ss.dcn_epoch)
            if state is not None and not stale:
                ss.state = state
            if dcn_epoch is not None:
                ss.dcn_epoch = max(ss.dcn_epoch, int(dcn_epoch))
            if restarted_slice is not None:
                counts = list(ss.slice_restarts
                              or (0,) * len(ss.slice_gangs))
                if 0 <= restarted_slice < len(counts):
                    counts[restarted_slice] += 1
                ss.slice_restarts = tuple(counts)
            if death_cause:
                ss.death_cause = death_cause
            payload = (ss.state, name, ss.dcn_epoch)
        self.publisher.publish("SLICESET", payload)

    def unregister_sliceset(self, name: str) -> None:
        with self._lock:
            ss = self._slicesets.pop(name, None)
        if ss is not None:
            self.publisher.publish("SLICESET",
                                   ("REMOVED", name, ss.dcn_epoch))

    # -- actor checkpoints (committed generations only) --------------------

    def record_checkpoint(self, info: CheckpointInfo) -> None:
        """Record a COMMITTED checkpoint generation. Only the driver's
        commit path calls this — after the commit marker is durably on
        disk — so the table never references a torn generation. Stale
        (out-of-order) records are ignored: commits are monotonic per
        actor."""
        with self._lock:
            prev = self._checkpoints.get(info.actor_id)
            if prev is not None and prev.gen >= info.gen:
                return
            self._checkpoints[info.actor_id] = info
        self.publisher.publish("CKPT",
                               ("COMMITTED", info.actor_id, info.gen))

    def get_checkpoint(self, actor_id: ActorID
                       ) -> Optional[CheckpointInfo]:
        with self._lock:
            return self._checkpoints.get(actor_id)

    def list_checkpoints(self) -> List[CheckpointInfo]:
        with self._lock:
            return list(self._checkpoints.values())

    def drop_checkpoint(self, actor_id: ActorID) -> None:
        with self._lock:
            info = self._checkpoints.pop(actor_id, None)
        if info is not None:
            self.publisher.publish("CKPT", ("DROPPED", actor_id,
                                            info.gen))

    # -- internal KV (reference: InternalKVManager) ------------------------

    def kv_put(self, key: bytes, value: bytes, namespace: str = "") -> None:
        with self._lock:
            self._kv[namespace][key] = value

    def kv_get(self, key: bytes, namespace: str = "") -> Optional[bytes]:
        with self._lock:
            return self._kv[namespace].get(key)

    def kv_del(self, key: bytes, namespace: str = "") -> None:
        with self._lock:
            self._kv[namespace].pop(key, None)

    def kv_keys(self, prefix: bytes, namespace: str = "") -> List[bytes]:
        with self._lock:
            return [k for k in self._kv[namespace] if k.startswith(prefix)]

    # -- persistence (reference: Redis-backed GcsTableStorage) -------------

    def dump_state(self) -> bytes:
        import pickle
        with self._lock:
            return pickle.dumps({
                "nodes": self._nodes,
                "actors": self._actors,
                "named_actors": self._named_actors,
                "gangs": self._gangs,
                "slicesets": self._slicesets,
                "checkpoints": self._checkpoints,
                "kv": dict(self._kv),
                "job_counter": self._job_counter,
            })

    def load_state(self, blob: bytes) -> None:
        import pickle
        state = pickle.loads(blob)
        with self._lock:
            self._nodes = state["nodes"]
            self._actors = state["actors"]
            self._named_actors = state["named_actors"]
            self._gangs = state.get("gangs", {})  # pre-gang snapshots
            # pre-multislice snapshots lack the table
            self._slicesets = state.get("slicesets", {})
            # pre-checkpoint-plane snapshots lack the table
            self._checkpoints = state.get("checkpoints", {})
            self._kv = defaultdict(dict, state["kv"])
            self._job_counter = state["job_counter"]
