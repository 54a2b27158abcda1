"""Node manager group: logical raylets, dependency resolution, the
cluster scheduling loop, and worker IO routing.

Reference analogs [UNVERIFIED — mount empty, SURVEY.md §0]:
- ``src/ray/raylet/node_manager.cc`` (per-node manager)
- ``src/ray/raylet/scheduling/cluster_task_manager.cc`` (queues +
  schedule loop), ``local_task_manager.cc`` (dispatch to workers)
- ``src/ray/raylet/dependency_manager.cc``

Topology note: like the reference's test clusters (N raylets as
processes on one machine), logical nodes here are N raylet objects in
the host process, each with its own worker pool and resource ledger,
scheduled against a shared ``ClusterResourceManager``. The scheduling
decision/dispatch seam is identical to the distributed one, so the
policy layer (including the TPU kernel policy) cannot tell the
difference; cross-host raylets plug in at the `Raylet` interface.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device_object import device_arg_desc
from ray_tpu_torch._private.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import MemoryStore, ShmStore
from ray_tpu_torch._private.scheduler.policy import (
    ISchedulingPolicy,
    SchedulingRequest,
)
from ray_tpu_torch._private.scheduler.resources import (
    ClusterResourceManager,
    NodeResources,
)
from ray_tpu_torch._private.task_spec import TaskSpec, TaskType
from ray_tpu_torch._private.worker_pool import BaseWorker, ProcessWorker, WorkerPool
from ray_tpu_torch.exceptions import (
    BackpressureError,
    CapacityInfeasibleError,
    OutOfMemoryError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)


class _FencedClass:
    """One scheduling class parked in the unplaceable ledger
    (docs/scheduler.md): its pending count exceeds the cluster's
    node-totals capacity bound, so rescanning it every tick is pure
    waste. ``version`` is the cluster resource version at park time —
    the scheduling loop releases the class back into scheduling on the
    first version delta (capacity freed, node joined/left), which is
    the only way new room can appear."""

    __slots__ = ("version", "specs", "error")

    def __init__(self, version: int, error: CapacityInfeasibleError):
        self.version = version
        self.specs: List[TaskSpec] = []
        self.error = error


class DependencyManager:
    """Tracks which queued tasks wait on which objects."""

    def __init__(self):
        self._waiting_on: Dict[ObjectID, Set[TaskID]] = defaultdict(set)  # guarded-by: _lock
        self._remaining: Dict[TaskID, int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def add_task(self, task_id: TaskID, deps: List[ObjectID],
                 is_available: Callable[[ObjectID], bool]) -> bool:
        """Register; returns True if already ready."""
        with self._lock:
            missing = [d for d in deps if not is_available(d)]
            if not missing:
                return True
            self._remaining[task_id] = len(missing)
            for d in missing:
                self._waiting_on[d].add(task_id)
            return False

    def on_object_available(self, object_id: ObjectID) -> List[TaskID]:
        with self._lock:
            ready = []
            for tid in self._waiting_on.pop(object_id, ()):  # noqa: B020
                self._remaining[tid] -= 1
                if self._remaining[tid] == 0:
                    del self._remaining[tid]
                    ready.append(tid)
            return ready

    def cancel_task(self, task_id: TaskID) -> None:
        with self._lock:
            self._remaining.pop(task_id, None)
            for waiters in self._waiting_on.values():
                waiters.discard(task_id)


class RunningTask:
    __slots__ = ("spec", "node_id", "worker", "resources", "pg")

    def __init__(self, spec: TaskSpec, node_id: NodeID, worker: BaseWorker,
                 resources: Dict[str, float], pg=None):
        self.spec = spec
        self.node_id = node_id
        self.worker = worker
        self.resources = resources
        self.pg = pg  # (PlacementGroupID, bundle_index) | None


class Raylet:
    """One logical node: resource ledger + worker pool + dispatch queue."""

    def __init__(self, node_id: NodeID, resources: NodeResources,
                 session: str, hub, reply_handler, on_worker_ready,
                 labels=None, max_process_workers: int = 8):
        self.node_id = node_id
        self.resources = resources
        if labels:
            self.resources.labels.update(labels)
        self.worker_pool = WorkerPool(session, hub, reply_handler,
                                      on_worker_ready,
                                      max_process_workers=max_process_workers)
        # unbounded-ok: fed only by the scheduler after a successful
        # capacity allocation — depth is bounded by node resources
        self.dispatch_queue: deque = deque()
        self.alive = True


class _RemoteLease:
    """RunningTask.worker sentinel for a normal task leased to a remote
    raylet (there is no driver-side worker object to release)."""

    is_actor_worker = False
    kind = "remote"

    def __init__(self, handle: "RemoteNodeHandle"):
        self.handle = handle

    @property
    def alive(self) -> bool:
        return self.handle.alive


class RemoteActorWorker:
    """Driver-side stand-in for a dedicated actor worker living on a
    remote raylet; routes sends over the node's RPC channel."""

    def __init__(self, handle: "RemoteNodeHandle", actor_id_bytes: bytes):
        self.handle = handle
        self.actor_id_bytes = actor_id_bytes
        self.is_actor_worker = True
        self.kind = "remote"

    @property
    def alive(self) -> bool:
        return self.handle.alive

    def send(self, msg: tuple) -> None:
        if msg[0] == "shutdown":
            try:
                self.handle.client.call("kill_actor", self.actor_id_bytes,
                                        timeout=5)
            except Exception:
                pass    # raylet gone: node-lost path reaps the actor
            return
        raise RuntimeError("remote actor sends go through submit_actor_task")

    def kill(self) -> None:
        pass


class RemoteNodeHandle:
    """Driver-side proxy of a raylet process (lease channel + object
    manager address + liveness).

    The channel is a ``RetryingRpcClient``: a dropped or severed
    connection reconnects in the background (re-running
    ``register_owner`` so completion pushes resume on the new
    connection) and in-flight lease calls re-send under their
    idempotency tokens — a transient network fault no longer costs the
    whole node. Only when reconnection keeps failing for
    ``raylet_channel_reconnect_ms`` is the node declared lost (its
    tasks then retry on survivors)."""

    def __init__(self, group: "NodeManagerGroup", node_id: NodeID,
                 addr, resources: NodeResources, proc=None):
        from ray_tpu_torch._private.rpc import RetryingRpcClient
        cfg = get_config()
        self.node_id = node_id
        self.addr = tuple(addr)
        self.resources = resources
        self.proc = proc
        self.alive = True
        self.known_functions: set = set()
        self._group = group
        self.client = RetryingRpcClient(
            self.addr, on_push=self._on_push,
            component="raylet_channel",
            on_reconnect=self._register_owner,
            on_give_up=self._on_give_up,
            should_reconnect=self._peer_may_return,
            auto_reconnect=True,
            reconnect_window=cfg.raylet_channel_reconnect_ms / 1000.0,
            call_deadline=cfg.worker_lease_timeout_ms / 1000.0)

    def _peer_may_return(self) -> bool:
        """A raylet process WE spawned that has exited can never answer
        a reconnect — skip the backoff window and let node-lost fire
        now (elastic shrink must not lag a known-dead child). Attached
        peers (proc None) keep the full window: their death is only
        visible through the network."""
        return self.proc is None or self.proc.poll() is None

    def _register_owner(self, raw) -> None:
        """Per-connection server state: the raylet routes completion
        pushes to the registered owner channel; every (re)connect must
        re-establish it before anything else. The session string is
        this driver's stable identity across reconnects — the raylet
        scopes dead-connection adoption to it, so one driver's
        reconnect never cancels another driver's teardown."""
        raw.call("register_owner", self._group._session, timeout=10.0)

    def _on_give_up(self, exc: BaseException) -> None:
        if self.alive:
            logger.warning("raylet channel to %s not restored (%s); "
                           "declaring node lost",
                           self.node_id.hex()[:8], exc)
            self._group._on_remote_node_lost(self.node_id)

    def _on_push(self, topic: str, payload) -> None:
        try:
            self._group._on_remote_push(self, topic, payload)
        except Exception:
            logger.exception("error handling push from %s", self.node_id)


class NodeManagerGroup:
    """Owns all logical raylets plus the scheduling/IO machinery."""

    def __init__(self, session: str, memory_store: MemoryStore,
                 shm_store: ShmStore, policy: ISchedulingPolicy,
                 complete_task_cb, function_blob_provider,
                 driver_node_resources: NodeResources,
                 max_process_workers: int = 8):
        self._session = session
        self._memory_store = memory_store
        self._shm_store = shm_store
        self._policy = policy
        self._complete_task = complete_task_cb  # (task_id, results, err_blob, sys_err)
        self._function_blob = function_blob_provider  # fid -> bytes
        self._max_process_workers = max_process_workers

        self.cluster_resources = ClusterResourceManager()
        self.dependency_manager = DependencyManager()
        from ray_tpu_torch._private.pip_env import PipEnvManager
        self._pip_envs = PipEnvManager(self._on_pip_env_requeue)
        self.pg_manager = None  # set by the owning Worker after init
        self._fail_task_cb = None  # (spec, exception) -> None; set by Worker
        self._cancelled_check = None  # (TaskID) -> bool; set by Worker
        self._recover_object_cb = None  # (ObjectID) -> bool; set by Worker
        self._ensure_host_copy_cb = None  # (ObjectID) -> (name, size)|None
        self._stream_item_cb = None  # (TaskID, results); set by Worker

        # Scheduling state lock. The dependency manager is a leaf:
        # its lock may be taken inside _lock (dispatch consults
        # readiness) but it never calls back up into the group
        # (enforced by graftcheck's lock-order pass):
        # lock-order: _lock -> DependencyManager._lock
        self._lock = threading.RLock()
        self._raylets: Dict[NodeID, Raylet] = {}  # guarded-by: _lock
        self._remote_nodes: Dict[NodeID, RemoteNodeHandle] = {}  # guarded-by: _lock
        # Multi-holder location table (docs/object_plane.md): every
        # node known to hold a sealed copy, insertion-ordered (first =
        # primary producer). Dead holders are filtered at read time.
        self._object_locations: Dict[ObjectID, List[NodeID]] = {}  # guarded-by: _lock
        # Broadcast fan-out assignments: consumer nodes recently handed
        # a pull descriptor for the object, in tree order — consumer k
        # pulls from consumer (k-1)//2 (falling back to real holders),
        # so no single link serves more than ~2 subtrees. Advisory:
        # wrong parents degrade to a re-route, never a wrong result.
        self._pull_assignments: Dict[ObjectID, List[NodeID]] = {}  # guarded-by: _lock
        self._waiting: Dict[TaskID, TaskSpec] = {}  # guarded-by: _lock
        # unbounded-ok: owner intake; nested submissions are bounded by
        # owner_max_pending_tasks (shed with BackpressureError), the
        # local driver's own burst is its own flow control
        self._to_schedule: deque = deque()  # guarded-by: _lock
        self._infeasible: Dict[TaskID, TaskSpec] = {}  # guarded-by: _lock
        # Unplaceable-class ledger (docs/scheduler.md): capacity-fenced
        # scheduling classes parked until the cluster resource version
        # moves. Keyed by the class's sorted demand items.
        self._unplaceable: Dict[tuple, _FencedClass] = {}  # guarded-by: _lock
        self.num_fenced = 0   # fenced parks honored (cumulative)
        # unbounded-ok: one entry per distinct fenced demand shape,
        # only used to rate-limit the first-fence warning/export
        self._fence_warned: set = set()
        self._running: Dict[TaskID, RunningTask] = {}  # guarded-by: _lock
        self._actor_workers: Dict[ActorID, Tuple[NodeID, BaseWorker, dict]] = {}  # guarded-by: _lock
        self._actor_death_cb: Optional[Callable] = None
        # checkpoint plane (set by Worker): a saved-generation report
        # from an actor's executor, and the restore info riding a
        # (re)creation's actor_ready
        self._actor_ckpt_cb: Optional[Callable] = None
        self._actor_restore_cb: Optional[Callable] = None

        self._wake = threading.Event()
        self._shutdown = False
        # Wire-plane stats (data-plane fast path observability): frames
        # vs payloads through the owner's submit paths — the bench's
        # rpc_frame_avg_batch / rpc_bytes_per_task inputs.
        from ray_tpu_torch._private import wire_stats
        self.wire_stats = wire_stats
        # hot-path accumulator held once (wire_stats.channel docstring)
        self._reply_stats = wire_stats.channel("worker_reply")
        # bumped on node add/remove
        self._membership_version = 0  # guarded-by: _lock
        # Cordoned nodes (autoscaler drain, docs/autoscaler.md): the
        # kernel's alive-mask is flipped in cluster_resources, so no
        # policy places new leases there; this set only remembers
        # which nodes WE cordoned (vs. genuinely dead) so uncordon
        # can restore exactly those.
        self._cordoned: set = set()  # guarded-by: _lock
        # Node-type catalog (autoscaler-registered): lets
        # unplaceable_report carry the node-type-feasible view without
        # the caller re-deriving fit. name -> resources dict.
        self._node_type_catalog: Dict[str, Dict[str, float]] = {}  # guarded-by: _lock
        # Overload plane, owner side: shed/OOM'd specs wait out their
        # backoff here as (due_monotonic, spec, resubmit) — the
        # scheduling loop pumps due entries back in. RNG seeding
        # semantics live in backoff.make_rng.
        from ray_tpu_torch._private.backoff import make_rng
        self._deferred: List[Tuple[float, TaskSpec, bool]] = []  # guarded-by: _lock
        self._shed_rng = make_rng()  # guarded-by: _lock
        self.num_shed = 0          # shed replies honored (cumulative)
        self.num_window_waits = 0  # dispatches parked on a full window
        # (timestamp, counts) memo for _remote_inflight_counts
        self._inflight_cache: Tuple[float, Dict[NodeID, int]] = (-1.0, {})  # guarded-by: _lock

        from ray_tpu_torch._private.connection_hub import ConnectionHub
        self.hub = ConnectionHub(session)

        # Driver-side object manager: serves this owner's store to
        # remote raylets pulling argument objects (every node, the head
        # included, is addressable on the transfer plane).
        from ray_tpu_torch._private.object_transfer import (
            PeerClients, PullManager, serve_store)
        from ray_tpu_torch._private.rpc import RpcServer
        self.object_server = RpcServer()
        self._peer_clients = PeerClients()
        # Driver-side pull engine: dedup + retried + re-routed pulls
        # into the owner's store; the owner locates holders directly
        # from its own table (docs/object_plane.md).
        self.pull_manager = PullManager(
            self._shm_store, self._peer_clients,
            locate=self._live_holder_addrs, label="owner")
        serve_store(self.object_server, self._serve_object_view,
                    progress=self.pull_manager.progress)
        # Location service for re-routing pullers whose sources died
        # (the raylets' PullManager calls this on the owner).
        self.object_server.register(
            "object_locations",
            lambda ctx, oid_b: self._live_holder_addrs(oid_b))
        self.object_server_addr = self.object_server.address

        self.head_node_id = NodeID.from_random()
        self.add_node(self.head_node_id, driver_node_resources)

        self._sched_thread = threading.Thread(
            target=self._scheduling_loop, daemon=True, name="rtpu-sched")
        self._io_thread = threading.Thread(
            target=self._io_loop, daemon=True, name="rtpu-io")
        self._sched_thread.start()
        self._io_thread.start()

    def _wake_sched(self) -> None:
        """Hot-path wake: ``Event.is_set`` is lock-free, so redundant
        wakes (one per submission/completion in a wave) skip the event
        lock entirely."""
        w = self._wake
        if not w.is_set():
            w.set()

    # -- cluster membership ------------------------------------------------

    def add_node(self, node_id: NodeID, resources: NodeResources,
                 labels: Optional[dict] = None) -> Raylet:
        raylet = Raylet(node_id, resources, self._session, self.hub,
                        self._on_inproc_reply, self._wake.set, labels,
                        self._max_process_workers)
        with self._lock:
            self._raylets[node_id] = raylet
        self.cluster_resources.add_or_update_node(node_id, resources)
        with self._lock:
            # AFTER the ledger update: the scheduler treats a version
            # bump as "new capacity may exist" and requeues infeasible
            # tasks exactly once — bumping first would let it consume
            # the bump against the stale view and strand them.
            self._membership_version += 1
        from ray_tpu_torch._private import export
        export.emit("NODE", {"event": "ADDED", "node_id": node_id.hex(),
                             "resources": dict(resources.total)})
        self._wake.set()
        return raylet

    def remove_node(self, node_id: NodeID) -> None:
        """Simulate node death: fail running tasks, drop resources."""
        with self._lock:
            raylet = self._raylets.pop(node_id, None)
            self._cordoned.discard(node_id)
            if raylet is None:
                return
            raylet.alive = False
            dead_tasks = [tid for tid, rt in self._running.items()
                          if rt.node_id == node_id]
            # Tasks scheduled to this node but not yet leased go back to
            # the cluster queue for rescheduling elsewhere.
            requeue = list(raylet.dispatch_queue)
            raylet.dispatch_queue.clear()
            self._to_schedule.extend(requeue)
        # Return any bundle draws held by requeued PG tasks so the
        # rescheduling pass re-draws cleanly, then dissolve groups that
        # lost a bundle with the node (their gang guarantee is gone).
        if self.pg_manager is not None:
            for spec in requeue:
                pg = self._spec_pg(spec)
                if pg is not None:
                    self.pg_manager.free_to_bundle(pg[0], pg[1],
                                                   spec.resources)
            self.pg_manager.on_node_removed(node_id)
        self.cluster_resources.remove_node(node_id)
        for tid in dead_tasks:
            self._fail_running(tid, WorkerCrashedError(
                f"node {node_id.hex()[:8]} died"))
        raylet.worker_pool.shutdown()
        self._wake.set()

    def nodes(self) -> List[NodeID]:
        with self._lock:
            return list(self._raylets) + list(self._remote_nodes)

    # -- cordon (autoscaler drain-before-terminate) ------------------------

    def cordon_node(self, node_id: NodeID) -> bool:
        """No NEW leases on this node: flip its alive-mask bit in the
        resource ledger (policies + allocate already skip non-alive
        nodes) without touching running work. The version bump also
        releases fenced classes so their capacity bound re-derives
        WITHOUT the cordoned node."""
        if not self.cluster_resources.set_node_alive(node_id, False):
            return False
        with self._lock:
            self._cordoned.add(node_id)
        from ray_tpu_torch._private import export
        export.emit("NODE", {"event": "CORDONED",
                             "node_id": node_id.hex()})
        self._wake.set()
        return True

    def uncordon_node(self, node_id: NodeID) -> bool:
        """Reopen the node for placement (a drain that failed or was
        abandoned). Only nodes cordon_node marked are restored — a
        genuinely dead node's alive bit stays down."""
        with self._lock:
            if node_id not in self._cordoned:
                return False
            self._cordoned.discard(node_id)
        self.cluster_resources.set_node_alive(node_id, True)
        from ray_tpu_torch._private import export
        export.emit("NODE", {"event": "UNCORDONED",
                             "node_id": node_id.hex()})
        self._wake.set()
        return True

    def is_cordoned(self, node_id: NodeID) -> bool:
        with self._lock:
            return node_id in self._cordoned

    def actors_on_node(self, node_id: NodeID) -> List[ActorID]:
        """Actors currently hosted by this node (the drain worklist)."""
        with self._lock:
            return [aid for aid, entry in self._actor_workers.items()
                    if entry[0] == node_id]

    def running_tasks_on(self, node_id: NodeID) -> int:
        """In-flight leases on this node (drain waits for zero: a
        cordon stops NEW leases, running work finishes normally)."""
        with self._lock:
            n = sum(1 for rt in self._running.values()
                    if rt.node_id == node_id)
            raylet = self._raylets.get(node_id)
            if raylet is not None:
                n += len(raylet.dispatch_queue)
            return n

    # -- remote nodes (raylet processes) -----------------------------------

    def add_remote_node(self, node_id: NodeID, addr,
                        resources: NodeResources, proc=None
                        ) -> RemoteNodeHandle:
        handle = RemoteNodeHandle(self, node_id, addr, resources, proc)
        with self._lock:
            self._remote_nodes[node_id] = handle
        self.cluster_resources.add_or_update_node(node_id, resources)
        with self._lock:
            # after the ledger update — see add_node
            self._membership_version += 1
        from ray_tpu_torch._private import export
        export.emit("NODE", {"event": "ADDED", "node_id": node_id.hex(),
                             "resources": dict(resources.total)})
        self._wake.set()
        return handle

    def _serve_object_view(self, oid_bytes: bytes):
        oid = ObjectID(oid_bytes)
        view = self._shm_store.get_local(oid)
        if view is not None:
            return view
        if self._ensure_host_copy_cb is not None:
            info = self._ensure_host_copy_cb(oid)
            if info is not None:
                return self._shm_store.get_local(oid)
        return None

    def record_object_location(self, oid: ObjectID, node_id: NodeID) -> None:
        with self._lock:
            holders = self._object_locations.setdefault(oid, [])
            if node_id not in holders:
                holders.append(node_id)

    def _live_holder_addrs(self, oid_or_bytes) -> List[Tuple[str, int]]:
        """Transfer-plane addresses of every LIVE node holding a sealed
        copy of the object — the ``object_locations`` RPC reply and the
        re-route source list. The driver's own object server is
        included when its store holds (or can materialize) a copy."""
        oid = (oid_or_bytes if isinstance(oid_or_bytes, ObjectID)
               else ObjectID(oid_or_bytes))
        addrs: List[Tuple[str, int]] = []
        with self._lock:
            for node_id in self._object_locations.get(oid, ()):
                handle = self._remote_nodes.get(node_id)
                if handle is not None and handle.alive:
                    addrs.append(tuple(handle.addr))
        if self._shm_store.contains(oid):
            addrs.append(tuple(self.object_server_addr))
        return addrs

    def _pull_sources_for(self, oid: ObjectID,
                          dest_node: Optional[NodeID]
                          ) -> Optional[List[Tuple[str, int]]]:
        """Ordered source list for ``dest_node``'s pull of ``oid``:
        its broadcast-tree parent first (a peer consumer that streams
        chunks as it receives them), then the live sealed holders.
        None when no live holder exists (callers route into
        reconstruction). Parents are advisory — a dead or never-sealed
        parent degrades to the holders / owner re-route, never to a
        wrong result."""
        holders = self._live_holder_addrs(oid)
        if not holders:
            return None
        sources: List[Tuple[str, int]] = []
        if dest_node is not None:
            with self._lock:
                assigned = self._pull_assignments.setdefault(oid, [])
                try:
                    k = assigned.index(dest_node)
                except ValueError:
                    k = len(assigned)
                    assigned.append(dest_node)
                    # Advisory table hygiene: one entry per object
                    # under broadcast; cap total tracked objects.
                    if len(self._pull_assignments) > 1024:
                        self._pull_assignments.pop(
                            next(iter(self._pull_assignments)))
                if k > 0:
                    parent = assigned[(k - 1) // 2]
                    handle = self._remote_nodes.get(parent)
                    if handle is not None and handle.alive:
                        sources.append(tuple(handle.addr))
        for addr in holders:
            if addr not in sources:
                sources.append(addr)
        return sources

    def _preferred_node_for(self, spec) -> Optional[NodeID]:
        """Locality-aware placement hint: prefer the live node holding
        the largest remote object argument (above
        ``object_locality_min_bytes``) so the task's heaviest input
        never crosses the wire. Falls back to the head node — the
        pre-locality behavior — when args are inline, local, small, or
        unready."""
        min_bytes = get_config().object_locality_min_bytes
        best_node: Optional[NodeID] = None
        best_size = min_bytes - 1
        for arg in spec.args:
            if arg.object_id is None or arg.owner_addr is not None:
                continue
            try:
                entry = self._memory_store.get(arg.object_id, timeout=0)
            except TimeoutError:
                continue
            if entry.kind != "remote":
                continue
            loc_node, size = entry.data
            if size <= best_size:
                continue
            with self._lock:
                holders = [n for n in self._object_locations.get(
                               arg.object_id, (loc_node,))
                           if (h := self._remote_nodes.get(n)) is not None
                           and h.alive]
            if holders:
                best_node, best_size = holders[0], size
        return best_node if best_node is not None else self.head_node_id

    def fetch_remote_object(self, oid: ObjectID, node_id: NodeID,
                            size: int) -> Optional[bytes]:
        """Pull an object into the driver's store (via the PullManager:
        deduped, retried, re-routed) and return its bytes. None when no
        live node still serves it (callers route into lineage
        reconstruction)."""
        from ray_tpu_torch.exceptions import ObjectTransferError
        sources = self._live_holder_addrs(oid)
        with self._lock:
            handle = self._remote_nodes.get(node_id)
        if handle is not None and handle.alive \
                and tuple(handle.addr) not in sources:
            sources.insert(0, tuple(handle.addr))
        try:
            self.pull_manager.pull(oid.binary(), size, sources)
        except ObjectTransferError:
            return None
        view = self._shm_store.get_local(oid)
        return None if view is None else bytes(view)

    def _localize_remote_entry(self, oid: ObjectID, entry) -> bool:
        """Pull a remote-located object into the driver's store and
        rewrite its directory entry to a local shm entry. False when
        every holder is gone (callers route into reconstruction)."""
        from ray_tpu_torch.exceptions import ObjectTransferError
        loc_node, size = entry.data
        if not self._shm_store.contains(oid):
            sources = self._live_holder_addrs(oid)
            with self._lock:
                handle = self._remote_nodes.get(loc_node)
            if handle is not None and handle.alive \
                    and tuple(handle.addr) not in sources:
                sources.insert(0, tuple(handle.addr))
            try:
                self.pull_manager.pull(oid.binary(), size, sources)
            except ObjectTransferError:
                return False
        info = self._shm_store.segment_for(oid)
        if info is None:
            return False
        entry.kind = "shm"
        entry.data = info
        return True

    def _handle_remote_build_error(self, handle: RemoteNodeHandle,
                                   spec: TaskSpec, err) -> None:
        self._free_allocation(handle.node_id, spec.resources,
                              self._spec_pg(spec))
        if isinstance(err, _DependencyError):
            self._complete_task(spec.task_id, [], err.entry.data, None)
        elif isinstance(err, _LostArgError):
            recovered = (self._recover_object_cb(err.object_id)
                         if self._recover_object_cb else False)
            if recovered:
                self.submit_task(spec)
            elif self._fail_task_cb is not None:
                from ray_tpu_torch.exceptions import ObjectLostError
                self._fail_task_cb(spec, ObjectLostError(
                    f"argument {err.object_id} of {spec.repr_name()} "
                    "was lost and cannot be reconstructed"))
        else:
            self._complete_task(spec.task_id, [], None, err)

    # How long a dispatch parked on a full in-flight window waits
    # before rescheduling (flat — the window drains on completions,
    # unlike a shed, which signals a raylet-side backlog).
    _WINDOW_RETRY_S = 0.05

    # Dispatch-path reads of the in-flight counts tolerate this much
    # staleness: the window is flow control, not an invariant, and an
    # off-by-a-few for 20ms beats an O(running) rescan per task (the
    # pg-task and shed-redispatch paths dispatch one task at a time).
    _INFLIGHT_CACHE_TTL = 0.02

    def _remote_inflight_counts(self, max_age: float = _INFLIGHT_CACHE_TTL
                                ) -> Dict[NodeID, int]:
        """node -> submitted-but-uncompleted normal-task leases, ONE
        pass over _running (derived, so the counts can never drift),
        memoized for ``max_age`` seconds (0 = always fresh)."""
        now = time.monotonic()
        with self._lock:
            ts, counts = self._inflight_cache
            if now - ts <= max_age:
                return counts
            counts = {}
            for rt in self._running.values():
                if isinstance(rt.worker, _RemoteLease):
                    counts[rt.node_id] = counts.get(rt.node_id, 0) + 1
            self._inflight_cache = (now, counts)
            return counts

    def _remote_inflight(self, node_id: NodeID,
                         max_age: float = 0.0) -> int:
        return self._remote_inflight_counts(max_age).get(node_id, 0)

    def _window_room(self, handle: RemoteNodeHandle) -> Optional[int]:
        """Free in-flight-window slots on ``handle``; None = unlimited."""
        window = get_config().raylet_inflight_window
        if window <= 0:
            return None
        return max(0, window - self._remote_inflight(
            handle.node_id, max_age=self._INFLIGHT_CACHE_TTL))

    def _unwind_remote(self, handle: RemoteNodeHandle,
                       spec: TaskSpec) -> None:
        """Drop the (possibly not-yet-recorded) running record and
        return the scheduler allocation — the shared unwind of every
        not-actually-submitted remote path (requeue, shed, window).
        The memoized in-flight counts are invalidated with the pop:
        a whole lost submit_many frame unwinding N leases must not
        keep counting them against the window until the memo expires
        (the re-dispatch would double-count the lost frame)."""
        with self._lock:
            self._running.pop(spec.task_id, None)
            self._inflight_cache = (-1.0, {})
        self._free_allocation(handle.node_id, spec.resources,
                              self._spec_pg(spec))

    def _defer_spec(self, spec: TaskSpec, delay: float,
                    resubmit: bool = False) -> None:
        with self._lock:
            self._deferred.append(
                (time.monotonic() + max(0.0, delay), spec, resubmit))

    def _defer_shed(self, handle: RemoteNodeHandle, spec: TaskSpec,
                    hint_s: float = 0.0) -> None:
        """Honor a shed reply: unwind the submission and park the spec
        for a jittered, exponentially growing backoff (the raylet's
        depth-scaled ``hint_s`` winning when larger) — a saturated
        cluster costs latency, never results."""
        from ray_tpu_torch._private.backoff import jittered, next_backoff
        self._unwind_remote(handle, spec)
        cfg = get_config()
        nxt = next_backoff(
            getattr(spec, "_shed_backoff_s", 0.0),
            cfg.backpressure_retry_base_ms / 1000.0,
            cfg.backpressure_retry_max_ms / 1000.0,
            hint_s=hint_s)
        spec._shed_backoff_s = nxt  # type: ignore[attr-defined]
        with self._lock:
            self.num_shed += 1
            delay = jittered(nxt, self._shed_rng)
        self._defer_spec(spec, delay)

    def _defer_window(self, handle: RemoteNodeHandle,
                      spec: TaskSpec) -> None:
        self._unwind_remote(handle, spec)
        with self._lock:
            self.num_window_waits += 1
        self._defer_spec(spec, self._WINDOW_RETRY_S)

    def _pump_deferred(self) -> None:
        """Move due deferred specs back into scheduling (runs on the
        scheduling loop's tick)."""
        now = time.monotonic()
        due: List[Tuple[float, TaskSpec, bool]] = []
        with self._lock:
            if not self._deferred:
                return
            keep = []
            for item in self._deferred:
                (due if item[0] <= now else keep).append(item)
            self._deferred[:] = keep
        # Cancellation can land while a spec is parked (cancel_queued
        # scans _deferred, but a cancel racing this pump's pop would
        # miss): re-check the flag before re-entering scheduling.
        cancelled: List[TaskSpec] = []
        if self._cancelled_check is not None:
            live, cancelled = [], []
            for item in due:
                (cancelled if self._cancelled_check(item[1].task_id)
                 else live).append(item)
            due = live
        resubmits = [s for _t, s, r in due if r]
        schedule = [s for _t, s, r in due if not r]
        for spec in resubmits:
            # full resubmission (OOM retry): deps re-checked
            self.submit_task(spec)
        if schedule:
            # one acquisition for the whole wave, not one per spec
            with self._lock:
                self._to_schedule.extend(schedule)
        for item in cancelled:
            from ray_tpu_torch.exceptions import TaskCancelledError
            spec = item[1]
            self._complete_task(spec.task_id, [], None,
                                TaskCancelledError(
                                    f"task {spec.repr_name()} was "
                                    "cancelled"))
        if due or cancelled:
            self._wake.set()

    def submit_task_after(self, spec: TaskSpec, delay: float) -> None:
        """Submit ``spec`` after ``delay`` seconds (the OOM retry's
        exponential backoff rides this)."""
        self._defer_spec(spec, delay, resubmit=True)

    def _dispatch_remote_batch(self, handle: RemoteNodeHandle,
                               specs: List[TaskSpec]) -> None:
        """One lease RPC for N tasks bound for the same raylet (the
        submit half of the remote wire path; statuses come back per
        payload so spillback refusals stay per-task)."""
        room = self._window_room(handle)
        if room is not None and len(specs) > room:
            # Capped in-flight submission window: the overflow waits
            # briefly instead of piling onto an already-loaded raylet.
            for spec in specs[room:]:
                self._defer_window(handle, spec)
            specs = specs[:room]
            if not specs:
                return
        if len(specs) == 1:
            # window already checked above — don't rescan _running
            self._dispatch_remote(handle, specs[0],
                                  window_checked=True)
            return
        sendable: List[Tuple[TaskSpec, dict]] = []
        batch_shipped: set = set()
        for spec in specs:
            payload, err = self._build_remote_payload(
                handle, spec, batch_shipped=batch_shipped)
            if err is not None:
                self._handle_remote_build_error(handle, spec, err)
                continue
            sendable.append((spec, payload))
        if not sendable:
            return
        with self._lock:
            for spec, _p in sendable:
                self._running[spec.task_id] = RunningTask(
                    spec, handle.node_id, _RemoteLease(handle),
                    dict(spec.resources), pg=self._spec_pg(spec))
            # new leases recorded: the memoized in-flight counts are
            # stale NOW, not in 20ms — without this, back-to-back
            # wake-driven ticks could overshoot the window by a full
            # batch per tick
            self._inflight_cache = (-1.0, {})
        # Timeout scales with the frame: the single-lease bound is
        # sized for one payload, and an N-task frame's transfer time
        # grows with N — timing out a frame the raylet already
        # admitted would duplicate-execute every task in it.
        lease_timeout = (get_config().worker_lease_timeout_ms / 1000.0
                         + 0.05 * len(sendable))
        try:
            statuses = handle.client.call(
                "submit_many", [p for _s, p in sendable],
                timeout=lease_timeout)
            self.wire_stats.channel("lease_rpc").record(len(sendable))
        except Exception:
            statuses = None
        if (not isinstance(statuses, list)
                or len(statuses) != len(sendable)):
            # whole frame lost (or a malformed reply — treat the same
            # rather than zip-truncating and stranding the tail in
            # _running with its allocations held): reschedule all
            for spec, _p in sendable:
                self._requeue_remote(handle, spec)
            self._wake.set()
            return
        from ray_tpu_torch._private import events
        requeued = False
        accepted: List[dict] = []
        ev_on = events.active()
        for (spec, payload), status in zip(sendable, statuses):
            if status == "refused":
                self._requeue_remote(handle, spec)
                requeued = True
            elif status == "shed" or (
                    isinstance(status, (list, tuple)) and status
                    and status[0] == "shed"):
                # bounded intake full: retry after a jittered backoff,
                # honoring the raylet's depth-scaled suggestion when
                # the frame carries one
                self._defer_shed(
                    handle, spec,
                    hint_s=(float(status[1])
                            if isinstance(status, (list, tuple))
                            and len(status) > 1 else 0.0))
            else:
                accepted.append(payload)
                # admitted: a LATER shed (e.g. after a crash retry)
                # starts its backoff from base again, not the stale cap
                spec._shed_backoff_s = 0.0  # type: ignore[attr-defined]
                if ev_on:
                    events.record(
                        spec.task_id.hex(), spec.repr_name(), "RUNNING",
                        worker=f"node:{handle.node_id.hex()[:8]}")
        self._record_shipped_functions(handle, accepted)
        if requeued:
            self._wake.set()

    def _requeue_remote(self, handle: RemoteNodeHandle,
                        spec: TaskSpec) -> None:
        """Unwind one remote submission (frame lost / spillback
        refusal): drop the running record, return the allocation,
        requeue for scheduling."""
        self._unwind_remote(handle, spec)
        with self._lock:
            self._to_schedule.append(spec)

    def _dispatch_remote(self, handle: RemoteNodeHandle, spec: TaskSpec,
                         window_checked: bool = False) -> None:
        """Ship a scheduled task to a remote raylet (lease+exec).
        ``window_checked``: the caller already ran the in-flight-window
        check for this dispatch (the batch path) — skip the rescan."""
        if not window_checked:
            room = self._window_room(handle)
            if room is not None and room <= 0:
                self._defer_window(handle, spec)
                return
        payload, err = self._build_remote_payload(handle, spec)
        if err is not None:
            self._handle_remote_build_error(handle, spec, err)
            return
        with self._lock:
            self._running[spec.task_id] = RunningTask(
                spec, handle.node_id, _RemoteLease(handle),
                dict(spec.resources), pg=self._spec_pg(spec))
            self._inflight_cache = (-1.0, {})   # see batch path
        lease_timeout = get_config().worker_lease_timeout_ms / 1000.0
        try:
            status = handle.client.call("submit", payload,
                                        timeout=lease_timeout)
        except BackpressureError as e:
            # typed shed (RESOURCE_EXHAUSTED frame): honor the backoff
            self._defer_shed(handle, spec, hint_s=e.backoff_s)
            return
        except Exception:
            self._requeue_remote(handle, spec)
            self._wake.set()
            return
        if status == "refused":
            # Spillback: the raylet's authoritative view says this can
            # never fit; reschedule elsewhere.
            self._requeue_remote(handle, spec)
            self._wake.set()
            return
        self._record_shipped_functions(handle, [payload])
        spec._shed_backoff_s = 0.0  # type: ignore[attr-defined]
        from ray_tpu_torch._private import events
        events.record(spec.task_id.hex(), spec.repr_name(), "RUNNING",
                      worker=f"node:{handle.node_id.hex()[:8]}")

    def _build_remote_payload(self, handle: RemoteNodeHandle,
                              spec: TaskSpec,
                              batch_shipped: Optional[set] = None):
        """Args for a remote node: inline values travel as bytes;
        object args travel as ("pull", oid, sources, size) — sources
        is the ordered transfer-plane address list (broadcast-tree
        parent first, then sealed holders; docs/object_plane.md) the
        raylet's PullManager fetches through.
        ``batch_shipped``: fids whose blob an earlier payload of the
        SAME submit_many frame already carries — one copy per frame,
        not one per task (the raylet caches it pre-admission)."""
        arg_descs = []
        for arg in spec.args:
            if arg.object_id is None:
                arg_descs.append(("v", arg.inline_blob))
                continue
            if arg.owner_addr is not None:
                # Worker-owned: the executing worker fetches from the
                # owner directly — the driver never touches the bytes.
                arg_descs.append(("owned", arg.object_id.binary(),
                                  tuple(arg.owner_addr)))
                continue
            oid = arg.object_id
            try:
                entry = self._memory_store.get(oid, timeout=0)
            except TimeoutError:
                return None, _LostArgError(oid)
            if entry.kind == "err":
                return None, _DependencyError(entry)
            if entry.kind == "blob":
                arg_descs.append(("v", entry.data))
                continue
            if entry.kind == "device":
                info = (self._ensure_host_copy_cb(oid)
                        if self._ensure_host_copy_cb else None)
                if info is None:
                    return None, _LostArgError(oid)
                arg_descs.append(("pull", oid.binary(),
                                  (tuple(self.object_server_addr),),
                                  info[1]))
                continue
            if entry.kind == "remote":
                loc_node, size = entry.data
                sources = self._pull_sources_for(oid, handle.node_id)
                if sources is None:
                    return None, _LostArgError(oid)
                arg_descs.append(("pull", oid.binary(), tuple(sources),
                                  size))
                continue
            # shm in the driver store
            info = self._shm_store.segment_for(oid)
            if info is None:
                return None, _LostArgError(oid)
            arg_descs.append(("pull", oid.binary(),
                              (tuple(self.object_server_addr),),
                              info[1]))
        payload = {
            "type": ("create_actor"
                     if spec.task_type == TaskType.ACTOR_CREATION_TASK
                     else "exec"),
            "task_id": spec.task_id.binary(),
            "function_id": spec.function.function_id,
            "args": arg_descs,
            "kwargs_keys": spec.kwargs_keys,
            "num_returns": spec.num_returns,
            "return_ids": [o.binary() for o in spec.return_ids],
            "name": spec.repr_name(),
            "runtime_env": spec.runtime_env,
            "owner_addr": self.object_server_addr,
            "streaming": spec.streaming,
            "stream_skip": spec.stream_skip,
            "resources": dict(spec.resources),
            # The memory watchdog prefers retryable victims; a task the
            # owner would not retry should only die under pressure when
            # nothing retryable is running (reference: memory-monitor
            # victim selection by retriability).
            "retryable": spec.max_retries > 0,
        }
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            payload["actor_id"] = spec.actor_creation_id.binary()
            payload["max_concurrency"] = spec.max_concurrency
            payload["checkpoint_interval"] = spec.checkpoint_interval
            if spec.lifetime == "detached":
                # The raylet must keep this actor when our connection
                # goes away (detached lifetime).
                payload["detached"] = True
        fid = spec.function.function_id
        if fid not in handle.known_functions \
                and (batch_shipped is None or fid not in batch_shipped):
            payload["function_blob"] = self._function_blob(fid)
            if batch_shipped is not None:
                batch_shipped.add(fid)
            # NOT recorded in handle.known_functions here: the submit
            # outcome is unknown — recording before a refusal/timeout
            # would strip the blob from the task's re-send and every
            # later task on this raylet, which then fails "unknown
            # function". Callers record via _record_shipped_functions
            # after a non-refused ok status.
        return payload, None

    @staticmethod
    def _record_shipped_functions(handle: RemoteNodeHandle,
                                  accepted: List[dict]) -> None:
        """The raylet admitted these payloads: their function blobs
        are now cached there, so later payloads may omit them."""
        for payload in accepted:
            if "function_blob" in payload:
                handle.known_functions.add(payload["function_id"])

    # -- remote completion routing -----------------------------------------

    def _on_remote_push(self, handle: RemoteNodeHandle, topic: str,
                        payload) -> None:
        if topic == "task_stream":
            results = []
            for oid_b, kind, data, contained in payload.get("results", ()):
                if kind == "remote":
                    oid = ObjectID(oid_b)
                    self.record_object_location(oid, handle.node_id)
                    results.append((oid_b, "remote",
                                    (handle.node_id, data), contained))
                else:
                    results.append((oid_b, kind, data, contained))
            if self._stream_item_cb is not None:
                self._stream_item_cb(TaskID(payload["task_id"]), results)
        elif topic == "task_done":
            self._complete_remote_task(handle, payload)
        elif topic == "task_done_many":
            # Coalesced completion frame (docs/data_plane.md): the
            # payload list preserves the raylet's completion order, so
            # per-caller ordering is exactly the unbatched behavior.
            for done in payload:
                self._complete_remote_task(handle, done)
        elif topic == "actor_ready":
            self._remote_actor_ready(handle, payload)
        elif topic == "actor_died":
            self._remote_actor_died(handle, payload)
        elif topic == "actor_ckpt":
            if self._actor_ckpt_cb is not None:
                self._actor_ckpt_cb(ActorID(payload["actor_id"]),
                                    payload["info"])

    def _complete_remote_task(self, handle: RemoteNodeHandle,
                              msg: dict) -> None:
        task_id = TaskID(msg["task_id"])
        with self._lock:
            rt = self._running.pop(task_id, None)
        if rt is None:
            return
        is_actor_task = rt.spec.task_type == TaskType.ACTOR_TASK
        if not is_actor_task:
            self._free_allocation(rt.node_id, rt.resources, rt.pg)
            self._wake.set()
        lost_arg = msg.get("lost_arg")
        if lost_arg is not None and self._recover_object_cb is not None:
            if self._recover_object_cb(ObjectID(lost_arg)):
                self.submit_task(rt.spec)
                return
        sys_err = None
        if msg.get("system_error"):
            if msg.get("oom"):
                # memory-watchdog kill: typed, with the task's own
                # retriability — routed through the OOM retry budget
                sys_err = OutOfMemoryError(
                    msg["system_error"],
                    retryable=bool(msg.get("oom_retryable", True)))
            else:
                sys_err = WorkerCrashedError(msg["system_error"])
        results = []
        for oid_b, kind, data, contained in msg.get("results", ()):
            if kind == "remote":
                oid = ObjectID(oid_b)
                self.record_object_location(oid, handle.node_id)
                results.append((oid_b, "remote", (handle.node_id, data),
                                contained))
            else:
                results.append((oid_b, kind, data, contained))
        self._complete_task(task_id, results, msg.get("error_blob"),
                            sys_err, msg.get("timings"))

    def _remote_actor_ready(self, handle: RemoteNodeHandle,
                            msg: dict) -> None:
        actor_id_b = msg["actor_id"]
        err_blob = msg.get("error_blob")
        task_id = None
        with self._lock:
            for tid, rt in self._running.items():
                if (rt.spec.task_type == TaskType.ACTOR_CREATION_TASK
                        and rt.spec.actor_creation_id.binary() == actor_id_b):
                    task_id = tid
                    break
            rt = self._running.pop(task_id, None) if task_id else None
        if rt is None:
            return
        if err_blob is not None:
            self._free_allocation(rt.node_id, rt.resources, rt.pg)
            self._complete_task(task_id, [], err_blob, None)
        else:
            restore = msg.get("restore")
            if restore is not None and self._actor_restore_cb is not None:
                self._actor_restore_cb(ActorID(actor_id_b), restore)
            self.register_actor_worker(
                ActorID(actor_id_b), rt.node_id,
                RemoteActorWorker(handle, actor_id_b), rt.resources,
                pg=rt.pg)
            self._complete_task(task_id, [], None, None)

    def _remote_actor_died(self, handle: RemoteNodeHandle,
                           msg: dict) -> None:
        actor_id = ActorID(msg["actor_id"])
        with self._lock:
            entry = self._actor_workers.pop(actor_id, None)
        if entry is not None:
            nid, _w, res, pg = entry
            self._free_allocation(nid, res, pg)
            if self._actor_death_cb is not None:
                self._actor_death_cb(actor_id)
        self._wake.set()

    def _on_remote_node_lost(self, node_id: NodeID) -> None:
        """A raylet process died (connection lost or GCS health). Fail
        its running tasks (they retry on survivors); its objects stay
        recorded and reconstruct lazily on access."""
        from ray_tpu_torch._private import export
        export.emit("NODE", {"event": "REMOVED",
                             "node_id": node_id.hex()})
        with self._lock:
            handle = self._remote_nodes.pop(node_id, None)
            if handle is None:
                return
            handle.alive = False
            dead_tasks = [tid for tid, rt in self._running.items()
                          if rt.node_id == node_id]
            dead_actors = [aid for aid, (nid, _w, _r, _p)
                           in self._actor_workers.items() if nid == node_id]
        logger.warning("remote node %s lost; failing %d running tasks",
                       node_id.hex()[:8], len(dead_tasks))
        if self.pg_manager is not None:
            self.pg_manager.on_node_removed(node_id)
        self.cluster_resources.remove_node(node_id)
        for tid in dead_tasks:
            self._fail_running(tid, WorkerCrashedError(
                f"node {node_id.hex()[:8]} died"))
        for aid in dead_actors:
            with self._lock:
                entry = self._actor_workers.pop(aid, None)
            if entry is not None and self._actor_death_cb is not None:
                self._actor_death_cb(aid)
        try:
            handle.client.close()
        except Exception:
            pass    # connection already torn down
        self._wake.set()

    def remove_remote_node(self, node_id: NodeID, kill_process: bool = True
                           ) -> None:
        with self._lock:
            handle = self._remote_nodes.get(node_id)
        if handle is None:
            return
        proc = handle.proc
        self._on_remote_node_lost(node_id)
        if kill_process and proc is not None:
            try:
                proc.terminate()
            except Exception:
                pass    # process already exited

    # -- submission --------------------------------------------------------

    def submit_task(self, spec: TaskSpec) -> None:
        deps = spec.dependencies()
        # dep-free fast path: skip the dependency manager's lock — the
        # overwhelming share of hot-path submissions carry no refs
        ready = not deps or self.dependency_manager.add_task(
            spec.task_id, deps, self._object_available)
        with self._lock:
            if ready:
                self._to_schedule.append(spec)
            else:
                self._waiting[spec.task_id] = spec
        self._wake_sched()

    def _object_available(self, oid: ObjectID) -> bool:
        return self._memory_store.contains(oid)

    def on_object_available(self, object_id: ObjectID) -> None:
        ready = self.dependency_manager.on_object_available(object_id)
        if not ready:
            return
        with self._lock:
            for tid in ready:
                spec = self._waiting.pop(tid, None)
                if spec is not None:
                    self._to_schedule.append(spec)
        self._wake_sched()

    # -- actor task routing ------------------------------------------------

    def _spec_pg(self, spec: TaskSpec):
        if spec.placement_group_id is not None:
            return (spec.placement_group_id,
                    spec.placement_group_bundle_index)
        return None

    def register_actor_worker(self, actor_id: ActorID, node_id: NodeID,
                              worker: BaseWorker, resources: dict,
                              pg=None, creation_spec=None) -> None:
        with self._lock:
            self._actor_workers[actor_id] = (node_id, worker, resources, pg)
        if creation_spec is not None and isinstance(worker, ProcessWorker):
            # Hot wire path: ship the constant half of every method-call
            # payload once; per-call frames then carry only the varying
            # fields ("atmpl" marker, see worker_process.merge_actor).
            # Pipe FIFO ordering guarantees the template lands before
            # any call that references it. Re-sent on restart (fresh
            # worker). In-process workers skip this — their payloads
            # are never pickled, so stripping saves nothing.
            tmpl = {
                "type": "exec_actor",
                "actor_id": actor_id.binary(),
                "function_id": creation_spec.function.function_id,
                "owner_addr": self.object_server_addr,
                "kwargs_keys": [],
                "num_returns": 1,
                "runtime_env": None,
                "cls": creation_spec.name or "Actor",
            }
            try:
                worker.send(("actor_tmpl", actor_id.binary(), tmpl))
                worker.actor_tmpl = actor_id.binary()
            except Exception:
                pass    # template is an optimization: calls still
                        # work untemplated if the send raced a death

    def set_actor_death_callback(self, cb: Callable) -> None:
        self._actor_death_cb = cb

    def actor_worker(self, actor_id: ActorID) -> Optional[BaseWorker]:
        with self._lock:
            entry = self._actor_workers.get(actor_id)
            return entry[1] if entry else None

    def cancel_actor_call(self, actor_id: ActorID,
                          task_id: TaskID) -> bool:
        """Route an async-actor call cancellation to the actor's
        worker (asyncio cancellation on its event loop)."""
        worker = self.actor_worker(actor_id)
        if worker is None:
            return False
        try:
            if isinstance(worker, RemoteActorWorker):
                worker.handle.client.call(
                    "cancel_actor_task", actor_id.binary(),
                    task_id.binary(), timeout=5)
            else:
                worker.send(("cancel_actor_task", actor_id.binary(),
                             task_id.binary()))
            return True
        except Exception:
            return False

    def actor_node(self, actor_id: ActorID) -> Optional[NodeID]:
        with self._lock:
            entry = self._actor_workers.get(actor_id)
            return entry[0] if entry else None

    def pick_remote_node(self, demand: Dict[str, float]
                         ) -> Optional[NodeID]:
        """An alive remote raylet that fits ``demand`` (detached-actor
        placement: anything but the driver-local raylets). Nodes with
        the capacity FREE beat merely-feasible (busy) ones; the busy
        fallback pairs with hard affinity — the creation queues until
        the node frees rather than degrading to a local raylet."""
        best, best_key = None, (-1, -1.0)
        with self._lock:
            remotes = {nid: h for nid, h in self._remote_nodes.items()
                       if h.alive}
        for nid in remotes:
            node = self.cluster_resources.get_node(nid)
            if node is None or not node.is_feasible(demand):
                continue
            key = (1 if node.is_available(demand) else 0,
                   node.available.get("CPU", 0.0))
            if key > best_key:
                best, best_key = nid, key
        return best

    def ensure_remote_actor_route(self, actor_id: ActorID,
                                  node_id: NodeID) -> bool:
        """Route calls for an actor THIS driver did not create (a
        detached actor found via the GCS): register a RemoteActorWorker
        over the hosting raylet's channel. Returns False when that
        raylet is not attached/alive."""
        with self._lock:
            if actor_id in self._actor_workers:
                return True
            handle = self._remote_nodes.get(node_id)
        if handle is None or not handle.alive:
            return False
        self.register_actor_worker(
            actor_id, node_id,
            RemoteActorWorker(handle, actor_id.binary()), {})
        return True

    def worker_core_addr(self, actor_id: ActorID,
                         timeout: float = 30.0):
        """Owner-core (host, port) of the process executing this actor —
        the pre-bound endpoint compiled DAGs use for stage handoffs.
        Returns None for actors on remote raylet nodes (compiled DAGs
        fall back to the replay path there)."""
        from ray_tpu_torch._private.worker_pool import (InProcessWorker,
                                                  ProcessWorker)
        with self._lock:
            entry = self._actor_workers.get(actor_id)
        if entry is None:
            return None
        worker = entry[1]
        if isinstance(worker, InProcessWorker):
            # In-process actors share the driver process; their owner
            # core is this process's singleton.
            from ray_tpu_torch._private import worker_core
            return worker_core.get_worker_core().address
        if not isinstance(worker, ProcessWorker):
            return None
        addr = getattr(worker, "core_addr", None)
        if addr is not None:
            return addr
        with self._lock:
            # Under the lock: two concurrent compiles must share ONE
            # event or the loser waits on an orphan until timeout.
            evt = getattr(worker, "_core_addr_evt", None)
            if evt is None:
                evt = worker._core_addr_evt = threading.Event()
        worker.send(("core_addr",))
        if not evt.wait(timeout):
            raise TimeoutError(
                "worker did not report its owner-core address")
        return worker.core_addr

    def submit_actor_task(self, actor_id: ActorID, spec: TaskSpec,
                          payload: dict) -> bool:
        return self.submit_actor_task_batch(actor_id,
                                            [(spec, payload)]) == 1

    def submit_actor_task_batch(self, actor_id: ActorID,
                                items: List[Tuple[TaskSpec, dict]]) -> int:
        """Submit N ORDERED actor calls in one wire frame (the batched
        half of the actor hot path). Returns the number submitted from
        the front of ``items`` — 0 when the worker is dead/missing,
        partial when an argument rewrite fails mid-batch; the caller
        requeues the remainder IN ORDER."""
        from ray_tpu_torch._private import events
        with self._lock:
            entry = self._actor_workers.get(actor_id)
            if entry is None or not entry[1].alive:
                return 0
            node_id, worker, _res, _pg = entry
        if isinstance(worker, RemoteActorWorker):
            handle = worker.handle
            sendable = []
            for spec, payload in items:
                if not self._rewrite_actor_args_for_remote(handle,
                                                           payload):
                    break
                sendable.append((spec, dict(payload, resources={})))
            if not sendable:
                return 0
            with self._lock:
                for spec, _p in sendable:
                    self._running[spec.task_id] = RunningTask(
                        spec, node_id, worker, {})
            try:
                handle.client.call(
                    "submit_batch", [p for _s, p in sendable],
                    timeout=get_config().worker_lease_timeout_ms / 1000.0)
                self.wire_stats.channel("lease_rpc").record(len(sendable))
            except Exception:
                with self._lock:
                    for spec, _p in sendable:
                        self._running.pop(spec.task_id, None)
                return 0
            if events.active():
                wname = f"node:{handle.node_id.hex()[:8]}"
                for spec, _p in sendable:
                    events.record(spec.task_id.hex(), spec.repr_name(),
                                  "RUNNING", worker=wname)
            return len(sendable)
        sendable = []
        for spec, payload in items:
            if not self._rewrite_actor_args_for_local(payload):
                break
            sendable.append((spec, payload))
        if not sendable:
            return 0
        tmpl_aid = getattr(worker, "actor_tmpl", None)
        if tmpl_aid is not None:
            # compiled-DAG stage payloads carry their own template
            # (stage_key) and a different shape — never strip those
            wire = [p if "stage_key" in p
                    else self._strip_actor_payload(p, tmpl_aid)
                    for _s, p in sendable]
        else:
            wire = [p for _s, p in sendable]
        with self._lock:
            for spec, _p in sendable:
                self._running[spec.task_id] = RunningTask(
                    spec, node_id, worker, {})
        try:
            worker.send(("exec_actor_batch", wire))
            self.wire_stats.channel("worker_pipe").record(len(wire))
        except Exception:
            with self._lock:
                for spec, _p in sendable:
                    self._running.pop(spec.task_id, None)
            return 0
        if events.active():
            wname = worker.worker_id.hex()[:8]
            for spec, _p in sendable:
                events.record(spec.task_id.hex(), spec.repr_name(),
                              "RUNNING", worker=wname)
        return len(sendable)

    @staticmethod
    def _strip_actor_payload(payload: dict, tmpl_aid: bytes) -> dict:
        """Drop the template-covered constants from a method-call
        payload before pickling it onto the pipe (the worker merges
        them back from its registered template)."""
        out = {
            "atmpl": tmpl_aid,
            "task_id": payload["task_id"],
            "method": payload["method"],
            "args": payload["args"],
            "return_ids": payload["return_ids"],
        }
        if payload.get("seq"):
            # checkpoint cursor input: varies per call, never templated
            out["seq"] = payload["seq"]
        if payload.get("kwargs_keys"):
            out["kwargs_keys"] = payload["kwargs_keys"]
        if payload.get("num_returns", 1) != 1:
            out["num_returns"] = payload["num_returns"]
        if payload.get("streaming"):
            out["streaming"] = True
            if payload.get("stream_skip"):
                out["stream_skip"] = payload["stream_skip"]
        if payload.get("publish"):
            out["publish"] = payload["publish"]
        if payload.get("runtime_env"):
            out["runtime_env"] = payload["runtime_env"]
        return out

    def _rewrite_actor_args_for_local(self, payload: dict) -> bool:
        """Localize remote-located args for an actor on a driver-process
        (logical) node. False => caller requeues the task."""
        for i, desc in enumerate(payload["args"]):
            if desc[0] != "remote":
                continue
            oid = ObjectID(desc[1])
            try:
                entry = self._memory_store.get(oid, timeout=0)
            except TimeoutError:
                return False
            if entry.kind == "remote":
                if not self._localize_remote_entry(oid, entry):
                    if self._recover_object_cb is not None:
                        self._recover_object_cb(oid)
                    return False
            if entry.kind != "shm":
                return False
            name, size = entry.data
            payload["args"][i] = ("shm", desc[1], name, size)
        return True

    def _rewrite_actor_args_for_remote(self, handle: "RemoteNodeHandle",
                                       payload: dict) -> bool:
        """Turn owner-store descriptors into pull descriptors for a
        remote actor's raylet. False => caller requeues the task."""
        for i, desc in enumerate(payload["args"]):
            if desc[0] == "shm":
                _, oid_b, _name, size = desc
                payload["args"][i] = ("pull", oid_b,
                                      (tuple(self.object_server_addr),),
                                      size)
            elif desc[0] == "remote":
                _, oid_b, _node, size = desc
                sources = self._pull_sources_for(ObjectID(oid_b),
                                                 handle.node_id)
                if sources is None:
                    if self._recover_object_cb is not None:
                        self._recover_object_cb(ObjectID(oid_b))
                    return False
                payload["args"][i] = ("pull", oid_b, tuple(sources),
                                      size)
        return True

    def cancel_queued(self, task_id: TaskID) -> bool:
        """Remove a not-yet-running task from every queue it could sit
        in (cluster queue, dep-wait, infeasible, per-raylet dispatch).
        True if it was found and removed.

        Accounting: only DISPATCH-queue specs hold anything — the
        scheduler allocated node capacity (or drew from a PG bundle)
        right before queueing them, so exactly those are freed here.
        Specs still in _to_schedule/_waiting/_infeasible have drawn
        nothing yet."""
        spec = None
        dispatch_node: Optional[NodeID] = None
        with self._lock:
            for q_spec in list(self._to_schedule):
                if q_spec.task_id == task_id:
                    self._to_schedule.remove(q_spec)
                    spec = q_spec
                    break
            if spec is None:
                spec = self._waiting.pop(task_id, None)
                if spec is not None:
                    self.dependency_manager.cancel_task(task_id)
            if spec is None:
                spec = self._infeasible.pop(task_id, None)
            if spec is None:
                # parked in the unplaceable (capacity-fence) ledger:
                # holds no allocation, removal is the cancellation
                for key, entry in list(self._unplaceable.items()):
                    for q_spec in entry.specs:
                        if q_spec.task_id == task_id:
                            entry.specs.remove(q_spec)
                            entry.error.pending = len(entry.specs)
                            if not entry.specs:
                                del self._unplaceable[key]
                            spec = q_spec
                            break
                    if spec is not None:
                        break
            if spec is None:
                # parked in the overload plane's deferred queue (shed
                # backoff / OOM retry): it holds no allocation, so
                # removal is the whole cancellation
                for item in list(self._deferred):
                    if item[1].task_id == task_id:
                        self._deferred.remove(item)
                        spec = item[1]
                        break
            if spec is None:
                for node_id, raylet in self._raylets.items():
                    for q_spec in list(raylet.dispatch_queue):
                        if q_spec.task_id == task_id:
                            raylet.dispatch_queue.remove(q_spec)
                            spec = q_spec
                            dispatch_node = node_id
                            break
                    if spec is not None:
                        break
        if spec is None:
            return False
        if dispatch_node is not None:
            # free what the scheduler reserved: the PG bundle draw when
            # bound to one, else the node allocation
            try:
                self._free_allocation(dispatch_node,
                                      dict(spec.resources),
                                      self._spec_pg(spec))
            except Exception:
                logger.exception("cancel allocation free failed")
        self._wake.set()
        return True

    def interrupt_running(self, task_id: TaskID, force: bool) -> bool:
        """Best-effort interruption of a RUNNING task: SIGINT the
        process worker (KeyboardInterrupt lands in the executing user
        code; the worker survives), or kill it outright with
        ``force``. In-process (thread) workers cannot be interrupted.
        True if a signal/kill was delivered."""
        import os as _os
        import signal as _signal
        with self._lock:
            rt = self._running.get(task_id)
        if rt is None:
            return False
        worker = rt.worker
        if isinstance(worker, RemoteActorWorker):
            return False
        if isinstance(worker, _RemoteLease):
            # forward to the remote raylet owning the execution
            try:
                worker.handle.client.oneway(
                    "cancel_task", task_id.binary(), force)
                return True
            except Exception:
                return False
        pid = getattr(getattr(worker, "proc", None), "pid", None)
        if pid is None:
            return False            # in-process thread: uninterruptible
        try:
            if force:
                worker.kill()
                # kill() closed the worker's connection and marked it
                # dead, so the IO loop may never see its EOF: run the
                # death path here (a second run finds nothing to do)
                with self._lock:
                    raylet = self._raylets.get(rt.node_id)
                if raylet is not None:
                    self._on_worker_death(raylet, worker)
            else:
                # record the target FIRST: the worker's SIGINT handler
                # drops signals aimed at a task it is no longer running
                from ray_tpu_torch._private.worker_process import (
                    write_cancel_target)
                write_cancel_target(self._session, pid,
                                    task_id.binary())
                _os.kill(pid, _signal.SIGINT)
            return True
        except Exception:
            return False

    def release_actor(self, actor_id: ActorID, kill_worker: bool = True
                      ) -> None:
        with self._lock:
            entry = self._actor_workers.pop(actor_id, None)
        if entry is None:
            return
        node_id, worker, resources, pg = entry
        if kill_worker:
            # Calls already in flight on the worker die with the actor:
            # fail them with the actor-death error (not a generic
            # worker-crash) so callers see the kill for what it was.
            from ray_tpu_torch.exceptions import ActorDiedError
            with self._lock:
                dead = [tid for tid, rt in self._running.items()
                        if rt.worker is worker
                        and rt.spec.task_type == TaskType.ACTOR_TASK]
            for tid in dead:
                self._fail_running(tid, ActorDiedError(
                    "actor was killed while this call was in flight"))
            worker.send(("shutdown",))
            worker.kill()
            with self._lock:
                raylet = self._raylets.get(node_id)
            if raylet is not None:
                raylet.worker_pool.remove_worker(worker)
        self._free_allocation(node_id, resources, pg)
        self._wake.set()

    # -- scheduling loop ---------------------------------------------------

    def _scheduling_loop(self) -> None:
        cfg = get_config()
        batch_limit = cfg.tpu_scheduler_batch_size
        seen_membership = -1
        last_moved = 0          # specs the previous tick scheduled
        # no-deadline: daemon scheduler loop, exits via _shutdown; the
        # wake wait is time-bounded and the coalescing sleep is one
        # bounded flush window, never a poll-until-condition
        while not self._shutdown:
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            if self._shutdown:
                # the wake that ended the wait was shutdown's — don't
                # run (and possibly jit-compile in) one more body
                break
            try:
                # Submit coalescing (data-plane fast path, layer 1):
                # while the submission stream is BURSTING — the
                # previous tick moved a real batch — wait a short
                # flush window so this tick's sendables leave as one
                # policy batch / one frame per destination instead of
                # a frame per task. A quiet stream (previous tick
                # moved a task or two) never waits, so serial
                # round-trip latency is untouched.
                coalesce_s = cfg.submit_coalesce_ms / 1000.0
                coalesce_max = cfg.submit_coalesce_max
                if coalesce_s > 0 and last_moved >= 4:
                    with self._lock:
                        depth = len(self._to_schedule)
                    if 0 < depth < coalesce_max:
                        time.sleep(coalesce_s)
                        self._wake.clear()
                # Membership changed since tasks were parked infeasible:
                # a new node may satisfy them now.
                if self._membership_version != seen_membership:
                    seen_membership = self._membership_version
                    with self._lock:
                        if self._infeasible:
                            self._to_schedule.extend(
                                self._infeasible.values())
                            self._infeasible.clear()
                if self.pg_manager is not None:
                    self.pg_manager.try_schedule_pending()
                # shed/OOM'd specs whose backoff expired rejoin here
                self._pump_deferred()
                # capacity-fenced classes rejoin only after the
                # cluster ledger moved (docs/scheduler.md): a static
                # tick never rescans them
                self._release_unplaceable()
                # Cap the batch at roughly what can place right now:
                # at queue depth, re-scanning the ENTIRE backlog on
                # every capacity change made each tick O(backlog) in
                # the policy — the dominant cost of the normal-task
                # path (tasks beyond free capacity just bounced back).
                last_moved = self._schedule_once(
                    min(batch_limit, self._free_slot_estimate()))
                self._dispatch_all()
                self._rescue_stalled_pipelines()
            except Exception:
                logger.exception("scheduling loop error")

    def cancel_pipelined(self, task_id: TaskID,
                         force: bool = False) -> bool:
        """Cancel a task queued on a busy worker's pipe (lease
        pipelining): it is in ``_running`` (so ``cancel_queued``
        misses it) but not executing (so the targeted SIGINT would
        miss too). A targeted steal pulls it back; the stolen-reply
        handler sees the cancel flag and completes it as cancelled.
        Returns False when the task is not in a pipelined queue
        position (caller falls through to the interrupt path).

        The steal can MISS: the task sits in the owner's per-tick
        exec_batch buffer (or in the pipe) and the steal frame beats
        the exec frame to the worker. Two guards close that race: the
        worker records missed steal targets and drops a later-arriving
        exec for them (replying stolen), and the target is remembered
        here so ``_on_tasks_stolen`` falls through to the interrupt
        path when the reply omits it (ADVICE r5)."""
        with self._lock:
            rt = self._running.get(task_id)
            if rt is None:
                return False
            worker = rt.worker
            pipeq = getattr(worker, "pipeq", None)
            if not pipeq or task_id not in pipeq \
                    or pipeq[0] == task_id:
                return False   # executing (head) or not pipe-queued
            worker.cancel_steal_targets[task_id] = force
        try:
            # True: cancel steal — the worker records a miss STICKY so
            # an exec frame delayed arbitrarily long is still dropped
            worker.send(("steal", [task_id.binary()], True))
            return True
        except Exception:
            with self._lock:
                worker.cancel_steal_targets.pop(task_id, None)
            return False

    # How long a pipelined task may sit queued behind a worker's
    # non-completing head task before it is stolen back. Well above a
    # healthy hot-path task (<1ms), well below a blocked parent's get.
    PIPELINE_STALL_S = 0.15

    def _rescue_stalled_pipelines(self) -> None:
        """Steal queued tasks off workers whose head task stopped
        making progress — the head may be BLOCKED on a nested child
        that is itself queued behind it (the lease-pipelining
        deadlock); stolen tasks reschedule anywhere."""
        now = time.monotonic()
        with self._lock:
            raylets = list(self._raylets.values())
        for raylet in raylets:
            with raylet.worker_pool._lock:
                workers = list(raylet.worker_pool._all.values())
            for w in workers:
                with self._lock:
                    if (not w.alive or w.is_actor_worker
                            or len(w.pipeq) <= 1 or w.steal_pending
                            or now - w.last_activity
                            < self.PIPELINE_STALL_S):
                        continue
                    victim_ids = list(w.pipeq)[1:]
                    victims = [t.binary() for t in victim_ids]
                    w.steal_pending = True
                    w.rescue_steal_ids = set(victim_ids)
                try:
                    w.send(("steal", victims))
                except Exception:
                    with self._lock:
                        w.steal_pending = False
                        w.rescue_steal_ids = set()

    def _on_tasks_stolen(self, worker: BaseWorker,
                         task_ids: List[bytes],
                         covered: Optional[List[bytes]] = None) -> None:
        """Worker returned still-queued pipelined payloads: free their
        slots on that worker and put them back through scheduling.
        ``covered`` is the id set this reply answers (the steal
        request's wanted list); None means legacy shape — treat every
        target as covered."""
        requeue: List[TaskSpec] = []
        cancelled: List[TaskSpec] = []
        freed = []
        interrupt: List[Tuple[TaskID, bool]] = []
        with self._lock:
            returned = {TaskID(b) for b in task_ids}
            covered_set = (returned if covered is None
                           else {TaskID(b) for b in covered})
            # Unlatch the rescue steal only when THIS reply answers it
            # — an unsolicited late-drop reply clearing the flag would
            # let the rescue loop issue overlapping steals.
            if covered is None or covered_set & worker.rescue_steal_ids:
                worker.steal_pending = False
                worker.rescue_steal_ids = set()
            # Cancel-steal targets this reply ANSWERS but did not take:
            # trusting the miss would let a cancelled task run its side
            # effects (ADVICE r5). Two cases: the task is EXECUTING
            # (pipe head) — fall through to the interrupt path; or its
            # exec frame is still in transit — the worker's
            # pending-steal intake drops it on arrival and answers
            # stolen, so no interrupt is needed (and a force interrupt
            # here would kill a worker mid-someone-else's task).
            # Targets NOT covered by this reply (their own steal is
            # still in flight) stay registered for their own reply.
            for tid, frc in list(worker.cancel_steal_targets.items()):
                if tid not in covered_set:
                    continue
                worker.cancel_steal_targets.pop(tid, None)
                if tid not in returned and tid in self._running \
                        and self._running[tid].worker is worker \
                        and worker.pipeq and worker.pipeq[0] == tid:
                    interrupt.append((tid, frc))
            for tid_b in task_ids:
                task_id = TaskID(tid_b)
                rt = self._running.pop(task_id, None)
                if worker.inflight > 0 and rt is not None:
                    worker.inflight -= 1
                try:
                    worker.pipeq.remove(task_id)
                except ValueError:
                    pass
                if rt is None:
                    continue
                freed.append((rt.node_id, rt.resources, rt.pg))
                # a stolen task was already burned once by a stalled
                # worker: park it for a FREE worker instead of
                # re-gluing it to another busy pipe
                rt.spec._pipeline_steals = 2
                if (self._cancelled_check is not None
                        and self._cancelled_check(task_id)):
                    # cancelled while queued on the pipe: it must
                    # NEVER run — complete it as cancelled instead of
                    # rescheduling it
                    cancelled.append(rt.spec)
                else:
                    requeue.append(rt.spec)
        for node_id, resources, pg in freed:
            self._free_allocation(node_id, resources, pg)
        for spec in cancelled:
            from ray_tpu_torch.exceptions import TaskCancelledError
            self._complete_task(spec.task_id, [], None,
                                TaskCancelledError(
                                    f"task {spec.repr_name()} was "
                                    "cancelled"))
        if requeue:
            with self._lock:
                self._to_schedule.extend(requeue)
            self._wake.set()
        for tid, frc in interrupt:
            self.interrupt_running(tid, frc)

    # Per-node, per-resource cap on a non-CPU key's contribution to
    # the slot estimate: one lane ≈ one placement, but a huge custom
    # pool (e.g. "requests": 1e6) must not turn the estimate into the
    # whole backlog. The schedule batch is clipped by
    # tpu_scheduler_batch_size anyway.
    _SLOT_ESTIMATE_LANE_CAP = 32.0

    def _free_slot_estimate(self) -> int:
        """~How many queued tasks could place this tick: free CPU plus
        free non-CPU lanes (TPU / custom resources — zero-CPU tasks
        place against those, and counting CPU only throttled them to
        the headroom constant under CPU saturation), plus headroom so
        infeasibility detection always makes progress."""
        free = 0.0
        for _nid, node in self.cluster_resources.nodes():
            # list(): .available is the live dict, mutated by
            # completion threads — bare iteration can raise
            # "dict changed size" mid-tick
            for key, avail in list(node.available.items()):
                if "memory" in key:
                    continue    # byte-denominated: not a task lane
                if key == "CPU":
                    free += max(0.0, avail)
                else:
                    free += min(max(0.0, avail),
                                self._SLOT_ESTIMATE_LANE_CAP)
        return int(free) + 8

    def _free_allocation(self, node_id: NodeID, resources: Dict[str, float],
                         pg=None) -> None:
        """Return a task/actor allocation: to its placement-group bundle
        when it was drawn from one, else to the node's free pool."""
        if pg is not None and self.pg_manager is not None:
            self.pg_manager.free_to_bundle(pg[0], pg[1], resources)
        else:
            self.cluster_resources.free(node_id, resources)

    def reacquire_allocation(self, node_id: NodeID,
                             resources: Dict[str, float], pg=None) -> None:
        """Take back resources a blocked parent task released while it
        waited on a nested get()."""
        if pg is not None and self.pg_manager is not None:
            self.pg_manager.reacquire_from_bundle(pg[0], pg[1], resources)
        else:
            self.cluster_resources.reacquire(node_id, resources)

    def _schedule_pg_task(self, spec: TaskSpec, retry: List[TaskSpec]
                          ) -> None:
        """Route a task bound to a placement group: draw from the
        bundle's reservation and pin to the bundle's node."""
        pg_id = spec.placement_group_id
        bundle_index = spec.placement_group_bundle_index
        alloc, reason = self.pg_manager.allocate_from_bundle(
            pg_id, bundle_index, spec.resources)
        if alloc is None:
            if reason in ("pending", "busy"):
                retry.append(spec)
            else:
                err_msg = (
                    f"placement group {pg_id.hex()[:12]} was removed"
                    if reason == "removed" else
                    f"task demand {spec.resources} can never fit bundle "
                    f"{bundle_index} of placement group {pg_id.hex()[:12]}")
                if self._fail_task_cb is not None:
                    from ray_tpu_torch.exceptions import PlacementGroupError
                    self._fail_task_cb(spec, PlacementGroupError(err_msg))
                else:
                    logger.error("dropping pg task %s: %s",
                                 spec.repr_name(), err_msg)
            return
        node_id, resolved_index = alloc
        spec.placement_group_bundle_index = resolved_index
        with self._lock:
            remote = self._remote_nodes.get(node_id)
        if remote is not None:
            if not remote.alive:
                self.pg_manager.free_to_bundle(pg_id, resolved_index,
                                               spec.resources)
                retry.append(spec)
            else:
                self._dispatch_remote(remote, spec)
            return
        with self._lock:
            raylet = self._raylets.get(node_id)
            if raylet is None or not raylet.alive:
                self.pg_manager.free_to_bundle(pg_id, resolved_index,
                                               spec.resources)
                retry.append(spec)
                return
            raylet.dispatch_queue.append(spec)

    def _schedule_once(self, batch_limit: int) -> int:
        """Schedule up to ``batch_limit`` queued specs; returns how
        many were actually placed this tick (the coalescing window's
        burst signal)."""
        with self._lock:
            batch: List[TaskSpec] = []
            while self._to_schedule and len(batch) < batch_limit:
                batch.append(self._to_schedule.popleft())
        if not batch:
            return 0
        retry: List[TaskSpec] = []
        fenced: List[Tuple[TaskSpec, Optional[int]]] = []
        plain: List[TaskSpec] = []
        for spec in batch:
            if (spec.placement_group_id is not None
                    and self.pg_manager is not None):
                self._schedule_pg_task(spec, retry)
            else:
                plain.append(spec)
        batch = plain
        # Request objects are cached on the spec: a task retries on
        # every capacity change until it fits, and rebuilding the
        # request each tick was measurable at queue depth.
        requests = []
        for spec in batch:
            req = getattr(spec, "_sched_request", None)
            if req is None:
                req = SchedulingRequest(
                    demand=spec.resources,
                    preferred_node=self._preferred_node_for(spec),
                    strategy=spec.scheduling_strategy,
                )
                spec._sched_request = req   # type: ignore[attr-defined]
            requests.append(req)
        # Park version captured BEFORE the policy call (and so before
        # this tick's allocations and dispatches): any cluster
        # mutation after this point — a node joining mid-batch, a
        # completion's free() racing an allocation below — lands
        # after the park version and releases the ledger next tick (a
        # spurious release/re-fence is benign; a mutation swallowed
        # into the park version is a permanently parked task).
        fence_version = self.cluster_resources.version()
        results = self._policy.schedule_batch(
            self.cluster_resources, requests) if requests else []
        # Remote dispatches coalesce into ONE lease RPC per raylet per
        # tick (the reference's lease-request batching): the per-task
        # submit round trip otherwise serializes the scheduler loop on
        # the network.
        remote_batches: Dict[NodeID, Tuple[RemoteNodeHandle,
                                           List[TaskSpec]]] = {}
        fence_on = get_config().scheduler_fence_enabled
        for spec, res in zip(batch, results):
            if res.node_id is None:
                if res.is_infeasible:
                    with self._lock:
                        self._infeasible[spec.task_id] = spec
                    logger.warning(
                        "task %s is infeasible: demand=%s",
                        spec.repr_name(), spec.resources)
                elif res.is_fenced and fence_on:
                    fenced.append((spec, res.fence_bound))
                else:
                    retry.append(spec)
                continue
            if not self.cluster_resources.allocate(res.node_id,
                                                   spec.resources):
                retry.append(spec)
                continue
            with self._lock:
                remote = self._remote_nodes.get(res.node_id)
            if remote is not None:
                if not remote.alive:
                    self.cluster_resources.free(res.node_id, spec.resources)
                    retry.append(spec)
                else:
                    remote_batches.setdefault(
                        res.node_id, (remote, []))[1].append(spec)
                continue
            with self._lock:
                raylet = self._raylets.get(res.node_id)
                if raylet is None or not raylet.alive:
                    self.cluster_resources.free(res.node_id, spec.resources)
                    retry.append(spec)
                    continue
                raylet.dispatch_queue.append(spec)
        for handle, specs in remote_batches.values():
            self._dispatch_remote_batch(handle, specs)
        if fenced:
            self._fence_specs(fenced, fence_version)
        if retry:
            with self._lock:
                self._to_schedule.extend(retry)
        return max(0, len(batch) - len(retry) - len(fenced))

    def pending_resource_demand(self) -> List[Dict[str, float]]:
        """Resource shapes of tasks the cluster cannot currently place
        (the autoscaler's demand signal; reference: GCS autoscaler
        resource-demand state)."""
        demands: List[Dict[str, float]] = []
        with self._lock:
            demands.extend(dict(s.resources)
                           for s in self._infeasible.values())
            for entry in self._unplaceable.values():
                demands.extend(dict(s.resources) for s in entry.specs)
            demands.extend(dict(s.resources) for s in self._to_schedule)
        if self.pg_manager is not None:
            with self.pg_manager._lock:
                for pg_id in list(self.pg_manager._pending):
                    info = self.pg_manager.get(pg_id)
                    if info is not None:
                        demands.extend(dict(b) for b in info.bundles)
        return demands

    def recheck_infeasible(self) -> None:
        with self._lock:
            specs = list(self._infeasible.values())
            self._infeasible.clear()
            self._to_schedule.extend(specs)
            for entry in self._unplaceable.values():
                self._to_schedule.extend(entry.specs)
            self._unplaceable.clear()
        self._wake.set()

    # -- unplaceable-class ledger (capacity fence) ------------------------

    def _class_capacity_bound(self, demand: Dict[str, float]) -> int:
        """How many instances of ``demand`` the cluster's node TOTALS
        could hold concurrently (the fence's typed-signal bound);
        semantics single-sourced in policy.class_capacity_bound."""
        from ray_tpu_torch._private.scheduler.policy import class_capacity_bound
        return class_capacity_bound(
            ((node.total, node.alive)
             for _nid, node in self.cluster_resources.nodes()), demand)

    def _fence_specs(self, specs: List[Tuple[TaskSpec, Optional[int]]],
                     version: int) -> None:
        """Park capacity-fenced (spec, bound) pairs in the unplaceable
        ledger and surface the typed signal: one
        ``CapacityInfeasibleError`` per class (PR-3 overload taxonomy —
        retryable, shipped typed over RPC), readable via
        ``unplaceable_report`` and exported as the
        ``ray_tpu_tasks{state=infeasible}`` gauge + the heartbeat's
        ``unplaceable`` stat. ``version`` is the cluster resource
        version from BEFORE the tick's own allocations (see
        _schedule_once) so no concurrent free() can be swallowed; the
        bound rides along from the policy (which already computed it)
        so a saturated class's once-per-completion re-fence doesn't
        pay an O(nodes) recompute."""
        from ray_tpu_torch._private import export
        new_classes = []
        recompute = []
        with self._lock:
            for spec, bound in specs:
                key = tuple(sorted(spec.resources.items()))
                entry = self._unplaceable.get(key)
                if entry is None:
                    entry = _FencedClass(version, CapacityInfeasibleError(
                        f"demand {dict(spec.resources)} exceeds cluster "
                        "capacity; parked until the resource ledger "
                        "moves", demand=spec.resources,
                        bound=bound if bound is not None else 0))
                    self._unplaceable[key] = entry
                    new_classes.append(entry)
                    if bound is None:
                        recompute.append(entry)
                entry.version = version
                entry.specs.append(spec)
                entry.error.pending = len(entry.specs)
                self.num_fenced += 1
        for entry in recompute:
            # bound computed outside _lock: it scans the cluster ledger
            entry.error.bound = self._class_capacity_bound(
                entry.error.demand)
        for entry in new_classes:
            # A saturated queue re-fences its class once per release
            # cycle (every completion) — warn/export only the first
            # time per class so steady-state saturation isn't noisy.
            key = tuple(sorted(entry.error.demand.items()))
            if key in self._fence_warned:
                continue
            self._fence_warned.add(key)
            logger.warning(
                "scheduling class %s fenced: cluster capacity bound %d "
                "< pending; parked until capacity changes",
                entry.error.demand, entry.error.bound)
            export.emit("SCHED", {
                "event": "CLASS_FENCED",
                "demand": dict(entry.error.demand),
                "bound": entry.error.bound,
                "pending": entry.error.pending,
            })

    def _release_unplaceable(self) -> None:
        """Fenced classes rejoin scheduling only after the cluster
        resource version moved — capacity can only appear through a
        ledger mutation (completion free, node join/leave), so static
        ticks provably skip them (no per-tick rescan)."""
        with self._lock:
            if not self._unplaceable:
                return
            version = self.cluster_resources.version()
            stale = [k for k, e in self._unplaceable.items()
                     if e.version != version]
            for key in stale:
                entry = self._unplaceable.pop(key)
                self._to_schedule.extend(entry.specs)

    def set_node_type_catalog(
            self, types: Optional[Dict[str, Dict[str, float]]]) -> None:
        """Register the autoscaler's node-type catalog (name ->
        resource totals) so ``unplaceable_report`` can annotate each
        fenced class with the types that could fit it."""
        with self._lock:
            self._node_type_catalog = dict(types or {})

    @staticmethod
    def _feasible_types(demand: Dict[str, float],
                        catalog: Dict[str, Dict[str, float]]
                        ) -> Optional[List[str]]:
        """Catalog node types whose TOTALS fit one instance of
        ``demand`` (the node-type-feasible bound: which launches could
        ever help); None when no catalog is registered — the
        current-cluster ``bound`` is then the only signal."""
        if not catalog:
            return None
        return [name for name, res in sorted(catalog.items())
                if all(res.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items())]

    def unplaceable_report(self) -> List[dict]:
        """Typed per-class view of everything the cluster cannot
        currently hold, for the owner (autoscaler hints, dashboards,
        tests): capacity-fenced classes (bound > 0 — surplus beyond
        the totals bound) AND totals-infeasible classes (bound == 0 —
        no node could EVER run one instance), each carrying its
        ``CapacityInfeasibleError``. With a node-type catalog
        registered (``set_node_type_catalog``), each entry also
        carries ``feasible_types`` — the catalog types whose totals
        fit the shape — so the autoscaler need not re-derive fit."""
        with self._lock:
            catalog = dict(self._node_type_catalog)
            out = [{"demand": dict(k), "pending": len(e.specs),
                    "bound": e.error.bound, "error": e.error,
                    "feasible_types": self._feasible_types(
                        e.error.demand, catalog)}
                   for k, e in self._unplaceable.items()]
            infeas: Dict[tuple, int] = {}
            for spec in self._infeasible.values():
                key = tuple(sorted(spec.resources.items()))
                infeas[key] = infeas.get(key, 0) + 1
        for key, pending in infeas.items():
            out.append({
                "demand": dict(key), "pending": pending, "bound": 0,
                "feasible_types": self._feasible_types(dict(key),
                                                       catalog),
                "error": CapacityInfeasibleError(
                    f"demand {dict(key)} is infeasible on every node",
                    demand=dict(key), bound=0, pending=pending)})
        return out

    def unplaceable_size(self) -> int:
        with self._lock:
            return sum(len(e.specs) for e in self._unplaceable.values())

    # -- dispatch ----------------------------------------------------------

    def _dispatch_all(self) -> None:
        with self._lock:
            raylets = list(self._raylets.values())
        for raylet in raylets:
            self._dispatch_node(raylet)

    def _on_pip_env_requeue(self, parked: list) -> None:
        """A venv build finished (ready or failed): re-queue the specs
        parked on it; dispatch re-polls and leases or fails them. A
        spec whose node died mid-build goes back through scheduling
        (its allocation was freed with the node)."""
        rescheduled = []
        with self._lock:
            for raylet, spec in parked:
                if raylet.alive:
                    raylet.dispatch_queue.append(spec)
                else:
                    rescheduled.append(spec)
        for spec in rescheduled:
            self.submit_task(spec)
        self._wake.set()

    def _dispatch_node(self, raylet: Raylet) -> None:
        # Per-round submit coalescing: payloads bound for the same
        # worker leave in ONE ("exec_batch", ...) frame instead of a
        # frame per task (the submit half of the batched normal-task
        # wire path); replies still stream back one per task.
        buffers: Dict[int, Tuple[BaseWorker, List[Tuple[TaskSpec, dict]]]] \
            = {}
        try:
            self._dispatch_node_inner(raylet, buffers)
        finally:
            for entry in buffers.values():
                self._flush_worker_buffer(raylet, entry)

    def _flush_worker_buffer(self, raylet: Raylet, entry) -> None:
        worker, items = entry
        if not items:
            return
        try:
            if len(items) == 1:
                worker.send(("exec", items[0][1]))
            else:
                worker.send(("exec_batch", [p for _s, p in items]))
            self.wire_stats.channel("worker_pipe").record(len(items))
        except Exception as e:   # worker pipe broken mid-flush
            for spec, _p in items:
                with self._lock:
                    self._running.pop(spec.task_id, None)
                    if worker.inflight > 0:
                        worker.inflight -= 1
                    try:
                        worker.pipeq.remove(spec.task_id)
                    except ValueError:
                        pass
                self._free_allocation(raylet.node_id, spec.resources,
                                      self._spec_pg(spec))
                self._complete_task(spec.task_id, [], None,
                                    WorkerCrashedError(str(e)))

    def _dispatch_node_inner(self, raylet: Raylet, buffers) -> None:
        while True:
            with self._lock:
                if not raylet.dispatch_queue or not raylet.alive:
                    return
                spec = raylet.dispatch_queue.popleft()
            dedicated = spec.task_type == TaskType.ACTOR_CREATION_TASK
            env_tag = python_exe = None
            pip_spec = (spec.runtime_env or {}).get("pip")
            if pip_spec is not None:
                from ray_tpu_torch._private.pip_env import resolve_for_dispatch

                def fail(err, spec=spec, raylet=raylet):
                    self._free_allocation(raylet.node_id, spec.resources,
                                          self._spec_pg(spec))
                    if self._fail_task_cb is not None:
                        self._fail_task_cb(spec, err)

                # "parked": parked atomically inside the manager until
                # the venv build finishes (allocation stays held — the
                # task WILL run here); the requeue callback re-queues.
                status, env_tag, python_exe = resolve_for_dispatch(
                    self._pip_envs, pip_spec, spec.resources,
                    raylet.worker_pool.substrate_for, fail,
                    park_item=(raylet, spec))
                if status != "go":
                    continue
            worker = raylet.worker_pool.pop_worker(
                spec.resources, dedicated, env_tag=env_tag,
                python_exe=python_exe)
            fresh = worker is not None
            if worker is None:
                # Lease pipelining: rather than stall until a done→
                # push→pop round trip frees a pool slot, queue a plain
                # normal task on a busy worker's pipe (bounded depth) —
                # the submit half of the batched normal-task wire path.
                if (spec.task_type == TaskType.NORMAL_TASK
                        and env_tag is None and python_exe is None
                        and getattr(spec, "_pipeline_steals", 0) < 2
                        and raylet.worker_pool.substrate_for(
                            spec.resources) == "process"):
                    worker = raylet.worker_pool.pipeline_candidate()
                if worker is None:
                    with self._lock:
                        raylet.dispatch_queue.appendleft(spec)
                    return
            err = self._send_task(raylet, worker, spec, buffers=buffers)
            entry = buffers.get(id(worker))
            if (entry is not None and len(entry[1])
                    >= raylet.worker_pool.PIPELINE_DEPTH):
                self._flush_worker_buffer(raylet, buffers.pop(id(worker)))
            if err is not None:
                if fresh:
                    raylet.worker_pool.push_worker(worker)
                self._free_allocation(raylet.node_id, spec.resources,
                                      self._spec_pg(spec))
                if isinstance(err, _DependencyError):
                    # Upstream task failed: propagate its error verbatim,
                    # never retry the dependent (reference semantics).
                    self._complete_task(spec.task_id, [], err.entry.data, None)
                elif isinstance(err, _LostArgError):
                    # An argument's backing storage vanished: recover it
                    # from lineage and requeue this task behind it.
                    recovered = (self._recover_object_cb(err.object_id)
                                 if self._recover_object_cb else False)
                    if recovered:
                        self.submit_task(spec)
                    elif self._fail_task_cb is not None:
                        from ray_tpu_torch.exceptions import ObjectLostError
                        self._fail_task_cb(spec, ObjectLostError(
                            f"argument {err.object_id} of "
                            f"{spec.repr_name()} was lost and cannot be "
                            "reconstructed"))
                else:
                    self._complete_task(spec.task_id, [], None, err)

    def _send_task(self, raylet: Raylet, worker: BaseWorker,
                   spec: TaskSpec,
                   buffers=None) -> Optional[BaseException]:
        """Build the payload (resolving args from the owner's stores) and
        ship it. Returns an error to fail the task without executing."""
        arg_descs = []
        for arg in spec.args:
            if arg.object_id is None:
                arg_descs.append(("v", arg.inline_blob))
                continue
            if arg.owner_addr is not None:
                arg_descs.append(("owned", arg.object_id.binary(),
                                  tuple(arg.owner_addr)))
                continue
            try:
                entry = self._memory_store.get(arg.object_id, timeout=0)
            except TimeoutError:
                # Directory entry purged by a concurrent lineage
                # reconstruction between the dependency check and here.
                with self._lock:
                    self._running.pop(spec.task_id, None)
                return _LostArgError(arg.object_id)
            if entry.kind == "err":
                # dependency failed -> propagate without executing
                with self._lock:
                    self._running.pop(spec.task_id, None)
                return _DependencyError(entry)
            if entry.kind == "blob":
                arg_descs.append(("v", entry.data))
            elif entry.kind == "device":
                desc = device_arg_desc(arg.object_id,
                                       worker.kind == "in_process",
                                       self._ensure_host_copy_cb)
                if desc is None:
                    with self._lock:
                        self._running.pop(spec.task_id, None)
                    return _LostArgError(arg.object_id)
                arg_descs.append(desc)
            elif entry.kind == "remote":
                # Object lives on a remote node; pull it into the local
                # store before dispatching to a local worker.
                if not self._localize_remote_entry(arg.object_id, entry):
                    with self._lock:
                        self._running.pop(spec.task_id, None)
                    return _LostArgError(arg.object_id)
                name, size = entry.data
                arg_descs.append(("shm", arg.object_id.binary(), name, size))
            else:  # shm
                if not self._shm_store.contains(arg.object_id):
                    with self._lock:
                        self._running.pop(spec.task_id, None)
                    return _LostArgError(arg.object_id)
                name, size = entry.data
                arg_descs.append(("shm", arg.object_id.binary(), name, size))
        is_exec = spec.task_type != TaskType.ACTOR_CREATION_TASK
        fid = spec.function.function_id
        name = spec.repr_name()
        # Hot-path template stripping (data-plane fast path, layer 4):
        # the constant half of a process worker's exec payload ships
        # ONCE per (worker, function); per-task frames then carry only
        # the varying fields ("xt" marker — worker_process.merge_exec
        # rebuilds the full payload). Pipe FIFO guarantees the
        # template lands first. In-process workers skip this (their
        # payloads are never pickled, so stripping saves nothing).
        use_tmpl = (is_exec and worker.kind == "process"
                    and spec.num_returns == 1 and not spec.kwargs_keys
                    and not spec.runtime_env and not spec.streaming
                    and not spec.stream_skip)
        if use_tmpl:
            payload = {
                "xt": fid,
                "task_id": spec.task_id.binary(),
                "args": arg_descs,
                "return_ids": [o.binary() for o in spec.return_ids],
            }
            tmpl_name = worker.exec_templates.get(fid)
            if tmpl_name is not None and tmpl_name != name:
                payload["name"] = name
        else:
            payload = {
                "type": "exec" if is_exec else "create_actor",
                "task_id": spec.task_id.binary(),
                "function_id": fid,
                "args": arg_descs,
                "kwargs_keys": spec.kwargs_keys,
                "num_returns": spec.num_returns,
                "return_ids": [o.binary() for o in spec.return_ids],
                "name": name,
                "runtime_env": spec.runtime_env,
                "owner_addr": self.object_server_addr,
                "streaming": spec.streaming,
                "stream_skip": spec.stream_skip,
            }
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            payload["actor_id"] = spec.actor_creation_id.binary()
            payload["max_concurrency"] = spec.max_concurrency
            payload["checkpoint_interval"] = spec.checkpoint_interval
        try:
            raylet.worker_pool.ensure_function(
                worker, fid, lambda: self._function_blob(fid))
            if use_tmpl and fid not in worker.exec_templates:
                worker.send(("exec_tmpl", fid, {
                    "type": "exec",
                    "function_id": fid,
                    "kwargs_keys": [],
                    "num_returns": 1,
                    "name": name,
                    "runtime_env": None,
                    "owner_addr": self.object_server_addr,
                    "streaming": False,
                    "stream_skip": 0,
                }))
                worker.exec_templates[fid] = name
            with self._lock:
                self._running[spec.task_id] = RunningTask(
                    spec, raylet.node_id, worker, dict(spec.resources),
                    pg=self._spec_pg(spec))
                if is_exec:
                    worker.inflight += 1
                    worker.pipeq.append(spec.task_id)
                    worker.last_activity = time.monotonic()
            if buffers is not None and is_exec:
                entry = buffers.get(id(worker))
                if entry is None:
                    entry = buffers[id(worker)] = (worker, [])
                entry[1].append((spec, payload))
            else:
                worker.send(("exec" if is_exec else "create_actor",
                             payload))
            from ray_tpu_torch._private import events
            if events.active():
                events.record(spec.task_id.hex(), name, "RUNNING",
                              worker=worker.worker_id.hex()[:8])
        except Exception as e:  # worker pipe broken
            with self._lock:
                self._running.pop(spec.task_id, None)
                if is_exec and worker.inflight > 0:
                    worker.inflight -= 1
                    try:
                        worker.pipeq.remove(spec.task_id)
                    except ValueError:
                        pass
            return WorkerCrashedError(str(e))
        return None

    # -- replies -----------------------------------------------------------

    def _on_inproc_reply(self, worker: BaseWorker, reply: tuple) -> None:
        try:
            self._handle_reply(worker, reply)
        except Exception:
            logger.exception("error handling in-process worker reply")

    def _handle_reply(self, worker: BaseWorker, reply: tuple) -> None:
        op = reply[0]
        if op == "batch":
            # Coalesced completions (one frame, N replies). Deferred
            # notify: entries land per reply but blocked getters wake
            # once for the whole batch, not once per object.
            with self._memory_store.deferred_notify():
                for r in reply[1]:
                    self._handle_reply(worker, r)
            return
        if op == "stream":
            # streaming generator item; the task keeps running
            _, task_id_b, results = reply
            if self._stream_item_cb is not None:
                self._stream_item_cb(TaskID(task_id_b), results)
            return
        if op == "core_addr":
            # Reply to a compiled-DAG channel-binding request.
            worker.core_addr = tuple(reply[1])
            evt = getattr(worker, "_core_addr_evt", None)
            if evt is not None:
                evt.set()
            return
        if op == "stolen":
            self._on_tasks_stolen(worker, reply[1],
                                  reply[2] if len(reply) > 2 else None)
            return
        if op == "stacks":
            from ray_tpu_torch._private.profiling import deliver_stack_reply
            deliver_stack_reply(worker, reply[1])
            return
        if op == "done":
            _, task_id_b, results, err_blob = reply[:4]
            timings = reply[4] if len(reply) > 4 else None
            task_id = TaskID(task_id_b)
            with self._lock:
                rt = self._running.pop(task_id, None)
            if rt is None:
                return
            if not worker.is_actor_worker:
                with self._lock:
                    raylet = self._raylets.get(rt.node_id)
                    if worker.inflight > 0:
                        worker.inflight -= 1
                    try:
                        worker.pipeq.remove(task_id)
                    except ValueError:
                        pass
                    worker.last_activity = time.monotonic()
                    worker.steal_pending = False
                    idle = worker.inflight == 0
                if raylet is not None and idle:
                    # pipelined tasks may still be queued on the pipe;
                    # the worker rejoins the pool only when drained
                    raylet.worker_pool.push_worker(worker)
                self._free_allocation(rt.node_id, rt.resources, rt.pg)
                self._wake_sched()
            self._complete_task(task_id, results, err_blob, None,
                                timings)
        elif op == "actor_ready":
            _, actor_id_b, err_blob = reply[:3]
            restore = reply[3] if len(reply) > 3 else None
            task_id = None
            with self._lock:
                for tid, rt in self._running.items():
                    if (rt.spec.task_type == TaskType.ACTOR_CREATION_TASK
                            and rt.spec.actor_creation_id.binary()
                            == actor_id_b):
                        task_id = tid
                        break
                rt = self._running.pop(task_id, None) if task_id else None
            if rt is None:
                return
            if err_blob is not None:
                # creation failed: release worker + resources
                with self._lock:
                    raylet = self._raylets.get(rt.node_id)
                if raylet is not None:
                    raylet.worker_pool.remove_worker(worker)
                    worker.send(("shutdown",))
                self._free_allocation(rt.node_id, rt.resources, rt.pg)
                self._complete_task(task_id, [], err_blob, None)
            else:
                if restore is not None and \
                        self._actor_restore_cb is not None:
                    # BEFORE completion: _on_actor_creation_done trims
                    # the replay queue against this restore's cursor
                    self._actor_restore_cb(ActorID(actor_id_b), restore)
                self.register_actor_worker(
                    ActorID(actor_id_b), rt.node_id, worker, rt.resources,
                    pg=rt.pg, creation_spec=rt.spec)
                self._complete_task(task_id, [], None, None)
        elif op == "ckpt_saved":
            # a checkpointable actor's executor wrote a generation;
            # the owner decides the commit (solo: now; gang: two-phase)
            if self._actor_ckpt_cb is not None:
                self._actor_ckpt_cb(ActorID(reply[1]), reply[2])

    def _io_loop(self) -> None:
        from multiprocessing.connection import wait as conn_wait
        # no-deadline: daemon service loop, exits via _shutdown; each
        # pass blocks at most 0.1s in conn_wait / 0.01s in the idle sleep
        while not self._shutdown:
            conns = []
            with self._lock:
                raylets = list(self._raylets.values())
            conn_to_raylet = {}
            for raylet in raylets:
                for c in raylet.worker_pool.process_connections():
                    conns.append(c)
                    conn_to_raylet[id(c)] = raylet
            if not conns:
                time.sleep(0.01)
                continue
            for c in conn_wait(conns, timeout=0.1):
                raylet = conn_to_raylet[id(c)]
                worker = raylet.worker_pool.worker_by_conn(c)
                if worker is None:
                    continue
                try:
                    msg = c.recv()
                except (EOFError, OSError):
                    try:
                        self._on_worker_death(raylet, worker)
                    except Exception:
                        logger.exception("error handling worker death")
                    continue
                try:
                    if msg[0] == "ready":
                        worker.ready = True
                    elif msg[0] == "pong":
                        pass
                    else:
                        # realized worker->owner coalescing factor
                        # (top-level frames only — _handle_reply
                        # recurses into batch items)
                        if msg[0] == "batch":
                            self._reply_stats.record(len(msg[1]))
                        elif msg[0] in ("done", "stream"):
                            self._reply_stats.record(1)
                        self._handle_reply(worker, msg)
                except Exception:
                    # Never let a completion error kill the IO thread —
                    # that would orphan every process worker.
                    logger.exception("error handling worker reply")

    def _on_worker_death(self, raylet: Raylet, worker: ProcessWorker) -> None:
        raylet.worker_pool.remove_worker(worker)
        worker.kill()
        dead: List[TaskID] = []
        dead_actor: Optional[ActorID] = None
        with self._lock:
            for tid, rt in self._running.items():
                if rt.worker is worker:
                    dead.append(tid)
            for aid, (nid, w, res, _pg) in list(self._actor_workers.items()):
                if w is worker:
                    dead_actor = aid
        for tid in dead:
            self._fail_running(tid, WorkerCrashedError(
                "worker process died while executing task"))
        if dead_actor is not None:
            with self._lock:
                entry = self._actor_workers.pop(dead_actor, None)
            if entry is not None:
                nid, _, res, pg = entry
                self._free_allocation(nid, res, pg)
                if self._actor_death_cb is not None:
                    self._actor_death_cb(dead_actor)
        self._wake.set()

    def _fail_running(self, task_id: TaskID, err: BaseException) -> None:
        with self._lock:
            rt = self._running.pop(task_id, None)
        if rt is None:
            return
        if not rt.worker.is_actor_worker and rt.resources:
            self._free_allocation(rt.node_id, rt.resources, rt.pg)
        self._complete_task(task_id, [], None, err)

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, leave_remote_nodes: bool = False) -> None:
        """``leave_remote_nodes``: this driver JOINED a cluster it does
        not own — detach from its raylets without shutting them down
        (nodes this driver spawned itself are always stopped)."""
        self._shutdown = True
        self._wake.set()
        with self._lock:
            raylets = list(self._raylets.values())
            remotes = list(self._remote_nodes.values())
            self._remote_nodes.clear()
        for handle in remotes:
            handle.alive = False    # suppress on_close node-lost handling
            if not leave_remote_nodes or handle.proc is not None:
                try:
                    handle.client.call("shutdown", timeout=2)
                except Exception:
                    pass    # raylet already down: proceed to close
            handle.client.close()
            if handle.proc is not None:
                try:
                    handle.proc.wait(timeout=5)
                except Exception:
                    handle.proc.terminate()
        for raylet in raylets:
            raylet.worker_pool.shutdown()
        self._sched_thread.join(timeout=2)
        self._io_thread.join(timeout=2)
        self._peer_clients.close()
        self.object_server.shutdown()
        self.hub.shutdown()

    def stats(self) -> dict:
        with self._lock:
            return {
                "nodes": len(self._raylets),
                "to_schedule": len(self._to_schedule),
                "waiting_deps": len(self._waiting),
                "running": len(self._running),
                "infeasible": len(self._infeasible),
                "unplaceable": sum(len(e.specs)
                                   for e in self._unplaceable.values()),
                "actors": len(self._actor_workers),
                "deferred": len(self._deferred),
                "shed": self.num_shed,
                "fenced": self.num_fenced,
                "window_waits": self.num_window_waits,
            }

    def inflight_windows(self) -> Dict[str, int]:
        """node-hex -> current in-flight lease count per remote node
        (the inflight_window gauge's data source); one scan covers
        every node."""
        with self._lock:
            nodes = [nid for nid, h in self._remote_nodes.items()
                     if h.alive]
        counts = self._remote_inflight_counts()
        return {nid.hex()[:12]: counts.get(nid, 0) for nid in nodes}


class _DependencyError(Exception):
    """Internal: carries a failed dependency's error entry."""

    def __init__(self, entry):
        self.entry = entry
        super().__init__("dependency failed")


class _LostArgError(Exception):
    """Internal: an argument object's backing storage is gone."""

    def __init__(self, object_id):
        self.object_id = object_id
        super().__init__("argument object lost")
