"""CoreWorker + the global driver singleton.

Reference analogs [UNVERIFIED — mount empty, SURVEY.md §0]:
``python/ray/_private/worker.py`` (global worker, init/connect,
get/put/wait) and ``src/ray/core_worker/core_worker.cc`` (SubmitTask,
actor submission, Put/Get/Wait) plus
``transport/actor_task_submitter.cc`` (ordered per-actor queues).
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.gcs import ActorInfo, GcsLite, NodeInfo
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
)
from ray_tpu_torch._private.node_manager import NodeManagerGroup
from ray_tpu_torch._private.object_store import MemoryStore, ShmStore
from ray_tpu_torch._private.ref_counting import ReferenceCounter
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.scheduler.policy import default_policy
from ray_tpu_torch._private.scheduler.resources import NodeResources
from ray_tpu_torch._private.task_manager import (
    Entry, TaskManager, _contained_item)
from ray_tpu_torch._private.task_spec import (
    FunctionDescriptor,
    TaskArg,
    TaskOptions,
    TaskSpec,
    TaskType,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    ObjectReconstructionFailedError,
    TaskError,
)

logger = logging.getLogger(__name__)


class _LostObjectSignal(Exception):
    """Internal: a sealed object's backing storage is gone; the caller
    should attempt lineage reconstruction."""


_SUPPORTED_RUNTIME_ENV_KEYS = {"env_vars", "working_dir", "pip"}


def _validate_runtime_env(runtime_env: Optional[dict]) -> Optional[dict]:
    """env_vars/working_dir apply inside an already-provisioned
    worker; pip builds a cached per-node venv whose interpreter runs a
    dedicated worker (``_private/pip_env.py``). conda/containers are
    rejected explicitly (no conda or container runtime in scope)."""
    if not runtime_env:
        return None
    unsupported = set(runtime_env) - _SUPPORTED_RUNTIME_ENV_KEYS
    if unsupported:
        raise ValueError(
            f"unsupported runtime_env key(s) {sorted(unsupported)}; "
            f"supported: {sorted(_SUPPORTED_RUNTIME_ENV_KEYS)}")
    env_vars = runtime_env.get("env_vars")
    if env_vars is not None and not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env_vars.items()):
        raise ValueError("runtime_env env_vars must be str -> str")
    out = dict(runtime_env)
    if out.get("pip") is not None:
        from ray_tpu_torch._private.pip_env import normalize_pip_spec
        out["pip"] = normalize_pip_spec(out["pip"])   # raises on bad shape
    return out


def _detect_num_gpus() -> int:
    """CUDA cards visible to this host process. Imports torch: the
    driver owns the cards, and asks only when the caller gave no
    ``num_gpus``."""
    import torch
    return torch.cuda.device_count()


def _runtime_device(num_gpus: float) -> str:
    """``"cuda"`` when the node has GPU resource and a card is there,
    else ``"cpu"``: a CPU-only runtime (``num_gpus=0``) never imports
    torch for this."""
    if not num_gpus:
        return "cpu"
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclass
class _GangRecord:
    """Driver-side view of one collective gang: everything the
    coordinated-restart path needs to kill, respawn, and re-join every
    member together (see docs/fault_tolerance.md "Gang semantics")."""

    name: str
    handles: list                    # ActorHandle per member (re-join)
    actor_ids: list
    ranks: list
    world_size: int
    backend: str
    restarts_left: int
    epoch: int = 1
    # a coordinated restart is in flight: further member deaths fold
    # into it instead of starting another
    restarting: bool = False
    # actor-queue flush gate: queued user calls must not reach a
    # restarted member before its re-join call re-forms the group
    gated: bool = False
    # terminally dead (budget exhausted, member killed, re-form
    # failed): no further coordinated restart may run for this gang
    dead: bool = False


@dataclass
class _SliceSetRecord:
    """Driver-side view of one multi-slice set (gang-of-gangs; see
    docs/multislice.md): which gangs are its slices and the DCN-tier
    epoch the coordinator fences on a slice abort."""

    name: str
    slice_gangs: list            # gang name per slice (index = slice id)
    dcn_group: str               # leader-rank DCN collective group
    world_size: int
    dcn_epoch: int = 1
    # terminally dead (a slice gang died for good): no further DCN
    # re-form can revive this set
    dead: bool = False


class Worker:
    """The driver-side core worker (single owner in the v0 slice)."""

    def __init__(self, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None,
                 max_process_workers: Optional[int] = None,
                 address: Optional[str] = None,
                 _system_config: Optional[dict] = None):
        # Before anything is built: a node without a card refuses to
        # start unless the caller asked for its GPU count.
        if num_gpus is None:
            num_gpus = float(_detect_num_gpus())
            if not num_gpus:
                raise RuntimeError(
                    "no CUDA device is available; pass num_gpus=0 to "
                    "ray_tpu_torch.init() to start a CPU-only runtime")
        # The runtime's device: the node manager's scheduling policy and
        # the placement-group packer run their kernels there.
        self.device = _runtime_device(num_gpus)
        cfg = get_config()
        # the overrides are this runtime's: shutdown() puts the process's
        # config back, so a later init() in the process (a test worker's
        # next test) does not inherit, say, gcs_mode="process"
        self._config_before = cfg.snapshot() if _system_config else None
        if _system_config:
            cfg.apply_system_config(_system_config)
        from ray_tpu_torch._private import chaos
        chaos.maybe_arm()   # RTPU_CHAOS / chaos_rules fault injection
        self._join_address = None
        if address:
            host, port = address.rsplit(":", 1)
            self._join_address = (host, int(port))
        self.session = os.urandom(4).hex()
        self.job_id = JobID.from_int(1)
        self.driver_task_id = TaskID.for_driver(self.job_id)
        self._put_index = 0  # guarded-by: _counter_lock
        self._counter_lock = threading.Lock()

        # Session secret gating every RPC connection (rpc.py handshake).
        # Heads mint one; joiners must arrive with the head's token in
        # RTPU_SESSION_TOKEN (printed by `ray_tpu_torch start --head`).
        from ray_tpu_torch._private import rpc as _rpc
        if self._join_address is None:
            _rpc.ensure_session_token(self.session)
        elif not _rpc.get_session_token():
            # same-host join with no token in the env: follow the
            # rtpt_current pointer to the head's persisted token file
            # (cross-host joiners still need RTPU_SESSION_TOKEN). Say
            # so: the pointer tracks the FRESHEST head, so a handshake
            # mismatch against an older session should read as "wrong
            # auto-loaded token", not "broken cluster".
            file_token = _rpc.load_session_token_file()
            if file_token:
                logger.info(
                    "using same-host session token from the "
                    "rtpt_current session dir (set RTPU_SESSION_TOKEN "
                    "to join a different session)")
                _rpc.set_session_token(file_token)

        # Exporter first: node/actor lifecycle events fire during the
        # rest of construction (head-node ADDED would otherwise vanish).
        if cfg.event_export_enabled:
            from ray_tpu_torch._private import export
            export.start(self.session)

        self.serde = serialization.get_context()
        self.memory_store = MemoryStore()
        self.shm_store = ShmStore(
            self.session,
            object_store_memory or cfg.object_store_memory_bytes,
            spill_dir=cfg.object_store_fallback_directory or None,
            spill_threshold=cfg.object_spilling_threshold)
        from ray_tpu_torch._private.device_object import DeviceStore
        self.device_store = DeviceStore()
        self.reference_counter = ReferenceCounter(self._on_ref_zero)
        self._gcs_proc = None
        self.gcs_address = None
        if self._join_address is not None:
            # Join an existing cluster: its GCS is the authority.
            from ray_tpu_torch._private.gcs_client import GcsClient
            self.gcs_address = self._join_address
            self.gcs = GcsClient(self.gcs_address)
        elif cfg.gcs_mode == "process":
            from ray_tpu_torch._private.gcs_client import GcsClient
            from ray_tpu_torch._private.gcs_server import spawn_gcs_process
            self._gcs_proc, self.gcs_address = spawn_gcs_process(
                self.session, cfg.serialize(), persist=True)
            self.gcs = GcsClient(self.gcs_address)
        else:
            self.gcs = GcsLite()

        # fid -> cloudpickle blob
        self._functions: Dict[bytes, bytes] = {}  # guarded-by: _functions_lock
        self._functions_lock = threading.Lock()

        if num_cpus is None:
            num_cpus = float(os.cpu_count() or 1)
        total = {"CPU": float(num_cpus)}
        if num_gpus:
            total["GPU"] = float(num_gpus)
        total["memory"] = float(object_store_memory
                                or cfg.object_store_memory_bytes)
        if resources:
            total.update({k: float(v) for k, v in resources.items()})
        node_res = NodeResources(total=dict(total), available=dict(total))

        from ray_tpu_torch._private import worker_core as _wc
        self.task_manager = TaskManager(
            store_result=self._store_result,
            resubmit=self._resubmit,
            on_task_arg_release=self.reference_counter.remove_task_argument,
            on_owned_arg_release=_wc.release_borrow)

        if max_process_workers is None:
            max_process_workers = max(2, min(8, int(num_cpus)))
        self.node_group = NodeManagerGroup(
            session=self.session,
            memory_store=self.memory_store,
            shm_store=self.shm_store,
            policy=default_policy(self.device),
            complete_task_cb=self._complete_task,
            function_blob_provider=self._get_function_blob,
            driver_node_resources=node_res,
            max_process_workers=max_process_workers)
        self.node_group.set_actor_death_callback(self._on_actor_death)

        from ray_tpu_torch._private.placement_group_manager import (
            PlacementGroupManager)
        self.pg_manager = PlacementGroupManager(
            self.node_group.cluster_resources,
            on_created=self._on_pg_created, device=self.device)
        self.node_group.pg_manager = self.pg_manager
        self.node_group._fail_task_cb = self._fail_task
        self.node_group._recover_object_cb = self._recover_object
        self.node_group._cancelled_check = self._task_cancelled
        self.node_group._ensure_host_copy_cb = self._ensure_host_copy
        self.node_group._stream_item_cb = self._on_stream_item
        self._pg_ready_refs: Dict[Any, ObjectID] = {}
        self.gcs.register_node(NodeInfo(
            node_id=self.node_group.head_node_id,
            resources_total=dict(total)))

        # Raylet self-reported availability (RESOURCES channel):
        # reconcile the scheduler's ledger — a wedged/externally-loaded
        # raylet's truth overrides the driver's optimistic view within
        # one heartbeat — and keep the raw reports for the dashboard.
        self.node_reports: Dict[NodeID, Tuple[float, Dict[str, float]]] = {}
        self.node_stats: Dict[NodeID, Tuple[float, dict]] = {}
        # streaming tasks: highest item index delivered (retry resume)
        self._stream_progress: Dict[TaskID, int] = {}
        # nested submissions shed at the owner's bounded intake
        self.num_nested_shed = 0
        # object-ready callbacks (serve router in-flight accounting and
        # any other completion hook) — fired inline on the completion
        # path, so no per-ref waiter threads
        self._ready_cb_lock = threading.Lock()
        self._ready_callbacks: Dict[ObjectID, List] = {}  # guarded-by: _ready_cb_lock
        self.gcs.publisher.subscribe("RESOURCES", self._on_resource_report)

        # per-actor ordered submission queues; _actor_flush_locks
        # serialize pop+send per actor so concurrent flushers can't
        # reorder a queue's head. Flushing itself runs on a dedicated
        # flusher thread: submitters only append + signal, so a tight
        # .remote() loop runs ahead of the wire and calls accumulate
        # into real batches (one frame per flush, not per call).
        self._actor_lock = threading.RLock()
        self._actor_queues: Dict[ActorID, deque] = {}  # guarded-by: _actor_lock
        self._actor_seq: Dict[ActorID, int] = {}  # guarded-by: _actor_lock
        # creation specs
        self._actor_specs: Dict[ActorID, TaskSpec] = {}  # guarded-by: _actor_lock
        self._actor_restarts: Dict[ActorID, int] = {}  # guarded-by: _actor_lock
        self._actor_flush_locks: Dict[ActorID, threading.RLock] = {}  # guarded-by: _actor_lock
        # kill tombstones: ray_tpu_torch.kill() must beat a creation spec a
        # concurrent _on_actor_death already resubmitted (satellite:
        # kill/restart race) — checked before any restart/revival
        self._actor_tombstones: set = set()  # guarded-by: _actor_lock
        # collective gangs (coordinated SPMD restart; see
        # docs/fault_tolerance.md "Gang semantics"). Gang teardown
        # snapshots membership under _gang_lock then fails the member
        # queues under _actor_lock inside it — never the reverse
        # nesting (enforced by graftcheck's lock-order pass):
        # lock-order: _gang_lock -> _actor_lock
        self._gang_lock = threading.Lock()
        self._gangs: Dict[str, _GangRecord] = {}  # guarded-by: _gang_lock
        self._actor_gang: Dict[ActorID, str] = {}  # guarded-by: _gang_lock
        self.num_gang_aborts = 0
        self.num_gang_restarts = 0
        # multi-slice runtime plane (docs/multislice.md): sliceset
        # records + slice-gang -> (set, slice index) mapping, and the
        # DCN-tier observability counters (fed by the trainer driver /
        # SliceSet.refresh_dcn_stats pulling leader-local counters)
        self._sliceset_lock = threading.Lock()
        self._slicesets: Dict[str, _SliceSetRecord] = {}  # guarded-by: _sliceset_lock
        self._gang_sliceset: Dict[str, Tuple[str, int]] = {}  # guarded-by: _sliceset_lock
        # per-set (bytes, ms) plus the fold of retired/replaced sets;
        # the gauges read retired + cross-set sums — cumulative, so a
        # destroyed set's traffic stays counted and a name reuse can't
        # walk them backwards
        self._dcn_stats_by_set: Dict[str, Tuple[int, float]] = {}  # guarded-by: _sliceset_lock
        self._dcn_retired: Tuple[int, float] = (0, 0.0)  # guarded-by: _sliceset_lock
        self.dcn_bytes_total = 0
        self.dcn_collective_ms_total = 0.0
        # stateful recovery plane (docs/fault_tolerance.md "Checkpoint
        # semantics"): restore info riding each (re)creation, staged
        # gang generations awaiting the two-phase commit, and the
        # checkpoint gauges' counters
        self._pending_restore: Dict[ActorID, dict] = {}  # guarded-by: _actor_lock
        # gang -> gen -> {actor_id: saved-info}; partial generations
        # are discarded on gang abort/restart
        self._gang_ckpt_stage: Dict[  # guarded-by: _gang_lock
            str, Dict[int, Dict[ActorID, dict]]] = {}
        self.num_ckpt_saved = 0       # committed generations (per actor)
        self.num_ckpt_restored = 0    # successful restores at creation
        self.num_ckpt_discarded = 0   # torn/uncommitted/partial drops
        self.ckpt_bytes_total = 0     # bytes across committed saves
        self.last_restore_ms = 0.0
        self.num_node_drains = 0      # completed drain-before-terminate
        self.node_group._actor_ckpt_cb = self._on_actor_ckpt_saved
        self.node_group._actor_restore_cb = self._on_actor_restore_info
        self._actor_flush_wake = threading.Event()
        self._actor_flusher = threading.Thread(
            target=self._actor_flush_loop, daemon=True,
            name="rtpu-actor-flush")
        self._actor_flusher.start()

        from ray_tpu_torch._private.stats import install_runtime_metrics
        install_runtime_metrics()
        self._install_node_metrics()
        self._register_nested_handlers()

        # Per-node agent log plane: tail local worker stdout/stderr
        # files + every remote raylet's read_logs RPC to the driver
        # console (reference: log_monitor.py, log_to_driver).
        self._log_monitor = None
        if cfg.log_to_driver:
            from ray_tpu_torch._private.log_monitor import LogMonitor
            self._log_monitor = LogMonitor.for_session(
                self.session, self._remote_log_sources)

        if self._join_address is not None:
            self._attach_cluster_nodes()

        prestart = cfg.worker_pool_prestart
        if prestart:
            raylet = self.node_group._raylets[self.node_group.head_node_id]
            raylet.worker_pool.prestart(prestart)

        self._shutdown = False

    # ------------------------------------------------------------------
    # cluster join (init(address=...))

    def _attach_cluster_nodes(self) -> None:
        """Attach every raylet registered in the cluster's GCS as a
        remote node, and track membership changes via the NODE feed."""
        def on_node_event(msg):
            kind, payload = msg
            try:
                if kind == "ADDED":
                    self._maybe_attach_node(payload)
                elif kind == "REMOVED":
                    self.node_group._on_remote_node_lost(payload)
            except Exception:
                logger.exception("node event handling failed")

        self.gcs.publisher.subscribe("NODE", on_node_event)
        for info in self.gcs.get_all_node_info():
            self._maybe_attach_node(info)

    def _maybe_attach_node(self, info) -> None:
        if (not info.alive or info.rpc_addr is None
                or info.node_id == self.node_group.head_node_id):
            return
        with self.node_group._lock:
            if info.node_id in self.node_group._remote_nodes:
                return
        total = dict(info.resources_total)
        self.node_group.add_remote_node(
            info.node_id, info.rpc_addr,
            NodeResources(total=dict(total), available=dict(total),
                          labels=dict(info.labels)))
        logger.info("attached cluster node %s at %s",
                    info.node_id.hex()[:8], info.rpc_addr)

    # ------------------------------------------------------------------
    # counters / ids

    def next_task_id(self) -> TaskID:
        return TaskID.for_normal_task(self.job_id)

    def next_put_id(self) -> ObjectID:
        with self._counter_lock:
            self._put_index += 1
            return ObjectID.for_put(self.driver_task_id, self._put_index)

    # ------------------------------------------------------------------
    # function registry

    def register_function(self, fn) -> FunctionDescriptor:
        blob = cloudpickle.dumps(fn)
        fid = hashlib.sha1(blob).digest()
        with self._functions_lock:
            self._functions.setdefault(fid, blob)
        return FunctionDescriptor(
            function_id=fid,
            module=getattr(fn, "__module__", "") or "",
            name=getattr(fn, "__qualname__", repr(fn)))

    def _get_function_blob(self, fid: bytes) -> bytes:
        with self._functions_lock:
            return self._functions[fid]

    # ------------------------------------------------------------------
    # object plane

    def put(self, value: Any) -> ObjectRef:
        oid = self.next_put_id()
        self._put_value(oid, value)
        self.reference_counter.add_owned_object(oid)
        return ObjectRef(oid)

    def _put_value(self, oid: ObjectID, value: Any) -> None:
        cfg = get_config()
        from ray_tpu_torch._private.device_object import is_device_value
        if is_device_value(value):
            # Device tier: the tensor stays where it lives; same-process
            # consumers get the identical object back. A host copy is
            # materialized only when another process needs the bytes
            # (_ensure_host_copy).
            self.device_store.put(oid, value)
            self._store_result(oid, Entry("device", None))
            return
        ser = self.serde.serialize(value)
        contained = tuple(ser.contained_refs)
        size = ser.size_with_header()
        if size <= cfg.max_direct_call_object_size:
            entry = Entry("blob", ser.to_bytes(), contained)
        else:
            buf = self.shm_store.create(oid, size)
            ser.write_into(buf)
            self.shm_store.seal(oid)
            from ray_tpu_torch._private.object_store import _segment_name
            entry = Entry("shm", (_segment_name(self.session, oid), size),
                          contained)
        self._store_result(oid, entry)

    def _store_result(self, oid: ObjectID, entry: Entry) -> None:
        if entry.kind == "blob" and not entry.contained:
            # Hot path (small inline result, no captured refs): skip
            # the shm-adoption probe and the containment bookkeeping.
            self.memory_store.put(oid, entry)
            with self._ready_cb_lock:
                cbs = self._ready_callbacks.pop(oid, None)
            for cb in cbs or ():
                try:
                    cb(oid)
                except Exception:
                    logger.exception("object-ready callback failed")
            self.node_group.on_object_available(oid)
            self._flush_actor_queues()
            return
        if entry.kind == "shm" and not self.shm_store.contains(oid):
            # result written by a worker process: adopt the segment
            try:
                self.shm_store.adopt(oid, entry.data[1])
            except FileNotFoundError:
                logger.warning("shm segment for %s vanished", oid)
        if entry.contained:
            driver_children = []
            for c in entry.contained:
                if isinstance(c, ObjectID):
                    driver_children.append(c)
                elif isinstance(c, ObjectRef):
                    if c.owner_addr() is None:
                        driver_children.append(c.id())
                    # worker-owned child: pinned by the live ref object
                    # the entry holds (its death releases the borrow)
                else:
                    driver_children.append(ObjectID(c))
            if driver_children:
                self.reference_counter.add_contained(oid, driver_children)
        self.memory_store.put(oid, entry)
        # Always under the lock (no unlocked emptiness fast-path): a
        # concurrent on_object_ready() registration that saw the store
        # pre-put must not slip past this pop, or its callback would
        # never fire.
        with self._ready_cb_lock:
            cbs = self._ready_callbacks.pop(oid, None)
        for cb in cbs or ():
            try:
                cb(oid)
            except Exception:
                logger.exception("object-ready callback failed")
        self.node_group.on_object_available(oid)
        self._flush_actor_queues()

    def _remote_log_sources(self):
        """[(node_hex, rpc_client)] for every live remote raylet."""
        out = []
        with self.node_group._lock:
            handles = list(self.node_group._remote_nodes.items())
        for node_id, handle in handles:
            if handle.alive:
                out.append((node_id.hex(), handle.client))
        return out

    def _install_node_metrics(self) -> None:
        """Per-node Prometheus series (reference: per-node metrics agent
        feeding one scrape endpoint): resource totals/availability from
        the scheduler ledger + raylet heartbeat stats, refreshed at
        scrape time via a registry collector."""
        from ray_tpu_torch.util import metrics
        from ray_tpu_torch._private.stats import node_reporter_gauges
        avail_g, total_g, stat_g, rss_g = node_reporter_gauges()

        def collect():
            if self._shutdown:
                return
            from ray_tpu_torch._private.profiling import (process_rss_bytes,
                                                    worker_rss_map)
            # Rebuild from live state each scrape: dead nodes' series
            # vanish instead of exporting their last values forever.
            avail_g.clear()
            total_g.clear()
            stat_g.clear()
            rss_g.clear()
            for nid, res in self.node_group.cluster_resources.nodes():
                node = nid.hex()[:12]
                for k, v in res.total.items():
                    total_g.set(v, tags={"node": node, "resource": k})
                for k, v in res.available.items():
                    avail_g.set(v, tags={"node": node, "resource": k})
            head = self.node_group.head_node_id
            head_hex = head.hex()[:12]
            store = self.shm_store.stats()
            head_rss = {}
            raylet = self.node_group._raylets.get(head)
            if raylet is not None:
                head_rss = worker_rss_map(raylet.worker_pool)
            heads = {
                "queued_tasks": len(self.node_group._to_schedule),
                "running_tasks": len(self.node_group._running),
                "actors": len(self.node_group._actor_workers),
                # unplaceable-class ledger size (capacity fence,
                # docs/scheduler.md) — the head's heartbeat-analog stat
                "unplaceable": self.node_group.unplaceable_size(),
                "store_used_bytes": store["used_bytes"],
                "store_num_objects": store["num_objects"],
                "workers_rss_bytes": sum(head_rss.values()),
            }
            for k, v in heads.items():
                stat_g.set(float(v),
                           tags={"node": head_hex, "stat": k})
            for whex, rss in head_rss.items():
                rss_g.set(float(rss), tags={"node": head_hex,
                                            "worker": whex})
            rss_g.set(float(process_rss_bytes()),
                      tags={"node": head_hex, "worker": "driver"})
            stale = 3 * get_config().health_check_period_ms / 1000.0
            now = time.time()
            for nid, (ts, stats) in list(self.node_stats.items()):
                if now - ts > stale:
                    self.node_stats.pop(nid, None)   # stopped beating
                    continue
                for k, v in stats.items():
                    if isinstance(v, dict):
                        if k == "worker_rss":
                            for whex, rss in v.items():
                                rss_g.set(float(rss),
                                          tags={"node": nid.hex()[:12],
                                                "worker": whex})
                        continue
                    stat_g.set(float(v), tags={"node": nid.hex()[:12],
                                               "stat": k})

        metrics.register_collector(collect)
        self._node_metrics_collector = collect

    def _on_resource_report(self, message) -> None:
        try:
            node_id, available = message[0], message[1]
            stats = message[2] if len(message) > 2 else None
            self.node_reports[node_id] = (time.time(), dict(available))
            if stats:
                self.node_stats[node_id] = (time.time(), dict(stats))
            if node_id != self.node_group.head_node_id:
                self.node_group.cluster_resources.apply_report(
                    node_id, available)
        except Exception:
            logger.exception("resource report handling failed")

    def on_object_ready(self, oid: ObjectID, callback) -> None:
        """Invoke ``callback(oid)`` once the object is in the owner's
        directory (immediately if already there). Callbacks run inline
        on the completion path — keep them cheap and non-blocking."""
        with self._ready_cb_lock:
            if not self.memory_store.contains(oid):
                self._ready_callbacks.setdefault(oid, []).append(callback)
                return
        callback(oid)

    def discard_object_ready(self, oid: ObjectID, callback) -> None:
        """Withdraw a pending ``on_object_ready`` registration (no-op
        if it already fired or was never made). Lets a caller that
        races readiness against another signal — e.g. the HTTP
        ingress waiting on a stream item OR the generator's done
        marker — drop the loser's hook instead of leaking it for an
        object that will never be produced."""
        with self._ready_cb_lock:
            cbs = self._ready_callbacks.get(oid)
            if not cbs:
                return
            try:
                cbs.remove(callback)
            except ValueError:
                return
            if not cbs:
                del self._ready_callbacks[oid]

    def _on_ref_zero(self, oid: ObjectID) -> None:
        # Pop-and-inspect: inline (blob/err) entries — the common case
        # for small task results — have no shm segment and no device
        # residence, so the two extra store locks are skipped. An
        # unknown or storage-backed entry takes the full sweep.
        entry = self.memory_store.pop(oid)
        kind = getattr(entry, "kind", None)
        if kind not in ("blob", "err"):
            self.shm_store.free(oid)
            self.device_store.free(oid)
        self.task_manager.release_lineage(oid)

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        owned = self._resolve_owned(refs, deadline)
        # Fast pre-pass: one lock acquisition snapshots every already-
        # completed entry, so a wave's get() doesn't pay a condition-
        # variable round trip per ref (only stragglers block below).
        ready = self.memory_store.get_ready(
            [r.id() for r in refs if r.owner_addr() is None])
        out: List[Any] = []
        for i, ref in enumerate(refs):
            if ref.owner_addr() is not None:
                out.append(owned[i])
                continue
            first = ready.get(ref.id())
            if first is not None:
                try:
                    out.append(self._entry_value(ref.id(), first))
                    continue
                except _LostObjectSignal:
                    if not self._recover_object(ref.id()):
                        raise ObjectLostError(
                            f"object {ref.id()} was lost and cannot be "
                            "reconstructed (no lineage retained or "
                            "reconstruction budget exhausted)") from None
            while True:
                remaining = None
                if deadline is not None:
                    remaining = max(0.0, deadline - time.monotonic())
                try:
                    entry: Entry = self.memory_store.get(ref.id(), remaining)
                except TimeoutError:
                    raise GetTimeoutError(
                        f"get() timed out waiting for {ref}") from None
                try:
                    out.append(self._entry_value(ref.id(), entry))
                    break
                except _LostObjectSignal:
                    # Backing storage vanished under the directory
                    # entry: re-execute the creating task from lineage
                    # (reference: object_recovery_manager.cc) and wait
                    # for the fresh copy.
                    if not self._recover_object(ref.id()):
                        raise ObjectLostError(
                            f"object {ref.id()} was lost and cannot be "
                            "reconstructed (no lineage retained or "
                            "reconstruction budget exhausted)") from None
        return out

    def _resolve_owned(self, refs: Sequence[ObjectRef],
                       deadline: Optional[float]) -> Dict[int, Any]:
        """Resolve the worker-owned refs in ``refs`` (by index) — ONE
        batched round trip per owner, shared deadline across owners:
        the decentralized-ownership data path."""
        from collections import defaultdict
        from ray_tpu_torch._private import worker_core
        by_owner: Dict[tuple, List[int]] = defaultdict(list)
        for i, ref in enumerate(refs):
            if ref.owner_addr() is not None:
                by_owner[ref.owner_addr()].append(i)
        out: Dict[int, Any] = {}
        for owner, idxs in by_owner.items():
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.monotonic())
            try:
                values = worker_core.fetch_values_from_owner(
                    owner, [refs[i].id() for i in idxs], remaining)
            except TimeoutError:
                raise GetTimeoutError(
                    "get() timed out waiting for worker-owned "
                    f"objects at {owner}") from None
            out.update(zip(idxs, values))
        return out

    def _entry_value(self, oid: ObjectID, entry: Entry) -> Any:
        has, val = entry.cached_value()
        if has:
            if entry.kind == "err":
                raise val.as_instanceof_cause() if isinstance(val, TaskError) \
                    else val
            return val
        if entry.kind == "err":
            err, _ = self.serde.deserialize_from_blob(memoryview(entry.data))
            entry.cache_value(err)
            raise err.as_instanceof_cause() if isinstance(err, TaskError) \
                else err
        if entry.kind == "blob":
            value, _ = self.serde.deserialize_from_blob(memoryview(entry.data))
        elif entry.kind == "device":
            value = self.device_store.get(oid)
            if value is None:
                raise _LostObjectSignal(oid)
        elif entry.kind == "remote":
            # Pull from the holding node into the local store (the
            # entry mutates to shm), then read zero-copy.
            if not self.node_group._localize_remote_entry(oid, entry):
                raise _LostObjectSignal(oid)
            blob = self.shm_store.get_local(oid)
            if blob is None:
                raise _LostObjectSignal(oid)
            value, _ = self.serde.deserialize_from_blob(blob)
        else:  # shm
            blob = self.shm_store.get_local(oid)
            if blob is None:
                raise _LostObjectSignal(oid)
            value, _ = self.serde.deserialize_from_blob(blob)
        entry.cache_value(value)
        return value

    def _ensure_host_copy(self, oid: ObjectID) -> Optional[tuple]:
        """(segment_name, size) of a host copy of a device object,
        materializing it (device->host gather + shm write) on first
        demand. The device copy stays primary. None if the object is gone.
        """
        info = self.shm_store.segment_for(oid)
        if info is not None:
            return info
        arr = self.device_store.get(oid)
        if arr is None:
            return None
        ser = self.serde.serialize(arr.detach().cpu())
        size = ser.size_with_header()
        try:
            buf = self.shm_store.create(oid, size)
        except ValueError:      # raced: another thread spilled it
            return self.shm_store.segment_for(oid)
        ser.write_into(buf)
        self.shm_store.seal(oid)
        self.device_store.num_spilled_to_host += 1
        return self.shm_store.segment_for(oid)

    # -- nested API served to in-task workers ---------------------------
    #
    # Workers are executors, but user code inside a task may call the
    # public API (nested tasks, get, put, wait). Those calls ride an
    # RPC channel from the worker back to this owner (reference: every
    # Ray worker embeds a full CoreWorker; here the owner serves the
    # core API surface to its workers — ownership of every object and
    # task stays with the driver, so lineage/refcounting stay simple).

    def _register_nested_handlers(self) -> None:
        s = self.node_group.object_server
        s.register("nested_submit", self._nested_submit)
        s.register("nested_get", self._nested_get)
        s.register("nested_function_blob",
                   lambda ctx, fid: self._get_function_blob(fid))
        s.register("nested_put", self._nested_put)
        s.register("nested_wait", self._nested_wait)
        s.register("nested_create_actor", self._nested_create_actor)
        s.register("nested_actor_task", self._nested_actor_task)
        s.register("nested_kill_actor", self._nested_kill_actor)
        s.register("nested_cancel", self._nested_cancel)
        s.register("nested_named_actor", self._nested_named_actor)
        s.register("nested_cluster_resources",
                   lambda ctx: self.cluster_resources())
        s.register("nested_available_resources",
                   lambda ctx: self.available_resources())
        s.register("nested_create_pg",
                   lambda ctx, b, bundles, strat, name:
                   self.create_placement_group(
                       PlacementGroupID(b), bundles, strat, name)
                   and None)
        s.register("nested_remove_pg",
                   lambda ctx, b: self.remove_placement_group(
                       PlacementGroupID(b)))
        s.register("nested_pg_ready", self._nested_pg_ready)
        s.register("nested_pg_info", self._nested_pg_info)
        s.register("nested_pg_table",
                   lambda ctx: self.pg_manager.table())

    def _nested_pg_ready(self, ctx, pg_id_b: bytes) -> bytes:
        ref = self.pg_ready_ref(PlacementGroupID(pg_id_b))
        self.reference_counter.add_local_reference(ref.id())
        return ref.binary()

    def _nested_pg_info(self, ctx, pg_id_b: bytes):
        info = self.pg_manager.get(PlacementGroupID(pg_id_b))
        if info is None:
            return None
        return (info.state, [dict(b) for b in info.bundles])

    def _deser_nested_args(self, arg_descs, kwargs_keys):
        """Worker-shipped (value-blob | ref) descriptors -> live args."""
        vals = []
        for d in arg_descs:
            if d[0] == "v":
                v, _ = self.serde.deserialize_from_blob(memoryview(d[1]))
                vals.append(v)
            elif d[0] == "ro":
                vals.append(ObjectRef(ObjectID(d[1]),
                                      owner_addr=tuple(d[2]),
                                      _count=False))
            else:
                vals.append(ObjectRef(ObjectID(d[1]), _count=False))
        if kwargs_keys:
            n = len(kwargs_keys)
            return tuple(vals[:-n]), dict(zip(kwargs_keys, vals[-n:]))
        return tuple(vals), {}

    def _nested_create_actor(self, ctx, fid: bytes, fn_blob,
                             class_name: str, arg_descs, kwargs_keys,
                             options_dict, method_names=(),
                             is_async: bool = False) -> bytes:
        if fn_blob is not None:
            with self._functions_lock:
                self._functions.setdefault(fid, fn_blob)
        args, kwargs = self._deser_nested_args(arg_descs, kwargs_keys)
        descriptor = FunctionDescriptor(function_id=fid, module="",
                                        name=class_name)
        actor_id = self.create_actor(descriptor, args, kwargs,
                                     TaskOptions(**options_dict),
                                     class_name,
                                     method_names=tuple(method_names),
                                     is_async=bool(is_async))
        return actor_id.binary()

    def _nested_actor_task(self, ctx, actor_id_b: bytes, method: str,
                           arg_descs, kwargs_keys, options_dict
                           ) -> List[bytes]:
        args, kwargs = self._deser_nested_args(arg_descs, kwargs_keys)
        refs = self.submit_actor_task(
            ActorID(actor_id_b), method, args, kwargs,
            TaskOptions(**options_dict))
        out = []
        for ref in refs:
            self.reference_counter.add_local_reference(ref.id())
            out.append(ref.binary())
        return out

    def _nested_kill_actor(self, ctx, actor_id_b: bytes) -> None:
        self.kill_actor(ActorID(actor_id_b))

    def _nested_cancel(self, ctx, oid_b: bytes, force: bool) -> None:
        self.cancel_task(ObjectRef(ObjectID(oid_b), _count=False),
                         force=bool(force))

    def _nested_named_actor(self, ctx, name: str, namespace: str):
        return self.gcs.get_named_actor(name, namespace)

    def _check_nested_intake(self) -> None:
        """Bounded nested-submission intake (owner_max_pending_tasks):
        a worker fanning out children without bound is shed with a
        typed BackpressureError — the in-worker client retries with
        backoff, so a saturated owner costs latency, never results.

        The bound applies to the QUEUED backlog (unfinished minus
        currently-executing): counting executing tasks would wedge —
        N blocked parents at the bound could never submit the children
        they are waiting on, and the count would never drain."""
        bound = get_config().owner_max_pending_tasks
        if bound <= 0:
            return
        with self.node_group._lock:
            executing = len(self.node_group._running)
        pending = max(0, self.task_manager.num_unfinished - executing)
        if pending >= bound:
            from ray_tpu_torch.exceptions import BackpressureError
            self.num_nested_shed += 1
            base = get_config().backpressure_retry_base_ms / 1000.0
            raise BackpressureError(
                f"owner intake full ({pending} unfinished tasks >= "
                f"{bound}); retry later", retryable=True,
                backoff_s=base)

    def _nested_submit(self, ctx, fid: bytes, fn_blob, fn_name: str,
                       arg_descs, kwargs_keys, options_dict) -> List[bytes]:
        # Cache the function blob BEFORE the intake check (mirrors the
        # raylet's _admit_payload): the nested client ships a blob only
        # once, so shedding the carrying submit past its deadline must
        # not strand every later call of this function blob-less.
        if fn_blob is not None:
            with self._functions_lock:
                self._functions.setdefault(fid, fn_blob)
        self._check_nested_intake()
        descriptor = FunctionDescriptor(function_id=fid, module="",
                                        name=fn_name)
        spec_args: List[TaskArg] = []
        for d in arg_descs:
            if d[0] == "v":
                spec_args.append(TaskArg.by_value(d[1]))
            elif d[0] == "ro":
                # Worker-owned arg: pin at the owner for the task's
                # lifetime (released by the owned-arg release hook).
                from ray_tpu_torch._private import worker_core
                oid, owner = ObjectID(d[1]), tuple(d[2])
                worker_core.register_borrow(owner, oid)
                spec_args.append(TaskArg.by_owned_ref(oid, owner))
            else:
                oid = ObjectID(d[1])
                spec_args.append(TaskArg.by_ref(oid))
                self.reference_counter.add_task_argument(oid)
        opts = TaskOptions(**options_dict)
        refs = self.submit_spec(descriptor, spec_args, list(kwargs_keys),
                                opts)
        out = []
        for ref in refs:
            # Pin on behalf of the borrowing worker (nested borrows are
            # not individually tracked; released at job end).
            self.reference_counter.add_local_reference(ref.id())
            out.append(ref.binary())
        return out

    def _entry_blob(self, oid: ObjectID, entry: Entry):
        """Entry -> ("val"|"err", serialized bytes) for shipping to a
        worker (no driver-side deserialization)."""
        if entry.kind == "err":
            return ("err", entry.data)
        if entry.kind == "blob":
            return ("val", entry.data)
        if entry.kind == "device":
            if self._ensure_host_copy(oid) is None:
                raise _LostObjectSignal(oid)
        elif entry.kind == "remote":
            if not self.node_group._localize_remote_entry(oid, entry):
                raise _LostObjectSignal(oid)
        view = self.shm_store.get_local(oid)
        if view is None:
            raise _LostObjectSignal(oid)
        return ("val", bytes(view))

    def _nested_get(self, ctx, task_id_b: bytes, oid_bytes_list,
                    timeout):
        release = self._release_blocked_parent(task_id_b)
        try:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            out = []
            for ob in oid_bytes_list:
                oid = ObjectID(ob)
                while True:
                    remaining = None
                    if deadline is not None:
                        remaining = max(0.0, deadline - time.monotonic())
                    try:
                        entry = self.memory_store.get(oid, remaining)
                    except TimeoutError:
                        return ("timeout", None)
                    try:
                        out.append(self._entry_blob(oid, entry))
                        break
                    except _LostObjectSignal:
                        if not self._recover_object(oid):
                            err = ObjectLostError(
                                f"object {oid} was lost and cannot be "
                                "reconstructed")
                            out.append(("err",
                                        self.serde.serialize(err)
                                        .to_bytes()))
                            break
            return ("ok", out)
        finally:
            release()

    def _nested_put(self, ctx, blob: bytes) -> bytes:
        cfg = get_config()
        oid = self.next_put_id()
        if len(blob) <= cfg.max_direct_call_object_size:
            entry = Entry("blob", blob)
        else:
            self.shm_store.put_blob(oid, bytes(blob))
            from ray_tpu_torch._private.object_store import _segment_name
            entry = Entry("shm",
                          (_segment_name(self.session, oid), len(blob)))
        self.reference_counter.add_owned_object(oid)
        self.reference_counter.add_local_reference(oid)   # worker pin
        self._store_result(oid, entry)
        return oid.binary()

    def _nested_wait(self, ctx, task_id_b: bytes, oid_bytes_list,
                     num_returns, timeout):
        ids = [ObjectID(b) for b in oid_bytes_list]
        # Like nested_get: a parent blocked in wait() must lend its CPU
        # or a child it waits on (e.g. a streaming generator launched
        # from the task) can deadlock at pool capacity.
        release = self._release_blocked_parent(task_id_b)
        try:
            ready, _ = self.memory_store.wait(ids, num_returns, timeout)
        finally:
            release()
        return [oid.binary() for oid in ready]

    def _release_blocked_parent(self, task_id_b: bytes):
        """A parent task blocking on get() releases its CPU allocation
        and lends its node one extra worker slot, so child tasks can run
        even at pool capacity (the reference's CPU-release-while-blocked
        deadlock avoidance). Only the CPU slice is released: accelerator
        and custom resources stay held because the blocked task's device
        memory (HBM) is still occupied. The returned restore callback
        re-acquires the CPU and retracts the lent slot."""
        if not task_id_b:
            return lambda: None
        ng = self.node_group
        tid = TaskID(task_id_b)
        with ng._lock:
            rt = ng._running.get(tid)
            if rt is None:
                return lambda: None
            cpu_part = {k: v for k, v in rt.resources.items() if k == "CPU"}
            rt.resources = {k: v for k, v in rt.resources.items()
                            if k != "CPU"}
            pg, node_id = rt.pg, rt.node_id
            raylet = ng._raylets.get(node_id)
            handle = ng._remote_nodes.get(node_id)
        if cpu_part:
            ng._free_allocation(node_id, cpu_part, pg)

        def _reacquire():
            if not cpu_part:
                return
            with ng._lock:
                rt2 = ng._running.get(tid)
                if rt2 is None:
                    # Task completed/crashed while blocked: the
                    # completion path already freed its (CPU-less)
                    # allocation — debiting now would leak capacity.
                    return
                merged = dict(rt2.resources)
                for k, v in cpu_part.items():
                    merged[k] = merged.get(k, 0.0) + v
                rt2.resources = merged
            ng.reacquire_allocation(node_id, cpu_part, pg)

        if raylet is not None:
            with ng._lock:
                raylet.worker_pool._max_process += 1
            ng._wake.set()

            def release():
                _reacquire()
                with ng._lock:
                    raylet.worker_pool._max_process -= 1
            return release
        if handle is not None:
            try:
                handle.client.oneway("adjust_pool", 1)
            except Exception:
                pass    # node lost: its pool no longer matters

            def release():
                _reacquire()
                try:
                    handle.client.oneway("adjust_pool", -1)
                except Exception:
                    pass    # node lost: its pool no longer matters
            return release
        return _reacquire

    # -- lineage reconstruction ----------------------------------------

    def _object_live(self, oid: ObjectID) -> bool:
        """Directory entry present AND its backing storage intact."""
        try:
            entry: Entry = self.memory_store.get(oid, timeout=0)
        except TimeoutError:   # freed/purged concurrently
            return False
        if entry.kind == "shm":
            return self.shm_store.contains(oid)
        return True

    def _recover_object(self, oid: ObjectID) -> bool:
        """Lineage reconstruction (reference:
        ``src/ray/core_worker/object_recovery_manager.cc``): re-submit
        the task that created ``oid``, recursively recovering lost
        arguments first. Bounded per task by ``max_retries``. Returns
        True when a recovery (or the original execution) is in flight —
        the caller waits on the store — and False when the object is
        unrecoverable."""
        spec = self.task_manager.lineage_task_for(oid)
        if spec is None or spec.task_type != TaskType.NORMAL_TASK:
            return False
        spec, needs_resubmit = self.task_manager.prepare_reconstruction(oid)
        if spec is None:
            return False
        if not needs_resubmit:
            return True       # already being recomputed; piggyback
        logger.info("reconstructing %s for lost object %s",
                    spec.repr_name(), oid)
        if spec.streaming:
            # Replay the WHOLE generator: the item-index dedup would
            # otherwise skip re-delivering the lost item (progress
            # tracks the highest index ever delivered). Both skip
            # mechanisms must reset — the owner-side progress AND the
            # spec-level skip a previous mid-run retry may have left
            # behind. Re-delivered live items re-store idempotently;
            # their extra owned-count errs on the over-pinned side.
            self._stream_progress.pop(spec.task_id, None)
            spec.stream_skip = 0
        # Purge the stale directory entries so consumers block until
        # the re-execution lands. (The old entries' contained-ref
        # counts are left in place: the fresh result re-registers them,
        # which can over-pin contained objects — safe direction.)
        for roid in spec.return_ids:
            self.memory_store.free(roid)
            self.shm_store.free(roid)
        for dep in spec.dependencies():
            if not self._object_live(dep) and not self._recover_object(dep):
                err = ObjectReconstructionFailedError(
                    f"cannot reconstruct {oid}: argument {dep} of "
                    f"{spec.repr_name()} was lost and is itself "
                    "unrecoverable")
                for roid in spec.return_ids:
                    self._store_error(roid, err)
                return True   # an (error) result is now available
        self.node_group.submit_task(spec)
        return True

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        owned_ready: set = set()
        driver_ids = []
        for r in refs:
            owner = r.owner_addr()
            if owner is None:
                driver_ids.append(r.id())
                continue
            # Worker-owned: ready iff the owner holds it. A dead owner
            # also counts as ready — get() will raise OwnerDiedError,
            # and the reference counts error-resolved refs as ready.
            from ray_tpu_torch._private import worker_core
            try:
                if worker_core.owner_contains(owner, r.id()):
                    owned_ready.add(r.id())
            except Exception:
                owned_ready.add(r.id())
        need = max(0, num_returns - len(owned_ready))
        ready_ids = set()
        if driver_ids:
            got, _ = self.memory_store.wait(driver_ids, need, timeout)
            ready_ids = set(got)
        ready_ids |= owned_ready
        ready, not_ready = [], []
        for r in refs:
            (ready if r.id() in ready_ids and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    # ------------------------------------------------------------------
    # task submission

    def build_args(self, args: tuple, kwargs: dict,
                   spec_args: List[TaskArg]) -> List[str]:
        cfg = get_config()
        kwargs_keys = list(kwargs.keys())
        for value in list(args) + [kwargs[k] for k in kwargs_keys]:
            if isinstance(value, ObjectRef):
                if value.owner_addr() is not None:
                    # Worker-owned ref: pin at the OWNER for the task's
                    # lifetime (released on terminal completion via
                    # TaskManager's owned-arg release hook).
                    from ray_tpu_torch._private import worker_core
                    worker_core.register_borrow(value.owner_addr(),
                                                value.id())
                    spec_args.append(TaskArg.by_owned_ref(
                        value.id(), value.owner_addr()))
                    continue
                spec_args.append(TaskArg.by_ref(value.id()))
                self.reference_counter.add_task_argument(value.id())
                continue
            ser = self.serde.serialize(value)
            size = ser.size_with_header()
            if size <= cfg.max_direct_call_object_size and \
                    not ser.contained_refs:
                spec_args.append(TaskArg.by_value(ser.to_bytes()))
            else:
                # big arg (or ref-carrying): promote to owned object
                oid = self.next_put_id()
                self._put_value(oid, value)
                self.reference_counter.add_owned_object(oid)
                self.reference_counter.add_task_argument(oid)
                # hold a ref until task completes via task_args count;
                # no local ObjectRef needed.
                spec_args.append(TaskArg.by_ref(oid))
        return kwargs_keys

    def submit_task(self, fn_descriptor: FunctionDescriptor, args: tuple,
                    kwargs: dict, options: TaskOptions) -> List[ObjectRef]:
        spec_args: List[TaskArg] = []
        kwargs_keys = self.build_args(args, kwargs, spec_args)
        return self.submit_spec(fn_descriptor, spec_args, kwargs_keys,
                                options)

    def submit_spec(self, fn_descriptor: FunctionDescriptor,
                    spec_args: List[TaskArg], kwargs_keys: List[str],
                    options: TaskOptions) -> List[ObjectRef]:
        cfg = get_config()
        task_id = self.next_task_id()
        streaming = options.num_returns == "streaming"
        num_returns = 1 if streaming else options.num_returns
        return_ids = [ObjectID.from_index(task_id, i + 1)
                      for i in range(num_returns)]
        max_retries = (options.max_retries if options.max_retries is not None
                       else cfg.task_max_retries)
        # The demand dict is a pure function of the options; cache it
        # on the options object (remote_function reuses one TaskOptions
        # per decorated function) so a tight .remote() loop builds it
        # once, not once per call. Nothing mutates spec.resources, so
        # a shallow copy per spec is safe.
        demand = getattr(options, "_demand_cache", None)
        if demand is None:
            demand = options.resource_demand()
            options._demand_cache = demand  # type: ignore[attr-defined]
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.NORMAL_TASK,
            function=fn_descriptor,
            args=spec_args,
            kwargs_keys=kwargs_keys,
            num_returns=num_returns,
            resources=dict(demand),
            max_retries=max_retries,
            retry_exceptions=options.retry_exceptions,
            scheduling_strategy=options.scheduling_strategy,
            name=options.name or fn_descriptor.repr_name(),
            runtime_env=_validate_runtime_env(options.runtime_env),
            streaming=streaming,
            return_ids=return_ids,
        )
        self._apply_pg_strategy(spec, options)
        for oid in return_ids:
            self.reference_counter.add_owned_object(oid)
        self.task_manager.add_pending_task(spec)
        self.node_group.submit_task(spec)
        return [ObjectRef(oid) for oid in return_ids]

    def _on_stream_item(self, task_id: TaskID, results) -> None:
        """An in-flight streaming generator yielded: materialize the
        item into the owner's directory and register it under the
        producing task's lineage (a lost item replays the generator)."""
        kind_map = {"inline": "blob", "shm": "shm", "remote": "remote"}
        for oid_b, kind, data, contained in results:
            oid = ObjectID(oid_b)
            # item N lives at return index N+1 (index 1 = done marker)
            item_no = oid.index() - 1
            prev = self._stream_progress.get(task_id, 0)
            if item_no <= prev:
                continue   # duplicate delivery from a retried attempt
            self._stream_progress[task_id] = item_no
            self.reference_counter.add_owned_object(oid)
            # streamed items carry lineage too: a lost item replays the
            # generator task (see _recover_object's streaming reset)
            self.task_manager.add_stream_lineage(oid, task_id)
            entry = Entry(kind_map[kind], data,
                          tuple(_contained_item(c) for c in contained))
            self._store_result(oid, entry)

    def _apply_pg_strategy(self, spec: TaskSpec, options: TaskOptions
                           ) -> None:
        """Bind the spec to a placement-group bundle (explicit strategy,
        or inherited from a capturing driver-side PG context)."""
        strat = options.scheduling_strategy
        if getattr(strat, "kind", None) == "PLACEMENT_GROUP":
            pg = strat.placement_group
            spec.placement_group_id = pg.id
            spec.placement_group_bundle_index = \
                strat.placement_group_bundle_index
            return
        if strat is None:
            from ray_tpu_torch.util.placement_group import (
                get_current_placement_group)
            pg = get_current_placement_group()
            if pg is not None and pg.capture_child_tasks:
                spec.placement_group_id = pg.id
                spec.placement_group_bundle_index = -1

    def _resubmit(self, spec: TaskSpec) -> None:
        if spec.streaming:
            # Item-index dedup (reference: generator replays skip
            # already-delivered items): resume past the highest item the
            # owner RECEIVED (tracked at delivery — scanning the store
            # would under-count, since consumed items may already have
            # been freed on ref-drop). BEFORE the deferred-retry branch:
            # an OOM-retried generator must resume, not replay.
            spec.stream_skip = self._stream_progress.get(spec.task_id, 0)
        # OOM retries carry an exponential-backoff delay (set by the
        # task manager): park the spec instead of hammering a node
        # that just shed it for memory pressure.
        delay = getattr(spec, "_resubmit_delay_s", 0.0)
        if delay > 0 and spec.task_type == TaskType.NORMAL_TASK:
            spec._resubmit_delay_s = 0.0  # type: ignore[attr-defined]
            self.node_group.submit_task_after(spec, delay)
            return
        if spec.task_type == TaskType.ACTOR_TASK:
            with self._actor_lock:
                queue = self._actor_queues.get(spec.actor_id)
                if queue is None:
                    self._fail_task(spec, ActorDiedError(
                        "actor is dead; cannot retry task"))
                    return
                # Re-queue in per-caller submission order: several
                # in-flight calls failing together (worker death)
                # resubmit one by one, and bare appendleft would
                # reverse them. Insert by sequence_number so the
                # replayed batch flushes in its original order.
                pos = 0
                while (pos < len(queue)
                       and queue[pos].sequence_number
                       < spec.sequence_number):
                    pos += 1
                queue.insert(pos, spec)
            self._flush_actor_queues()
        else:
            self.node_group.submit_task(spec)

    def _fail_task(self, spec: TaskSpec, err: BaseException) -> None:
        from ray_tpu_torch.exceptions import RayTpuError
        blob = self.serde.serialize(
            err if isinstance(err, RayTpuError)
            else TaskError(err, spec.repr_name(), str(err))).to_bytes()
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            # No return refs: fail through task completion so the actor
            # transitions to DEAD and its queued calls error out.
            self._complete_task(spec.task_id, [], blob, None)
            return
        for oid in spec.return_ids:
            self._store_result(oid, Entry("err", blob))
        # Out-of-band terminal failure: transition the record too, or
        # num_unfinished (the nested-intake signal) leaks one forever.
        self.task_manager.mark_failed_external(spec.task_id)

    def _complete_task(self, task_id: TaskID, results, err_blob,
                       system_error, timings: Optional[dict] = None
                       ) -> None:
        rec = self.task_manager.get_record(task_id)
        spec = rec.spec if rec else None
        if spec is not None:
            from ray_tpu_torch._private import events
            if events.active():
                ok = err_blob is None and system_error is None
                events.record(task_id.hex(), spec.repr_name(),
                              "FINISHED" if ok else "FAILED",
                              extra=timings)
        if (spec is not None
                and spec.task_type == TaskType.ACTOR_CREATION_TASK):
            self._on_actor_creation_done(spec, err_blob, system_error)
        self.task_manager.complete_task(task_id, results, err_blob,
                                        system_error)
        if spec is not None and spec.streaming:
            rec = self.task_manager.get_record(task_id)
            if rec is not None and rec.status in ("finished", "failed"):
                self._stream_progress.pop(task_id, None)

    # ------------------------------------------------------------------
    # placement groups

    def create_placement_group(self, pg_id, bundles, strategy, name):
        info = self.pg_manager.create(pg_id, bundles, strategy, name)
        self.node_group._wake.set()
        return info

    def remove_placement_group(self, pg_id) -> None:
        created = False
        info = self.pg_manager.get(pg_id)
        if info is not None:
            created = info.state == "CREATED"
        self.pg_manager.remove(pg_id)
        if not created:
            oid = self._pg_ready_refs.get(pg_id)
            if oid is not None and not self.memory_store.contains(oid):
                from ray_tpu_torch.exceptions import PlacementGroupError
                self._store_error(oid, PlacementGroupError(
                    f"placement group {pg_id.hex()[:12]} removed before "
                    "it was scheduled"))
        self.node_group._wake.set()

    def pg_ready_ref(self, pg_id) -> ObjectRef:
        with self._counter_lock:
            oid = self._pg_ready_refs.get(pg_id)
            if oid is None:
                self._put_index += 1
                oid = ObjectID.for_put(self.driver_task_id, self._put_index)
                self._pg_ready_refs[pg_id] = oid
                self.reference_counter.add_owned_object(oid)
        info = self.pg_manager.get(pg_id)
        if info is not None and info.state == "CREATED" \
                and not self.memory_store.contains(oid):
            self._store_pg_ready(pg_id, oid)
        elif (info is None or info.state == "REMOVED") \
                and not self.memory_store.contains(oid):
            from ray_tpu_torch.exceptions import PlacementGroupError
            self._store_error(oid, PlacementGroupError(
                f"placement group {pg_id.hex()[:12]} was removed"))
        return ObjectRef(oid)

    def _on_pg_created(self, info) -> None:
        oid = self._pg_ready_refs.get(info.pg_id)
        if oid is not None and not self.memory_store.contains(oid):
            self._store_pg_ready(info.pg_id, oid)

    def _store_pg_ready(self, pg_id, oid: ObjectID) -> None:
        from ray_tpu_torch.util.placement_group import PlacementGroup
        info = self.pg_manager.get(pg_id)
        handle = PlacementGroup(pg_id,
                                [dict(b) for b in info.bundles])
        self._put_value(oid, handle)

    def _store_error(self, oid: ObjectID, err: BaseException) -> None:
        blob = self.serde.serialize(err).to_bytes()
        self._store_result(oid, Entry("err", blob))

    # ------------------------------------------------------------------
    # actors

    def create_actor(self, fn_descriptor: FunctionDescriptor, args: tuple,
                     kwargs: dict, options: TaskOptions,
                     class_name: str,
                     method_names: tuple = (),
                     is_async: bool = False) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        task_id = self.next_task_id()
        spec_args: List[TaskArg] = []
        kwargs_keys = self.build_args(args, kwargs, spec_args)
        demand = options.resource_demand(default_cpus=1.0)
        max_restarts = (options.max_restarts
                        if options.max_restarts is not None
                        else get_config().actor_max_restarts)
        detached = options.lifetime == "detached"
        if detached and options.scheduling_strategy is None:
            # A detached actor must outlive this driver, so it must not
            # land on the driver's in-process raylet; prefer a
            # persistent (cluster) raylet when one exists.
            target = self.node_group.pick_remote_node(demand)
            if target is not None:
                from ray_tpu_torch.util.scheduling_strategies import (
                    NodeAffinitySchedulingStrategy)
                # HARD affinity: a soft one would fall back to the
                # driver-local raylet under contention, silently
                # breaking the survival contract. Queuing on a busy
                # (but feasible) cluster node is the correct wait.
                options.scheduling_strategy = NodeAffinitySchedulingStrategy(
                    node_id=target.hex(), soft=False)
            elif self._join_address is not None:
                raise ValueError(
                    "detached actor needs a cluster raylet to host it, "
                    "but no remote nodes are attached")
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function=fn_descriptor,
            args=spec_args,
            kwargs_keys=kwargs_keys,
            num_returns=0,
            resources=demand,
            max_retries=0,
            actor_creation_id=actor_id,
            max_restarts=max_restarts,
            max_task_retries=options.max_task_retries,
            max_concurrency=max(1, options.max_concurrency),
            checkpoint_interval=max(0, options.checkpoint_interval),
            lifetime=options.lifetime,
            scheduling_strategy=options.scheduling_strategy,
            name=options.name or class_name,
            runtime_env=_validate_runtime_env(options.runtime_env),
            return_ids=[],
        )
        self._apply_pg_strategy(spec, options)
        info = ActorInfo(
            actor_id=actor_id, name=options.name,
            namespace=options.namespace or "default",
            max_restarts=max_restarts,
            creation_spec=spec, class_name=class_name,
            lifetime=options.lifetime,
            method_names=tuple(method_names),
            is_async=is_async)
        self.gcs.register_actor(info)
        from ray_tpu_torch._private import export
        export.emit("ACTOR", {"actor_id": actor_id.hex(),
                              "state": "REGISTERED",
                              "class_name": class_name})
        with self._actor_lock:
            # unbounded-ok: per-actor ordered call queue, drained by
            # the flusher thread in _ACTOR_FLUSH_BATCH frames; calls
            # enter one public submit_actor_task at a time
            self._actor_queues[actor_id] = deque()
            self._actor_seq[actor_id] = 0
            self._actor_specs[actor_id] = spec
            self._actor_restarts[actor_id] = max_restarts
        self.task_manager.add_pending_task(spec)
        self.node_group.submit_task(spec)
        return actor_id

    def _on_actor_creation_done(self, spec: TaskSpec, err_blob,
                                system_error) -> None:
        actor_id = spec.actor_creation_id
        with self._actor_lock:
            restore = self._pending_restore.pop(actor_id, None)
        if err_blob is None and system_error is None:
            with self._actor_lock:
                tombstoned = actor_id in self._actor_tombstones
            if tombstoned:
                # kill/restart race, kill wins: a creation resubmitted
                # before ray_tpu_torch.kill() landed completed anyway — reap
                # the revived worker and keep the actor DEAD.
                self.node_group.release_actor(actor_id, kill_worker=True)
                self.gcs.update_actor_state(actor_id, "DEAD",
                                            death_cause="killed")
                self._fail_actor_queue(actor_id, None)
                return
            if spec.lifetime == "detached":
                # Publish the hosting raylet so later drivers can
                # route calls to this actor after we exit.
                node_id = self.node_group.actor_node(actor_id)
                if node_id is not None:
                    self.gcs.update_actor_location(actor_id, node_id)
            if restore:
                # Restore-before-replay: trim BEFORE the actor turns
                # ALIVE — the flusher only drains ALIVE actors, so a
                # pre-checkpoint call can never ship before the trim.
                self._apply_restore_info(actor_id, restore)
            self.gcs.update_actor_state(actor_id, "ALIVE")
            from ray_tpu_torch._private import export
            export.emit("ACTOR", {"actor_id": actor_id.hex(),
                                  "state": "ALIVE"})
            self._flush_actor_queues()
        else:
            self.gcs.update_actor_state(actor_id, "DEAD",
                                        death_cause="creation failed")
            from ray_tpu_torch._private import export
            export.emit("ACTOR", {"actor_id": actor_id.hex(),
                                  "state": "DEAD",
                                  "cause": "creation failed"})
            self._fail_actor_queue(actor_id, err_blob)
            self._cleanup_actor_ckpt(actor_id)

    def _ensure_actor_route(self, actor_id: ActorID, info) -> None:
        """Make a detached actor created by ANOTHER driver callable
        from this one: build the remote route from the GCS-recorded
        hosting node and initialize the call queue."""
        with self._actor_lock:
            have_queue = actor_id in self._actor_queues
        if have_queue and self.node_group.actor_worker(actor_id) is not None:
            return
        node_id = getattr(info, "node_id", None)
        if node_id is None:
            return   # locally-created actor mid-creation: normal path
        if not self.node_group.ensure_remote_actor_route(actor_id, node_id):
            from ray_tpu_torch.exceptions import ActorDiedError
            raise ActorDiedError(
                f"actor {info.class_name} is hosted on node "
                f"{node_id.hex()[:8]}, which is not reachable")
        with self._actor_lock:
            # unbounded-ok: same per-actor flusher-drained queue as
            # create_actor's (see there)
            self._actor_queues.setdefault(actor_id, deque())
            self._actor_seq.setdefault(actor_id, 0)
            # Another driver owns restarts; we never restart it.
            self._actor_restarts.setdefault(actor_id, 0)

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict,
                          options: TaskOptions) -> List[ObjectRef]:
        info = self.gcs.get_actor_info(actor_id)
        if info is None:
            raise ValueError(f"unknown actor {actor_id}")
        if actor_id not in self._actor_specs:
            # only actors created by ANOTHER driver (detached lookup)
            # need a route built; our own actors got queue + route at
            # create_actor — skipping the two-lock probe per call
            self._ensure_actor_route(actor_id, info)
        task_id = TaskID.of(actor_id)
        spec_args: List[TaskArg] = []
        kwargs_keys = self.build_args(args, kwargs, spec_args)
        streaming = options.num_returns == "streaming"
        num_returns = 1 if streaming else options.num_returns
        return_ids = [ObjectID.from_index(task_id, i + 1)
                      for i in range(num_returns)]
        with self._actor_lock:
            seq = self._actor_seq[actor_id] = self._actor_seq.get(actor_id,
                                                                  0) + 1
        creation = self._actor_specs.get(actor_id)
        if creation is None:
            # An actor created by another driver (detached): the GCS
            # carries its creation spec — calls need the real function
            # id so the hosting raylet/worker resolve the class.
            creation = getattr(info, "creation_spec", None)
            if creation is not None:
                with self._actor_lock:
                    self._actor_specs.setdefault(actor_id, creation)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_TASK,
            function=creation.function if creation else
            FunctionDescriptor(b"", "", method_name),
            args=spec_args,
            kwargs_keys=kwargs_keys,
            num_returns=num_returns,
            resources={},
            max_retries=(creation.max_task_retries if creation else 0),
            actor_id=actor_id,
            sequence_number=seq,
            name=f"{info.class_name}.{method_name}",
            streaming=streaming,
            return_ids=return_ids,
        )
        spec.method_name = method_name  # type: ignore[attr-defined]
        for oid in return_ids:
            self.reference_counter.add_owned_object(oid)
        self.task_manager.add_pending_task(spec)
        if info.state == "DEAD":
            self._fail_task(spec, ActorDiedError(
                f"actor {info.class_name} is dead: {info.death_cause}"))
        else:
            with self._actor_lock:
                self._actor_queues[actor_id].append(spec)
            self._flush_actor_queues()
        return [ObjectRef(oid) for oid in return_ids]

    def _flush_actor_queues(self) -> None:
        # Signal the flusher thread instead of flushing inline: the
        # submitting thread keeps producing while the flusher drains
        # whatever accumulated (adaptive batching). is_set() first —
        # it is lock-free, and this runs per completion as well as per
        # submission (a redundant set() takes the event lock).
        if not self._actor_flush_wake.is_set():
            self._actor_flush_wake.set()

    def _actor_flush_loop(self) -> None:
        wake = self._actor_flush_wake
        while not getattr(self, "_shutdown", False):
            wake.wait(timeout=0.2)
            if getattr(self, "_shutdown", False):
                return
            wake.clear()
            try:
                with self._actor_lock:
                    actor_ids = [aid for aid, q in
                                 self._actor_queues.items() if q]
                for actor_id in actor_ids:
                    self._flush_one_actor(actor_id)
            except Exception:
                logger.exception("actor flush loop error")

    _ACTOR_FLUSH_BATCH = 256   # max calls per wire frame

    def _flush_one_actor(self, actor_id: ActorID) -> None:
        if self._gang_flush_gated(actor_id):
            # gang restart in flight: queued calls must not reach the
            # member before its re-join call re-forms the group
            return
        info = self.gcs.get_actor_info(actor_id)
        if info is None or info.state != "ALIVE":
            return
        with self._actor_lock:
            flush_lock = self._actor_flush_locks.setdefault(
                actor_id, threading.RLock())
        # Serialize the whole pop+send per actor: without this, two
        # flushers could pop seq N and N+1 and send them out of order.
        # (All flushing runs on the flusher thread; anything appended
        # after this drain re-sets the wake event, so one pass is
        # enough — no retry loop.)
        with flush_lock:
            # blocking-ok: per-actor flush lock exists to hold across
            # the send — pop+ship must be atomic per actor or two
            # flushers reorder seq N and N+1 on the wire
            self._drain_actor_queue(actor_id)

    def _drain_actor_queue(self, actor_id: ActorID) -> None:
        """Pop every dep-ready call (in order) and ship them in ONE
        batched frame per round — the submit half of the batched actor
        wire path. Flush-lock held by the caller."""
        while True:
            if self._gang_flush_gated(actor_id):
                # a gang restart began after the caller's gate check:
                # stop popping so queued calls stay queued (and survive
                # the restart) instead of shipping into the kill window
                return
            batch: List[TaskSpec] = []
            with self._actor_lock:
                queue = self._actor_queues.get(actor_id)
                while queue and len(batch) < self._ACTOR_FLUSH_BATCH:
                    spec = queue[0]
                    deps = spec.dependencies()
                    if deps and not all(self.memory_store.contains(d)
                                        for d in deps):
                        break
                    queue.popleft()
                    batch.append(spec)
            if not batch:
                return
            items: List[Tuple[TaskSpec, dict]] = []
            requeue_from = None
            for i, spec in enumerate(batch):
                try:
                    payload, dep_err = self._build_actor_payload(spec)
                except _LostObjectSignal as sig:
                    lost_oid = sig.args[0]
                    if self._recover_object(lost_oid):
                        # requeue this call AND everything behind it (in
                        # order) behind the reconstruction; the purged
                        # entry keeps the dependency check unsatisfied
                        requeue_from = i
                        break
                    self._fail_task(spec, ObjectLostError(
                        f"argument {lost_oid} of {spec.repr_name()} was "
                        "lost and cannot be reconstructed"))
                    continue
                if dep_err is not None:
                    self.task_manager.complete_task(spec.task_id, [],
                                                    dep_err, None)
                    continue
                items.append((spec, payload))
            leftovers: List[TaskSpec] = []
            if items:
                for spec, _p in items:
                    self.task_manager.mark_running(spec.task_id)
                n = self.node_group.submit_actor_task_batch(actor_id,
                                                            items)
                if n < len(items):
                    leftovers.extend(s for s, _p in items[n:])
            if requeue_from is not None:
                leftovers.extend(batch[requeue_from:])
            if leftovers:
                # put back at the FRONT in submission order; a later
                # flush (worker ready / object reconstructed) retries
                with self._actor_lock:
                    q = self._actor_queues.get(actor_id)
                    if q is not None:
                        q.extendleft(reversed(leftovers))
                return

    def _build_actor_payload(self, spec: TaskSpec):
        arg_descs = []
        from ray_tpu_torch._private.device_object import device_arg_desc
        in_process = getattr(self.node_group.actor_worker(spec.actor_id),
                             "kind", None) == "in_process"
        for arg in spec.args:
            if arg.object_id is None:
                arg_descs.append(("v", arg.inline_blob))
                continue
            if arg.owner_addr is not None:
                arg_descs.append(("owned", arg.object_id.binary(),
                                  tuple(arg.owner_addr)))
                continue
            try:
                entry: Entry = self.memory_store.get(arg.object_id, timeout=0)
            except TimeoutError:
                # Purged by a concurrent reconstruction: route through
                # the lost-object recovery path.
                raise _LostObjectSignal(arg.object_id) from None
            if entry.kind == "err":
                return None, entry.data
            if entry.kind == "blob":
                arg_descs.append(("v", entry.data))
            elif entry.kind == "device":
                desc = device_arg_desc(arg.object_id, in_process,
                                       self._ensure_host_copy)
                if desc is None:
                    raise _LostObjectSignal(arg.object_id)
                arg_descs.append(desc)
            elif entry.kind == "remote":
                # Resolved per destination by the node manager (pull
                # descriptor for remote actors, localization for
                # driver-process actors).
                node_id, size = entry.data
                arg_descs.append(
                    ("remote", arg.object_id.binary(), node_id, size))
            else:
                if not self.shm_store.contains(arg.object_id):
                    raise _LostObjectSignal(arg.object_id)
                name, size = entry.data
                arg_descs.append(
                    ("shm", arg.object_id.binary(), name, size))
        payload = {
            "type": "exec_actor",
            "task_id": spec.task_id.binary(),
            "actor_id": spec.actor_id.binary(),
            # per-caller submission sequence: the checkpoint cursor
            # records the highest executed seq, so post-restore replay
            # can be trimmed to calls after the snapshot
            "seq": spec.sequence_number,
            "method": getattr(spec, "method_name", ""),
            "function_id": spec.function.function_id,
            "args": arg_descs,
            "kwargs_keys": spec.kwargs_keys,
            "num_returns": spec.num_returns,
            "return_ids": [o.binary() for o in spec.return_ids],
            "name": spec.repr_name(),
            "runtime_env": spec.runtime_env,
            "owner_addr": self.node_group.object_server_addr,
        }
        if spec.streaming:
            payload["streaming"] = True
            payload["stream_skip"] = spec.stream_skip
        return payload, None

    def _task_cancelled(self, task_id: TaskID) -> bool:
        rec = self.task_manager.get_record(task_id)
        return rec is not None and rec.cancelled

    # -- actor checkpoints (stateful recovery plane; see
    # docs/fault_tolerance.md "Checkpoint semantics") --------------------

    def _on_actor_restore_info(self, actor_id: ActorID,
                               info: dict) -> None:
        """actor_ready carried restore info: park it for the creation
        task's completion hook (which runs the replay trim)."""
        with self._actor_lock:
            self._pending_restore[actor_id] = dict(info)

    def _apply_restore_info(self, actor_id: ActorID, info: dict) -> None:
        """A (re)created actor restored generation ``restored_gen`` at
        replay cursor ``cursor``: account the gauges and trim queued
        replay to calls AFTER the cursor — the restored state already
        includes every call at or below it, so re-executing one would
        double-apply its side effects. Trimmed calls' (lost) results
        surface as errors; in practice the save path sends results
        before the covering checkpoint on the same FIFO channel, so a
        call can only be trimmed when its completion already landed."""
        if int(info.get("restored_gen") or 0) > 0:
            self.num_ckpt_restored += 1
            self.last_restore_ms = float(info.get("restore_ms") or 0.0)
        self.num_ckpt_discarded += int(info.get("discarded") or 0)
        cursor = int(info.get("cursor") or 0)
        if cursor <= 0:
            return
        trimmed: List[TaskSpec] = []
        with self._actor_lock:
            q = self._actor_queues.get(actor_id)
            if q:
                for s in list(q):
                    # seq 0 = gang re-join specs (front-loaded by the
                    # restart coordinator): never trimmed
                    if 0 < s.sequence_number <= cursor:
                        q.remove(s)
                        trimmed.append(s)
        for s in trimmed:
            self._fail_task(s, RuntimeError(
                f"actor call {s.repr_name()} (seq {s.sequence_number}) "
                f"executed before the restored checkpoint (cursor "
                f"{cursor}); its side effects are part of the restored "
                "state, so the replay was trimmed instead of "
                "double-executing it"))

    def _on_actor_ckpt_saved(self, actor_id: ActorID, info: dict) -> None:
        """An executor reported a durably-saved (but uncommitted)
        generation. Solo actors commit immediately; gang members stage
        until EVERY rank has reported the same generation (two-phase
        commit over the gang table) — a mid-checkpoint kill leaves a
        partial stage that is discarded, never a torn restore."""
        gen = int(info.get("gen") or 0)
        with self._gang_lock:
            name = self._actor_gang.get(actor_id)
            rec = self._gangs.get(name) if name is not None else None
            if rec is not None:
                if rec.restarting or rec.dead:
                    # a report from the aborted incarnation (possibly
                    # a PR-2 push replay): staging it would collide
                    # with post-restart generation numbers — the
                    # restore resets each rank's counter to its
                    # committed max, so reused gens must start clean
                    self.num_ckpt_discarded += 1
                    return
                stage = self._gang_ckpt_stage.setdefault(name, {})
                stage.setdefault(gen, {})[actor_id] = dict(info)
                per_gen = stage[gen]
                if any(aid not in per_gen for aid in rec.actor_ids):
                    return          # first phase: wait for the rest
                items = [(aid, per_gen[aid]) for aid in rec.actor_ids]
                # second phase reached: drop this and every OLDER
                # staged generation (superseded partials can never
                # complete once the gang moved past them)
                for g in [g for g in stage if g <= gen]:
                    if g != gen:
                        self.num_ckpt_discarded += len(stage[g])
                    del stage[g]
            else:
                items = [(actor_id, dict(info))]
        self._commit_actor_ckpt(items, gang=name if rec else None)

    def _commit_actor_ckpt(self, items, gang: Optional[str]) -> None:
        """Write COMMIT markers + record the generation in the GCS
        checkpoint table. Runs outside the gang lock (file IO + GCS
        RPC must not gate the actor flusher).

        Gang commits are ALL-OR-NOTHING: if any rank's marker write
        fails, markers already written this pass are rolled back so no
        restore can ever see a generation committed on some ranks and
        not others (the torn-restore case the two-phase design
        exists to rule out)."""
        import json as _json
        from ray_tpu_torch._private import actor_checkpoint as _ackpt
        from ray_tpu_torch._private import chaos, durable
        from ray_tpu_torch._private.gcs import CheckpointInfo
        if chaos.fire("actor", "checkpoint", "commit") == "drop":
            # commit marker never lands: the saved generation stays
            # uncommitted and restore provably discards it
            self.num_ckpt_discarded += len(items)
            return
        written: List[str] = []
        committed = []
        for aid, info in items:
            gen = int(info.get("gen") or 0)
            root = _ackpt.actor_ckpt_dir(self.session, aid.binary())
            marker = _ackpt.commit_marker_path(root, gen)
            try:
                # never commit a generation whose payload is gone (a
                # concurrent restart's discard may have reaped it):
                # the marker write would fabricate an empty
                # "committed" dir via makedirs
                if not os.path.isfile(os.path.join(
                        os.path.dirname(marker), "state.pkl")):
                    raise FileNotFoundError(
                        f"generation payload missing under "
                        f"{os.path.dirname(marker)}")
                durable.atomic_write_bytes(
                    marker,
                    _json.dumps({"gen": gen, "gang": gang,
                                 "ts": time.time()}).encode())
                written.append(marker)
            except Exception:
                logger.exception("checkpoint commit failed for %s "
                                 "gen %d", aid.hex()[:8], gen)
                if gang is not None:
                    # roll the whole gang generation back: a partially
                    # committed generation must not exist
                    for m in written:
                        try:
                            os.unlink(m)
                        except OSError:
                            pass    # rollback is best-effort; restore
                                    # tolerates a marker-only dir too
                    self.num_ckpt_discarded += len(items)
                    return
                self.num_ckpt_discarded += 1
                continue
            committed.append((aid, info, gen, root))
        for aid, info, gen, root in committed:
            try:
                _ackpt.prune_generations(
                    root, get_config().actor_checkpoint_keep)
            except Exception:
                logger.exception("checkpoint prune failed")
            self.num_ckpt_saved += 1
            self.ckpt_bytes_total += int(info.get("bytes") or 0)
            try:
                self.gcs.record_checkpoint(CheckpointInfo(
                    actor_id=aid, gen=gen,
                    cursor=int(info.get("cursor") or 0),
                    size_bytes=int(info.get("bytes") or 0),
                    gang=gang, ts=time.time()))
            except Exception:
                # table record is observability; the durable commit
                # marker is the restore authority and already landed
                logger.exception("checkpoint table record failed")

    def _cleanup_actor_ckpt(self, actor_id: ActorID) -> None:
        """A permanently-DEAD actor can never restore: remove its
        on-disk generations and drop its GCS checkpoint row (mirrors
        destroy_collective_group's rmtree + unregister cleanup). No-op
        for actors that never checkpointed."""
        import shutil as _shutil
        from ray_tpu_torch._private import actor_checkpoint as _ackpt
        root = _ackpt.actor_ckpt_dir(self.session, actor_id.binary())
        if not os.path.isdir(root):
            return
        _shutil.rmtree(root, ignore_errors=True)
        try:
            self.gcs.drop_checkpoint(actor_id)
        except Exception:
            logger.exception("checkpoint table drop failed")

    def _discard_gang_ckpt_stage(self, name: str) -> None:
        """Gang aborted/restarting/dead: every partially-staged
        generation is torn by definition — discard."""
        with self._gang_lock:
            stage = self._gang_ckpt_stage.pop(name, None)
        if stage:
            self.num_ckpt_discarded += sum(
                len(per_gen) for per_gen in stage.values())

    # -- collective gangs (coordinated SPMD restart) ---------------------

    def register_gang(self, name: str, handles: list, ranks: list,
                      world_size: int, backend: str,
                      max_restarts: Optional[int] = None,
                      epoch: int = 1) -> None:
        """Record a collective gang (called by
        ``collective.create_collective_group``): member deaths from
        here on are handled collectively — abort + epoch fence + a
        coordinated kill-and-restart of every member. ``epoch`` starts
        past a reused name's previous incarnation."""
        if max_restarts is None:
            max_restarts = get_config().gang_max_restarts
        actor_ids = [h._actor_id for h in handles]
        rec = _GangRecord(name=name, handles=list(handles),
                          actor_ids=actor_ids, ranks=list(ranks),
                          world_size=world_size, backend=backend,
                          restarts_left=max_restarts, epoch=epoch)
        with self._gang_lock:
            self._gangs[name] = rec
            for aid in actor_ids:
                self._actor_gang[aid] = name
        from ray_tpu_torch._private.gcs import GangInfo
        self.gcs.register_gang(GangInfo(
            name=name, members=tuple(actor_ids), world_size=world_size,
            max_restarts=max_restarts, epoch=epoch))

    def gang_formed(self, name: str) -> None:
        self.gcs.update_gang_state(name, "ALIVE")

    def unregister_gang(self, name: str) -> None:
        with self._gang_lock:
            rec = self._gangs.pop(name, None)
            if rec is not None:
                for aid in rec.actor_ids:
                    if self._actor_gang.get(aid) == name:
                        self._actor_gang.pop(aid, None)
        if rec is not None:
            self._discard_gang_ckpt_stage(name)
            self.gcs.unregister_gang(name)

    def _gang_flush_gated(self, actor_id: ActorID) -> bool:
        with self._gang_lock:
            name = self._actor_gang.get(actor_id)
            rec = self._gangs.get(name) if name is not None else None
            return rec is not None and rec.gated

    # -- slice sets (multi-slice runtime plane; docs/multislice.md) ------

    def register_sliceset(self, name: str, slice_gangs: list,
                          dcn_group: str, world_size: int,
                          dcn_epoch: int = 1) -> None:
        """Record a gang-of-gangs (called by
        ``multislice.SliceSet.create``): from here on, any member
        gang's abort/death fences the DCN tier — abort marker at the
        old DCN epoch + an epoch bump — so surviving slices' in-flight
        DCN waits fail typed in milliseconds and the restarting
        slice's stale DCN rank-files can never satisfy the new
        incarnation."""
        rec = _SliceSetRecord(name=name, slice_gangs=list(slice_gangs),
                              dcn_group=dcn_group,
                              world_size=world_size, dcn_epoch=dcn_epoch)
        with self._sliceset_lock:
            if name in self._slicesets:
                # name reuse without a destroy: the old incarnation's
                # DCN totals retire instead of being clobbered
                self._retire_dcn_entry(name)
            self._slicesets[name] = rec
            for idx, gang in enumerate(rec.slice_gangs):
                self._gang_sliceset[gang] = (name, idx)
        from ray_tpu_torch._private.gcs import SliceSetInfo
        self.gcs.register_sliceset(SliceSetInfo(
            name=name, slice_gangs=tuple(rec.slice_gangs),
            dcn_group=dcn_group, world_size=world_size,
            dcn_epoch=dcn_epoch,
            slice_restarts=(0,) * len(rec.slice_gangs)))

    def _sync_sliceset_epoch(self, name: str,
                             dcn_epoch: Optional[int]) -> None:
        """Fold an externally-advanced DCN epoch into the coordinator's
        record. ``rejoin_dcn`` can re-form PAST an epoch the fence
        never saw (a pure transport abort bumps the group state file
        without any gang event) — a record left behind would make the
        NEXT fence write its abort marker at a dead epoch (survivors
        polling the live epoch would burn the group timeout) and mark
        FORMING at the already-live one (preserving the dead
        incarnation's rank files through cleanup)."""
        if dcn_epoch is None:
            return
        with self._sliceset_lock:
            rec = self._slicesets.get(name)
            if rec is not None and int(dcn_epoch) > rec.dcn_epoch:
                rec.dcn_epoch = int(dcn_epoch)

    def sliceset_formed(self, name: str,
                        dcn_epoch: Optional[int] = None) -> None:
        """The DCN tier (re-)formed: every leader — on first creation
        or, after a fence, restarted and surviving alike — is in the
        group at ``dcn_epoch``. The epoch rides along so a late ALIVE
        racing a NEWER fence is dropped by the table instead of
        un-fencing it, and so the coordinator's own record fences the
        LIVE epoch next time."""
        self._sync_sliceset_epoch(name, dcn_epoch)
        self.gcs.update_sliceset(name, state="ALIVE",
                                 dcn_epoch=dcn_epoch)

    # the post-recovery re-join publishes exactly like formation
    sliceset_reformed = sliceset_formed

    def unregister_sliceset(self, name: str) -> None:
        with self._sliceset_lock:
            rec = self._slicesets.pop(name, None)
            if rec is not None:
                for gang in rec.slice_gangs:
                    if self._gang_sliceset.get(gang, (None,))[0] == name:
                        self._gang_sliceset.pop(gang, None)
                # retire the set's DCN totals: its traffic stays in
                # the cumulative gauges, and a later set REUSING the
                # name starts a fresh per-set entry instead of
                # clobbering this one (gauges must never go backwards)
                self._retire_dcn_entry(name)
        if rec is not None:
            self.gcs.unregister_sliceset(name)

    def _retire_dcn_entry(self, name: str) -> None:  # lock-held: _sliceset_lock
        b, m = self._dcn_stats_by_set.pop(name, (0, 0.0))
        self._dcn_retired = (self._dcn_retired[0] + b,
                             self._dcn_retired[1] + m)

    def record_dcn_stats(self, name: str, bytes_total: int,
                         ms_total: float) -> None:
        """Driver-side DCN observability totals for one sliceset
        (monotonic across leader restarts — the SliceSet accumulates
        deltas); the gauges report retired sets' totals plus the sum
        across every live set."""
        with self._sliceset_lock:
            if name not in self._slicesets:
                # unregistered (destroyed) set: its totals were folded
                # into the retired accumulator already — re-recording
                # them would double-count
                return
            self._dcn_stats_by_set[name] = (int(bytes_total),
                                            float(ms_total))
            self.dcn_bytes_total = self._dcn_retired[0] + sum(
                b for b, _ in self._dcn_stats_by_set.values())
            self.dcn_collective_ms_total = self._dcn_retired[1] + sum(
                m for _, m in self._dcn_stats_by_set.values())

    def _fence_sliceset_dcn(self, gang_name: str,
                            gang_dead: bool) -> None:
        """A slice gang aborted (coordinated restart) or died: fence
        the set's DCN tier NOW. The abort marker at the OLD epoch
        reaches surviving leaders' in-flight DCN waits within
        milliseconds (typed CollectiveAbortError, not the group
        timeout); the epoch bump makes any of the dead incarnation's
        stale DCN rank-files structurally unsatisfiable. Decision
        under ``_sliceset_lock``; filesystem/GCS work outside it
        (same discipline as the gang path — a stalled GCS channel
        must not freeze callers)."""
        with self._sliceset_lock:
            ref = self._gang_sliceset.get(gang_name)
            if ref is None:
                return
            name, slice_idx = ref
            rec = self._slicesets.get(name)
            if rec is None or rec.dead:
                return
            old_epoch = rec.dcn_epoch
            rec.dcn_epoch += 1
            new_epoch = rec.dcn_epoch
            if gang_dead:
                rec.dead = True
        from ray_tpu_torch import collective as _col
        from ray_tpu_torch._private import export
        root = _col.group_root(rec.dcn_group)
        cause = (f"slice {slice_idx} gang {gang_name} "
                 + ("died" if gang_dead else
                    f"restarting; DCN tier re-forms at epoch {new_epoch}"))
        _col.write_abort_marker(root, old_epoch, cause)
        if gang_dead:
            self.gcs.update_sliceset(name, state="DEAD",
                                     death_cause=cause)
        else:
            # publish the bumped epoch before anyone can re-join: the
            # restarting slice's leader reads its DCN epoch from here
            _col.write_group_state(root, new_epoch,
                                   len(rec.slice_gangs), "FORMING")
            self.gcs.update_sliceset(name, state="DEGRADED",
                                     dcn_epoch=new_epoch,
                                     restarted_slice=slice_idx)
        export.emit("SLICESET", {
            "set": name, "slice": slice_idx,
            "state": "DEAD" if gang_dead else "DEGRADED",
            "dcn_epoch": new_epoch})

    def _on_gang_member_death(self, name: str, actor_id: ActorID) -> bool:
        """Collective handling of one member's death. Returns True when
        the gang path owns the event (the individual restart path must
        not also run). The decision is made atomically under
        ``_gang_lock``; the blocking work (GCS RPCs, rendezvous
        filesystem writes, task submission) runs after it is released
        — the lock also gates every actor flush, so a stalled GCS
        channel must not freeze the flusher."""
        from ray_tpu_torch import collective as _col
        from ray_tpu_torch._private import export
        with self._gang_lock:
            rec = self._gangs.get(name)
            if rec is None:
                return False
            with self._actor_lock:
                tombstoned = actor_id in self._actor_tombstones
                creation = self._actor_specs.get(actor_id)
            if rec.restarting and not tombstoned:
                mode = "fold"
            elif (tombstoned or rec.dead or rec.restarts_left == 0
                    or creation is None):
                mode = "dead"
                was_dead = rec.dead
                rec.dead = True
                if not was_dead:
                    self.num_gang_aborts += 1
            else:
                mode = "restart"
                rec.restarting = True
                rec.gated = True
                rec.restarts_left -= 1
                self.num_gang_aborts += 1
                self.num_gang_restarts += 1
            old_epoch = rec.epoch
        if mode == "fold":
            # a coordinated restart is already re-forming this gang:
            # fold the death in (respawn just this member; the watcher
            # keeps waiting for it to come back ALIVE)
            self.gcs.update_actor_state(actor_id, "RESTARTING")
            export.emit("ACTOR", {"actor_id": actor_id.hex(),
                                  "state": "RESTARTING"})
            if creation is not None:
                self.task_manager.add_pending_task(creation)
                self.node_group.submit_task(creation)
            return True
        root = _col.group_root(name)
        # either way this incarnation is over: partially-staged
        # checkpoint generations can never complete — discard them
        # (committed generations are untouched; they are the restore
        # points the coordinated restart comes back from)
        self._discard_gang_ckpt_stage(name)
        if mode == "dead":
            # budget exhausted, gang already dead, or the user killed a
            # member: no (further) restart. Callers see ActorDiedError
            # on the dead member and CollectiveAbortError in any in-op
            # rank.
            cause = ("member killed" if tombstoned
                     else "gang is dead" if was_dead
                     else "gang restart budget exhausted")
            self.gcs.update_actor_state(actor_id, "DEAD",
                                        death_cause=cause)
            export.emit("ACTOR", {"actor_id": actor_id.hex(),
                                  "state": "DEAD", "cause": cause})
            if not was_dead:
                # gang-level transition happens once; later member
                # deaths of an already-dead gang only reap that member
                _col.write_abort_marker(root, old_epoch, cause)
                self.gcs.update_gang_state(name, "DEAD",
                                           death_cause=cause)
                # a dead slice takes its sliceset's DCN tier with it:
                # surviving slices must abort typed, not hang
                self._fence_sliceset_dcn(name, gang_dead=True)
            self._fail_actor_queue(actor_id, None)
            self._cleanup_actor_ckpt(actor_id)
            return True
        # abort this incarnation and restart the whole gang. rec's
        # epoch/restarting/gated fields now have a single writer (this
        # path claimed rec.restarting above).
        # RESTARTING trips the GCS gang hook: ABORTED + epoch bump
        self.gcs.update_actor_state(actor_id, "RESTARTING")
        export.emit("ACTOR", {"actor_id": actor_id.hex(),
                              "state": "RESTARTING"})
        info = self.gcs.get_gang_info(name)
        rec.epoch = info.epoch if info is not None else old_epoch + 1
        _col.write_abort_marker(
            root, old_epoch,
            f"member {actor_id.hex()[:8]} died; gang restarting at "
            f"epoch {rec.epoch}")
        export.emit("GANG", {"group": name, "state": "ABORTED",
                             "epoch": rec.epoch})
        # slice-gang abort fences the set's DCN tier (epoch bump +
        # typed abort to surviving slices' in-flight DCN waits) while
        # ONLY this slice's gang restarts below
        self._fence_sliceset_dcn(name, gang_dead=False)
        self.task_manager.add_pending_task(creation)
        self.node_group.submit_task(creation)
        threading.Thread(
            target=self._gang_restart_worker,
            args=(rec, actor_id), daemon=True,
            name=f"rtpu-gang-restart-{name[:16]}").start()
        return True

    def _gang_restart_worker(self, rec: _GangRecord,
                             dead_id: ActorID) -> None:
        """Coordinated restart: drain, kill every surviving member,
        wait for the whole gang to be ALIVE again, then re-form the
        group at the bumped epoch (TorchElastic-style rendezvous
        round). Runs on its own thread — the death callback that
        spawned it must not block the node IO loop."""
        from ray_tpu_torch import collective as _col
        from ray_tpu_torch._private import export
        name = rec.name
        root = _col.group_root(name)
        survivors = [aid for aid in rec.actor_ids if aid != dead_id]
        try:
            # 1. drain: the abort marker reaches in-op ranks within
            # milliseconds, so their in-flight calls finish (with
            # CollectiveAbortError) instead of dying as ActorDiedError
            # under the kill below.
            drain_deadline = time.monotonic() + 3.0
            while time.monotonic() < drain_deadline:
                with self.node_group._lock:
                    busy = any(
                        rt.spec.task_type == TaskType.ACTOR_TASK
                        and rt.spec.actor_id in survivors
                        for rt in self.node_group._running.values())
                if not busy:
                    break
                time.sleep(0.01)
            # 2. kill-and-resubmit every survivor together: gang
            # semantics are all-or-nothing — a fresh epoch starts from
            # fresh member state.
            for aid in survivors:
                self.gcs.update_actor_state(aid, "RESTARTING")
                export.emit("ACTOR", {"actor_id": aid.hex(),
                                      "state": "RESTARTING"})
                self.node_group.release_actor(aid, kill_worker=True)
                with self._actor_lock:
                    creation = self._actor_specs.get(aid)
                if creation is not None:
                    self.task_manager.add_pending_task(creation)
                    self.node_group.submit_task(creation)
            # 3. scrub the previous incarnation's rendezvous artifacts
            # (generation dirs, rank files, old abort markers): nothing
            # stale may leak — or collide — under the new epoch.
            _col.cleanup_stale_epochs(root, rec.epoch)
            # 4. the gang re-forms only once EVERY member is back
            deadline = (time.monotonic()
                        + get_config().gang_reform_timeout_s)
            while time.monotonic() < deadline:
                states = [getattr(self.gcs.get_actor_info(aid), "state",
                                  "DEAD") for aid in rec.actor_ids]
                if any(s == "DEAD" for s in states):
                    break
                if all(s == "ALIVE" for s in states):
                    break
                time.sleep(0.05)
            else:
                states = ["TIMEOUT"]
            if not all(s == "ALIVE" for s in states):
                cause = (f"gang re-form failed: member states {states}")
                logger.warning("%s: %s", name, cause)
                rec.dead = True
                _col.write_abort_marker(root, rec.epoch, cause)
                self.gcs.update_gang_state(name, "DEAD",
                                           death_cause=cause)
                return
            # 5. re-join at the new epoch, ahead of any queued user
            # calls: the join specs are moved to each member's queue
            # front before the flush gate opens.
            _col.write_group_state(root, rec.epoch, rec.world_size,
                                   "FORMING")
            self.gcs.update_gang_state(name, "FORMING")
            join_refs = []
            for handle, rank in zip(rec.handles, rec.ranks):
                ref = handle._join_collective_group.remote(
                    rec.world_size, rank, rec.backend, name)
                join_refs.append(ref)
                join_tid = ref.id().task_id()
                with self._actor_lock:
                    q = self._actor_queues.get(handle._actor_id)
                    if q:
                        for spec in list(q):
                            if spec.task_id == join_tid:
                                q.remove(spec)
                                # seq 0: a straggler retry re-queued by
                                # _resubmit's ordered insert (user seqs
                                # start at 1) can never slot in ahead
                                # of the re-join
                                spec.sequence_number = 0
                                q.appendleft(spec)
                                break
            rec.gated = False
            self._flush_actor_queues()
            remaining = max(1.0, deadline - time.monotonic())
            self.get(join_refs, timeout=remaining)
            _col.write_group_state(root, rec.epoch, rec.world_size,
                                   "ALIVE")
            self.gcs.update_gang_state(name, "ALIVE")
            export.emit("GANG", {"group": name, "state": "ALIVE",
                                 "epoch": rec.epoch})
            logger.info("gang %s re-formed at epoch %d", name, rec.epoch)
        except Exception as e:
            cause = f"gang restart failed: {e!r}"
            logger.exception("gang %s restart failed", name)
            rec.dead = True
            _col.write_abort_marker(root, rec.epoch, cause)
            self.gcs.update_gang_state(name, "DEAD", death_cause=cause)
        finally:
            rec.restarting = False
            rec.gated = False
            self._flush_actor_queues()

    def _on_actor_death(self, actor_id: ActorID) -> None:
        from ray_tpu_torch._private import export
        with self._gang_lock:
            gang_name = self._actor_gang.get(actor_id)
        if gang_name is not None and \
                self._on_gang_member_death(gang_name, actor_id):
            return
        with self._actor_lock:
            restarts_left = self._actor_restarts.get(actor_id, 0)
            creation = self._actor_specs.get(actor_id)
            tombstoned = actor_id in self._actor_tombstones
        if restarts_left != 0 and creation is not None and not tombstoned:
            if restarts_left > 0:
                with self._actor_lock:
                    self._actor_restarts[actor_id] = restarts_left - 1
            self.gcs.update_actor_state(actor_id, "RESTARTING")
            # counted by the GCS before the creation is resubmitted, so
            # the restarted actor never serves a call before its restart
            # is recorded (a process GCS returns copies of the info)
            self.gcs.record_actor_restart(actor_id)
            export.emit("ACTOR", {"actor_id": actor_id.hex(),
                                  "state": "RESTARTING"})
            self.task_manager.add_pending_task(creation)
            self.node_group.submit_task(creation)
        else:
            self.gcs.update_actor_state(actor_id, "DEAD",
                                        death_cause="worker died")
            export.emit("ACTOR", {"actor_id": actor_id.hex(),
                                  "state": "DEAD",
                                  "cause": "worker died"})
            self._fail_actor_queue(actor_id, None)
            self._cleanup_actor_ckpt(actor_id)

    def _fail_actor_queue(self, actor_id: ActorID,
                          err_blob: Optional[bytes]) -> None:
        with self._actor_lock:
            queue = self._actor_queues.get(actor_id)
            specs = list(queue) if queue else []
            if queue:
                queue.clear()
        for spec in specs:
            if err_blob is not None:
                self.task_manager.complete_task(spec.task_id, [], err_blob,
                                                None)
            else:
                self._fail_task(spec, ActorDiedError("actor died"))

    def kill_actor(self, actor_id: ActorID) -> None:
        info = self.gcs.get_actor_info(actor_id)
        if info is not None:
            try:
                # Detached actor created elsewhere: route to its raylet
                # so the kill reaches the worker, not just the tables.
                self._ensure_actor_route(actor_id, info)
            except Exception:
                # swallow-ok: kill is best-effort delivery — the
                # hosting raylet may be unreachable (ActorError /
                # ConnectionError); the tombstone + DEAD state update
                # below are the authoritative kill either way
                pass
        with self._actor_lock:
            self._actor_restarts[actor_id] = 0
            # Tombstone: a creation spec a concurrent _on_actor_death
            # already resubmitted must not revive this actor — kill
            # wins (checked in _on_actor_death/_on_actor_creation_done).
            self._actor_tombstones.add(actor_id)
        self.node_group.release_actor(actor_id, kill_worker=True)
        self.gcs.update_actor_state(actor_id, "DEAD", death_cause="killed")
        from ray_tpu_torch._private import export
        export.emit("ACTOR", {"actor_id": actor_id.hex(),
                              "state": "DEAD", "cause": "killed"})
        self._fail_actor_queue(actor_id, None)
        self._cleanup_actor_ckpt(actor_id)
        # A killed gang member takes its gang down: fence the epoch and
        # fan CollectiveAbortError out to any in-op ranks (the user
        # chose to kill; the gang does not restart over it).
        with self._gang_lock:
            gang_name = self._actor_gang.get(actor_id)
            rec = self._gangs.get(gang_name) if gang_name else None
            gang_was_dead = rec.dead if rec is not None else True
            if rec is not None:
                rec.dead = True     # no restart may revive this gang
        if rec is not None and not gang_was_dead:
            from ray_tpu_torch import collective as _col
            _col.write_abort_marker(
                _col.group_root(gang_name), rec.epoch,
                f"member {actor_id.hex()[:8]} killed")
            self.gcs.update_gang_state(gang_name, "DEAD",
                                       death_cause="member killed")
            self._fence_sliceset_dcn(gang_name, gang_dead=True)

    # ------------------------------------------------------------------
    # drain-before-terminate (autoscaler scale-down, docs/autoscaler.md)

    def request_actor_checkpoint(self, actor_id: ActorID) -> bool:
        """Ask the actor's hosting worker for a save-NOW snapshot
        (same ``__ray_save__`` -> generation -> ``ckpt_saved`` path as
        the interval autosave). Returns whether the request could be
        delivered — a remote-raylet actor has no save-now channel and
        migrates via the restart path instead."""
        w = self.node_group.actor_worker(actor_id)
        if w is None:
            return False
        try:
            w.send(("ckpt_save", actor_id.binary()))
        except Exception:
            return False    # remote route / worker already dead
        return True

    def migrate_actor(self, actor_id: ActorID,
                      idle_deadline: Optional[float] = None) -> bool:
        """Move one actor off its node through the restart/restore
        taxonomy WITHOUT consuming its restart budget (the move is
        voluntary, not a fault): mark RESTARTING so the flusher stops
        dispatching new calls, wait for in-flight calls to finish,
        then release the worker and resubmit the creation spec — the
        scheduler places it on a non-cordoned node and restore-before-
        replay reloads the newest committed checkpoint."""
        from ray_tpu_torch._private import export
        with self._actor_lock:
            creation = self._actor_specs.get(actor_id)
            tombstoned = actor_id in self._actor_tombstones
        if creation is None or tombstoned:
            return False
        self.gcs.update_actor_state(actor_id, "RESTARTING")
        export.emit("ACTOR", {"actor_id": actor_id.hex(),
                              "state": "RESTARTING", "cause": "migrate"})
        deadline = idle_deadline if idle_deadline is not None \
            else time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self.node_group._lock:
                busy = any(rt.spec.task_type == TaskType.ACTOR_TASK
                           and rt.spec.actor_id == actor_id
                           for rt in self.node_group._running.values())
            if not busy:
                break
            time.sleep(0.01)
        self.node_group.release_actor(actor_id, kill_worker=True)
        self.task_manager.add_pending_task(creation)
        self.node_group.submit_task(creation)
        return True

    def drain_node(self, node_id: NodeID,
                   timeout_s: float = 10.0) -> Tuple[bool, str]:
        """Two-phase scale-down drain: (1) cordon — the scheduler's
        alive-mask refuses new leases; (2) checkpoint + migrate every
        hosted actor and wait for running leases to finish; only then
        may the caller terminate the instance. Any refusal uncordons
        and reports why — the node keeps running. A chaos kill
        mid-drain is ordinary actor death: the restart/restore
        taxonomy replays from the newest COMMITTED generation, so no
        checkpointed state is lost."""
        ng = self.node_group
        if not ng.cordon_node(node_id):
            return False, "unknown node or cordon refused"
        deadline = time.monotonic() + timeout_s
        actors = ng.actors_on_node(node_id)
        # refuse non-drainable hosts up front, before disturbing state
        for aid in actors:
            with self._gang_lock:
                gang = self._actor_gang.get(aid)
            if gang is not None:
                ng.uncordon_node(node_id)
                return False, (f"actor {aid.hex()[:8]} is a member of "
                               f"gang {gang}: gang migration is a "
                               "coordinated restart, not a drain")
            with self._actor_lock:
                restarts = self._actor_restarts.get(aid, 0)
                creation = self._actor_specs.get(aid)
            checkpointable = (
                creation is not None and creation.checkpoint_interval > 0
                or self.gcs.get_checkpoint(aid) is not None)
            if creation is None or (restarts == 0 and not checkpointable):
                ng.uncordon_node(node_id)
                return False, (f"actor {aid.hex()[:8]} is neither "
                               "restartable nor checkpointable: "
                               "terminating would destroy its state")
        # phase 1: save-now; wait for each commit marker to land (the
        # owner-side commit is what makes the generation restorable)
        waiting: Dict[ActorID, int] = {}
        for aid in actors:
            before = self.gcs.get_checkpoint(aid)
            with self._actor_lock:
                creation = self._actor_specs.get(aid)
            if creation is not None and creation.checkpoint_interval > 0 \
                    or before is not None:
                if self.request_actor_checkpoint(aid):
                    waiting[aid] = before.gen if before else 0
        for aid, gen0 in waiting.items():
            while time.monotonic() < deadline:
                info = self.gcs.get_checkpoint(aid)
                if info is not None and info.gen > gen0:
                    break
                time.sleep(0.02)
        # phase 2: running leases finish (cordon stops new ones)
        while time.monotonic() < deadline:
            if ng.running_tasks_on(node_id) == 0:
                break
            time.sleep(0.02)
        if ng.running_tasks_on(node_id) != 0:
            ng.uncordon_node(node_id)
            return False, "running leases did not drain in time"
        # phase 3: migrate — restart/restore without burning budget
        for aid in actors:
            self.migrate_actor(aid, idle_deadline=deadline)
        self.num_node_drains += 1
        return True, ""

    # ------------------------------------------------------------------
    # lifecycle

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        self._actor_flush_wake.set()
        if getattr(self, "_log_monitor", None) is not None:
            self._log_monitor.stop()
        from ray_tpu_torch.util import metrics as _metrics
        _metrics.unregister_collector(
            getattr(self, "_node_metrics_collector", None))
        self.reference_counter.freeze()
        from ray_tpu_torch._private import worker_core as _wc
        core = _wc.try_worker_core()
        if core is not None:
            # in-process tasks created a driver-hosted worker core:
            # its objects die with the session (unlink segments)
            core.shutdown()
            _wc._core = None
        joined = self._join_address is not None
        if joined:
            # Leaving a cluster we don't own: reap our NON-detached
            # actors from its raylets (their raylet would otherwise
            # keep them alive), keep detached ones running, and mark
            # our actor table entries accordingly.
            with self._actor_lock:
                specs = dict(self._actor_specs)
            for actor_id, spec in specs.items():
                if spec.lifetime == "detached":
                    continue
                try:
                    info = self.gcs.get_actor_info(actor_id)
                    if info is not None and info.state != "DEAD":
                        self.node_group.release_actor(actor_id,
                                                      kill_worker=True)
                        self.gcs.update_actor_state(
                            actor_id, "DEAD", death_cause="driver exited")
                except Exception:
                    pass    # shutdown path: best-effort teardown
        self.node_group.shutdown(leave_remote_nodes=joined)
        self.shm_store.shutdown()
        self.device_store.shutdown()
        if self._gcs_proc is not None:
            try:
                self.gcs.close()
            except Exception:
                pass    # connection already dropped
            try:
                self._gcs_proc.terminate()
                self._gcs_proc.wait(timeout=5)
            except Exception:
                pass    # GCS process already exited
            self._gcs_proc = None
        elif self._join_address is not None:
            # joined cluster: leave the shared GCS running
            try:
                self.gcs.close()
            except Exception:
                pass    # connection already dropped
        from ray_tpu_torch._private import export as _export
        try:
            tm = self.task_manager
            _export.emit("NODE", {"event": "SESSION_END"})
            writer = _export.start(self.session) \
                if get_config().event_export_enabled else None
            if writer is not None:
                writer.write_usage_stats({
                    "session": self.session,
                    "tasks_finished": tm.num_finished,
                    "tasks_failed": tm.num_failed,
                    "task_retries": tm.num_retries,
                    "reconstructions": tm.num_reconstructions,
                    "num_nodes": len(list(
                        self.node_group.cluster_resources.nodes())),
                    "actors_registered": len(self._actor_specs),
                })
        except Exception:
            pass    # exporter already stopped: stats are optional
        _export.stop()
        # the flusher saw _shutdown at its last wake (set above); join it
        # so that shutdown() leaves no runtime thread behind
        if self._actor_flusher is not threading.current_thread():
            self._actor_flusher.join(timeout=5.0)
        if self._join_address is None:
            # Session owner: sweep shm orphans left by killed workers.
            from ray_tpu_torch._private.object_store import (
                sweep_orphan_segments)
            sweep_orphan_segments(self.session)
        if self._config_before is not None:
            get_config().restore(self._config_before)

    def cancel_task(self, ref, force: bool = False) -> None:
        """Cancel a NORMAL task or an ASYNC-actor call (reference
        ``ray.cancel`` semantics, best-effort): a queued normal task
        never runs; a running one gets KeyboardInterrupt (or its
        worker killed, with ``force``); an async-actor call is
        cancelled on the actor's event loop (queued calls immediately,
        running coroutines at their next await). A finished task keeps
        its result. Consumers of a cancelled task's refs see
        TaskCancelledError. SYNC actor calls are not cancellable
        (TypeError, like the reference)."""
        from ray_tpu_torch.exceptions import TaskCancelledError
        task_id = ref.id().task_id()
        rec = self.task_manager.get_record(task_id)
        if rec is None:
            return                       # unknown/already released
        if rec.spec.task_type == TaskType.ACTOR_TASK:
            actor_id = rec.spec.actor_id
            info = self.gcs.get_actor_info(actor_id)
            if info is None or not getattr(info, "is_async", False):
                raise TypeError(
                    "ray_tpu_torch.cancel() on actor calls is supported for "
                    "ASYNC actors only (asyncio cancellation); sync "
                    "actor calls cannot be interrupted")
            status = self.task_manager.mark_cancelled(task_id)
            if status in ("finished", "failed"):
                return
            # still queued at the DRIVER (actor mid-creation, or queue
            # backlog): dequeue now — it must never be flushed
            with self._actor_lock:
                q = self._actor_queues.get(actor_id)
                removed = None
                if q:
                    for s in q:
                        if s.task_id == task_id:
                            removed = s
                            break
                    if removed is not None:
                        q.remove(removed)
            if removed is not None:
                # complete_task substitutes the canonical cancelled
                # message for flagged records; this exception is just
                # the terminal-failure trigger
                self.task_manager.complete_task(
                    task_id, [], None, TaskCancelledError("cancelled"))
                return
            self.node_group.cancel_actor_call(actor_id, task_id)
            return
        if rec.spec.task_type != TaskType.NORMAL_TASK:
            raise TypeError(
                "ray_tpu_torch.cancel() supports normal tasks and async "
                "actor calls only")
        status = self.task_manager.mark_cancelled(task_id)
        if status in ("finished", "failed"):
            return                       # too late: result/error stands
        if self.node_group.cancel_queued(task_id):
            # never ran: complete it as a terminal cancellation
            self.task_manager.complete_task(
                task_id, [], None,
                TaskCancelledError(
                    f"task {rec.spec.repr_name()} was cancelled before "
                    "it started"))
            return
        if self.node_group.cancel_pipelined(task_id, force):
            # queued on a busy worker's pipe: a targeted steal pulls
            # it back and the stolen-reply handler (which re-checks the
            # cancel flag) completes it as cancelled — the SIGINT
            # path would have matched the wrong (executing) task
            return
        # running (or in a dispatch race): interrupt best-effort; the
        # resulting failure completes through the cancelled path
        self.node_group.interrupt_running(task_id, force)

    def dump_stacks(self, node_id: Optional[NodeID] = None
                    ) -> Dict[str, Dict[str, str]]:
        """Live Python stacks across the cluster (reference: the
        dashboard reporter's py-spy endpoint): per node, the host
        process ("driver"/"raylet") plus each process worker. Restrict
        to one node with ``node_id``."""
        from ray_tpu_torch._private.profiling import (dump_all_stacks,
                                                gather_pool_stacks)
        out: Dict[str, Dict[str, str]] = {}
        with self.node_group._lock:
            raylets = dict(self.node_group._raylets)
            remotes = dict(self.node_group._remote_nodes)
        for nid, raylet in raylets.items():
            if node_id is not None and nid != node_id:
                continue
            entry = {"driver": dump_all_stacks()}
            entry.update(gather_pool_stacks(raylet.worker_pool))
            out[nid.hex()[:12]] = entry
        for nid, handle in remotes.items():
            if node_id is not None and nid != node_id:
                continue
            try:
                out[nid.hex()[:12]] = handle.client.call(
                    "dump_stacks", timeout=10)
            except Exception as e:
                out[nid.hex()[:12]] = {"error": repr(e)}
        return out

    def cluster_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for _nid, res in self.node_group.cluster_resources.nodes():
            for k, v in res.total.items():
                total[k] = total.get(k, 0.0) + v
        return total

    def available_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for _nid, res in self.node_group.cluster_resources.nodes():
            for k, v in res.available.items():
                total[k] = total.get(k, 0.0) + v
        return total


# ---------------------------------------------------------------------------
# global singleton

_global_worker: Optional[Worker] = None
_global_lock = threading.Lock()  # blocking-ok: lifecycle lock — held across full init/shutdown (process spawns, joins, backoff sleeps) so concurrent init() blocks until the transition lands


def init(**kwargs) -> Worker:
    global _global_worker
    if os.environ.get("RAY_TPU_WORKER_MODE") == "1":
        nested = _nested_client()
        if nested is not None:
            return nested
        raise RuntimeError(
            "ray_tpu_torch API calls inside task/actor workers need an owner "
            "channel and none is attached (workers are pure executors; "
            "nested calls are served by the task's owner).")
    address = kwargs.get("address")
    if address and address.startswith("rtpu://"):
        # Proxied remote driver (Ray Client analog): the whole API
        # rides one connection to a client-server in the cluster.
        from ray_tpu_torch._private.nested_client import (ClientWorker,
                                                    parse_client_address)
        with _global_lock:
            if _global_worker is not None:
                return _global_worker
            _global_worker = ClientWorker(parse_client_address(address))
            atexit.register(shutdown)
            return _global_worker
    with _global_lock:
        if _global_worker is not None:
            return _global_worker
        _global_worker = Worker(**kwargs)
        atexit.register(shutdown)
        return _global_worker


def _nested_client():
    from ray_tpu_torch._private.nested_client import get_nested_client
    return get_nested_client()


def shutdown() -> None:
    global _global_worker
    with _global_lock:
        if _global_worker is not None:
            _global_worker.shutdown()
            _global_worker = None


def global_worker() -> Worker:
    if _global_worker is None:
        if os.environ.get("RAY_TPU_WORKER_MODE") == "1":
            return init()      # resolves to the nested-call client
        init()
    return _global_worker


def try_global_worker() -> Optional[Worker]:
    return _global_worker


def is_initialized() -> bool:
    return _global_worker is not None
