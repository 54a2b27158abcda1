"""Autoscaler v2: the closed loop from typed demand to chaos-hardened,
drain-safe supply (docs/autoscaler.md).

Reference: ``python/ray/autoscaler/v2/`` [UNVERIFIED — mount empty,
SURVEY.md §0] — the reworked autoscaler separates three views and
reconciles them: DESIRED capacity (scheduler demand), CLOUD state
(what the provider actually allocated), and RAY state (which nodes
joined the cluster). Four layers here:

1. **Demand aggregation** — the reconciler consumes the
   unplaceable-ledger report (per demand-shape pending counts +
   capacity bounds, now annotated with node-type feasibility), parked
   placement-group cohorts (gang/slice-granular: a PACK'd 8-GPU gang
   demands one whole 8-GPU node, never 8 stray cards), and the
   shed/backpressure gauges, and bin-matches shapes against the
   node-type catalog. A shape NO catalog type can ever fit is
   recorded as a typed :class:`UnsatisfiableDemandError` instead of
   launching nodes that could never help.
2. **Chaos-hardened provisioning** — every instance moves through an
   explicit lifecycle with recorded transitions::

     QUEUED -> REQUESTED -> ALLOCATED -> RUNNING -> TERMINATING
                        \\-> ALLOCATION_FAILED (bounded requeue)

   with per-transition deadlines: a launch request the cloud never
   acknowledged (chaos ``autoscaler.provider.launch:drop``) or a node
   that boots then immediately dies
   (``autoscaler.provider.boot:kill``) is detected at its deadline
   and re-launched under seeded backoff from a bounded retry budget —
   converging to RUNNING or the typed ALLOCATION_FAILED terminal
   state, never a silent leak.
3. **Drain-before-terminate scale-down** — idle detection feeds a
   two-phase drain (``Worker.drain_node``): cordon in the scheduler
   (alive-mask: no new leases), checkpointable actors save via the
   checkpoint plane and migrate through restart/restore, then the
   instance terminates. A refused drain uncordons and keeps the node.
4. **Composition & observability** — direction-stable up/down delays
   mirroring the serve autoscaler's, so replica scaling and node
   scaling compose without oscillation; the
   ``ray_tpu_autoscaler_*`` gauges export the instance table, demand
   shapes, launch retries, and completed drains (declared in
   _private/stats.py per the metric-discipline pass; this module only
   exposes :func:`metrics_snapshot`).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
import uuid
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.backoff import jittered, make_rng, next_backoff
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch.autoscaler import NodeType
from ray_tpu_torch.exceptions import UnsatisfiableDemandError

logger = logging.getLogger(__name__)

__all__ = ["InstanceState", "Instance", "CloudInstanceProvider",
           "FakeCloudProvider", "InstanceManager", "AutoscalerV2",
           "metrics_snapshot"]


class InstanceState(enum.Enum):
    QUEUED = "QUEUED"                  # desired, not yet requested
    REQUESTED = "REQUESTED"            # launch request in flight
    ALLOCATED = "ALLOCATED"            # cloud says it exists
    RUNNING = "RUNNING"                # the ray node joined the cluster
    ALLOCATION_FAILED = "ALLOCATION_FAILED"
    TERMINATING = "TERMINATING"        # drain-before-terminate window
    TERMINATED = "TERMINATED"


@dataclass
class Instance:
    instance_id: str
    node_type: str
    state: InstanceState = InstanceState.QUEUED
    cloud_id: Optional[str] = None
    node_id: Optional[NodeID] = None
    launch_attempts: int = 0
    # per-transition deadline anchor: monotonic time the instance
    # entered its current state (QUEUED->REQUESTED->... deadlines are
    # measured from here, so a lost launch can't sit forever)
    state_since: float = field(default_factory=time.monotonic)
    # seeded-backoff relaunch pacing (set by the reconciler on requeue)
    backoff_s: float = 0.0
    retry_at: float = 0.0
    # (ts, from_state, to_state) — the reference records transition
    # history on each instance for debuggability
    transitions: List[tuple] = field(default_factory=list)

    def to(self, state: InstanceState) -> None:
        self.transitions.append((time.time(), self.state.value,
                                 state.value))
        self.state = state
        self.state_since = time.monotonic()


class CloudInstanceProvider:
    """Async cloud seam: ``launch`` returns a request handle
    immediately; ``describe`` reports what the cloud actually holds."""

    def check_node_type(self, node_type: NodeType) -> None:
        """Raise if this provider can never launch ``node_type``."""

    def launch(self, node_type: NodeType) -> str:
        """Request one instance; returns a cloud id (the request may
        still fail — or be lost entirely — poll ``describe``)."""
        raise NotImplementedError

    def describe(self) -> Dict[str, str]:
        """cloud_id -> status in {'pending', 'running', 'failed',
        'gone'} — with 'running' meaning the ray node process is up
        (its node id is then in ``node_id_of``). A cloud id the cloud
        never heard of (lost launch) is simply absent."""
        raise NotImplementedError

    def node_id_of(self, cloud_id: str) -> Optional[NodeID]:
        raise NotImplementedError

    def terminate(self, cloud_id: str) -> None:
        raise NotImplementedError


class FakeCloudProvider(CloudInstanceProvider):
    """Test/reference provider over the Cluster utility: launches
    become ray nodes after ``boot_delay_s``; the first
    ``fail_first_n`` launches report 'failed' (allocation-failure
    path). Chaos points (rule grammar in _private/chaos.py; actions
    are SITE-applied via ``fire_site`` so the driver process hosting
    the provider never dies):

    - ``autoscaler.provider.launch`` — ``drop``: the launch request is
      lost cloud-side (the id never appears in ``describe``);
      ``delay=S``: this instance's boot takes S seconds longer.
    - ``autoscaler.provider.boot`` — ``kill``: the node boots and
      immediately dies (membership blip + 'gone' allocation, the
      preemption analog).
    """

    def __init__(self, cluster, boot_delay_s: float = 0.0,
                 fail_first_n: int = 0, remote: bool = False):
        self._cluster = cluster
        self._boot_delay = boot_delay_s
        self._fail_left = fail_first_n
        self._remote = remote
        self._lock = threading.Lock()
        # cloud_id -> dict(state=..., boot_at=..., node_type=...,
        #                  node_id=...)
        self._instances: Dict[str, dict] = {}  # guarded-by: _lock

    def check_node_type(self, node_type: NodeType) -> None:
        if self._remote:
            from ray_tpu_torch.cluster_utils import refuse_remote_gpu
            refuse_remote_gpu(node_type.resources)

    def launch(self, node_type: NodeType) -> str:
        cloud_id = f"i-{uuid.uuid4().hex[:12]}"
        action, arg = chaos.fire_site("autoscaler", "provider", "launch")
        if action == "drop":
            # request lost in flight: the cloud never records it, so
            # describe() stays silent and the reconciler's REQUESTED
            # deadline is the only thing that can notice
            return cloud_id
        boot_delay = self._boot_delay + (arg if action == "delay"
                                         else 0.0)
        with self._lock:
            if self._fail_left > 0:
                self._fail_left -= 1
                self._instances[cloud_id] = {"state": "failed"}
            else:
                self._instances[cloud_id] = {
                    "state": "pending",
                    "boot_at": time.monotonic() + boot_delay,
                    "node_type": node_type,
                }
        return cloud_id

    def _boot_due(self) -> None:
        # lock held
        now = time.monotonic()
        for cid, rec in self._instances.items():
            if rec["state"] == "pending" and now >= rec["boot_at"]:
                nt = rec["node_type"]
                res = dict(nt.resources)
                action, _ = chaos.fire_site("autoscaler", "provider",
                                            "boot")
                node_id = self._cluster.add_node(
                    num_cpus=res.pop("CPU", 1),
                    num_gpus=res.pop("GPU", 0),
                    resources=res or None, remote=self._remote)
                if action == "kill":
                    # boot-then-die: the ray node joins and is dead
                    # before the reconciler can observe it; the cloud
                    # reports the allocation gone
                    self._cluster.remove_node(node_id)
                    rec["state"] = "gone"
                    continue
                rec["node_id"] = node_id
                rec["state"] = "running"

    def describe(self) -> Dict[str, str]:
        with self._lock:
            self._boot_due()
            return {cid: rec["state"]
                    for cid, rec in self._instances.items()}

    def node_id_of(self, cloud_id: str) -> Optional[NodeID]:
        with self._lock:
            return self._instances.get(cloud_id, {}).get("node_id")

    def terminate(self, cloud_id: str) -> None:
        with self._lock:
            rec = self._instances.get(cloud_id)
            if rec is None:
                return
            node_id = rec.get("node_id")
            rec["state"] = "gone"
        if node_id is not None:
            self._cluster.remove_node(node_id)


class InstanceManager:
    """The instance table: thread-safe membership + views.

    Lock discipline (graftsan-covered): ``_lock`` guards the id ->
    Instance map; it is a LEAF — no method calls out of this class
    while holding it:
    lock-order: InstanceManager._lock
    Individual ``Instance`` fields have a single writer (the owning
    reconciler thread); readers (``table``/gauges/tests) see a
    consistent map snapshot plus monotonically-appended transitions.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}  # guarded-by: _lock

    def add(self, node_type: str) -> Instance:
        inst = Instance(instance_id=f"inst-{uuid.uuid4().hex[:12]}",
                        node_type=node_type)
        with self._lock:
            self._instances[inst.instance_id] = inst
        return inst

    def all(self) -> List[Instance]:
        with self._lock:
            return list(self._instances.values())

    def in_state(self, *states: InstanceState) -> List[Instance]:
        with self._lock:
            return [i for i in self._instances.values()
                    if i.state in states]

    def table(self) -> List[dict]:
        with self._lock:
            return [{
                "instance_id": i.instance_id,
                "node_type": i.node_type,
                "state": i.state.value,
                "cloud_id": i.cloud_id,
                "node_id": i.node_id.hex() if i.node_id else None,
                "launch_attempts": i.launch_attempts,
            } for i in self._instances.values()]


# live scalers, for the stats collector (weak: a stopped/GC'd scaler
# must not pin its worker or keep exporting series)
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def metrics_snapshot() -> dict:
    """Aggregated gauge inputs across live scalers (consumed by
    _private/stats.py's collect closure — constructors live THERE per
    the metric-discipline declaration-locality rule)."""
    instances: Dict[str, int] = {}
    demand: Dict[str, int] = {}
    retries = 0
    drains = 0
    for scaler in list(_LIVE):
        for inst in scaler.instances.all():
            instances[inst.state.value] = \
                instances.get(inst.state.value, 0) + 1
        for shape, n in scaler.demand_shapes().items():
            demand[shape] = demand.get(shape, 0) + n
        retries += scaler.num_launch_retries
        drains += scaler.num_drains
    return {"instances": instances, "demand": demand,
            "launch_retries": retries, "drains": drains}


def _shape_key(shape: Dict[str, float]) -> str:
    return ",".join(f"{k}:{v:g}" for k, v in sorted(shape.items()))


class AutoscalerV2:
    """Reconciler between desired capacity, cloud state, and ray
    state — the module docstring has the four-layer map. All mutation
    happens on the reconciler thread (or the caller of
    ``reconcile_once`` in tests); the instance table and snapshot
    attributes are safe to read from any thread."""

    def __init__(self, provider: CloudInstanceProvider,
                 node_types: List[NodeType],
                 idle_timeout_s: float = 60.0,
                 period_s: float = 0.2,
                 max_launch_attempts: int = 3,
                 worker=None,
                 upscale_delay_s: Optional[float] = None,
                 downscale_delay_s: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 allocate_timeout_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None):
        from ray_tpu_torch._private.worker import global_worker
        for t in node_types:
            provider.check_node_type(t)
        cfg = get_config()
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.period_s = period_s
        self.max_launch_attempts = max_launch_attempts
        self.upscale_delay_s = (cfg.autoscaler_upscale_delay_s
                                if upscale_delay_s is None
                                else upscale_delay_s)
        self.downscale_delay_s = (cfg.autoscaler_downscale_delay_s
                                  if downscale_delay_s is None
                                  else downscale_delay_s)
        self.request_timeout_s = (cfg.autoscaler_request_timeout_s
                                  if request_timeout_s is None
                                  else request_timeout_s)
        self.allocate_timeout_s = (cfg.autoscaler_allocate_timeout_s
                                   if allocate_timeout_s is None
                                   else allocate_timeout_s)
        self.drain_timeout_s = (cfg.autoscaler_drain_timeout_s
                                if drain_timeout_s is None
                                else drain_timeout_s)
        self._backoff_base_s = cfg.autoscaler_launch_backoff_base_s
        self._backoff_cap_s = cfg.autoscaler_launch_backoff_cap_s
        self._worker = worker or global_worker()
        self.instances = InstanceManager()
        # typed terminal demand: shape-key -> UnsatisfiableDemandError
        # for shapes no catalog type can ever fit (reported, gauged,
        # and excluded from launch pressure)
        self.unsatisfiable: Dict[str, UnsatisfiableDemandError] = {}
        self.num_launch_retries = 0   # re-launches beyond the first try
        self.num_drains = 0           # completed drain-before-terminate
        self._rng = make_rng()        # relaunch jitter (chaos_seed'd)
        self._idle_since: Dict[str, float] = {}
        # direction-stable pressure (serve-autoscaler mirror): a
        # direction flip resets the timer so the two loops can't chase
        # each other into up/down/up flap
        self._dir: Optional[str] = None
        self._dir_since: float = 0.0
        # last tick's demand aggregation, for the demand gauge
        self._demand_snapshot: Dict[str, int] = {}
        self._stats_baseline = self._worker.node_group.stats()
        # register the catalog so unplaceable_report carries
        # feasible_types without re-deriving fit
        self._worker.node_group.set_node_type_catalog(
            {t.name: dict(t.resources) for t in node_types})
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _LIVE.add(self)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "AutoscalerV2":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-autoscaler-v2")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        _LIVE.discard(self)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.reconcile_once()
            except Exception:
                logger.exception("autoscaler v2 reconcile error")

    # -- reconciliation ------------------------------------------------

    def reconcile_once(self) -> None:
        unmet, pressure = self._aggregate_demand()
        direction, held_s = self._direction(unmet, pressure)
        if unmet and (direction == "up"
                      and held_s >= self.upscale_delay_s):
            self._queue_for_demand(unmet)
        self._request_queued()
        self._observe_cloud()
        self._observe_ray()
        if direction == "down" and held_s >= self.downscale_delay_s:
            self._scale_down()

    # .. layer 1: demand aggregation ...................................

    @staticmethod
    def _fits(shape: Dict[str, float], capacity: Dict[str, float]
              ) -> bool:
        return all(capacity.get(k, 0.0) + 1e-9 >= v
                   for k, v in shape.items())

    def _pick_node_type(self, shape: Dict[str, float]
                        ) -> Optional[NodeType]:
        """Bin-shape matching: the feasible catalog type with the
        least leftover (a whole 8-GPU gang shape lands on the
        8-GPU type, not the biggest box available)."""
        best = None
        best_excess = None
        for nt in self.node_types.values():
            if not self._fits(shape, nt.resources):
                continue
            excess = sum(v - shape.get(k, 0.0)
                         for k, v in nt.resources.items())
            if best is None or excess < best_excess:
                best, best_excess = nt, excess
        return best

    def _aggregate_demand(self) -> Tuple[List[Dict[str, float]], bool]:
        """(unmet demand shapes, extra up-pressure). Sources: the
        unplaceable-ledger report (fenced + totals-infeasible classes,
        one entry per pending instance), pending placement-group
        cohorts (PACK'd groups as ONE combined gang shape), and the
        shed/backpressure counters (pressure only — their shapes are
        transient). Shapes that fit no catalog type are recorded as
        typed UnsatisfiableDemandError and excluded — launches could
        never help them."""
        ng = self._worker.node_group
        shapes: List[Dict[str, float]] = []
        for entry in ng.unplaceable_report():
            shapes.extend(dict(entry["demand"])
                          for _ in range(entry["pending"]))
        pgm = ng.pg_manager
        if pgm is not None:
            with pgm._lock:
                pending = [pgm._groups.get(pg_id)
                           for pg_id in pgm._pending]
            for info in pending:
                if info is None:
                    continue
                if info.strategy in ("PACK", "STRICT_PACK"):
                    combined: Dict[str, float] = {}
                    for b in info.bundles:
                        for k, v in b.items():
                            combined[k] = combined.get(k, 0.0) + v
                    shapes.append(combined)   # one slice-shaped node,
                else:                         # never stray bundles
                    shapes.extend(dict(b) for b in info.bundles)
        # shed/backpressure gauges: deferred work holds up-pressure so
        # the downscaler can't reap capacity the backoff queue is
        # about to need
        stats = ng.stats()
        pressure = (stats.get("deferred", 0) > 0
                    or stats.get("shed", 0)
                    > self._stats_baseline.get("shed", 0))
        self._stats_baseline["shed"] = stats.get("shed", 0)

        unmet: List[Dict[str, float]] = []
        demand_snapshot: Dict[str, int] = {}
        for shape in shapes:
            key = _shape_key(shape)
            demand_snapshot[key] = demand_snapshot.get(key, 0) + 1
            if self._pick_node_type(shape) is None:
                if key not in self.unsatisfiable:
                    err = UnsatisfiableDemandError(
                        f"demand {shape} fits no catalog node type",
                        demand=shape,
                        node_types=sorted(self.node_types))
                    self.unsatisfiable[key] = err
                    logger.warning("v2: %s", err)
                continue
            unmet.append(shape)
        self._demand_snapshot = demand_snapshot
        return self._subtract_capacity(unmet), pressure

    def _subtract_capacity(self, shapes: List[Dict[str, float]]
                           ) -> List[Dict[str, float]]:
        """Greedy bin-pack of demand into current + incoming capacity;
        what overflows is the launch signal. Incoming instances count
        so one surge queues each node once, not once per tick."""
        ng = self._worker.node_group
        capacity = [dict(res.total) for _nid, res in
                    ng.cluster_resources.nodes() if res.alive]
        incoming = self.instances.in_state(
            InstanceState.QUEUED, InstanceState.REQUESTED,
            InstanceState.ALLOCATED)
        capacity += [dict(self.node_types[i.node_type].resources)
                     for i in incoming if i.node_type in self.node_types]
        unmet = []
        for shape in shapes:
            placed = False
            for cap in capacity:
                if self._fits(shape, cap):
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if not placed:
                unmet.append(shape)
        return unmet

    def _direction(self, unmet: List[Dict[str, float]],
                   pressure: bool) -> Tuple[Optional[str], float]:
        """Direction-stable pressure timer (serve-autoscaler mirror):
        scale decisions require the SAME direction sustained for its
        delay; a flip resets the clock."""
        now = time.monotonic()
        if unmet or pressure:
            d = "up"
        elif self._any_idle(now):
            d = "down"
        else:
            d = None
        if d != self._dir:
            self._dir = d
            self._dir_since = now
        return d, (0.0 if d is None else now - self._dir_since)

    def _any_idle(self, now: float) -> bool:
        """Track lease-idle RUNNING instances; True when at least one
        has been idle past idle_timeout_s (the down-pressure input —
        the downscale delay then runs on top of it). Idle = no leases
        running or queued on the node; a resident between-calls actor
        does NOT pin its node — the drain path checkpoints + migrates
        it, and refuses the drain when it can't."""
        ng = self._worker.node_group
        live = {nid for nid, _res in ng.cluster_resources.nodes()}
        any_ripe = False
        for inst in self.instances.in_state(InstanceState.RUNNING):
            if inst.node_id not in live:
                continue
            if ng.running_tasks_on(inst.node_id) != 0:
                self._idle_since.pop(inst.instance_id, None)
                continue
            since = self._idle_since.setdefault(inst.instance_id, now)
            if now - since >= self.idle_timeout_s:
                any_ripe = True
        return any_ripe

    def _queue_for_demand(self, unmet: List[Dict[str, float]]) -> None:
        """Convert overflow shapes into node-type launches, consuming
        queued capacity as shapes land on it (bin-shape matching)."""
        queued_capacity: List[Dict[str, float]] = []
        for shape in unmet:
            placed = False
            for cap in queued_capacity:
                if self._fits(shape, cap):
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            nt = self._pick_node_type(shape)
            if nt is None:
                continue    # already recorded unsatisfiable
            live = [i for i in self.instances.all()
                    if i.node_type == nt.name and i.state not in
                    (InstanceState.TERMINATED,
                     InstanceState.ALLOCATION_FAILED)]
            if len(live) >= nt.max_workers:
                continue
            inst = self.instances.add(nt.name)
            logger.info("v2: queued %s (%s) for demand %s",
                        inst.instance_id, nt.name, shape)
            cap = dict(nt.resources)
            for k, v in shape.items():
                cap[k] = cap.get(k, 0.0) - v
            queued_capacity.append(cap)

    # .. layer 2: chaos-hardened provisioning ..........................

    def _request_queued(self) -> None:
        now = time.monotonic()
        for inst in self.instances.in_state(InstanceState.QUEUED):
            if inst.retry_at > now:
                continue    # seeded backoff window still open
            inst.launch_attempts += 1
            if inst.launch_attempts > 1:
                self.num_launch_retries += 1
            inst.cloud_id = self.provider.launch(
                self.node_types[inst.node_type])
            inst.to(InstanceState.REQUESTED)

    def _relaunch_or_fail(self, inst: Instance, why: str) -> None:
        """Release the cloud side (quota/billing) and retry within the
        budget under seeded backoff — a stuck instance would otherwise
        count as phantom incoming capacity forever. Budget exhaustion
        is the typed terminal state, never a silent leak."""
        try:
            self.provider.terminate(inst.cloud_id)
        except Exception:
            pass    # instance may already be gone cloud-side
        if inst.launch_attempts < self.max_launch_attempts:
            inst.backoff_s = next_backoff(
                inst.backoff_s, self._backoff_base_s,
                self._backoff_cap_s)
            inst.retry_at = time.monotonic() + jittered(inst.backoff_s,
                                                        self._rng)
            logger.info("v2: %s allocation %s, requeueing (attempt %d,"
                        " backoff %.2fs)", inst.instance_id, why,
                        inst.launch_attempts, inst.backoff_s)
            inst.to(InstanceState.QUEUED)
        else:
            logger.warning("v2: %s allocation %s after %d attempts: "
                           "ALLOCATION_FAILED", inst.instance_id, why,
                           inst.launch_attempts)
            inst.to(InstanceState.ALLOCATION_FAILED)

    def _observe_cloud(self) -> None:
        cloud = self.provider.describe()
        now = time.monotonic()
        for inst in self.instances.in_state(InstanceState.REQUESTED,
                                            InstanceState.ALLOCATED):
            status = cloud.get(inst.cloud_id)
            if status in ("failed", "gone"):
                # failed launch OR the allocation vanished/was
                # preempted (boot-then-die) before the node joined
                self._relaunch_or_fail(inst, status)
            elif status is None:
                # the cloud never heard of the request: a lost launch
                # (chaos drop) only proves itself by deadline
                if now - inst.state_since >= self.request_timeout_s:
                    self._relaunch_or_fail(inst, "lost")
            elif status == "pending":
                if now - inst.state_since >= self.allocate_timeout_s:
                    self._relaunch_or_fail(inst, "stuck pending")
            elif status == "running" \
                    and inst.state == InstanceState.REQUESTED:
                inst.to(InstanceState.ALLOCATED)

    def _observe_ray(self) -> None:
        """RAY state: an allocated instance whose node joined the
        cluster view is RUNNING; one that never joins by deadline is
        re-launched."""
        ng = self._worker.node_group
        live = {nid for nid, _res in ng.cluster_resources.nodes()}
        now = time.monotonic()
        for inst in self.instances.in_state(InstanceState.ALLOCATED):
            node_id = self.provider.node_id_of(inst.cloud_id)
            if node_id is not None and node_id in live:
                inst.node_id = node_id
                inst.to(InstanceState.RUNNING)
            elif now - inst.state_since >= self.allocate_timeout_s:
                self._relaunch_or_fail(inst, "never joined")
        # A RUNNING instance whose node vanished: the ray process died
        # but the cloud allocation may still exist (and bill) — issue
        # the terminate before recording the terminal state.
        for inst in self.instances.in_state(InstanceState.RUNNING):
            if inst.node_id not in live:
                try:
                    self.provider.terminate(inst.cloud_id)
                except Exception:
                    pass    # instance may already be gone cloud-side
                inst.to(InstanceState.TERMINATED)
                self._idle_since.pop(inst.instance_id, None)

    # .. layer 3: drain-before-terminate scale-down ....................

    def _scale_down(self) -> None:
        """One victim per tick: the longest-idle RUNNING instance past
        idle_timeout_s drains (cordon -> checkpoint -> migrate) and
        only then terminates; a refused drain uncordons and keeps the
        node (its idle clock restarts)."""
        now = time.monotonic()
        victim = None
        victim_since = now
        for inst in self.instances.in_state(InstanceState.RUNNING):
            since = self._idle_since.get(inst.instance_id)
            if since is None or now - since < self.idle_timeout_s:
                continue
            if victim is None or since < victim_since:
                victim, victim_since = inst, since
        if victim is None:
            return
        logger.info("v2: draining idle %s (node %s)",
                    victim.instance_id,
                    victim.node_id.hex()[:8] if victim.node_id else "?")
        victim.to(InstanceState.TERMINATING)
        ok, why = self._worker.drain_node(
            victim.node_id, timeout_s=self.drain_timeout_s)
        if not ok:
            logger.warning("v2: drain of %s refused (%s); keeping node",
                           victim.instance_id, why)
            victim.to(InstanceState.RUNNING)
            self._idle_since.pop(victim.instance_id, None)
            return
        self.num_drains += 1
        self.provider.terminate(victim.cloud_id)
        victim.to(InstanceState.TERMINATED)
        self._idle_since.pop(victim.instance_id, None)

    # -- views ---------------------------------------------------------

    def demand_shapes(self) -> Dict[str, int]:
        """Last tick's aggregated demand (shape-key -> pending count),
        the ``ray_tpu_autoscaler_demand`` gauge input."""
        return dict(self._demand_snapshot)

    def report(self) -> dict:
        """Inspectable control-loop state (dashboards/tests)."""
        return {
            "instances": self.instances.table(),
            "demand": self.demand_shapes(),
            "unsatisfiable": {k: str(e)
                              for k, e in self.unsatisfiable.items()},
            "launch_retries": self.num_launch_retries,
            "drains": self.num_drains,
            "direction": self._dir,
        }
