"""Serve controller: reconciles target vs actual replicas.

Reference: ``python/ray/serve/_private/controller.py`` +
``deployment_state.py`` [UNVERIFIED — mount empty, SURVEY.md §0]: a
control loop owning the deployment table; every iteration it converges
each deployment's actual replica set toward the target (create
missing, remove extra, replace dead) and applies request-based
autoscaling. The reference hosts this in a detached actor; here it is
a driver-side controller thread (the same topology as this framework's
Tune controller — this runtime's workers are pure executors, so
control loops live with the driver). Replicas themselves are ordinary
core-API actors — libraries-on-core holds.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve._private.replica import ReplicaActor
from ray_tpu_torch.serve._private.router import ReplicaSet

logger = logging.getLogger(__name__)


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0


def _discover_batch_cfg(target) -> dict:
    """method name -> ``@serve.batch`` config for the router's gather
    queues (the handle-side half of dynamic batching)."""
    cfgs = {}
    if isinstance(target, type):
        for name in dir(target):
            try:
                attr = getattr(target, name)
            except Exception:  # noqa: BLE001 - exotic descriptors skip
                continue
            cfg = getattr(attr, "_rtpu_batch_cfg", None)
            if cfg is not None:
                cfgs[name] = dict(cfg)
    else:
        cfg = getattr(target, "_rtpu_batch_cfg", None)
        if cfg is not None:
            cfgs["__call__"] = dict(cfg)
    return cfgs


@dataclass
class DeploymentInfo:
    name: str
    deployment_blob: bytes
    init_args: tuple
    init_kwargs: dict
    num_replicas: int
    actor_options: dict = field(default_factory=dict)
    autoscaling: Optional[AutoscalingConfig] = None
    replicas: List = field(default_factory=list)
    replica_set: ReplicaSet = None
    state: str = "DEPLOYING"     # DEPLOYING|HEALTHY|DELETING
    # Version of this deploy (reference: DeploymentVersion). Replicas
    # are tagged with the generation that created them; a redeploy
    # bumps it and the reconcile loop ROLLS old-generation replicas
    # out one at a time, each replacement gated on the new replica's
    # health — never a mass kill.
    generation: int = 0
    # Bounded wait for a retiring replica's in-flight requests
    # (reference: graceful_shutdown_timeout_s + wait_loop).
    graceful_shutdown_timeout_s: float = 20.0
    _last_scale_change: float = 0.0
    _scale_pressure_since: Optional[float] = None
    # backpressure-driven autoscaling state (docs/serve.md): EWMA of
    # total load (queue depth + ongoing), evaluated every
    # serve_autoscale_interval_s
    _load_ewma: Optional[float] = None
    _last_autoscale_eval: float = 0.0
    _scale_dir: Optional[bool] = None   # True = pressure upward


class ServeController:
    """Driver-side reconcile loop over the deployment table."""

    RECONCILE_PERIOD_S = 0.25

    def __init__(self):
        self._lock = threading.RLock()
        self._deployments: Dict[str, DeploymentInfo] = {}
        # worker-hosted ingress proxies fed by route-table pushes
        self._proxies: List = []
        self._pushed_routes: Dict[str, tuple] = {}
        self._draining: Dict[object, str] = {}   # handle -> deployment
        self._shutdown = threading.Event()
        # Serializes reconcile passes: deploy() reconciles inline while
        # the background loop also runs — unserialized, both see
        # len(replicas) < target and double-create, and the surplus
        # replica can eat the cluster's last CPU so the next creation
        # parks in the scheduler forever.
        self._reconcile_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-serve-controller")
        self._thread.start()
        from ray_tpu_torch._private import serve_stats
        serve_stats.register_controller(self)

    # -- worker-hosted ingress -----------------------------------------

    def register_proxy(self, proxy_handle) -> None:
        """Attach a ProxyActor: it receives the current route table now
        and every membership change from here on."""
        with self._lock:
            self._proxies.append(proxy_handle)
            infos = list(self._deployments.values())
        for info in infos:
            try:
                _ = proxy_handle.update_routes.remote(
                    info.name, info.replica_set)
            except Exception:
                logger.exception("proxy route push failed")

    def _push_routes(self, info: DeploymentInfo) -> None:
        """Push this deployment's replica snapshot to every proxy when
        membership changed since the last push. Keyed on stable actor
        ids — id() reuse after a replica swap would alias a changed
        membership to the cached key."""
        key = tuple(r._actor_id.hex() for r in info.replicas)
        with self._lock:
            if self._pushed_routes.get(info.name) == key:
                return
            self._pushed_routes[info.name] = key
            proxies = list(self._proxies)
        for proxy in proxies:
            try:
                _ = proxy.update_routes.remote(info.name,
                                               info.replica_set)
            except Exception:
                logger.exception("proxy route push failed")

    # -- API -----------------------------------------------------------

    def deploy(self, name: str, target, init_args: tuple,
               init_kwargs: dict, num_replicas: int,
               actor_options: Optional[dict] = None,
               autoscaling: Optional[AutoscalingConfig] = None,
               max_ongoing_requests: Optional[int] = None,
               graceful_shutdown_timeout_s: float = 20.0,
               max_queued_requests: Optional[int] = None
               ) -> ReplicaSet:
        info = DeploymentInfo(
            name=name,
            deployment_blob=cloudpickle.dumps(target),
            init_args=init_args, init_kwargs=init_kwargs,
            num_replicas=num_replicas,
            actor_options=dict(actor_options or {}),
            autoscaling=autoscaling,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            replica_set=ReplicaSet(name))
        if autoscaling is not None:
            info.num_replicas = max(autoscaling.min_replicas,
                                    min(num_replicas,
                                        autoscaling.max_replicas))
        with self._lock:
            old = self._deployments.get(name)
            if old is not None:
                # Rolling update: the old generation KEEPS SERVING;
                # reconcile replaces its replicas one health-gated
                # step at a time (mass-killing here = dropped
                # requests for the whole redeploy window).
                info.replica_set = old.replica_set   # handles stay valid
                info.generation = old.generation + 1
                info.replicas = list(old.replicas)
            self._deployments[name] = info
            # inside the lock and after the old-set swap: a concurrent
            # redeploy must not leave the superseded deploy's cap,
            # queue bound, or batch table on the shared replica set
            info.replica_set.max_ongoing = max_ongoing_requests
            info.replica_set.max_queued = max_queued_requests
            info.replica_set.batch_cfg = _discover_batch_cfg(target)
        self._reconcile_once()
        return info.replica_set

    def delete(self, name: str) -> None:
        # Under the reconcile lock: an in-flight background pass would
        # otherwise finish AFTER this delete and re-install routes to
        # the replicas killed here — permanently, since the deployment
        # is no longer in the table for a later pass to retract.
        with self._reconcile_lock:
            with self._lock:
                info = self._deployments.pop(name, None)
                self._pushed_routes.pop(name, None)
                proxies = list(self._proxies)
            if info is not None:
                # fail parked batched requests typed BEFORE replicas
                # die (their dispatches would fail anyway; this is the
                # deterministic path) and stop the flusher
                info.replica_set.close()
                self._kill_replicas(info.replicas)
                info.replica_set.set_replicas([])
                for proxy in proxies:
                    try:
                        _ = proxy.update_routes.remote(name, None)
                    except Exception:
                        pass    # proxy died: nothing routes there now

    def get_replica_set(self, name: str) -> Optional[ReplicaSet]:
        with self._lock:
            info = self._deployments.get(name)
            return info.replica_set if info else None

    def status(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "state": info.state,
                    "target_replicas": info.num_replicas,
                    "live_replicas": len(info.replicas),
                    "ongoing_requests": info.replica_set.total_inflight(),
                    "queued_requests": info.replica_set.total_queued(),
                    "generation": info.generation,
                    "updating": any(
                        getattr(r, "_serve_gen", info.generation)
                        != info.generation for r in info.replicas),
                    "draining_replicas": sum(
                        1 for n in self._draining.values()
                        if n == name),
                }
                for name, info in self._deployments.items()
            }

    def wait_healthy(self, name: str, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                info = self._deployments.get(name)
                if info is not None and info.state == "HEALTHY":
                    return
            time.sleep(0.05)
        raise TimeoutError(f"deployment {name!r} never became healthy")

    def metrics_snapshot(self):
        """[(deployment, queue_depth, live_replicas), ...] for the
        runtime metrics collector (stats.py serve gauges)."""
        with self._lock:
            infos = list(self._deployments.values())
        return [(info.name, info.replica_set.total_queued(),
                 len(info.replicas)) for info in infos]

    def detach_proxies(self) -> None:
        """Stop routing to the worker-hosted proxies (serve.shutdown
        step 1): no further route pushes or autoscale aggregation —
        the proxies can then drain and be killed without racing a
        controller push."""
        with self._lock:
            self._proxies = []

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._lock:
            names = list(self._deployments)
        for name in names:
            self.delete(name)

    # -- reconcile loop ------------------------------------------------

    def _loop(self) -> None:
        while not self._shutdown.wait(self.RECONCILE_PERIOD_S):
            try:
                self._reconcile_once()
            except Exception:
                logger.exception("serve reconcile error")

    def _reconcile_once(self) -> None:
        with self._reconcile_lock:
            with self._lock:
                infos = list(self._deployments.values())
            for info in infos:
                # blocking-ok: _reconcile_lock exists to serialize
                # exactly this pass (liveness probes, replica spawns)
                # against deploy/delete; only those paths contend, and
                # they must observe a finished reconcile, not overlap
                # one. The hot path (router/handles) never takes it.
                self._reconcile_deployment(info)

    def _reconcile_deployment(self, info: DeploymentInfo) -> None:
        if self._shutdown.is_set():
            return
        with self._lock:
            if self._deployments.get(info.name) is not info:
                return   # superseded by a redeploy/delete mid-pass
        # 1. drop dead replicas (replica-death recovery)
        live = []
        for handle in info.replicas:
            if self._replica_alive(handle):
                live.append(handle)
            else:
                logger.warning("serve %s: replica died; replacing",
                               info.name)
        info.replicas = live

        # 2. autoscale on ongoing requests
        if info.autoscaling is not None:
            self._autoscale(info)

        # 3. converge toward target. Replicas are generation-tagged:
        # during a rolling update both generations serve, and each
        # retirement is gated on a new replica having passed health.
        gen = info.generation
        new_gen = [r for r in info.replicas
                   if getattr(r, "_serve_gen", gen) == gen]
        old_gen = [r for r in info.replicas if r not in new_gen]

        while len(new_gen) < info.num_replicas:
            handle = self._create_replica(info)   # health-gated (ping)
            if handle is None:
                break
            with self._lock:
                superseded = self._deployments.get(info.name) is not info
            if superseded:
                # a redeploy/delete swapped the table mid-create: this
                # replica belongs to a dead generation — kill it now or
                # it holds resources forever with no owner
                self._kill_replicas([handle])
                return
            info.replicas.append(handle)
            new_gen.append(handle)
            # one-at-a-time roll: each healthy new replica retires one
            # old-generation replica (drained, never killed in flight)
            if old_gen:
                victim = old_gen.pop(0)
                info.replicas.remove(victim)
                self._drain_replica(info, victim)
        # all new-generation slots filled (vacuously so for a target of
        # zero): retire any old stragglers
        while len(new_gen) >= info.num_replicas and old_gen:
            victim = old_gen.pop(0)
            info.replicas.remove(victim)
            self._drain_replica(info, victim)
        # downscale: victims drain too — a downscale under load must
        # not drop the requests already running on the victim
        while len(new_gen) > info.num_replicas:
            victim = new_gen.pop()
            info.replicas.remove(victim)
            self._drain_replica(info, victim)

        info.replica_set.set_replicas(info.replicas)
        info.state = ("HEALTHY"
                      if len(info.replicas) >= max(1, info.num_replicas)
                      else "DEPLOYING")
        self._push_routes(info)

    # -- graceful drain ------------------------------------------------

    def _drain_replica(self, info: DeploymentInfo, handle) -> None:
        """Retire a replica without dropping requests: it is already
        out of ``info.replicas`` — route tables stop sending it new
        work NOW (proxy pushes ACKED, not fire-and-forget, so no stale
        snapshot routes to it after the drain decision); a background
        drainer waits (bounded) for its in-flight count to reach zero,
        then kills it."""
        info.replica_set.set_replicas(info.replicas)
        self._push_routes(info)
        with self._lock:
            proxies = list(self._proxies)
            self._draining[handle] = info.name
        for proxy in proxies:
            try:
                ray_tpu_torch.get(
                    proxy.update_routes.remote(info.name,
                                               info.replica_set),
                    timeout=10)
            except Exception:
                pass      # dead proxy: nothing routes through it
        t = threading.Thread(
            target=self._drain_and_kill,
            args=(handle, info.graceful_shutdown_timeout_s),
            daemon=True, name="rtpu-serve-drain")
        t.start()

    def _drain_and_kill(self, handle, timeout_s: float) -> None:
        from ray_tpu_torch.exceptions import GetTimeoutError
        deadline = time.monotonic() + timeout_s
        # settle: a request assigned just before the route update (or a
        # streaming call not yet visible in the replica's count) is
        # still in flight toward the replica
        time.sleep(0.3)
        zeros = 0
        while time.monotonic() < deadline:
            try:
                n = int(ray_tpu_torch.get(handle.num_ongoing.remote(),
                                          timeout=5))
            except GetTimeoutError:
                # event loop busy with a long request — still draining
                zeros = 0
                continue
            except Exception:
                break                      # replica already dead
            zeros = zeros + 1 if n == 0 else 0
            if zeros >= 2:
                break
            time.sleep(0.25)
        self._kill_replicas([handle])
        with self._lock:
            self._draining.pop(handle, None)

    def _proxy_ongoing(self, name: str) -> int:
        """Aggregate in-flight counts from worker-hosted proxies: their
        pickled ReplicaSet snapshots charge requests locally, invisible
        to the driver-side set — without this, proxy traffic would
        never scale a deployment up."""
        with self._lock:
            proxies = list(self._proxies)
        total = 0
        for proxy in proxies:
            try:
                total += int(ray_tpu_torch.get(
                    proxy.ongoing.remote(name), timeout=2))
            except Exception:
                pass        # dead/slow proxy: count what we can see
        return total

    def _autoscale(self, info: DeploymentInfo) -> None:
        """Backpressure-driven autoscaling (docs/serve.md): every
        ``serve_autoscale_interval_s`` fold the deployment's TOTAL
        load — queue depth (batch-parked + admission waiters) plus
        ongoing requests, proxies included — into an EWMA and steer
        the target straight to ``ceil(ewma / target_ongoing_requests)``
        within [min_replicas, max_replicas]. Direction changes reset
        the up/downscale delay; scale-down victims drain through the
        existing graceful-shutdown path."""
        import math

        from ray_tpu_torch._private.config import get_config
        cfg = info.autoscaling
        rcfg = get_config()
        now = time.monotonic()
        if now - info._last_autoscale_eval < rcfg.serve_autoscale_interval_s:
            return
        info._last_autoscale_eval = now
        load = info.replica_set.total_queued()
        if self._proxies:
            load += self._proxy_ongoing(info.name)
        alpha = min(1.0, max(0.0, rcfg.serve_autoscale_ewma_alpha))
        info._load_ewma = (float(load) if info._load_ewma is None
                           else alpha * load
                           + (1.0 - alpha) * info._load_ewma)
        target = max(cfg.target_ongoing_requests, 1e-9)
        desired = int(math.ceil(info._load_ewma / target))
        desired = min(max(desired, cfg.min_replicas), cfg.max_replicas)
        if desired == info.num_replicas:
            info._scale_pressure_since = None
            info._scale_dir = None
            return
        up = desired > info.num_replicas
        if info._scale_pressure_since is None or info._scale_dir != up:
            info._scale_pressure_since = now
            info._scale_dir = up
            return
        delay = cfg.upscale_delay_s if up else cfg.downscale_delay_s
        if now - info._scale_pressure_since < delay:
            return
        logger.info("serve %s: autoscale %d -> %d (load=%d ewma=%.1f)",
                    info.name, info.num_replicas, desired, load,
                    info._load_ewma)
        info.num_replicas = desired
        info._scale_pressure_since = None
        info._scale_dir = None

    # -- replica lifecycle ---------------------------------------------

    def _create_replica(self, info: DeploymentInfo):
        try:
            actor_cls = ray_tpu_torch.remote(ReplicaActor)
            opts = dict(info.actor_options)
            opts.setdefault("max_restarts", 0)
            handle = actor_cls.options(**opts).remote(
                info.deployment_blob, info.init_args, info.init_kwargs,
                info.replica_set.max_ongoing)
            # wait for construction so state flips once it's servable
            ray_tpu_torch.get(handle.ping.remote(), timeout=120)
            handle._serve_gen = info.generation
            return handle
        except Exception:
            # A reconcile tick racing runtime teardown is not an error
            # worth a traceback in CI logs (round-3 weak #8c).
            if not self._shutdown.is_set():
                logger.exception("serve %s: replica creation failed",
                                 info.name)
            return None

    @staticmethod
    def _replica_alive(handle) -> bool:
        from ray_tpu_torch._private.worker import global_worker
        info = global_worker().gcs.get_actor_info(handle._actor_id)
        return info is not None and info.state == "ALIVE"

    @staticmethod
    def _kill_replicas(handles) -> None:
        for handle in handles:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass    # replica already dead
