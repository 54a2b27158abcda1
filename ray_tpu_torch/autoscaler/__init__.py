"""ray_tpu_torch.autoscaler — demand-driven cluster scaling.

Reference: ``python/ray/autoscaler/`` v1 monitor loop + v2 instance
manager [UNVERIFIED — mount empty, SURVEY.md §0]: read unmet resource
demand from the scheduler, bin-pack it onto configured node types,
drive a pluggable NodeProvider to launch/terminate; reap nodes idle
past a timeout. Providers wrap whatever actually provisions capacity —
the in-tree one drives ``Cluster`` (raylet processes on this machine,
the test topology); cloud providers implement the same three methods.
A node type's ``"GPU"`` becomes the node's ``num_gpus``; a remote
raylet sees no card, so a remote provider refuses a GPU node type when
the scaler is built (a logical GPU node's work runs on driver threads).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import NodeID

logger = logging.getLogger(__name__)

__all__ = ["NodeProvider", "ClusterNodeProvider", "NodeType",
           "Autoscaler"]


class NodeProvider:
    """Plugin seam (reference: node-provider API)."""

    def check_node_type(self, node_type: "NodeType") -> None:
        """Raise if this provider can never launch ``node_type``."""

    def create_node(self, node_type: "NodeType") -> NodeID:
        raise NotImplementedError

    def terminate_node(self, node_id: NodeID) -> None:
        raise NotImplementedError


class ClusterNodeProvider(NodeProvider):
    """Provisions nodes on the local Cluster utility (logical or raylet
    processes) — the autoscaler's test/provider reference."""

    def __init__(self, cluster, remote: bool = False):
        self._cluster = cluster
        self._remote = remote

    def check_node_type(self, node_type: "NodeType") -> None:
        if self._remote:
            from ray_tpu_torch.cluster_utils import refuse_remote_gpu
            refuse_remote_gpu(node_type.resources)

    def create_node(self, node_type: "NodeType") -> NodeID:
        res = dict(node_type.resources)
        num_cpus = res.pop("CPU", 1)
        num_gpus = res.pop("GPU", 0)
        return self._cluster.add_node(
            num_cpus=num_cpus, num_gpus=num_gpus, resources=res,
            remote=self._remote)

    def terminate_node(self, node_id: NodeID) -> None:
        self._cluster.remove_node(node_id)


@dataclass
class NodeType:
    name: str
    resources: Dict[str, float]
    max_workers: int = 10


@dataclass
class _ManagedNode:
    node_type: str
    launched_at: float
    idle_since: Optional[float] = None


class Autoscaler:
    """Monitor loop: unmet demand up-scales, idleness down-scales."""

    def __init__(self, provider: NodeProvider,
                 node_types: List[NodeType],
                 idle_timeout_s: float = 60.0,
                 period_s: float = 0.5,
                 worker=None):
        from ray_tpu_torch._private.worker import global_worker
        for t in node_types:
            provider.check_node_type(t)
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.period_s = period_s
        self._worker = worker or global_worker()
        self._managed: Dict[NodeID, _ManagedNode] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_launched = 0
        self.num_terminated = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- the monitor loop ----------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self._reconcile()
            except Exception:
                logger.exception("autoscaler reconcile error")

    def _reconcile(self) -> None:
        self._scale_up()
        self._scale_down()

    def _count(self, type_name: str) -> int:
        with self._lock:
            return sum(1 for m in self._managed.values()
                       if m.node_type == type_name)

    def _scale_up(self) -> None:
        ng = self._worker.node_group
        demand = ng.pending_resource_demand()
        if not demand:
            return
        # capacity view: what could the CURRENT nodes ever run
        totals = [dict(res.total) for _nid, res in
                  ng.cluster_resources.nodes()]

        def fits(shape: Dict[str, float], capacity: Dict[str, float]
                 ) -> bool:
            return all(capacity.get(k, 0.0) + 1e-9 >= v
                       for k, v in shape.items())

        unmet = [d for d in demand
                 if not any(fits(d, t) for t in totals)]
        launched_types = set()
        for shape in unmet:
            for node_type in self.node_types.values():
                if node_type.name in launched_types:
                    continue          # one launch per type per tick
                if not fits(shape, node_type.resources):
                    continue
                if self._count(node_type.name) >= node_type.max_workers:
                    continue
                logger.info("autoscaler: launching %s for demand %s",
                            node_type.name, shape)
                node_id = self.provider.create_node(node_type)
                with self._lock:
                    self._managed[node_id] = _ManagedNode(
                        node_type.name, time.monotonic())
                self.num_launched += 1
                launched_types.add(node_type.name)
                break

    def _scale_down(self) -> None:
        ng = self._worker.node_group
        now = time.monotonic()
        view = {nid: res for nid, res in ng.cluster_resources.nodes()}
        with self._lock:
            managed = dict(self._managed)
        for node_id, m in managed.items():
            res = view.get(node_id)
            if res is None:           # already gone
                with self._lock:
                    self._managed.pop(node_id, None)
                continue
            fully_idle = all(
                abs(res.available.get(k, 0.0) - v) < 1e-9
                for k, v in res.total.items())
            if not fully_idle:
                with self._lock:
                    self._managed[node_id].idle_since = None
                continue
            with self._lock:
                if self._managed[node_id].idle_since is None:
                    self._managed[node_id].idle_since = now
                    continue
                idle_for = now - self._managed[node_id].idle_since
            if idle_for >= self.idle_timeout_s:
                logger.info("autoscaler: terminating idle node %s",
                            node_id.hex()[:8])
                self.provider.terminate_node(node_id)
                with self._lock:
                    self._managed.pop(node_id, None)
                self.num_terminated += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "managed_nodes": len(self._managed),
                "num_launched": self.num_launched,
                "num_terminated": self.num_terminated,
            }
