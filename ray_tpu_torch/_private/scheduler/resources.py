"""Resource bookkeeping for cluster scheduling.

The port's own copy of ``ray_tpu/_private/scheduler/resources.py``.

Reference: ``src/ray/raylet/scheduling/cluster_resource_manager`` +
``local_resource_manager`` [UNVERIFIED — mount empty, SURVEY.md §0].
The cluster view is eventually consistent (updated by node reports);
the local view is authoritative for the node's own dispatch.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Set, Tuple

from ray_tpu_torch._private.ids import NodeID

ResourceRequest = Dict[str, float]

_EPS = 1e-9


@dataclass
class NodeResources:
    total: Dict[str, float] = field(default_factory=dict)
    available: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True

    @staticmethod
    def of(**total: float) -> "NodeResources":
        return NodeResources(total=dict(total), available=dict(total))

    def is_feasible(self, demand: ResourceRequest) -> bool:
        """Could this node EVER run the request (vs. total)."""
        return all(self.total.get(k, 0.0) + _EPS >= v for k, v in demand.items())

    def is_available(self, demand: ResourceRequest) -> bool:
        return all(self.available.get(k, 0.0) + _EPS >= v
                   for k, v in demand.items())

    def allocate(self, demand: ResourceRequest) -> bool:
        if not self.is_available(demand):
            return False
        for k, v in demand.items():
            self.available[k] = self.available.get(k, 0.0) - v
        return True

    def free(self, demand: ResourceRequest) -> None:
        for k, v in demand.items():
            self.available[k] = min(self.total.get(k, 0.0),
                                    self.available.get(k, 0.0) + v)

    def critical_utilization(self) -> float:
        """max over resources of used/total — the hybrid policy's packing
        signal (reference: HybridSchedulingPolicy)."""
        worst = 0.0
        for k, tot in self.total.items():
            if tot <= 0:
                continue
            used = tot - self.available.get(k, 0.0)
            worst = max(worst, used / tot)
        return worst

    def copy(self) -> "NodeResources":
        return NodeResources(dict(self.total), dict(self.available),
                             dict(self.labels), self.alive)


class ClusterResourceManager:
    """View of every node's resources, keyed by NodeID.

    Thread-safe; the scheduler reads it, node reports / local dispatch
    write it.
    """

    _LOG_CAP = 4096

    def __init__(self):
        self._nodes: Dict[NodeID, NodeResources] = {}
        self._lock = threading.RLock()
        self._version = 0  # bumped on every mutation; lets the TPU policy
        #                    invalidate its device-resident resource matrix.
        # Bounded mutation log: (version, node_id, membership_change).
        # Policies use it to update their dense matrices row-wise instead
        # of rebuilding O(nodes) state per scheduling batch.
        self._log: deque = deque(maxlen=self._LOG_CAP)
        # Active heartbeat-report corrections per node (apply_report).
        self._report_corrections: Dict[NodeID, Dict[str, float]] = {}

    def add_or_update_node(self, node_id: NodeID,
                           resources: NodeResources) -> None:
        with self._lock:
            self._nodes[node_id] = resources
            self._version += 1
            self._log.append((self._version, node_id, True))

    def remove_node(self, node_id: NodeID) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)
            self._version += 1
            self._log.append((self._version, node_id, True))

    def set_node_alive(self, node_id: NodeID, alive: bool) -> bool:
        """Flip the node's alive-mask bit (the scheduler's cordon
        seam: every policy and ``allocate`` refuse non-alive nodes,
        so a cordoned node takes no new leases while running work
        still ``free``s normally). Recorded as a membership change so
        dense policy views rebuild their row for the node."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or node.alive == alive:
                return False
            node.alive = alive
            self._version += 1
            self._log.append((self._version, node_id, True))
            return True

    def get_node(self, node_id: NodeID) -> Optional[NodeResources]:
        with self._lock:
            return self._nodes.get(node_id)

    def nodes(self) -> Iterator[Tuple[NodeID, NodeResources]]:
        with self._lock:
            return iter(list(self._nodes.items()))

    def num_nodes(self) -> int:
        with self._lock:
            return len(self._nodes)

    def version(self) -> int:
        with self._lock:
            return self._version

    def allocate(self, node_id: NodeID, demand: ResourceRequest) -> bool:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return False
            ok = node.allocate(demand)
            if ok:
                self._version += 1
                self._log.append((self._version, node_id, False))
            return ok

    def free(self, node_id: NodeID, demand: ResourceRequest) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.free(demand)
                self._version += 1
                self._log.append((self._version, node_id, False))

    def apply_report(self, node_id: NodeID,
                     reported: ResourceRequest) -> None:
        """Reconcile the ledger with a raylet's self-reported
        availability (reference: ray_syncer resource broadcast). The
        correction only ever SHRINKS the view — min(ledger, report) —
        so allocations in flight that the raylet has not yet observed
        are never double-counted; each heartbeat first undoes the
        previous correction, so the view recovers as soon as the
        raylet reports capacity back."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            prev = self._report_corrections.pop(node_id, {})
            for k, v in prev.items():
                node.available[k] = min(node.total.get(k, 0.0),
                                        node.available.get(k, 0.0) + v)
            corr = {}
            for k, rep in reported.items():
                avail = node.available.get(k, 0.0)
                if rep + _EPS < avail:
                    corr[k] = avail - rep
                    node.available[k] = rep
            if corr:
                self._report_corrections[node_id] = corr
            if corr or prev:
                self._version += 1
                self._log.append((self._version, node_id, False))

    def reacquire(self, node_id: NodeID, demand: ResourceRequest) -> None:
        """Take back resources a blocked task released while waiting on
        get(). Unconditional: the worker already occupies the CPU, so a
        transient oversubscription here is truthful accounting that
        corrects as other tasks finish."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return
            for k, v in demand.items():
                node.available[k] = node.available.get(k, 0.0) - v
            self._version += 1
            self._log.append((self._version, node_id, False))

    def changes_since(self, version: int
                      ) -> Optional[Tuple[Set[NodeID], bool]]:
        """(dirty_nodes, membership_changed) covering (version, now], or
        None when the gap outran the bounded log (caller must rebuild)."""
        with self._lock:
            if version == self._version:
                return set(), False
            if not self._log or self._log[0][0] > version + 1:
                return None
            dirty: Set[NodeID] = set()
            membership = False
            # Newest-first, stopping at the caller's version: the log
            # is append-only with increasing versions, so the scan is
            # O(changes since last call), not O(log capacity) — a full
            # 4096-entry sweep per scheduling tick was the single
            # biggest fixed cost of the hot scheduling loop.
            for v, nid, member in reversed(self._log):
                if v <= version:
                    break
                dirty.add(nid)
                membership = membership or member
            return dirty, membership

    def snapshot(self) -> Dict[NodeID, NodeResources]:
        with self._lock:
            return {nid: r.copy() for nid, r in self._nodes.items()}
