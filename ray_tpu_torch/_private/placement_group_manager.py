"""Placement groups: gang resource reservation with 2-phase semantics.

Reference analogs [UNVERIFIED — mount empty, SURVEY.md §0]:
``src/ray/gcs/gcs_server/gcs_placement_group_manager.cc`` +
``gcs_placement_group_scheduler.cc`` (2-phase prepare/commit of
bundles across raylets) and
``src/ray/raylet/scheduling/policy/bundle_scheduling_policy.cc``
(PACK / SPREAD / STRICT_PACK / STRICT_SPREAD bin-packing).

Reservation here is all-or-nothing against the shared
``ClusterResourceManager`` (the in-process analog of prepare/commit:
a trial assignment is computed on a snapshot, then committed with
rollback on conflict). Tasks and actors scheduled into a bundle draw
from the bundle's reservation, not the node's free pool, and return
capacity to the bundle on completion.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import NodeID, PlacementGroupID
from ray_tpu_torch._private.scheduler.resources import (
    ClusterResourceManager,
    NodeResources,
    ResourceRequest,
)

logger = logging.getLogger(__name__)

_EPS = 1e-9


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: List[ResourceRequest]
    strategy: str                   # PACK|SPREAD|STRICT_PACK|STRICT_SPREAD
    name: str = ""
    state: str = "PENDING"          # PENDING|CREATED|REMOVED
    bundle_nodes: List[NodeID] = field(default_factory=list)
    # remaining capacity inside each bundle's reservation:
    bundle_avail: List[ResourceRequest] = field(default_factory=list)
    is_infeasible: bool = False     # no node set could EVER host it

    def table_entry(self) -> dict:
        return {
            "placement_group_id": self.pg_id.hex(),
            "name": self.name,
            "strategy": self.strategy,
            "state": self.state,
            "bundles": {i: dict(b) for i, b in enumerate(self.bundles)},
            "bundle_nodes": [n.hex() for n in self.bundle_nodes],
        }


_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroupManager:
    """Owns all placement groups; schedules pending ones as capacity
    appears (poked by the node manager's scheduling loop)."""

    def __init__(self, cluster: ClusterResourceManager,
                 on_created: Optional[Callable[[PlacementGroupInfo], None]]
                 = None, device="cpu"):
        self._cluster = cluster
        self._device = device   # where the packing kernel would run
        self._on_created = on_created
        self._lock = threading.RLock()
        self._groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self._pending: List[PlacementGroupID] = []
        self._kernel_solver = None   # lazy jitted bin-packer
        self.num_kernel_solves = 0
        self.num_batched_solves = 0  # multi-group launches (storms)

    # -- creation / removal ------------------------------------------------

    def create(self, pg_id: PlacementGroupID, bundles: List[ResourceRequest],
               strategy: str, name: str = "") -> PlacementGroupInfo:
        if strategy not in _STRATEGIES:
            raise ValueError(f"invalid strategy {strategy!r}; "
                             f"one of {_STRATEGIES}")
        if not bundles:
            raise ValueError("placement group needs at least one bundle")
        for b in bundles:
            if not b or any(v <= 0 for v in b.values()):
                raise ValueError(f"invalid bundle {b!r}: resources must "
                                 "be positive")
        info = PlacementGroupInfo(
            pg_id=pg_id,
            bundles=[dict(b) for b in bundles],
            strategy=strategy, name=name)
        with self._lock:
            self._groups[pg_id] = info
            self._pending.append(pg_id)
        self.try_schedule_pending()
        return info

    def remove(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            info = self._groups.get(pg_id)
            if info is None or info.state == "REMOVED":
                return
            was_created = info.state == "CREATED"
            info.state = "REMOVED"
            if pg_id in self._pending:
                self._pending.remove(pg_id)
            nodes = list(info.bundle_nodes)
            avails = [dict(a) for a in info.bundle_avail]
        if was_created:
            # Return each bundle's *remaining* reserve to its node; the
            # in-use share is returned directly to the node when the
            # running task/actor finishes (see free_to_bundle).
            for node_id, avail in zip(nodes, avails):
                self._cluster.free(node_id, avail)

    def get(self, pg_id: PlacementGroupID) -> Optional[PlacementGroupInfo]:
        with self._lock:
            return self._groups.get(pg_id)

    def table(self) -> List[dict]:
        with self._lock:
            return [g.table_entry() for g in self._groups.values()]

    # -- scheduling --------------------------------------------------------

    def try_schedule_pending(self) -> None:
        """Attempt to place every pending group (all-or-nothing each).

        When several groups of one strategy are pending at once — a
        PR-4 restart storm re-creating gangs, a PR-6 slice-set re-form
        — and the kernel path is on, they pack in ONE batched launch
        (``PgKernelSolver.solve_many``); groups the batched solve
        can't fit (or whose commit loses a race) fall back to the
        single-group path below, which also owns infeasibility
        marking."""
        with self._lock:
            pending = list(self._pending)
        batched = self._try_schedule_batched(pending)
        for pg_id in pending:
            if pg_id in batched:
                continue
            with self._lock:
                info = self._groups.get(pg_id)
                if info is None or info.state != "PENDING":
                    continue
            self._try_place(info)

    def _try_schedule_batched(self, pending) -> set:
        """One kernel launch per pending strategy cohort; returns the
        pg_ids successfully COMMITTED (the rest retry singly)."""
        placed: set = set()
        with self._lock:
            cohorts: Dict[str, List[PlacementGroupInfo]] = {}
            for pg_id in pending:
                info = self._groups.get(pg_id)
                if info is not None and info.state == "PENDING":
                    cohorts.setdefault(info.strategy, []).append(info)
        for strategy, infos in cohorts.items():
            if len(infos) < 2:
                continue
            solver = self._kernel_for(
                sum(len(i.bundles) for i in infos))
            if solver is None:
                continue
            try:
                assignments = solver.solve_many(
                    self._cluster, [i.bundles for i in infos], strategy)
            except Exception:
                logger.exception("batched pg kernel solve failed; "
                                 "single-group fallback")
                continue
            self.num_batched_solves += 1
            for info, assignment in zip(infos, assignments):
                if assignment is not None and self._commit(info,
                                                           assignment):
                    placed.add(info.pg_id)
        return placed

    def _try_place(self, info: PlacementGroupInfo) -> None:
        assignment = self._solve(info)
        if assignment is None:
            return
        self._commit(info, assignment)

    def _commit(self, info: PlacementGroupInfo,
                assignment: List[NodeID]) -> bool:
        """Allocate each bundle from its node, rolling back on any
        conflict with a concurrent allocation (2-phase analogue)."""
        committed: List[Tuple[NodeID, ResourceRequest]] = []
        for node_id, bundle in zip(assignment, info.bundles):
            if not self._cluster.allocate(node_id, bundle):
                for nid, b in committed:
                    self._cluster.free(nid, b)
                return False
            committed.append((node_id, bundle))
        with self._lock:
            if info.state != "PENDING":
                # removed concurrently: roll the commit back
                for nid, b in committed:
                    self._cluster.free(nid, b)
                return False
            info.bundle_nodes = list(assignment)
            info.bundle_avail = [dict(b) for b in info.bundles]
            info.state = "CREATED"
            if info.pg_id in self._pending:
                self._pending.remove(info.pg_id)
        if self._on_created is not None:
            try:
                self._on_created(info)
            except Exception:
                logger.exception("pg on_created callback failed")
        return True

    def _kernel_for(self, n_bundles: int):
        """The lazily-built jitted solver when the kernel path is on
        and ``bundles × nodes`` crosses the work threshold; None
        defers to the Python paths."""
        from ray_tpu_torch._private.config import get_config
        work = n_bundles * self._cluster.num_nodes()
        if work < get_config().pg_kernel_min_work:
            return None
        from ray_tpu_torch._private.scheduler.policy import _tpu_scheduler_enabled
        if not _tpu_scheduler_enabled(self._device):
            return None
        if self._kernel_solver is None:
            from ray_tpu_torch._private.scheduler.pg_kernel import (
                PgKernelSolver)
            self._kernel_solver = PgKernelSolver(device=self._device)
        return self._kernel_solver

    def _try_kernel_solve(self, info: PlacementGroupInfo
                          ) -> Optional[List[NodeID]]:
        """The jitted assignment solve (BASELINE.json:5) for big
        bundle × node products on accelerator hosts; None defers to
        the Python greedy (which also owns infeasibility marking)."""
        solver = self._kernel_for(len(info.bundles))
        if solver is None:
            return None
        try:
            return solver.solve(self._cluster, info.bundles,
                                info.strategy)
        except Exception:
            logger.exception("pg kernel solve failed; python fallback")
            return None

    def _solve(self, info: PlacementGroupInfo
               ) -> Optional[List[NodeID]]:
        """Trial assignment of bundles -> nodes on a snapshot; None if it
        doesn't fit right now. Sets ``is_infeasible`` when it can never
        fit the current node set."""
        kernel_assignment = self._try_kernel_solve(info)
        if kernel_assignment is not None:
            self.num_kernel_solves += 1
            return kernel_assignment
        view = self._cluster.snapshot()
        alive = {nid: n for nid, n in view.items() if n.alive}
        strategy = info.strategy
        bundles = info.bundles

        if strategy == "STRICT_PACK":
            total: ResourceRequest = {}
            for b in bundles:
                for k, v in b.items():
                    total[k] = total.get(k, 0.0) + v
            feasible = any(n.is_feasible(total) for n in alive.values())
            info.is_infeasible = not feasible
            candidates = sorted(
                (nid for nid, n in alive.items() if n.is_available(total)),
                key=lambda nid: alive[nid].critical_utilization())
            if not candidates:
                return None
            return [candidates[0]] * len(bundles)

        if strategy in ("SPREAD", "STRICT_SPREAD"):
            strict = strategy == "STRICT_SPREAD"
            if strict and len(alive) < len(bundles):
                info.is_infeasible = True
                return None
            assignment: List[NodeID] = []
            used: set = set()
            for b in bundles:
                # least-utilized node not already used by this group
                choices = sorted(
                    ((n.critical_utilization(), nid)
                     for nid, n in alive.items()
                     if nid not in used and n.is_available(b)),
                    key=lambda t: t[0])
                if not choices and not strict:
                    choices = sorted(
                        ((n.critical_utilization(), nid)
                         for nid, n in alive.items() if n.is_available(b)),
                        key=lambda t: t[0])
                if not choices:
                    if strict and not any(
                            n.is_feasible(b) for nid, n in alive.items()
                            if nid not in used):
                        info.is_infeasible = True
                    return None
                _, nid = choices[0]
                alive[nid].allocate(b)
                used.add(nid)
                assignment.append(nid)
            return assignment

        # PACK: prefer co-locating everything on the fullest feasible
        # node, then overflow to more nodes greedily.
        assignment = []
        for b in bundles:
            choices = sorted(
                ((-n.critical_utilization(), nid)
                 for nid, n in alive.items() if n.is_available(b)),
                key=lambda t: t[0])
            if not choices:
                if not any(n.is_feasible(b) for n in alive.values()):
                    info.is_infeasible = True
                return None
            _, nid = choices[0]
            alive[nid].allocate(b)
            assignment.append(nid)
        return assignment

    def on_node_removed(self, node_id: NodeID) -> None:
        """A node died: every CREATED group with a bundle there loses its
        gang guarantee, so the whole group is dissolved (callers see
        PlacementGroupError and recreate — the Train/Tune layers drive
        gang restart). Remaining reserves on surviving nodes are
        returned; frees targeting the dead node are no-ops."""
        with self._lock:
            hit = [g for g in self._groups.values()
                   if g.state == "CREATED" and node_id in g.bundle_nodes]
            for g in hit:
                g.state = "REMOVED"
                nodes = list(g.bundle_nodes)
                avails = [dict(a) for a in g.bundle_avail]
                for nid, avail in zip(nodes, avails):
                    self._cluster.free(nid, avail)

    # -- bundle-level allocation (tasks/actors inside the group) ----------

    def allocate_from_bundle(self, pg_id: PlacementGroupID,
                             bundle_index: int, demand: ResourceRequest
                             ) -> Tuple[Optional[Tuple[NodeID, int]], str]:
        """Draw ``demand`` from a bundle's reservation.

        Returns ``((node, index), "ok")`` or ``(None, reason)`` where
        reason is one of ``pending`` / ``removed`` / ``busy`` /
        ``infeasible``.
        """
        with self._lock:
            info = self._groups.get(pg_id)
            if info is None or info.state == "REMOVED":
                return None, "removed"
            if info.state == "PENDING":
                return None, "pending"
            if bundle_index >= len(info.bundles):
                return None, "infeasible"
            indices = ([bundle_index] if bundle_index >= 0
                       else range(len(info.bundles)))
            for i in indices:
                avail = info.bundle_avail[i]
                if all(avail.get(k, 0.0) + _EPS >= v
                       for k, v in demand.items()):
                    for k, v in demand.items():
                        avail[k] = avail.get(k, 0.0) - v
                    return (info.bundle_nodes[i], i), "ok"
            # distinguish "never fits the bundle" from "busy right now"
            for i in indices:
                spec = info.bundles[i]
                if all(spec.get(k, 0.0) + _EPS >= v
                       for k, v in demand.items()):
                    return None, "busy"
            return None, "infeasible"

    def reacquire_from_bundle(self, pg_id: PlacementGroupID,
                              bundle_index: int,
                              demand: ResourceRequest) -> None:
        """Unconditionally re-draw ``demand`` from a bundle after a
        blocked task resumes (see ClusterResources.reacquire). If the
        group dissolved while the task was blocked its reservation was
        already returned to the node, so the debit lands on the node —
        mirror image of free_to_bundle's REMOVED branch."""
        with self._lock:
            info = self._groups.get(pg_id)
            if info is None:
                return
            if info.state == "REMOVED" or bundle_index >= len(
                    info.bundle_avail):
                if bundle_index < len(info.bundle_nodes):
                    node_id = info.bundle_nodes[bundle_index]
                else:
                    return
                self._cluster.reacquire(node_id, demand)
                return
            avail = info.bundle_avail[bundle_index]
            for k, v in demand.items():
                avail[k] = avail.get(k, 0.0) - v

    def free_to_bundle(self, pg_id: PlacementGroupID, bundle_index: int,
                       demand: ResourceRequest) -> None:
        with self._lock:
            info = self._groups.get(pg_id)
            if info is None:
                return
            if info.state == "REMOVED":
                # reservation already dissolved: return to the node
                if bundle_index < len(info.bundle_nodes):
                    node_id = info.bundle_nodes[bundle_index]
                else:
                    return
                self._cluster.free(node_id, demand)
                return
            avail = info.bundle_avail[bundle_index]
            spec = info.bundles[bundle_index]
            for k, v in demand.items():
                avail[k] = min(spec.get(k, 0.0), avail.get(k, 0.0) + v)
