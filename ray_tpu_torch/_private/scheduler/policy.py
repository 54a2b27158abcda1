"""ISchedulingPolicy — the plugin seam the scheduling kernel slots into.

The port's own copy of ``ray_tpu/_private/scheduler/policy.py``. It
differs in how the default policy is chosen: ``default_policy`` takes the
device the kernel policy runs on (default ``"cuda"``) instead of probing
what hardware exists, and a kernel policy that cannot be built raises
instead of falling back to the CPU hybrid.

Reference: ``src/ray/raylet/scheduling/policy/scheduling_policy.h``
(``ISchedulingPolicy``), ``hybrid_scheduling_policy.cc``,
``spread_scheduling_policy.cc``, ``random_scheduling_policy.cc``,
``node_affinity_scheduling_policy.cc``, ``composite_scheduling_policy.cc``
[UNVERIFIED — mount empty, SURVEY.md §0].

The seam is deliberately batch-first: ``schedule_batch`` takes a list of
requests so a backend can amortize one device launch over many pending
tasks (the per-request ``schedule`` is sugar over a batch of one). The
CPU policies below are the portable baseline; the kernel-backed policy
in ``ray_tpu_torch._private.scheduler.tpu_policy`` registers itself under
the same interface.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.scheduler.resources import (
    ClusterResourceManager,
    NodeResources,
    ResourceRequest,
)


@dataclass
class SchedulingRequest:
    demand: ResourceRequest
    preferred_node: Optional[NodeID] = None   # usually the submitting node
    avoid_local: bool = False
    strategy: object = None                   # public SchedulingStrategy or None
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class SchedulingResult:
    node_id: Optional[NodeID]   # None => infeasible or unavailable now
    is_infeasible: bool = False # no node could EVER satisfy the demand
    # Capacity fence (docs/scheduler.md): the task's scheduling class
    # exceeds the node-totals capacity bound — the cluster could not
    # hold this many instances concurrently even when idle. Unlike
    # is_infeasible, ONE instance is runnable; the owner parks the
    # surplus in its unplaceable ledger (released on the next cluster
    # ledger version delta) instead of rescanning it every tick.
    is_fenced: bool = False
    # The bound itself, when the policy already computed it — spares
    # the owner an O(nodes) recompute for the typed signal.
    fence_bound: Optional[int] = None


class ISchedulingPolicy:
    """Pick a node for each request against the cluster resource view."""

    name = "base"

    def schedule_batch(self, cluster: ClusterResourceManager,
                       requests: Sequence[SchedulingRequest]
                       ) -> List[SchedulingResult]:
        raise NotImplementedError

    def schedule(self, cluster: ClusterResourceManager,
                 request: SchedulingRequest) -> SchedulingResult:
        return self.schedule_batch(cluster, [request])[0]


def request_class_key(req: "SchedulingRequest") -> tuple:
    """Scheduling-class key of a request's demand, cached on the
    request object: requests are reused across retry ticks (the node
    manager caches them on the spec), so the sort runs once per task.
    Shared with the native policy's demand-row cache."""
    key = getattr(req, "_row_key", None)
    if key is None:
        key = tuple(sorted(req.demand.items()))
        req._row_key = key     # type: ignore[attr-defined]
    return key


def class_capacity_bound(node_totals, demand: Dict[str, float],
                         stop_at: Optional[int] = None) -> int:
    """Capacity bound from node TOTALS: how many instances of
    ``demand`` the cluster could hold concurrently even when idle —
    sum over feasible nodes of floor(min_r total[r]/demand[r]).
    Zero-valued demand entries constrain nothing (callers must not
    fence all-zero demands — they are unbounded). ``node_totals``
    iterates (total_dict, alive); ``stop_at`` early-outs once the
    bound provably covers the caller's class. Single source of the
    fence's epsilon/zero semantics — shared by the Python hybrid
    policy and the owner ledger's typed-signal bound."""
    bound = 0
    for total, alive in node_totals:
        if not alive:
            continue
        cap = None
        for k, v in demand.items():
            if v <= 0:
                continue                # zero demand: no constraint
            tot = total.get(k, 0.0)
            if tot + 1e-9 < v:
                cap = 0
                break
            c = int((tot + 1e-9) // v)
            cap = c if cap is None else min(cap, c)
        if cap:
            bound += cap
            if stop_at is not None and bound >= stop_at:
                break
    return bound


def apply_capacity_fence(requests: Sequence["SchedulingRequest"],
                         results: List["SchedulingResult"],
                         node_totals: Optional[Sequence[tuple]] = None,
                         bound_fn: Optional[Callable] = None) -> None:
    """Mark the capacity-infeasible tail of each scheduling class.

    For each class with unplaced members, the capacity bound from node
    TOTALS — sum over feasible nodes of how many instances their total
    resources could hold — caps what the cluster fits concurrently
    even when idle; batch members beyond it get ``is_fenced`` (with
    the bound attached) so the owner parks them instead of retrying
    every tick. The bound comes from ``node_totals`` ([(total_dict,
    alive)] per node) via :func:`class_capacity_bound`, or from
    ``bound_fn(demand_dict, stop_at) -> int`` — the native policy's
    dense-matrix variant — so the fencing CONTRACT (class grouping,
    zero-demand guard, unplaced-tail selection) has one copy.
    In-place; placed and infeasible results are never touched (the
    fence refines the plain unavailable-now middle ground only)."""
    classes: Dict[tuple, List[int]] = {}
    for i, req in enumerate(requests):
        classes.setdefault(request_class_key(req), []).append(i)
    for key, idxs in classes.items():
        unplaced = [i for i in idxs if results[i].node_id is None
                    and not results[i].is_infeasible]
        if not unplaced or not any(v > 0 for _, v in key):
            continue                    # zero-demand never fences
        if bound_fn is not None:
            bound = bound_fn(dict(key), len(idxs))
        else:
            bound = class_capacity_bound(node_totals, dict(key),
                                         stop_at=len(idxs))
        surplus = len(idxs) - bound
        if surplus <= 0:
            continue
        for i in unplaced[-min(surplus, len(unplaced)):]:
            results[i] = SchedulingResult(None, is_fenced=True,
                                          fence_bound=bound)


class HybridSchedulingPolicy(ISchedulingPolicy):
    """Default policy: pack locally until the preferred node's critical
    resource utilization crosses ``scheduler_spread_threshold``, then
    pick the least-utilized feasible+available node (top-k randomized
    tie-break). Pure-Python baseline of the reference's C++ policy; the
    benchmark baseline proper is the C++ build in ``native/``.
    """

    name = "hybrid"

    def __init__(self, spread_threshold: Optional[float] = None,
                 seed: Optional[int] = None):
        cfg = get_config()
        self._threshold = (spread_threshold if spread_threshold is not None
                           else cfg.scheduler_spread_threshold)
        self._rng = random.Random(seed)

    def schedule_batch(self, cluster, requests):
        results: List[SchedulingResult] = []
        # The batch is scheduled sequentially against a mutable copy of
        # the availability view so requests in one batch don't all pile
        # onto the same node.
        view = cluster.snapshot()
        for req in requests:
            results.append(self._schedule_one(view, req))
        if len(requests) > 1:
            apply_capacity_fence(
                requests, results,
                [(n.total, n.alive) for n in view.values()])
        return results

    def _schedule_one(self, view: Dict[NodeID, NodeResources],
                      req: SchedulingRequest) -> SchedulingResult:
        # 1. prefer the local node while it is under-utilized
        pref = req.preferred_node
        if pref is not None and not req.avoid_local:
            node = view.get(pref)
            if (node is not None and node.alive
                    and node.critical_utilization() < self._threshold
                    and node.is_available(req.demand)):
                node.allocate(req.demand)
                return SchedulingResult(pref)
        # 2. least-utilized among available nodes
        best: List[tuple] = []
        any_feasible = False
        for nid, node in view.items():
            if not node.alive or not node.is_feasible(req.demand):
                continue
            any_feasible = True
            if not node.is_available(req.demand):
                continue
            best.append((node.critical_utilization(), nid))
        if not best:
            return SchedulingResult(None, is_infeasible=not any_feasible)
        best.sort(key=lambda t: t[0])
        cfg = get_config()
        k = max(cfg.scheduler_top_k_absolute,
                int(len(best) * cfg.scheduler_top_k_fraction))
        _, chosen = self._rng.choice(best[:k])
        view[chosen].allocate(req.demand)
        return SchedulingResult(chosen)


class SpreadSchedulingPolicy(ISchedulingPolicy):
    """Round-robin over available nodes (reference: spread policy)."""

    name = "spread"

    def __init__(self):
        self._next = 0

    def schedule_batch(self, cluster, requests):
        view = cluster.snapshot()
        order = sorted(view.keys())
        results = []
        for req in requests:
            chosen = None
            any_feasible = False
            for i in range(len(order)):
                nid = order[(self._next + i) % len(order)] if order else None
                if nid is None:
                    break
                node = view[nid]
                if not node.alive or not node.is_feasible(req.demand):
                    continue
                any_feasible = True
                if node.is_available(req.demand):
                    chosen = nid
                    self._next = (self._next + i + 1) % len(order)
                    break
            if chosen is None:
                results.append(SchedulingResult(None,
                                                is_infeasible=not any_feasible))
            else:
                view[chosen].allocate(req.demand)
                results.append(SchedulingResult(chosen))
        return results


class RandomSchedulingPolicy(ISchedulingPolicy):
    name = "random"

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def schedule_batch(self, cluster, requests):
        view = cluster.snapshot()
        results = []
        for req in requests:
            avail = [nid for nid, n in view.items()
                     if n.alive and n.is_available(req.demand)]
            feasible = any(n.alive and n.is_feasible(req.demand)
                           for n in view.values())
            if not avail:
                results.append(SchedulingResult(None, is_infeasible=not feasible))
            else:
                chosen = self._rng.choice(avail)
                view[chosen].allocate(req.demand)
                results.append(SchedulingResult(chosen))
        return results


class NodeAffinitySchedulingPolicy(ISchedulingPolicy):
    """Pin to a specific node; ``soft`` falls back to hybrid."""

    name = "node_affinity"

    def __init__(self, node_id: NodeID, soft: bool = False):
        self._node_id = node_id
        self._soft = soft
        self._fallback = HybridSchedulingPolicy()

    def schedule_batch(self, cluster, requests):
        results = []
        for req in requests:
            node = cluster.get_node(self._node_id)
            if node is not None and node.alive and node.is_available(req.demand):
                results.append(SchedulingResult(self._node_id))
            elif self._soft:
                results.append(self._fallback.schedule(cluster, req))
            else:
                feasible = node is not None and node.alive and \
                    node.is_feasible(req.demand)
                results.append(SchedulingResult(None, is_infeasible=not feasible))
        return results


class NodeLabelSchedulingPolicy(ISchedulingPolicy):
    """Filter nodes by label equality constraints, then hybrid-score."""

    name = "node_label"

    def __init__(self, hard: Dict[str, str],
                 soft: Optional[Dict[str, str]] = None):
        self._hard = hard
        self._soft = soft or {}
        self._inner = HybridSchedulingPolicy()

    def schedule_batch(self, cluster, requests):
        results = []
        for req in requests:
            view = cluster.snapshot()
            matching = {nid: n for nid, n in view.items()
                        if all(n.labels.get(k) == v
                               for k, v in self._hard.items())}
            soft_matching = {nid: n for nid, n in matching.items()
                            if all(n.labels.get(k) == v
                                   for k, v in self._soft.items())}
            pool = soft_matching or matching
            sub = ClusterResourceManager()
            for nid, n in pool.items():
                sub.add_or_update_node(nid, n)
            results.append(self._inner.schedule(sub, req))
        return results


# --- registry ------------------------------------------------------------

_POLICY_REGISTRY: Dict[str, Callable[[], ISchedulingPolicy]] = {}


def register_policy(name: str, factory: Callable[[], ISchedulingPolicy]):
    _POLICY_REGISTRY[name] = factory


def create_policy(name: str) -> ISchedulingPolicy:
    if name not in _POLICY_REGISTRY:
        raise ValueError(f"unknown scheduling policy {name!r}; "
                         f"known: {sorted(_POLICY_REGISTRY)}")
    return _POLICY_REGISTRY[name]()


register_policy("hybrid", HybridSchedulingPolicy)
register_policy("spread", SpreadSchedulingPolicy)
register_policy("random", RandomSchedulingPolicy)


class CompositeSchedulingPolicy(ISchedulingPolicy):
    """Dispatch per-request by its SchedulingStrategy (reference:
    ``policy/composite_scheduling_policy.cc``): default requests go to
    the inner policy (hybrid or TPU), NodeAffinity / NodeLabel / PG
    strategies route to their dedicated policies.
    """

    name = "composite"

    def __init__(self, inner: Optional[ISchedulingPolicy] = None):
        self._inner = inner or HybridSchedulingPolicy()
        self._spread = SpreadSchedulingPolicy()

    def schedule_batch(self, cluster, requests):
        results: List[Optional[SchedulingResult]] = [None] * len(requests)
        default_batch: List[tuple] = []  # (index, request)
        for i, req in enumerate(requests):
            strat = req.strategy
            kind = getattr(strat, "kind", None)
            if kind == "NODE_AFFINITY":
                pol = NodeAffinitySchedulingPolicy(
                    NodeID.from_hex(strat.node_id), soft=strat.soft)
                results[i] = pol.schedule(cluster, req)
            elif kind == "NODE_LABEL":
                pol = NodeLabelSchedulingPolicy(strat.hard, strat.soft)
                results[i] = pol.schedule(cluster, req)
            elif kind == "SPREAD":
                results[i] = self._spread.schedule(cluster, req)
            else:
                # DEFAULT and PLACEMENT_GROUP (PG requests are rewritten
                # to bundle node affinity before reaching the policy).
                default_batch.append((i, req))
        if default_batch:
            inner_results = self._inner.schedule_batch(
                cluster, [r for _, r in default_batch])
            for (i, _), res in zip(default_batch, inner_results):
                results[i] = res
        return results


def _cpu_hybrid_policy() -> ISchedulingPolicy:
    """The CPU hybrid policy. The reference takes its native C++ build
    when that builds; the port has no copy of it yet, so this is the
    pure-Python hybrid, the reference's own choice when the native
    library does not import."""
    return create_policy("hybrid")


def _tpu_scheduler_enabled(device) -> bool:
    """Resolve the three-state ``use_tpu_scheduler`` key for ``device``:
    'auto' selects the kernel policy on a CUDA device and the CPU hybrid
    on the CPU, as the reference selects it on an accelerator host and
    not on a CPU host; '1'/'true' and '0'/'false' force either."""
    v = str(get_config().use_tpu_scheduler).strip().lower()
    if v in ("auto", ""):
        return torch.device(device).type == "cuda"
    return v in ("1", "true", "yes", "on")


def default_policy(device="cuda") -> ISchedulingPolicy:
    """The production policy: the adaptive kernel policy on ``device``
    (or the CPU hybrid, by ``use_tpu_scheduler``) behind the composite
    dispatch. Raises ``RuntimeError`` for a CUDA device when no card is
    present; a kernel that fails to build or launch raises too."""
    dev = resolve_device(device)
    if _tpu_scheduler_enabled(dev):
        from ray_tpu_torch._private.scheduler.tpu_policy import (
            AdaptiveSchedulingPolicy)
        inner: ISchedulingPolicy = AdaptiveSchedulingPolicy(device=dev)
    else:
        inner = _cpu_hybrid_policy()
    return CompositeSchedulingPolicy(inner)
