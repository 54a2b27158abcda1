"""ISchedulingPolicy backed by the native C++ scheduler.

Same semantics as the pure-Python ``HybridSchedulingPolicy`` (and the
reference C++ policy it mirrors), at C++ speed: the batch crosses the
ctypes boundary once as dense [nodes, resources] matrices. Registered
as ``"hybrid_native"``; ``default_policy`` prefers it when the library
builds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.native_loader import scheduler_lib
from ray_tpu_torch._private.scheduler.policy import (
    ISchedulingPolicy,
    SchedulingRequest,
    SchedulingResult,
    apply_capacity_fence,
    register_policy,
    request_class_key,
)
from ray_tpu_torch._private.scheduler.resources import ClusterResourceManager


class NativeHybridSchedulingPolicy(ISchedulingPolicy):
    name = "hybrid_native"

    def __init__(self, spread_threshold: Optional[float] = None,
                 seed: int = 0):
        cfg = get_config()
        self._threshold = (spread_threshold if spread_threshold is not None
                           else cfg.scheduler_spread_threshold)
        self._top_k_abs = cfg.scheduler_top_k_absolute
        self._top_k_frac = cfg.scheduler_top_k_fraction
        self._seed = seed or 0x12345678
        self._lib = scheduler_lib()
        if self._lib is None:
            raise ImportError("native scheduler library failed to build")
        # Dense-matrix cache maintained incrementally from the cluster's
        # mutation log: only rows whose nodes changed since the cached
        # version are rewritten, so steady-state per-batch overhead is
        # O(dirty nodes), not O(cluster).
        self._cached_version = -1
        self._node_order: List[NodeID] = []
        self._node_index: Dict[NodeID, int] = {}
        self._res_names: List[str] = []
        self._res_index: Dict[str, int] = {}
        self._total: Optional[np.ndarray] = None
        self._alive: Optional[np.ndarray] = None
        self._avail: Optional[np.ndarray] = None
        # demand-dict -> dense row (False = names an unknown resource);
        # epoch-invalidated on _rebuild (resource columns changed)
        self._row_cache: Dict = {}
        self._row_epoch = 0
        self._row_cache_epoch = -1
        # Single-task fast-path state: preallocated in/out buffers and
        # cached ctypes pointers (refreshed on _rebuild), so the p99 of
        # a light-load schedule() is the native scan itself, not Python
        # buffer assembly + a [nodes, resources] copy per call.
        self._ptrs: Optional[Tuple] = None
        self._one_dem: Optional[np.ndarray] = None
        self._one_pref = np.full(1, -1, np.int32)
        self._one_out = np.empty(1, np.int32)
        self._one_inf = np.empty(1, np.uint8)

    def _write_row(self, i: int, node) -> None:
        self._alive[i] = 1 if node.alive else 0
        for j, name in enumerate(self._res_names):
            self._total[i, j] = node.total.get(name, 0.0)
            self._avail[i, j] = node.available.get(name, 0.0)

    def _rebuild(self, cluster: ClusterResourceManager, version: int):
        import ctypes as ct
        snap = cluster.snapshot()
        names = sorted({k for node in snap.values() for k in node.total})
        self._res_names = names
        self._res_index = {name: j for j, name in enumerate(names)}
        self._node_order = list(snap.keys())
        self._node_index = {nid: i for i, nid in enumerate(self._node_order)}
        self._row_epoch += 1          # resource columns may have moved
        n, r = len(self._node_order), max(len(names), 1)
        self._total = np.zeros((n, r), np.float32)
        self._alive = np.zeros(n, np.uint8)
        self._avail = np.zeros((n, r), np.float32)
        for i, nid in enumerate(self._node_order):
            self._write_row(i, snap[nid])
        self._cached_version = version
        self._one_dem = np.zeros((1, r), np.float32)
        f32p = ct.POINTER(ct.c_float)
        u8p = ct.POINTER(ct.c_uint8)
        i32p = ct.POINTER(ct.c_int32)
        self._ptrs = (self._avail.ctypes.data_as(f32p),
                      self._total.ctypes.data_as(f32p),
                      self._alive.ctypes.data_as(u8p),
                      self._one_dem.ctypes.data_as(f32p),
                      self._one_pref.ctypes.data_as(i32p),
                      self._one_out.ctypes.data_as(i32p),
                      self._one_inf.ctypes.data_as(u8p))

    def _sync(self, cluster: ClusterResourceManager) -> None:
        """Bring the cached matrices up to the cluster's version."""
        version = cluster.version()
        if self._avail is None:
            self._rebuild(cluster, version)
        elif version != self._cached_version:
            changes = cluster.changes_since(self._cached_version)
            if changes is None or changes[1]:
                # log outran or membership changed: full rebuild
                self._rebuild(cluster, version)
            else:
                for nid in changes[0]:
                    node = cluster.get_node(nid)
                    i = self._node_index.get(nid)
                    if node is None or i is None:
                        self._rebuild(cluster, version)
                        break
                    new_res = {k for k in node.total
                               if k not in self._res_names}
                    if new_res:
                        self._rebuild(cluster, version)
                        break
                    self._write_row(i, node)
                else:
                    self._cached_version = version

    def _matrices(self, cluster: ClusterResourceManager) -> np.ndarray:
        """Sync the cached matrices to the cluster; returns a private
        copy of avail (the native batch loop mutates it)."""
        self._sync(cluster)
        return self._avail.copy()

    def schedule(self, cluster: ClusterResourceManager,
                 request: SchedulingRequest) -> SchedulingResult:
        """Single-task fast path: the native scan runs directly on the
        cached availability matrix (no copy) and the one row the native
        loop debits is credited back — the cluster ledger, not this
        cache, is the authority for commits."""
        self._sync(cluster)
        res_index = self._res_index
        for k, v in request.demand.items():
            if v > 0 and k not in res_index:
                return SchedulingResult(None, is_infeasible=True)
        dem = self._one_dem
        dem[0, :] = 0.0
        for k, v in request.demand.items():
            if v > 0:                  # zero demand constrains nothing
                dem[0, res_index[k]] = v
        pref = -1
        if request.preferred_node is not None and not request.avoid_local:
            pref = self._node_index.get(request.preferred_node, -1)
        self._one_pref[0] = pref
        import ctypes as ct
        availp, totalp, alivep, demp, prefp, outp, infp = self._ptrs
        self._lib.rtpu_hybrid_schedule(
            availp, totalp, alivep,
            self._avail.shape[0], self._avail.shape[1],
            demp, prefp, 1, ct.c_float(self._threshold), self._top_k_abs,
            ct.c_float(self._top_k_frac), self._seed, outp, infp)
        i = int(self._one_out[0])
        if i < 0:
            return SchedulingResult(
                None, is_infeasible=bool(self._one_inf[0]))
        self._avail[i] += dem[0]      # undo the native loop's debit
        return SchedulingResult(self._node_order[i])

    def schedule_batch(self, cluster: ClusterResourceManager,
                       requests: Sequence[SchedulingRequest]
                       ) -> List[SchedulingResult]:
        import ctypes as ct
        avail = self._matrices(cluster)
        n_nodes, n_res = avail.shape
        node_index = self._node_index
        # Requests naming a resource no node has are infeasible outright
        # and must NOT reach the native loop: a partial demand row would
        # be allocated from the shared batch-availability view, spuriously
        # denying capacity to later requests in the same batch. They are
        # simply skipped — results default to infeasible.
        res_index = self._res_index
        # Demand rows cached by scheduling class: a pending queue is a
        # handful of demand shapes repeated thousands of times, and the
        # dict->row translation in Python dominated batch cost (the
        # same task retries on every capacity change until it fits).
        row_cache = self._row_cache
        if self._row_cache_epoch != self._row_epoch:
            # columns changed under us (an id()-based check would be
            # unsound: CPython reuses freed dict addresses)
            row_cache.clear()
            self._row_cache_epoch = self._row_epoch
        elif len(row_cache) > 4096:
            # bound it: per-task memory/custom values make demand
            # shapes arbitrarily high-cardinality in a long driver
            row_cache.clear()
        kept: List[int] = []
        rows: List[np.ndarray] = []
        for t, req in enumerate(requests):
            # the key is cached ON the request: request objects are
            # reused across retry ticks (node_manager caches them on
            # the spec), so the sort runs once per task, not per tick
            key = request_class_key(req)
            row = row_cache.get(key)
            if row is None:
                row = np.zeros(n_res, np.float32)
                ok = True
                for k, v in req.demand.items():
                    if v <= 0:
                        continue       # zero demand constrains nothing
                    j = res_index.get(k)
                    if j is None:
                        ok = False
                        break
                    row[j] = v
                row_cache[key] = row if ok else False
                if not ok:
                    continue
            elif row is False:
                continue
            kept.append(t)
            rows.append(row)
        nreq = len(kept)
        demands = (np.stack(rows) if rows
                   else np.zeros((1, n_res), np.float32))
        preferred = np.full(max(nreq, 1), -1, np.int32)
        for row_i, t in enumerate(kept):
            req = requests[t]
            if req.preferred_node is not None and not req.avoid_local:
                preferred[row_i] = node_index.get(req.preferred_node, -1)
        out_nodes = np.empty(max(nreq, 1), np.int32)
        out_inf = np.empty(max(nreq, 1), np.uint8)
        if nreq:
            f32p = ct.POINTER(ct.c_float)
            u8p = ct.POINTER(ct.c_uint8)
            i32p = ct.POINTER(ct.c_int32)
            self._lib.rtpu_hybrid_schedule(
                avail.ctypes.data_as(f32p),
                self._total.ctypes.data_as(f32p),
                self._alive.ctypes.data_as(u8p),
                n_nodes, n_res,
                demands.ctypes.data_as(f32p),
                preferred.ctypes.data_as(i32p),
                nreq, ct.c_float(self._threshold), self._top_k_abs,
                ct.c_float(self._top_k_frac), self._seed,
                out_nodes.ctypes.data_as(i32p),
                out_inf.ctypes.data_as(u8p))
        results: List[SchedulingResult] = [
            SchedulingResult(None, is_infeasible=True)
            for _ in range(len(requests))]
        for row, t in enumerate(kept):
            if out_nodes[row] < 0:
                results[t] = SchedulingResult(
                    None, is_infeasible=bool(out_inf[row]))
            else:
                results[t] = SchedulingResult(
                    self._node_order[out_nodes[row]])
        if len(requests) > 1:
            self._fence_batch(requests, results)
        return results

    def _fence_batch(self, requests: Sequence[SchedulingRequest],
                     results: List[SchedulingResult]) -> None:
        """Capacity fence (docs/scheduler.md): the fencing contract
        lives in ``policy.apply_capacity_fence``; this supplies only
        the dense-matrix bound computation."""
        alive = self._alive.astype(bool)

        def bound_fn(demand: Dict[str, float], stop_at: int) -> int:
            row = self._row_cache.get(tuple(sorted(demand.items())))
            if row is None or row is False:
                return stop_at         # unknown resource: infeasible path
            mask = row > 0
            if not mask.any():
                return stop_at         # zero-demand: unbounded
            dem = row[mask]
            tot = self._total[:, mask]
            feas = alive & (tot + 1e-9 >= dem).all(axis=1)
            caps = np.floor((tot + 1e-9) / dem).min(axis=1)
            return int(caps[feas].sum())

        apply_capacity_fence(requests, results, bound_fn=bound_fn)


register_policy("hybrid_native", NativeHybridSchedulingPolicy)
