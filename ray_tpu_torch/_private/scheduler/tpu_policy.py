"""The kernel scheduling policy: K scheduling classes against the dense
[nodes x resources] matrix in one device launch.

Counterpart of ``ray_tpu/_private/scheduler/tpu_policy.py``, whose device
program ``_schedule_classes_kernel`` (a jitted ``lax.scan`` over classes)
becomes a CUDA kernel written by hand for ``sm_90a``,
``ray_tpu_torch/csrc/scheduler.cu::schedule_classes``, with its plain
PyTorch version ``schedule_classes_plain`` beside it. A CPU tensor goes
through the plain version, a CUDA tensor through the kernel, which
launches or raises.

The design is the reference's:

1. **Scheduling classes.** The pending queue is grouped by distinct
   (demand vector, preferred node); 1M identical tasks are one class.
2. **Class-level fill.** For one class, scheduling ``count`` tasks
   sequentially under the hybrid policy is equivalent to packing the
   preferred node until the spread threshold, then water-filling the
   remaining nodes in least-critical-utilization order up to their
   per-node capacity ``cap[n] = floor(min_r avail[n,r]/demand[r])``.
3. **Sequential commit across classes** against a carried availability
   matrix, in scarcity order, so a mixed batch never oversubscribes a
   node.

Placements are integers, so kernel and plain version agree exactly, and
the plain version agrees with the JAX program element for element on the
same inputs (``tests/test_torch_scheduler.py``). Per-task results are
recovered on the host by expanding per-node counts.

The policy registers as ``"tpu"`` and ``"tpu_adaptive"`` in the
ISchedulingPolicy registry, the reference's names; there they default to
the card, as every entry point of the port does.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private import native_loader
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.scheduler.policy import (
    ISchedulingPolicy,
    SchedulingRequest,
    SchedulingResult,
    _cpu_hybrid_policy,
    register_policy,
)
from ray_tpu_torch._private.scheduler.resources import ClusterResourceManager

_EPS = 1e-6
_BISECT_STEPS = 40
_UPPER_CLAMP = float(2 ** 30)   # int32-safe bound of a zero-demand class
MAX_KERNEL_RESOURCES = 64       # resource columns the kernels take
_MAX_NODES = 2 ** 24            # node indices stay exact in fp32

# Kernel launches since the last reset: a run reads it to show that its
# scheduling went through the kernel.
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two >= n (>= minimum) — keeps the shapes few."""
    b = minimum
    while b < n:
        b *= 2
    return b


# --------------------------------------------------------------------------
# The device program: plain version and kernel
# --------------------------------------------------------------------------

def _lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))``: primary ascending, ties by
    secondary ascending, then by index — two stable argsorts, the
    secondary key first."""
    first = torch.argsort(secondary, stable=True)
    return first[torch.argsort(primary[first], stable=True)]


def _fill_class(avail, total, alive, demand, countf, pref, threshold):
    """One class of ``_schedule_classes_kernel``'s scan step, op for op in
    fp32: the totals fence, the preferred-node phase, the 40-step
    bisection for the common utilization level, the stable order of
    post-fill utilization and the remainder's distribution. Returns the
    new availability and the class's outputs."""
    n_nodes = avail.shape[0]
    inf = torch.tensor(float("inf"), device=avail.device)
    zero = torch.zeros((), device=avail.device)
    has_demand = demand > 0.0
    demand_safe = torch.clamp_min(demand, _EPS)

    ratio_tot = torch.where(has_demand[None, :],
                            (total + _EPS) / demand_safe[None, :], inf)
    cap_tot = torch.floor(ratio_tot.min(dim=1).values)
    cap_tot = torch.where(alive, cap_tot, zero)
    feas = cap_tot >= 1.0
    any_feasible = feas.any()
    upper_total = torch.minimum(cap_tot.sum(),
                                torch.tensor(_UPPER_CLAMP, device=avail.device))
    fenced = torch.clamp_min(countf - upper_total, 0.0)
    fenced = torch.where(countf > 0, fenced, zero)
    target = countf - fenced

    ratio = torch.where(has_demand[None, :],
                        (avail + _EPS) / demand_safe[None, :], inf)
    cap = torch.floor(ratio.min(dim=1).values)
    cap = torch.where(feas, torch.minimum(cap, target), zero)
    admitted = torch.minimum(target, cap.sum())

    used = total - avail
    util = torch.where(total > 0.0, used / torch.clamp_min(total, _EPS),
                       zero).max(dim=1).values

    # Phase 1: pack the preferred node while util < threshold.
    pref_valid = pref >= 0
    p = torch.clamp_min(pref, 0)
    head = threshold * total[p] - used[p]
    c_r = torch.where(has_demand, torch.ceil(head / demand_safe), inf)
    c_thresh = torch.clamp_min(c_r.min(), 0.0)
    local_take = torch.where(
        pref_valid & (util[p] < threshold),
        torch.minimum(torch.minimum(c_thresh, cap[p]), target), zero)
    local_take = torch.where(countf > 0, local_take, zero)
    upd = torch.zeros_like(avail)
    upd[p] = local_take * demand
    avail = avail - upd
    cap = cap.clone()
    cap[p] = cap[p] - local_take
    remaining = target - local_take

    # Phase 2: the utilization water-fill, by bisection for its level.
    used = total - avail

    def x_of(lam):
        head = lam * total - used
        per_r = torch.where(has_demand[None, :],
                            torch.floor(head / demand_safe[None, :]), inf)
        return torch.clamp(per_r.min(dim=1).values, zero, cap)

    lo = torch.zeros((), device=avail.device)
    hi = torch.ones((), device=avail.device)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        ge = x_of(mid).sum() >= remaining
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    x_lo = x_of(lo)
    deficit = torch.clamp_min(remaining - x_lo.sum(), 0.0)
    delta = torch.clamp_min(x_of(hi) - x_lo, 0.0)
    util_after = torch.where(
        total > 0.0,
        (used + x_lo[:, None] * demand[None, :])
        / torch.clamp_min(total, _EPS), zero).max(dim=1).values
    order = torch.argsort(util_after, stable=True)   # as jnp.argsort
    delta_sorted = delta[order]
    cum = torch.cumsum(delta_sorted, dim=0)
    extra_sorted = torch.clamp(deficit - (cum - delta_sorted), zero,
                               delta_sorted)
    take_sorted = x_lo[order] + extra_sorted
    taken = torch.empty(n_nodes, device=avail.device)
    taken[order] = take_sorted
    avail = avail - taken[:, None] * demand[None, :]
    return avail, (local_take, order, take_sorted, any_feasible, fenced,
                   admitted, upper_total)


def _commit_order(avail, total, alive, demands, counts):
    """Scarcity order of the classes: rarity of the scarcest demanded
    resource ascending, then demand pressure descending, then index;
    zero-count (padding) classes last."""
    countsf = counts.float()
    inf = torch.tensor(float("inf"), device=avail.device)
    has_d = demands > 0.0
    n_alive = torch.clamp_min(alive.float().sum(), 1.0)
    res_frac = ((total > 0.0) & alive[:, None]).sum(dim=0).float() / n_alive
    rarity = torch.where(has_d, res_frac[None, :], inf).min(dim=1).values
    supply = torch.where(alive[:, None], avail,
                         torch.zeros((), device=avail.device)).sum(dim=0)
    class_demand = countsf[:, None] * demands
    pressure = class_demand.sum(dim=0) / torch.clamp_min(supply, _EPS)
    press_k = torch.where(has_d, pressure[None, :], -inf).max(dim=1).values
    rarity = torch.where(counts > 0, rarity, inf)
    press_k = torch.where(counts > 0, press_k, -inf)
    return _lexsort(-press_k, rarity)


def schedule_classes_plain(avail, total, alive, demands, counts, prefs,
                           threshold: float):
    """What the kernel computes, with the outputs of
    ``ray_tpu/_private/scheduler/tpu_policy.py::_schedule_classes_kernel``:
    ``(packed, new_avail)``. ``packed`` is int32 [K, 4N+5] in the caller's
    class order: local_take, any_feasible, fenced, admitted, upper_total,
    then order [N], take_sorted [N], order2 [N], take2 [N] (the residual
    pass's, zeros when it did not run). avail and total are fp32 [N, R],
    alive bool [N], demands fp32 [K, R], counts and prefs int32 [K]."""
    device = avail.device
    n_nodes = avail.shape[0]
    k = demands.shape[0]
    thr = torch.tensor(threshold, dtype=torch.float32, device=device)
    perm = _commit_order(avail, total, alive, demands, counts)
    demands_c, counts_c = demands[perm], counts.float()[perm]
    prefs_c = prefs.long()[perm]

    def scan(avail, counts_c, prefs_c):
        rows = []
        for c in range(k):
            avail, out = _fill_class(avail, total, alive, demands_c[c],
                                     counts_c[c], prefs_c[c], thr)
            rows.append(out)
        return avail, [torch.stack(col) for col in zip(*rows)]

    avail, (local_take, order, take_sorted, any_feasible, fenced, admitted,
            upper) = scan(avail, counts_c, prefs_c)
    placed1 = torch.minimum(local_take + take_sorted.sum(dim=1), admitted)
    residual = torch.clamp_min(admitted - placed1, 0.0)
    if residual.sum().item() > 0.0:      # the reference's lax.cond
        avail, out2 = scan(avail, residual, torch.full_like(prefs_c, -1))
        order2, take2 = out2[1], out2[2]
    else:
        order2 = torch.zeros((k, n_nodes), dtype=torch.long, device=device)
        take2 = torch.zeros((k, n_nodes), device=device)
    packed = torch.cat(
        [local_take[:, None], any_feasible.float()[:, None],
         fenced[:, None], admitted[:, None], upper[:, None],
         order.float(), take_sorted, order2.float(), take2], dim=1)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(k, device=device)
    return packed[inv].to(torch.int32), avail


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_loader.load_library("scheduler")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.schedule_classes.argtypes = (
            [ptr] * 6 + [ctypes.c_float, i32, i32, i32, ptr, ptr,
                         ctypes.c_longlong, ptr])
        lib.schedule_classes.restype = ctypes.c_int
        lib.schedule_scratch_floats.argtypes = [i32, i32]
        lib.schedule_scratch_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check_dense(avail, total, alive, demands, counts, prefs) -> None:
    """Raise on what the kernel does not take."""
    dev = avail.device
    n, r = avail.shape
    want = {"avail": (avail, torch.float32, (n, r)),
            "total": (total, torch.float32, (n, r)),
            "alive": (alive, torch.bool, (n,)),
            "demands": (demands, torch.float32, (demands.shape[0], r)),
            "counts": (counts, torch.int32, (demands.shape[0],)),
            "prefs": (prefs, torch.int32, (demands.shape[0],))}
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= n <= _MAX_NODES and 1 <= r <= MAX_KERNEL_RESOURCES
            and demands.shape[0] >= 1):
        raise ValueError(f"the kernel takes 1 <= N <= {_MAX_NODES}, 1 <= R <= "
                         f"{MAX_KERNEL_RESOURCES} and K >= 1, got N={n}, "
                         f"R={r}, K={demands.shape[0]}")


def schedule_classes_cuda(avail, total, alive, demands, counts, prefs,
                          threshold: float):
    """``(packed, new_avail)`` from the CUDA kernel, same contract as
    ``schedule_classes_plain``: one launch, ``avail`` updated in place
    and returned (the counterpart of the reference's donated buffer)."""
    global launches
    _check_dense(avail, total, alive, demands, counts, prefs)
    n, r = avail.shape
    k = demands.shape[0]
    lib = _kernel_lib()
    packed = torch.empty((k, 4 * n + 5), dtype=torch.int32,
                         device=avail.device)
    scratch = torch.empty(lib.schedule_scratch_floats(n, k),
                          dtype=torch.float32, device=avail.device)
    with torch.cuda.device(avail.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.schedule_classes(
            avail.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), counts.data_ptr(), prefs.data_ptr(),
            float(threshold), n, r, k, packed.data_ptr(),
            scratch.data_ptr(), scratch.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"schedule_classes kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return packed, avail


def schedule_classes(avail, total, alive, demands, counts, prefs,
                     threshold: float):
    """The device program: the plain version for CPU tensors, the kernel
    for CUDA tensors (which updates ``avail`` in place)."""
    if avail.device.type == "cpu":
        return schedule_classes_plain(avail, total, alive, demands, counts,
                                      prefs, threshold)
    if avail.device.type == "cuda":
        return schedule_classes_cuda(avail, total, alive, demands, counts,
                                     prefs, threshold)
    raise ValueError(f"schedule_classes runs on cuda or cpu, got "
                     f"{avail.device}")


# --------------------------------------------------------------------------
# Host-side policy
# --------------------------------------------------------------------------

class DenseSchedule(NamedTuple):
    """One kernel invocation's host-side outputs (caller class order).

    ``fenced[k]`` tasks of class k exceed the node-totals capacity bound
    (the cluster could not hold them even idle); ``admitted[k]`` is the
    live bound at the class's commit turn — the fill places exactly this
    many, so ``placed == admitted`` is the kernel's completeness
    contract."""

    local_take: np.ndarray    # [K]
    any_feasible: np.ndarray  # [K] bool
    fenced: np.ndarray        # [K]
    admitted: np.ndarray      # [K]
    upper_total: np.ndarray   # [K] totals bound (int32-clamped)
    order: np.ndarray         # [K, N]
    take_sorted: np.ndarray   # [K, N]
    order2: np.ndarray        # [K, N]  residual pass
    take2: np.ndarray         # [K, N]
    new_avail: torch.Tensor   # [N, R] on the policy's device


class _DenseView:
    """Dense [nodes, resources] mirror of a ClusterResourceManager
    snapshot, rebuilt only when the manager's version changes."""

    def __init__(self):
        self.version = -1
        self.node_ids: List[NodeID] = []
        self.node_index: Dict[NodeID, int] = {}
        self.res_names: List[str] = []
        self.res_index: Dict[str, int] = {}
        self.avail: Optional[np.ndarray] = None   # [Npad, Rpad] f32
        self.total: Optional[np.ndarray] = None
        self.alive: Optional[np.ndarray] = None   # [Npad] bool

    def refresh(self, cluster: ClusterResourceManager,
                extra_resources: Sequence[str]) -> None:
        version = cluster.version()
        extra = [r for r in extra_resources if r not in self.res_index]
        if version == self.version and not extra:
            return
        # Incremental path: only rows whose nodes mutated since the cached
        # version are rewritten; membership changes, log overrun and new
        # resource names fall back to the full rebuild below.
        if self.version >= 0 and not extra:
            delta = cluster.changes_since(self.version)
            if delta is not None and not delta[1]:
                for nid in delta[0]:
                    i = self.node_index.get(nid)
                    node = cluster.get_node(nid)
                    if i is None or node is None or any(
                            r not in self.res_index for r in node.total):
                        break          # unknown row/column: rebuild
                    self._write_row(i, node)
                else:
                    self.version = version
                    return
        snapshot = cluster.snapshot()
        names = set(extra_resources)
        for node in snapshot.values():
            names.update(node.total)
        self.res_names = sorted(names)
        self.res_index = {r: i for i, r in enumerate(self.res_names)}
        self.node_ids = sorted(snapshot.keys(), key=lambda n: n.hex())
        self.node_index = {n: i for i, n in enumerate(self.node_ids)}
        n_pad = _bucket(max(len(self.node_ids), 1))
        r_pad = _bucket(max(len(self.res_names), 1), minimum=4)
        self.avail = np.zeros((n_pad, r_pad), np.float32)
        self.total = np.zeros((n_pad, r_pad), np.float32)
        self.alive = np.zeros((n_pad,), bool)
        for i, nid in enumerate(self.node_ids):
            self._write_row(i, snapshot[nid])
        self.version = version

    def _write_row(self, i: int, node) -> None:
        self.alive[i] = node.alive
        self.total[i, :] = 0.0
        self.avail[i, :] = 0.0
        # list(): incremental refresh reads the live node dicts, which
        # completion threads mutate concurrently
        for r, v in list(node.total.items()):
            self.total[i, self.res_index[r]] = v
        for r, v in list(node.available.items()):
            j = self.res_index.get(r)
            if j is not None:
                self.avail[i, j] = v

    def demand_vector(self, demand: Dict[str, float]) -> np.ndarray:
        vec = np.zeros((self.total.shape[1],), np.float32)
        for r, v in demand.items():
            vec[self.res_index[r]] = v
        return vec


class TpuSchedulingPolicy(ISchedulingPolicy):
    """Batched scheduling on the card behind the standard seam.

    Semantics match HybridSchedulingPolicy per class: prefer the local
    node until ``scheduler_spread_threshold`` critical utilization, then
    least-utilized feasible nodes; never oversubscribes; a batch is
    committed class by class against a carried availability matrix. The
    name is the reference's, so that its counterpart is found; it runs on
    ``device`` (default ``"cuda"``, a ``RuntimeError`` without a card
    unless the caller passes ``device="cpu"``).
    """

    name = "tpu"

    def __init__(self, spread_threshold: Optional[float] = None,
                 device="cuda"):
        cfg = get_config()
        self._threshold = (spread_threshold if spread_threshold is not None
                           else cfg.scheduler_spread_threshold)
        self.device = resolve_device(device)
        self._view = _DenseView()

    # -- dense fast path (used by schedule_batch and by the benchmarks) ---

    def schedule_dense(self, avail, total, alive, demands, counts,
                       prefs) -> DenseSchedule:
        """Run the device program on dense matrices: one launch, one
        device-to-host copy. Classes pad to a power of two."""
        k_pad = _bucket(len(counts), minimum=1)
        if k_pad != len(counts):
            demands = np.pad(demands, ((0, k_pad - len(counts)), (0, 0)))
            prefs = np.pad(prefs, (0, k_pad - len(prefs)),
                           constant_values=-1)
            counts = np.pad(counts, (0, k_pad - len(counts)))
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        packed, new_avail = schedule_classes(
            put(avail, torch.float32), put(total, torch.float32),
            put(alive, torch.bool), put(demands, torch.float32),
            put(counts, torch.int32), put(prefs, torch.int32),
            self._threshold)
        packed = packed.cpu().numpy()        # the one device-to-host copy
        n = avail.shape[0]
        return DenseSchedule(
            local_take=packed[:, 0],
            any_feasible=packed[:, 1].astype(bool),
            fenced=packed[:, 2],
            admitted=packed[:, 3],
            upper_total=packed[:, 4],
            order=packed[:, 5:5 + n],
            take_sorted=packed[:, 5 + n:5 + 2 * n],
            order2=packed[:, 5 + 2 * n:5 + 3 * n],
            take2=packed[:, 5 + 3 * n:5 + 4 * n],
            new_avail=new_avail,
        )

    # -- ISchedulingPolicy ------------------------------------------------

    def schedule_batch(self, cluster: ClusterResourceManager,
                       requests: Sequence[SchedulingRequest]
                       ) -> List[SchedulingResult]:
        if not requests:
            return []
        view = self._view
        view.refresh(cluster, extra_resources=[
            r for req in requests for r in req.demand])
        if not view.node_ids:
            return [SchedulingResult(None, is_infeasible=True)
                    for _ in requests]

        # Group the batch into scheduling classes.
        classes: Dict[tuple, List[int]] = {}
        for i, req in enumerate(requests):
            pref = -1
            if req.preferred_node is not None and not req.avoid_local:
                pref = view.node_index.get(req.preferred_node, -1)
            key = (tuple(sorted(req.demand.items())), pref)
            classes.setdefault(key, []).append(i)

        keys = list(classes.keys())
        demands = np.stack([view.demand_vector(dict(k[0])) for k in keys])
        counts = np.array([len(classes[k]) for k in keys], np.int32)
        prefs = np.array([k[1] for k in keys], np.int32)

        ds = self.schedule_dense(view.avail, view.total, view.alive,
                                 demands, counts, prefs)

        # Expand per-node counts back to per-task results.
        results: List[Optional[SchedulingResult]] = [None] * len(requests)
        for k, key in enumerate(keys):
            indices = classes[key]
            count = len(indices)
            fill = []
            if ds.local_take[k] > 0:
                fill.append(np.full(ds.local_take[k], key[1], np.int32))
            for order_k, take_k in ((ds.order[k], ds.take_sorted[k]),
                                    (ds.order2[k], ds.take2[k])):
                nz = take_k > 0
                if nz.any():
                    fill.append(np.repeat(order_k[nz], take_k[nz]))
            assigned = (np.concatenate(fill) if fill
                        else np.empty(0, np.int32))
            feasible = bool(ds.any_feasible[k])
            fenced_k = int(ds.fenced[k])
            placed = min(len(assigned), count)
            for j, req_i in enumerate(indices):
                if j < placed:
                    results[req_i] = SchedulingResult(
                        view.node_ids[int(assigned[j])])
                elif not feasible:
                    results[req_i] = SchedulingResult(
                        None, is_infeasible=True)
                elif j >= count - fenced_k:
                    # Surplus beyond the class's node-totals capacity
                    # bound: the owner parks it (typed) instead of
                    # retrying every tick.
                    results[req_i] = SchedulingResult(
                        None, is_fenced=True,
                        fence_bound=int(ds.upper_total[k]))
                else:
                    results[req_i] = SchedulingResult(None)

        # Classes key by (demand, preferred node) but the totals bound is
        # a per-demand cluster-wide quantity: classes sharing a demand
        # would each be granted the full bound and under-fence the joint
        # surplus. Top up across the group.
        by_demand: Dict[tuple, List[int]] = {}
        for k, key in enumerate(keys):
            by_demand.setdefault(key[0], []).append(k)
        for dkey, ks in by_demand.items():
            if len(ks) < 2 or not any(v > 0 for _, v in dkey):
                continue
            upper = int(ds.upper_total[ks[0]])   # same for the group
            group_count = sum(len(classes[keys[k]]) for k in ks)
            need = (max(group_count - upper, 0)
                    - sum(int(ds.fenced[k]) for k in ks))
            for k in ks:
                if need <= 0:
                    break
                for req_i in reversed(classes[keys[k]]):
                    if need <= 0:
                        break
                    r = results[req_i]
                    if (r.node_id is None and not r.is_infeasible
                            and not r.is_fenced):
                        results[req_i] = SchedulingResult(
                            None, is_fenced=True, fence_bound=upper)
                        need -= 1
        return results


_device_rt_s: Dict[torch.device, float] = {}
_device_rt_errors: Dict[torch.device, BaseException] = {}
_device_rt_lock = threading.Lock()
_device_rt_threads: Dict[torch.device, threading.Thread] = {}


def _measure_device_rt(device: torch.device) -> float:
    """One measurement of the device round trip (a tiny op and its copy
    back to the host) on ``device``: the floor that a kernel invocation
    pays whatever its size."""
    x = torch.zeros((8,), device=device)
    (x + 1.0).cpu()                         # first use: context, allocator
    t0 = time.perf_counter()
    (x + 1.0).cpu()
    return time.perf_counter() - t0


def _probe_device_rt(device: torch.device) -> None:
    """The probe thread's body: stores the round trip, or the error that
    the next ``schedule_batch`` raises (the reference's ``except -> inf``
    would route all work to the CPU scan without a word)."""
    try:
        _device_rt_s[device] = _measure_device_rt(device)
    except Exception as exc:  # noqa: BLE001 - handed to the caller
        _device_rt_errors[device] = exc


def _ensure_rt_measurement(device: torch.device) -> None:
    with _device_rt_lock:
        if device not in _device_rt_s and device not in _device_rt_threads:
            _device_rt_threads[device] = threading.Thread(
                target=_probe_device_rt, args=(device,), daemon=True,
                name="rtpu-device-rt-probe")
            _device_rt_threads[device].start()


def _raise_probe_error(device: torch.device) -> None:
    """Raise what the probe on ``device`` failed with, once; the next
    call starts a new probe."""
    with _device_rt_lock:
        exc = _device_rt_errors.pop(device, None)
        if exc is not None:
            _device_rt_threads.pop(device, None)
    if exc is not None:
        raise RuntimeError(f"the device round-trip probe on {device} "
                           f"failed: {exc!r}") from exc


class AdaptiveSchedulingPolicy(ISchedulingPolicy):
    """Latency/throughput-adaptive production policy.

    A device invocation has a fixed round-trip floor (one host-to-device
    and one device-to-host copy); a CPU feasibility scan is O(nodes) per
    task with no floor. The kernel therefore pays off only when the
    batch's CPU-scan cost exceeds the measured round trip: the policy
    measures that round trip once on its device (in the background, CPU
    path until known) and routes each batch by ``batch x per-task CPU
    cost`` against it. This routing is the reference's cost model, not a
    fallback: a kernel that fails raises, and so does the next
    ``schedule_batch`` after a failed probe.
    """

    name = "tpu_adaptive"

    # Per-task scan cost model of the reference: ~1 us fixed + ~40 ns per
    # node (its native scan at 10k nodes).
    _CPU_FIXED_S = 1e-6
    _CPU_PER_NODE_S = 4e-8

    def __init__(self, device="cuda"):
        cfg = get_config()
        self._min_batch = cfg.tpu_scheduler_min_batch
        self._tpu = TpuSchedulingPolicy(device=device)
        self.device = self._tpu.device
        self._cpu = _cpu_hybrid_policy()
        _ensure_rt_measurement(self.device)

    def _kernel_pays_off(self, n_tasks: int, n_nodes: int) -> bool:
        rt = _device_rt_s.get(self.device)
        if rt is None:           # not yet measured: stay on the scan
            _ensure_rt_measurement(self.device)
            return False
        cpu_cost = n_tasks * (self._CPU_FIXED_S
                              + self._CPU_PER_NODE_S * max(n_nodes, 1))
        return cpu_cost > 2.0 * rt

    def schedule_batch(self, cluster: ClusterResourceManager,
                       requests: Sequence[SchedulingRequest]
                       ) -> List[SchedulingResult]:
        _raise_probe_error(self.device)
        if (len(requests) < self._min_batch
                or not self._kernel_pays_off(len(requests),
                                             cluster.num_nodes())):
            return self._cpu.schedule_batch(cluster, requests)
        return self._tpu.schedule_batch(cluster, requests)

    def schedule(self, cluster: ClusterResourceManager,
                 request: SchedulingRequest) -> SchedulingResult:
        # The CPU policy's single-task path, with no batch wrapping.
        return self._cpu.schedule(cluster, request)


register_policy("tpu", TpuSchedulingPolicy)
register_policy("tpu_adaptive", AdaptiveSchedulingPolicy)
