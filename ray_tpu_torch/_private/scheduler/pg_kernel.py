"""Placement-group bundle packing as one device solve.

Counterpart of ``ray_tpu/_private/scheduler/pg_kernel.py``. Its two
device programs become CUDA kernels written by hand for ``sm_90a``, in
``ray_tpu_torch/csrc/scheduler.cu``, each with its plain PyTorch version
beside it (a CPU tensor goes through the plain version, a CUDA tensor
through the kernel, which launches or raises):

- ``pack`` (``pg_pack``, for ``_pack_kernel``): one group, a sequential
  scan over its bundles, each step scoring all N nodes against the
  carried availability;
- ``pack_batch`` (``pg_pack_batch``, for ``_pack_batch_kernel``): many
  groups in one entry. Nodes are ranked once by the strategy's score and
  dealt round-robin across groups; each group's scan then scores only its
  k candidates. A group whose top-k solve fails re-solves on the
  single-group path host-side.

Strategies: PACK (most-utilized feasible node first), SPREAD
(least-utilized, preferring nodes unused by this group), STRICT_SPREAD
(distinct node per bundle), STRICT_PACK (the bundle sum must fit one
node). Assignments are integers: kernels, plain versions and the JAX
programs agree exactly.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private import native_loader
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.scheduler.tpu_policy import (
    MAX_KERNEL_RESOURCES,
    _bucket,
    _DenseView,
)

_EPS = 1e-6
_SPREAD_PENALTY = 1e3
MODES = {"pack": 0, "spread": 1, "strict_spread": 2}

# Kernel launches a ``pack_batch_cuda`` call makes: the ranking's
# cluster, then the groups' grid (``S3_FUSED`` false in ``scheduler.cu``).
BATCH_LAUNCHES = 2

# Kernel launches since the last reset: one a ``pack_cuda`` call,
# BATCH_LAUNCHES a ``pack_batch_cuda`` call, one a ``rank_nodes_cuda``
# call.
launches_pack = 0
launches_pack_batch = 0

_lib: Optional[ctypes.CDLL] = None


def _util(avail, total):
    """Critical utilization per row: max_r of used / total."""
    zero = torch.zeros((), device=avail.device)
    return torch.where(total > 0.0,
                       (total - avail) / torch.clamp_min(total, _EPS),
                       zero).max(dim=-1).values


def _score(avail, total, alive, used, demand, mode: str):
    """(feasible mask, score) of every row for one bundle, as the
    reference's scan step computes them."""
    has = demand > 0.0
    can = alive & torch.where(has, avail + _EPS >= demand, True).all(dim=-1)
    util = _util(avail, total)
    if mode == "pack":
        score = -util
    elif mode == "spread":
        score = util + torch.where(
            used, torch.tensor(_SPREAD_PENALTY, device=avail.device),
            torch.zeros((), device=avail.device))
    else:  # strict_spread
        score = util
        can = can & ~used
    return can, torch.where(can, score,
                            torch.tensor(float("inf"), device=avail.device))


def pack_plain(avail, total, alive, demands, mode: str) -> torch.Tensor:
    """What ``pg_pack`` computes, with the output of
    ``ray_tpu/_private/scheduler/pg_kernel.py::_pack_kernel``: int32
    [B+1], the node of each bundle (-1 unplaced) and the all-placed flag.
    avail and total fp32 [N, R], alive bool [N], demands fp32 [B, R]."""
    avail = avail.clone()
    used = torch.zeros(avail.shape[0], dtype=torch.bool, device=avail.device)
    assign = []
    for demand in demands:
        can, score = _score(avail, total, alive, used, demand, mode)
        idx = torch.argmin(score)
        ok = can[idx]
        upd = torch.zeros_like(avail)
        upd[idx] = torch.where(ok, demand, torch.zeros_like(demand))
        avail = avail - upd
        used[idx] = used[idx] | ok
        assign.append(torch.where(ok, idx, -1))
    assign = (torch.stack(assign) if assign else
              torch.zeros(0, dtype=torch.long, device=avail.device))
    ok_all = (assign >= 0).all().long()
    return torch.cat([assign, ok_all[None]]).to(torch.int32)


def rank_nodes_plain(avail, total, alive, mode: str) -> torch.Tensor:
    """Nodes in the order of the strategy's base score (dead rows last),
    the stable argsort that opens ``_pack_batch_kernel``."""
    util = _util(avail, total)
    base = -util if mode == "pack" else util
    return torch.argsort(torch.where(
        alive, base, torch.tensor(float("inf"), device=avail.device)),
        stable=True)


def pack_batch_plain(avail, total, alive, demands, valid, mode: str,
                     k: int) -> torch.Tensor:
    """What ``pg_pack_batch`` computes, with the output of
    ``_pack_batch_kernel``: int32 [G, B+1], the global node of each bundle
    (-1 unplaced or padding) and each group's all-placed flag. demands
    fp32 [G, B, R] (zero rows pad), valid bool [G, B]."""
    n = avail.shape[0]
    g, b = demands.shape[0], demands.shape[1]
    dev = avail.device
    ranked = rank_nodes_plain(avail, total, alive, mode)
    deal = (torch.arange(k, device=dev)[None, :] * g
            + torch.arange(g, device=dev)[:, None]) % n
    cand = ranked[deal]                                      # [G, k]
    av, ctot, cal = avail[cand], total[cand], alive[cand]    # [G, k, R]
    used = torch.zeros((g, k), dtype=torch.bool, device=dev)
    rows = torch.arange(g, device=dev)
    assign = []
    for j in range(b):
        demand = demands[:, j]                               # [G, R]
        can, score = _score(av, ctot, cal, used, demand[:, None, :], mode)
        idx = torch.argmin(score, dim=1)                     # [G]
        ok = can[rows, idx] & valid[:, j]
        upd = torch.zeros_like(av)
        upd[rows, idx] = torch.where(ok[:, None], demand,
                                     torch.zeros_like(demand))
        av = av - upd
        chosen = cand[rows, idx]
        used = torch.where(ok[:, None], used | (cand == chosen[:, None]),
                           used)
        assign.append(torch.where(ok, chosen, -1))
    assign = (torch.stack(assign, dim=1) if assign else
              torch.zeros((g, 0), dtype=torch.long, device=dev))
    ok_all = ((assign >= 0) | ~valid).all(dim=1).long()
    return torch.cat([assign, ok_all[:, None]], dim=1).to(torch.int32)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_loader.load_library("scheduler")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pg_pack.argtypes = [ptr] * 4 + [i32] * 4 + [ptr] * 3
        lib.pg_pack_batch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr] * 4
        lib.pg_pack_rank.argtypes = [ptr] * 3 + [i32] * 3 + [ptr] * 2
        lib.pg_pack_batch_scratch.argtypes = [i32] * 5 + [ptr]
        for fn in (lib.pg_pack, lib.pg_pack_batch, lib.pg_pack_rank,
                   lib.pg_pack_batch_scratch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(avail, total, alive, demands, valid=None) -> None:
    """Raise on what the kernels do not take."""
    n, r = avail.shape
    named = {"avail": (avail, torch.float32), "total": (total, torch.float32),
             "alive": (alive, torch.bool), "demands": (demands, torch.float32)}
    if valid is not None:
        named["valid"] = (valid, torch.bool)
    for name, (t, dtype) in named.items():
        if (t.device != avail.device or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} on "
                             f"{avail.device}, got {t.dtype} on {t.device}")
    if (tuple(total.shape) != (n, r) or tuple(alive.shape) != (n,)
            or demands.shape[-1] != r or n < 1
            or not 1 <= r <= MAX_KERNEL_RESOURCES):
        raise ValueError(f"shapes do not match: avail {tuple(avail.shape)}, "
                         f"total {tuple(total.shape)}, alive "
                         f"{tuple(alive.shape)}, demands "
                         f"{tuple(demands.shape)}")


def pack_cuda(avail, total, alive, demands, mode: str) -> torch.Tensor:
    """``pg_pack``: same contract as ``pack_plain``, one launch."""
    global launches_pack
    _check(avail, total, alive, demands)
    n, r = avail.shape
    b = demands.shape[0]
    out = torch.empty(b + 1, dtype=torch.int32, device=avail.device)
    work = avail.clone()                       # the carried availability
    used = torch.zeros(n, dtype=torch.bool, device=avail.device)
    with torch.cuda.device(avail.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib().pg_pack(
            work.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), n, r, b, MODES[mode], used.data_ptr(),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pg_pack kernel launch failed: CUDA error {rc}")
    launches_pack += 1
    return out


@functools.lru_cache(maxsize=256)
def _scratch_sizes(n, r, b, k):
    """(ints of ``ranked``, floats of ``slots`` a group) that
    ``pg_pack_batch_scratch`` gives at this shape."""
    sizes = (ctypes.c_longlong * 2)()
    rc = _kernel_lib().pg_pack_batch_scratch(n, r, 1, b, k, sizes)
    if rc != 0:
        raise ValueError(f"pg_pack_batch takes no scratch for n={n}, r={r}, "
                         f"b={b}, k={k}")
    return sizes[0], sizes[1]


def _batch_scratch(n, r, g, b, k, device):
    """``pg_pack_batch``'s scratch: int32 ``ranked`` (the order, then the
    sorted slices where they stay in global memory) and fp32 ``slots``
    (the groups' state where it does not fit in shared memory)."""
    ranked, per_group = _scratch_sizes(n, r, b, k)
    return (torch.empty(ranked, dtype=torch.int32, device=device),
            torch.empty(max(g * per_group, 1), dtype=torch.float32,
                        device=device))


def pack_batch_cuda(avail, total, alive, demands, valid, mode: str,
                    k: int) -> torch.Tensor:
    """``pg_pack_batch``: same contract as ``pack_batch_plain``,
    BATCH_LAUNCHES launches."""
    global launches_pack_batch
    _check(avail, total, alive, demands, valid)
    n, r = avail.shape
    g, b = demands.shape[0], demands.shape[1]
    if not 1 <= k <= n or tuple(valid.shape) != (g, b):
        raise ValueError(f"need 1 <= k <= N and valid [G, B], got k={k}, "
                         f"N={n}, valid {tuple(valid.shape)}")
    out = torch.empty((g, b + 1), dtype=torch.int32, device=avail.device)
    with torch.cuda.device(avail.device):
        ranked, slots = _batch_scratch(n, r, g, b, k, avail.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib().pg_pack_batch(
            avail.data_ptr(), total.data_ptr(), alive.data_ptr(),
            demands.data_ptr(), valid.data_ptr(), n, r, g, b, k,
            MODES[mode], ranked.data_ptr(), slots.data_ptr(), out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"pg_pack_batch kernel launch failed: CUDA "
                           f"error {rc}")
    launches_pack_batch += BATCH_LAUNCHES
    return out


def rank_nodes_cuda(avail, total, alive, mode: str) -> torch.Tensor:
    """``pg_pack_batch``'s ranking alone (one launch of its cluster
    kernel with no groups): same contract as ``rank_nodes_plain``."""
    global launches_pack_batch
    _check(avail, total, alive, avail[:0])     # no demands
    n, r = avail.shape
    with torch.cuda.device(avail.device):
        ranked, _ = _batch_scratch(n, r, 0, 0, 1, avail.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel_lib().pg_pack_rank(
            avail.data_ptr(), total.data_ptr(), alive.data_ptr(), n, r,
            MODES[mode], ranked.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pg_pack_rank kernel launch failed: CUDA error "
                           f"{rc}")
    launches_pack_batch += 1
    return ranked[:n].long()


def pack(avail, total, alive, demands, mode: str) -> torch.Tensor:
    """One group's solve: plain version on the CPU, kernel on the card."""
    if avail.device.type == "cpu":
        return pack_plain(avail, total, alive, demands, mode)
    return pack_cuda(avail, total, alive, demands, mode)


def pack_batch(avail, total, alive, demands, valid, mode: str,
               k: int) -> torch.Tensor:
    """Many groups' solve: plain version on the CPU, kernels on the
    card."""
    if avail.device.type == "cpu":
        return pack_batch_plain(avail, total, alive, demands, valid, mode, k)
    return pack_batch_cuda(avail, total, alive, demands, valid, mode, k)


class PgKernelSolver:
    """Host wrapper: dense view + strategy dispatch, on ``device``
    (default ``"cuda"``, a ``RuntimeError`` without a card unless the
    caller passes ``device="cpu"``).

    The dense [nodes, resources] view is cached keyed by the cluster
    resource version, with row-wise incremental refresh: back-to-back
    solves in one scheduling tick share one rebuild."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._view = _DenseView()

    def _tensors(self, view):
        dev = self.device
        return (torch.as_tensor(view.avail).to(dev),
                torch.as_tensor(view.total).to(dev),
                torch.as_tensor(view.alive).to(dev))

    def _group_demands(self, view, bundles: List[Dict[str, float]],
                       strategy: str):
        """(demand matrix rows, mode) for one group under a strategy:
        STRICT_PACK collapses to the bundle-sum on one node."""
        if strategy == "STRICT_PACK":
            total_demand: Dict[str, float] = {}
            for b in bundles:
                for k, v in b.items():
                    total_demand[k] = total_demand.get(k, 0.0) + v
            return [view.demand_vector(total_demand)], "spread"
        mode = {"PACK": "pack", "SPREAD": "spread",
                "STRICT_SPREAD": "strict_spread"}[strategy]
        return [view.demand_vector(b) for b in bundles], mode

    def solve(self, cluster, bundles: List[Dict[str, float]],
              strategy: str) -> Optional[List]:
        """Bundle -> NodeID assignment, or None when it doesn't fit
        right now (caller falls back for infeasibility marking)."""
        view = self._view
        view.refresh(cluster,
                     extra_resources=[r for b in bundles for r in b])
        if not view.node_ids:
            return None

        rows, mode = self._group_demands(view, bundles, strategy)
        demands = (np.stack(rows) if rows
                   else np.zeros((0, view.total.shape[1]), np.float32))
        packed = pack(*self._tensors(view),
                      torch.as_tensor(demands).to(self.device),
                      mode).cpu().numpy()      # the one device-to-host copy
        assign, ok = packed[:-1], bool(packed[-1])
        if not ok:
            return None
        if strategy == "STRICT_PACK":
            nid = view.node_ids[int(assign[0])]
            return [nid] * len(bundles)
        return [view.node_ids[int(i)] for i in assign]

    def solve_many(self, cluster,
                   group_bundles: List[List[Dict[str, float]]],
                   strategy: str) -> List[Optional[List]]:
        """Pack many groups of one strategy in a single kernel entry (the
        restart-storm shape). Returns one assignment list per group;
        ``None`` entries did not fit their top-k candidate set and should
        re-solve on the single-group path."""
        view = self._view
        view.refresh(cluster, extra_resources=[
            r for bundles in group_bundles for b in bundles for r in b])
        n_groups = len(group_bundles)
        if not view.node_ids or n_groups == 0:
            return [None] * n_groups

        rows_per_group = []
        mode = "spread"
        for bundles in group_bundles:
            rows, mode = self._group_demands(view, bundles, strategy)
            rows_per_group.append(rows)

        n_pad, n_res = view.total.shape
        b_pad = _bucket(max(len(r) for r in rows_per_group), minimum=1)
        g_pad = _bucket(n_groups, minimum=1)
        demands = np.zeros((g_pad, b_pad, n_res), np.float32)
        valid = np.zeros((g_pad, b_pad), bool)
        for g, rows in enumerate(rows_per_group):
            if rows:
                demands[g, :len(rows)] = np.stack(rows)
                valid[g, :len(rows)] = True
        # Candidate-set size: config floor, but never below the bundle
        # count (STRICT_SPREAD needs >= B distinct candidates) and never
        # above the padded node count.
        k = min(_bucket(max(get_config().pg_pack_topk, b_pad),
                        minimum=1), n_pad)

        packed = pack_batch(
            *self._tensors(view), torch.as_tensor(demands).to(self.device),
            torch.as_tensor(valid).to(self.device), mode,
            k).cpu().numpy()                   # the one device-to-host copy
        out: List[Optional[List]] = []
        for g, bundles in enumerate(group_bundles):
            if not packed[g, -1]:
                out.append(None)
                continue
            assign = packed[g, :len(rows_per_group[g])]
            if strategy == "STRICT_PACK":
                nid = view.node_ids[int(assign[0])]
                out.append([nid] * len(bundles))
            else:
                out.append([view.node_ids[int(i)] for i in assign])
        return out
