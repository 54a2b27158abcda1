"""The DCN tier: cross-slice collectives among per-slice leader ranks.

A multi-slice set (docs/multislice.md) joins the rank-0 actor of every
slice gang into ONE extra collective group — the DCN group — whose
rendezvous rides the same epoch-fenced layout as ``ray_tpu_torch/collective``
(``<root>/ep_<epoch>/…``, abort markers, liveness-aware waits), so the
whole fencing contract applies across slices for free. What this
module adds on top of the shared mechanics:

- a **simulated cost model**: every remote rank-file read charges
  ``dcn_latency_ms + bytes*8/(dcn_gbps*1e9)`` of wall time (both knobs
  in ``_private/config.py``; 0 disables a term), so benches report
  realistic cross-slice step overhead without real DCN hardware;
- **byte/time accounting**: counters of bytes injected into
  (``bytes_tx``) and pulled from (``bytes_rx``) the DCN tier and
  wall-clock spent inside DCN collectives, kept per member actor (the
  port runs GPU-demand leaders on threads of the driver, so two
  leaders can share one process and its pid) — the trainer driver
  aggregates leaders' counters into the ``ray_tpu_dcn_bytes`` /
  ``ray_tpu_dcn_collective_ms`` gauges, and the hierarchical-allreduce
  test proves only ~1/num_slices of gradient bytes cross this tier;
- **chaos points** ``multislice.dcn.save_<tag>`` (``drop`` = the
  leader's rank file vanishes, peers abort via liveness; ``kill`` =
  die mid-DCN-collective) and ``multislice.dcn.load_<tag>`` (``drop``
  = the transfer is declared failed: the reader writes the DCN abort
  marker and raises typed instead of burning the group timeout).

The DCN group is joined DIRECTLY (``join_dcn_group``), never through
``create_collective_group``: it must NOT register as a gang — a leader
death is handled by its own slice gang's coordinated restart, and the
sliceset coordinator (``_private/worker.py``) fences this tier's epoch
in response.

The port's copy of ``ray_tpu/multislice/dcn.py``. It differs in the
per-actor counters above, in the group lookup by the calling actor
(``collective._lookup_key``), as the port keys membership, and in
taking a tensor's host copy (``collective._as_np``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch import collective as col
from ray_tpu_torch.collective import collective as _cc
from ray_tpu_torch.collective.collective import ReduceOp, _REDUCERS

# DCN observability counters, one set per incarnation of a member
# actor, ``(actor id, starts)`` (leaders only, by construction —
# non-leaders never run a DCN op)
_stats_lock = threading.Lock()
_FIELDS = ("bytes_tx", "bytes_rx", "ops", "ms")
_stats: Dict[Tuple[bytes, int], Dict[str, float]] = {}  # guarded-by: _stats_lock
_starts: Dict[bytes, int] = {}  # guarded-by: _stats_lock


def _incarnation(actor: bytes) -> Tuple[bytes, int]:  # lock-held: _stats_lock
    return actor, _starts.get(actor, 0)


def begin_incarnation() -> None:
    """Called by a member actor's constructor: the (re)started actor's
    counters start from zero under a new incarnation marker, also where
    the restart runs in the same process as the old incarnation (a
    GPU-demand actor on a thread of the driver)."""
    actor = _cc._current_actor()
    with _stats_lock:
        _stats.pop(_incarnation(actor), None)
        _starts[actor] = _starts.get(actor, 0) + 1


def stats_snapshot() -> Dict[str, float]:
    """The calling actor's cumulative DCN counters plus an incarnation
    marker (pid, actor, starts): counters reset on a restart, and the
    aggregator (``SliceSet.refresh_dcn_stats``) must treat a snapshot
    from a NEW incarnation as starting from zero even when the fresh
    counters have already grown past the old ones."""
    actor = _cc._current_actor()
    with _stats_lock:
        key = _incarnation(actor)
        out = dict(_stats.get(key) or dict.fromkeys(_FIELDS, 0))
    out["incarnation"] = (os.getpid(), actor.hex(), key[1])
    return out


def reset_stats() -> None:
    """Zero every counter of this process."""
    with _stats_lock:
        _stats.clear()


def _account(actor: bytes, **deltas) -> None:
    with _stats_lock:
        counters = _stats.setdefault(_incarnation(actor),
                                     dict.fromkeys(_FIELDS, 0))
        for k, v in deltas.items():
            counters[k] += v


@dataclass(frozen=True)
class DcnCostModel:
    """Per-transfer simulated cost: ``latency_s`` plus the serialized
    bytes over ``bytes_per_s`` (0 = term disabled). Charged once per
    REMOTE rank-file read — local (own-rank) reads are free, exactly
    like the real tier where a leader's own contribution never leaves
    the host."""

    latency_s: float = 0.0
    bytes_per_s: float = 0.0

    @classmethod
    def from_config(cls) -> "DcnCostModel":
        from ray_tpu_torch._private.config import get_config
        cfg = get_config()
        return cls(latency_s=cfg.dcn_latency_ms / 1000.0,
                   bytes_per_s=cfg.dcn_gbps * 1e9 / 8.0)

    def delay_s(self, nbytes: int) -> float:
        d = self.latency_s
        if self.bytes_per_s > 0:
            d += nbytes / self.bytes_per_s
        return d


def join_dcn_group(world_size: int, rank: Optional[int],
                   group_name: str, timeout_s: float = 60.0
                   ) -> Optional[int]:
    """Join (or re-join at a bumped epoch) the DCN leader group.

    ``rank=None`` is a structured no-op: non-leader ranks receive the
    same call so call counts stay SPMD-symmetric across a slice gang —
    the contract the gang-consistent checkpoint plane aligns
    generations by."""
    if rank is None:
        return None
    col.init_collective_group(world_size, rank, "shm", group_name,
                              timeout_s=timeout_s)
    return rank


def _dcn_save(g, actor: bytes, d: str, tag: str, arr: np.ndarray) -> None:
    from ray_tpu_torch._private import chaos
    action = chaos.fire("multislice", "dcn", f"save_{tag}")
    if action == "drop":
        return          # the DCN rank file vanishes: peers must abort
    _cc._atomic_save(
        os.path.join(d, f"rank_{g.rank}.npy"), arr)
    _account(actor, bytes_tx=arr.nbytes)


def _dcn_load(g, actor: bytes, path: str, tag: str, deadline: float,
              model: DcnCostModel) -> np.ndarray:
    """Remote rank-file read: liveness-aware wait (every poll checks
    the DCN epoch's abort marker — a fenced slice costs milliseconds,
    not the group timeout), then the simulated transfer cost."""
    from ray_tpu_torch._private import chaos
    action = chaos.fire("multislice", "dcn", f"load_{tag}")
    if action == "drop":
        # the transport declared this transfer failed: fan the abort
        # out (marker) and raise typed — the multi-slice analog of a
        # severed DCN link
        col.write_abort_marker(
            g.root, g.epoch,
            f"chaos: dcn load_{tag} dropped at rank {g.rank}")
        _cc._check_abort(g)
    arr = _cc._wait_load(g, path, deadline)
    delay = model.delay_s(arr.nbytes)
    if delay > 0:
        time.sleep(delay)
    _account(actor, bytes_rx=arr.nbytes)
    return arr


def dcn_allreduce(tensor, group_name: str,
                  op: str = ReduceOp.SUM) -> np.ndarray:
    """Allreduce among the per-slice leaders over the DCN tier. Same
    rendezvous mechanics as ``collective.allreduce`` plus the cost
    model, accounting, and ``multislice.dcn.*`` chaos points."""
    key = _cc._lookup_key(group_name)
    g = _cc._groups.get(key) if key is not None else None
    if g is None:
        # A restarted leader can be driven into a step before the
        # coordinator's rejoin_dcn re-join lands in this process (the
        # DCN join arrives out-of-band, unlike the slice-group join
        # the gang-restart plane re-issues ahead of queued calls).
        # That ordering is transient by construction, so abort typed —
        # the trainer's recover() taxonomy re-drives the step after
        # the join instead of surfacing a raw RuntimeError.
        from ray_tpu_torch.exceptions import CollectiveAbortError
        raise CollectiveAbortError(
            f"no DCN group {group_name!r} in this process yet "
            "(rejoin in flight)", group=group_name)
    _cc._check_abort(g)
    model = DcnCostModel.from_config()
    t0 = time.perf_counter()
    d = _cc._gen_dir(g, "ar")
    actor = key[0]
    arr = _cc._as_np(tensor)
    _dcn_save(g, actor, d, "ar", arr)
    deadline = time.monotonic() + g.timeout_s
    parts = []
    for r in range(g.world_size):
        path = os.path.join(d, f"rank_{r}.npy")
        if r == g.rank:
            # own contribution: local read, no transfer cost — unless
            # our own save was chaos-dropped, in which case the wait
            # times out and fans the abort out like any lost rank
            parts.append(_cc._wait_load(g, path, deadline))
        else:
            parts.append(_dcn_load(g, actor, path, "ar", deadline,
                                   model))
    out = _REDUCERS[op](np.stack(parts))
    _cc._finish(g, d)
    _account(actor, ops=1, ms=(time.perf_counter() - t0) * 1000.0)
    return out


def dcn_epoch(group_name: str) -> int:
    """Current DCN incarnation epoch of this process's membership."""
    return col.get_group_epoch(group_name)
