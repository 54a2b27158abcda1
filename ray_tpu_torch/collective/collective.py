"""Actor-to-actor collective groups.

Reference: ``python/ray/util/collective/`` [UNVERIFIED — mount empty,
SURVEY.md §0] — collective groups over NCCL/Gloo between actors
(allreduce / allgather / reducescatter / broadcast / send / recv /
barrier).

The port's copy of ``ray_tpu/collective/collective.py``. *In-program*
collectives run over NCCL inside the program on a mesh (see
``ray_tpu_torch.collective.xla``) and should carry the FLOP-heavy traffic.
This module is the **host-side control-plane collective** between
actor processes — the role Gloo plays in the reference: parameter
averaging, barriers, small tensor exchange. Transport on one host is
the shared-memory filesystem (``/dev/shm``) with atomic renames; the
rendezvous layout (group dir / epoch dir / generation dir / per-rank
files) is the same shape a DCN object-transfer backend plugs into for
multi-host.

Gang fault tolerance (docs/fault_tolerance.md "Gang semantics"):

- every incarnation of a group carries a monotonically increasing
  **epoch**; all rendezvous artifacts live under
  ``<root>/ep_<epoch>/`` so a stale writer from a previous
  incarnation can never satisfy (or corrupt) a new incarnation's
  rendezvous — the fence is structural, not advisory;
- the driver (which observes member-actor deaths) writes an **abort
  marker** ``<root>/aborted_<epoch>`` when the gang aborts; every
  ``_wait_load`` poll checks it and raises a retryable
  ``CollectiveAbortError`` promptly instead of burning the group
  timeout. A rank that times out locally writes the same marker
  before raising, fanning its failure out to all in-op peers;
- the current epoch is published in ``<root>/state.json`` (written by
  the driver before each (re-)join), so members re-joining after a
  coordinated gang restart pick up the new epoch without an API
  change.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.exceptions import CollectiveAbortError

logger = logging.getLogger(__name__)

_BASE = os.environ.get("RAY_TPU_COLL_DIR", "/dev/shm/ray_tpu_torch_coll")
_POLL_S = 0.0005


class ReduceOp:
    SUM = "sum"
    PRODUCT = "prod"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


_REDUCERS = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
    ReduceOp.MEAN: lambda xs: np.mean(xs, axis=0),
}


# ---------------------------------------------------------------------------
# rendezvous layout helpers (shared with the driver's gang coordinator)


def group_root(group_name: str) -> str:
    """Rendezvous root of a group (shared with the gang coordinator in
    ``_private/worker.py``, which writes abort markers / state here)."""
    return os.path.join(_BASE, group_name)


def _epoch_dir(root: str, epoch: int) -> str:
    return os.path.join(root, f"ep_{epoch:08d}")


def _abort_marker(root: str, epoch: int) -> str:
    return os.path.join(root, f"aborted_{epoch:08d}")


def _state_path(root: str) -> str:
    return os.path.join(root, "state.json")


def write_group_state(root: str, epoch: int, world_size: int,
                      state: str) -> None:
    """Atomically publish the group's current incarnation. The driver
    writes this before every (re-)join; members read their epoch from
    it in ``init_collective_group``."""
    from ray_tpu_torch._private import durable
    os.makedirs(root, exist_ok=True)
    durable.atomic_write(
        _state_path(root),
        lambda f: json.dump({"epoch": int(epoch),
                             "world_size": int(world_size),
                             "state": state}, f),
        mode="w")


def read_group_state(root: str) -> Optional[dict]:
    try:
        with open(_state_path(root)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_abort_marker(root: str, epoch: int, reason: str = "") -> None:
    """Fan an abort out to every rank in-op at ``epoch``: the marker is
    checked on every ``_wait_load`` poll, so blocked ranks raise
    ``CollectiveAbortError`` within milliseconds."""
    from ray_tpu_torch._private import durable
    os.makedirs(root, exist_ok=True)
    durable.atomic_write(_abort_marker(root, epoch),
                         lambda f: f.write(reason), mode="w")


def cleanup_stale_epochs(root: str, current_epoch: int) -> None:
    """Delete every previous incarnation's artifacts (epoch dirs and
    abort markers below ``current_epoch``): stale ``gen``/``rank_*``
    files must not leak under the session dir, and group-name reuse
    must never collide with them."""
    try:
        names = os.listdir(root)
    except OSError:
        return
    for name in names:
        stale = False
        if name.startswith("ep_"):
            stale = int(name[3:]) < current_epoch
        elif name.startswith("aborted_"):
            stale = int(name[8:]) < current_epoch
        if stale:
            path = os.path.join(root, name)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.unlink(path)
                except OSError:
                    pass    # concurrent cleanup: already gone


@dataclass
class _Group:
    name: str
    rank: int
    world_size: int
    root: str
    epoch: int = 1
    seq: int = 0
    timeout_s: float = 60.0
    _gc_pending: List[str] = field(default_factory=list)


# Membership is per (actor, group): GPU actors run on threads of the
# driver process, so two ranks of one group can share a process (the
# reference's TPU actors would too, but it never puts two in one gang).
_groups: Dict[tuple, _Group] = {}


def _current_actor() -> bytes:
    """The actor whose call runs on this thread (b"" outside actors):
    the executor's thread-local or an async actor's contextvar, never
    the process-level fallback, which outlives the call."""
    from ray_tpu_torch._private import worker_process as _wp
    ctx = _wp._CTX_TASK.get()
    actor = ctx.get("actor_id") if ctx else None
    return actor or getattr(_wp._CURRENT_TASK, "actor_id", b"") or b""


def _lookup_key(group_name: str):
    """The key of this caller's membership of ``group_name``: its own,
    else the process's only one (a thread of the actor's own making
    carries no actor identity)."""
    key = (_current_actor(), group_name)
    if key in _groups:
        return key
    keys = [k for k in _groups if k[1] == group_name]
    return keys[0] if len(keys) == 1 else None


def _atomic_save(path: str, arr: np.ndarray) -> None:
    # Shared helper, rename-only (fsync=False): a reader polling for
    # the rank file can never observe a torn array, but rank files are
    # transient rendezvous artifacts on the collective HOT PATH — a
    # crash aborts the op via the liveness/abort-marker plane, so
    # paying two fsyncs per rank per op would buy nothing.
    from ray_tpu_torch._private import durable
    durable.atomic_write(path, lambda f: np.save(f, arr,
                                                 allow_pickle=False),
                         fsync=False)


def _check_abort(g: _Group) -> None:
    """Raise if this incarnation has been aborted (driver-observed
    member death, or a peer's local timeout fan-out)."""
    marker = _abort_marker(g.root, g.epoch)
    if os.path.exists(marker):
        try:
            with open(marker) as f:
                reason = f.read().strip()
        except OSError:
            reason = ""
        raise CollectiveAbortError(
            f"collective group {g.name!r} (epoch {g.epoch}) aborted"
            + (f": {reason}" if reason else ""),
            group=g.name, epoch=g.epoch)


def _save_rank_file(g: _Group, d: str, tag: str, arr: np.ndarray) -> None:
    """Write this rank's contribution; the chaos point here is how
    tests drop a rank file or kill a member mid-collective
    (``collective.rendezvous.save_<tag>:drop|kill``)."""
    from ray_tpu_torch._private import chaos
    action = chaos.fire("collective", "rendezvous", f"save_{tag}")
    if action == "drop":
        return          # the rank file vanishes: peers must abort
    _atomic_save(os.path.join(d, f"rank_{g.rank}.npy"), arr)


def _wait_load(g: _Group, path: str, deadline: float) -> np.ndarray:
    """Liveness-aware wait: poll for the peer's rank file, but check
    the incarnation's abort marker on every pass — a dead member
    costs milliseconds, not the group timeout. A local timeout writes
    the marker itself before raising, so peers abort promptly too."""
    while True:
        if os.path.exists(path):
            try:
                return np.load(path, allow_pickle=False)
            except (ValueError, EOFError, OSError):
                pass  # torn read before rename landed (shouldn't happen)
        _check_abort(g)
        if time.monotonic() > deadline:
            write_abort_marker(
                g.root, g.epoch,
                f"rank {g.rank} timed out waiting for {os.path.basename(path)}")
            raise TimeoutError(f"collective timed out waiting for {path}")
        time.sleep(_POLL_S)


def init_collective_group(world_size: int, rank: int,
                          backend: str = "shm",
                          group_name: str = "default",
                          timeout_s: float = 60.0) -> None:
    """Join a collective group. Every member must call this with the
    same ``group_name`` and ``world_size`` and a distinct ``rank``.

    The incarnation epoch is read from the group's ``state.json``
    (written by the driver's ``create_collective_group`` / gang
    restart coordinator); a direct join with no state file starts at
    epoch 1. Rendezvous artifacts are epoch-fenced: a process still
    writing under a previous epoch can never satisfy this one.

    Backends: ``shm`` (single-host actor plane) and ``xla`` (the
    collectives inside a program on a mesh — see ``collective.xla``;
    named here for API parity, it needs no group rendezvous). The
    reference's ``nccl``/``gloo`` names are rejected rather than silently
    aliased: the port's device collectives run inside programs over a
    mesh's NCCL process group, not between actors.
    """
    if backend in ("nccl", "gloo"):
        raise ValueError(
            f"backend {backend!r} is not an actor-group backend: device "
            "collectives run inside programs over a mesh's NCCL process "
            "group (ray_tpu_torch.collective.xla); the host plane backend "
            "is 'shm'")
    if backend not in ("shm", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "xla":
        raise ValueError(
            "the 'xla' backend needs no collective group: collectives "
            "are ops inside programs over a mesh")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    root = group_root(group_name)
    os.makedirs(root, exist_ok=True)
    st = read_group_state(root)
    if st is None:
        # direct join (no driver coordinator): first incarnation
        epoch = 1
        write_group_state(root, epoch, world_size, "FORMING")
    else:
        epoch = int(st.get("epoch", 1))
    os.makedirs(_epoch_dir(root, epoch), exist_ok=True)
    g = _Group(group_name, rank, world_size, root, epoch=epoch,
               timeout_s=timeout_s)
    _groups[(_current_actor(), group_name)] = g
    barrier(group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave and tear down the group's rendezvous dir (every epoch's
    generation dirs and rank files — nothing may leak under the
    session dir, and group-name reuse must start clean). Called in the
    driver process it also retires the gang record and GCS entry."""
    key = _lookup_key(group_name)
    g = _groups.pop(key, None) if key is not None else None
    root = g.root if g is not None else group_root(group_name)
    shutil.rmtree(root, ignore_errors=True)
    try:
        from ray_tpu_torch._private.worker import try_global_worker
        w = try_global_worker()
    except Exception:
        w = None    # interpreter teardown: the dir removal above is
                    # the part that must not be skipped
    if w is not None and hasattr(w, "unregister_gang"):
        w.unregister_gang(group_name)      # proxied drivers lack gangs


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def get_group_epoch(group_name: str = "default") -> int:
    """Current incarnation epoch of this process's group membership."""
    return _get(group_name).epoch


def _get(group_name: str) -> _Group:
    key = _lookup_key(group_name)
    g = _groups.get(key) if key is not None else None
    if g is None:
        raise RuntimeError(
            f"no collective group {group_name!r} in this process; call "
            "init_collective_group first")
    return g


def _gen_dir(g: _Group, tag: str) -> str:
    g.seq += 1
    d = os.path.join(_epoch_dir(g.root, g.epoch),
                     f"{tag}_{g.seq:08d}")
    os.makedirs(d, exist_ok=True)
    return d


def _finish(g: _Group, d: str) -> None:
    """Mark this rank done with generation ``d``; lazily GC complete
    generations at a safe distance (2 ops back)."""
    open(os.path.join(d, f"done_{g.rank}"), "w").close()
    g._gc_pending.append(d)
    while len(g._gc_pending) > 2:
        old = g._gc_pending[0]
        if g.rank == 0:
            if all(os.path.exists(os.path.join(old, f"done_{r}"))
                   for r in range(g.world_size)):
                shutil.rmtree(old, ignore_errors=True)
                g._gc_pending.pop(0)
            else:
                break
        else:
            g._gc_pending.pop(0)


def _as_np(tensor) -> np.ndarray:
    """A numpy copy of ``tensor``; a ``torch.Tensor`` (on either device)
    comes to the host first. Never imports torch."""
    import sys
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def allreduce(tensor, group_name: str = "default",
              op: str = ReduceOp.SUM) -> np.ndarray:
    g = _get(group_name)
    _check_abort(g)
    d = _gen_dir(g, "ar")
    arr = _as_np(tensor)
    _save_rank_file(g, d, "ar", arr)
    deadline = time.monotonic() + g.timeout_s
    parts = [_wait_load(g, os.path.join(d, f"rank_{r}.npy"), deadline)
             for r in range(g.world_size)]
    out = _REDUCERS[op](np.stack(parts))
    _finish(g, d)
    return out


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    g = _get(group_name)
    _check_abort(g)
    d = _gen_dir(g, "ag")
    _save_rank_file(g, d, "ag", _as_np(tensor))
    deadline = time.monotonic() + g.timeout_s
    parts = [_wait_load(g, os.path.join(d, f"rank_{r}.npy"), deadline)
             for r in range(g.world_size)]
    _finish(g, d)
    return parts


def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM) -> np.ndarray:
    """Reduce across ranks, then scatter equal chunks along axis 0."""
    g = _get(group_name)
    _check_abort(g)
    arr = _as_np(tensor)
    if arr.shape[0] % g.world_size != 0:
        raise ValueError(
            f"leading dim {arr.shape[0]} not divisible by world size "
            f"{g.world_size}")
    full = allreduce(arr, group_name, op)
    chunk = full.shape[0] // g.world_size
    return full[g.rank * chunk:(g.rank + 1) * chunk]


def broadcast(tensor, src_rank: int = 0,
              group_name: str = "default") -> np.ndarray:
    g = _get(group_name)
    _check_abort(g)
    d = _gen_dir(g, "bc")
    deadline = time.monotonic() + g.timeout_s
    path = os.path.join(d, f"rank_{src_rank}.npy")
    if g.rank == src_rank:
        _save_rank_file(g, d, "bc", _as_np(tensor))
        out = _as_np(tensor)
    else:
        out = _wait_load(g, path, deadline)
    _finish(g, d)
    return out


def barrier(group_name: str = "default") -> None:
    g = _get(group_name)
    _check_abort(g)
    d = _gen_dir(g, "bar")
    _save_rank_file(g, d, "bar", np.zeros(1, np.int8))
    deadline = time.monotonic() + g.timeout_s
    for r in range(g.world_size):
        _wait_load(g, os.path.join(d, f"rank_{r}.npy"), deadline)
    _finish(g, d)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send. Pairs with a matching ``recv`` on dst."""
    g = _get(group_name)
    _check_abort(g)
    d = os.path.join(_epoch_dir(g.root, g.epoch),
                     f"p2p_{g.rank}_to_{dst_rank}")
    os.makedirs(d, exist_ok=True)
    key = f"_p2p_send_{dst_rank}"
    seq = getattr(g, key, 0)
    _atomic_save(os.path.join(d, f"{seq:08d}.npy"), _as_np(tensor))
    setattr(g, key, seq + 1)


def recv(src_rank: int, group_name: str = "default") -> np.ndarray:
    """Point-to-point receive. Fails fast on an aborted epoch at ENTRY
    like every other op: without the check a payload queued before the
    abort would still be consumed at the fenced incarnation (the
    in-poll marker check only covers the not-yet-arrived case)."""
    g = _get(group_name)
    _check_abort(g)
    d = os.path.join(_epoch_dir(g.root, g.epoch),
                     f"p2p_{src_rank}_to_{g.rank}")
    os.makedirs(d, exist_ok=True)
    key = f"_p2p_recv_{src_rank}"
    seq = getattr(g, key, 0)
    deadline = time.monotonic() + g.timeout_s
    path = os.path.join(d, f"{seq:08d}.npy")
    out = _wait_load(g, path, deadline)
    try:
        os.unlink(path)  # consumed: keep /dev/shm bounded
    except OSError:
        pass
    setattr(g, key, seq + 1)
    return out


def create_collective_group(actors, world_size: int, ranks: List[int],
                            backend: str = "shm",
                            group_name: Optional[str] = None,
                            gang_max_restarts: Optional[int] = None
                            ) -> str:
    """Driver-side declaration: tell each actor to join the group.
    Returns the group name (generated if not given).

    Registers the gang with the runtime (GCS gang table + the driver's
    gang coordinator): a member-actor death then aborts the group's
    epoch promptly and — up to ``gang_max_restarts`` (default from
    config) — kills and restarts *all* members together, re-forming
    the group at the bumped epoch."""
    import ray_tpu_torch
    from ray_tpu_torch._private.worker import try_global_worker
    if group_name is None:
        group_name = f"group_{uuid.uuid4().hex[:8]}"
    root = group_root(group_name)
    # Name reuse without a destroy: start PAST the old incarnation's
    # epoch — rmtree alone can't fence a still-live old member, whose
    # makedirs would recreate the old epoch dir and whose timeout
    # fan-out would write an abort marker the new group (if also at
    # that epoch) would trip over.
    old = read_group_state(root)
    epoch = int(old.get("epoch", 0)) + 1 if old else 1
    shutil.rmtree(root, ignore_errors=True)
    write_group_state(root, epoch, world_size, "FORMING")
    w = try_global_worker()
    if w is not None and not hasattr(w, "register_gang"):
        w = None      # proxied (rtpu://) driver: no gang coordinator
    if w is not None:
        w.register_gang(group_name, list(actors), list(ranks),
                        world_size, backend,
                        max_restarts=gang_max_restarts, epoch=epoch)
    refs = [a._join_collective_group.remote(world_size, r, backend,
                                            group_name)
            for a, r in zip(actors, ranks)]
    try:
        ray_tpu_torch.get(refs, timeout=60)
    except BaseException:
        # failed formation must not leave a registered gang behind: a
        # later death of one of these actors would otherwise launch a
        # coordinated restart of a group that never formed
        if w is not None:
            w.unregister_gang(group_name)
        shutil.rmtree(root, ignore_errors=True)
        raise
    write_group_state(root, epoch, world_size, "ALIVE")
    if w is not None:
        w.gang_formed(group_name)
    return group_name
