"""Per-node raylet process.

Reference: ``src/ray/raylet/`` — ``main.cc`` starting a per-node
``NodeManager`` (worker leasing + dispatch), local object store, and
object manager, talking to the GCS and to the task owner over RPC
[UNVERIFIED — mount empty, SURVEY.md §0].

One process per (logical or physical) node:

- owns a **node-local ShmStore** in its own namespace — objects on this
  node are NOT host-shared with other nodes; crossing nodes goes
  through the chunked transfer plane (``object_transfer.py``), exactly
  as it would over DCN,
- owns a **WorkerPool** of exec'd worker subprocesses (same execution
  core as the head node's),
- serves **leases**: the owner (driver) sends task payloads; the raylet
  resolves argument objects (local shm hit, else pull from the peer
  holding them), dispatches to a leased worker, seals results locally,
  and pushes completions back on the owner's channel — big results stay
  node-local and only their location travels,
- **registers with the GCS** and heartbeats resource reports; the GCS
  health manager declares it dead when pings stop.

Spillback: a lease whose demand cannot EVER fit this node's total
resources is refused back to the owner for rescheduling (the wrong-
guess correction of the reference's two-level scheduling).

The port's copy of ``ray_tpu/_private/raylet_server.py``. A raylet
process and its workers see no card (``CUDA_VISIBLE_DEVICES`` empty):
the head driver owns the cards, and ``Cluster.add_node`` refuses a
remote node with GPUs. Its process files live in the node session's
directory under ``TMPDIR`` (``session_dir.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.gcs import NodeInfo
from ray_tpu_torch._private.gcs_client import GcsClient
from ray_tpu_torch._private.ids import ActorID, NodeID, ObjectID
from ray_tpu_torch._private.object_store import ShmStore, _segment_name
from ray_tpu_torch._private.object_transfer import (
    PeerClients,
    PullManager,
    pull_counters,
    serve_store,
)
from ray_tpu_torch.exceptions import ObjectTransferError
from ray_tpu_torch._private.rpc import ConnectionContext, RpcServer
from ray_tpu_torch._private.session_dir import session_dir
from ray_tpu_torch._private.worker_pool import BaseWorker, ProcessWorker, WorkerPool

logger = logging.getLogger(__name__)


class RayletServer:
    def __init__(self, session: str, node_id: NodeID,
                 resources_total: Dict[str, float],
                 gcs_addr: Optional[Tuple[str, int]] = None,
                 max_process_workers: int = 2,
                 object_store_memory: Optional[int] = None,
                 labels: Optional[Dict[str, str]] = None):
        from ray_tpu_torch._private import chaos
        chaos.maybe_arm()
        cfg = get_config()
        self.node_id = node_id
        self.session = session          # node-scoped namespace
        self.resources_total = dict(resources_total)
        self.labels = dict(labels or {})
        self.shm_store = ShmStore(
            session, object_store_memory or cfg.object_store_memory_bytes,
            spill_dir=cfg.object_store_fallback_directory or None,
            spill_threshold=cfg.object_spilling_threshold)
        self._functions: Dict[bytes, bytes] = {}
        self._peers = PeerClients()
        self._owner_ctx: Optional[ConnectionContext] = None
        self._owner_lock = threading.Lock()

        from ray_tpu_torch._private.connection_hub import ConnectionHub
        self.hub = ConnectionHub(session)
        self.worker_pool = WorkerPool(
            session, self.hub, self._unused_inproc_reply, self._wake_dispatch,
            max_process_workers=max_process_workers)

        self._lock = threading.RLock()
        # unbounded-ok: bounded by admission control — _admit_payload
        # sheds submits once len() reaches raylet_max_queued_tasks
        self._dispatch_queue: deque = deque()
        self._running: Dict[bytes, BaseWorker] = {}   # task_id -> worker
        self._actor_workers: Dict[bytes, BaseWorker] = {}
        self._creation_tasks: Dict[bytes, bytes] = {}  # actor_id -> task_id
        # Detached actors (lifetime="detached"): survive their creating
        # driver's connection; everything else is reaped when its
        # owner's channel closes (reference: GcsActorManager owns
        # detached actors, workers of a dead job are cleaned up).
        self._detached: set = set()                    # actor_id bytes
        self._actor_ctx: Dict[bytes, ConnectionContext] = {}
        self._orphaned_creations: set = set()          # owner died mid-create
        # Completion routing: pushes go to the connection that
        # SUBMITTED the task, so several drivers can share this raylet
        # (the detached-actor case) without stealing each other's
        # completions; _owner_ctx stays as the fallback.
        self._task_ctx: Dict[bytes, ConnectionContext] = {}
        # Owner-reconnect tolerance: a disconnected channel is NOT
        # torn down immediately — the owner's retrying client may be
        # mid-reconnect. Dead ctxs wait out a grace period here
        # (ctx -> purge deadline); a returning register_owner adopts
        # their routing state, and pushes that found no live channel
        # buffer in _undelivered for replay on that re-register.
        self._dead_ctxs: Dict[ConnectionContext, float] = {}  # guarded-by: _lock
        self._undelivered: List[Tuple[str, dict]] = []  # guarded-by: _lock
        # True while a registration replay is draining _undelivered:
        # new pushes are routed INTO the buffer so they queue behind
        # the backlog — a direct push overtaking buffered stream items
        # would be dropped owner-side as a stale duplicate (the item
        # index only moves forward). Cleared atomically with the
        # drain's emptiness check.
        self._replaying = False  # guarded-by: _lock
        # Authoritative local usage: what running tasks and resident
        # actors nominally demand — the heartbeat reports total minus
        # this (reference: LocalResourceManager's available view).
        self._running_demand: Dict[bytes, Dict[str, float]] = {}
        self._actor_demand: Dict[bytes, Dict[str, float]] = {}
        self._wake = threading.Event()
        self._shutdown = threading.Event()
        # Completion coalescing (data-plane fast path, layer 2): owner
        # pushes buffer here and leave as one task_done_many frame per
        # flush — size- and deadline-bounded; the first push after an
        # idle window bypasses the buffer (serial round trips pay no
        # added latency). Order is preserved: non-task_done topics
        # flush the buffer ahead of themselves, so e.g. an actor_ckpt
        # commit can never overtake the completions it covers.
        from ray_tpu_torch._private import wire_stats
        self._push_stats = wire_stats.channel("completion_push")
        self._push_coalesce_s = max(0.0,
                                    cfg.task_done_coalesce_ms / 1000.0)
        self._push_coalesce_max = max(1, cfg.task_done_coalesce_max)
        # unbounded-ok: _push_owner_buffered flushes the moment depth
        # reaches _push_coalesce_max, so occupancy never exceeds it
        self._push_buf: deque = deque()  # guarded-by: _push_lock
        self._push_lock = threading.Lock()
        # Serializes drain+send sequences (NOT individual pushes):
        # draining under _push_lock but sending outside it would let a
        # flush-ahead topic (e.g. an actor_ckpt commit) observe an
        # empty buffer while the drained completions it must trail are
        # still unsent in another thread — the commit would overtake
        # its completions on the wire. Never reversed (graftcheck's
        # lock-order pass enforces the declaration below):
        # lock-order: _push_order_lock -> _push_lock -> ConnectionContext._send_lock
        self._push_order_lock = threading.Lock()  # blocking-ok: flush-ahead ordering — the send MUST complete under this lock or a commit can overtake its completions on the wire
        self._push_armed = threading.Event()
        self._last_push_ts = 0.0  # guarded-by: _push_lock
        if self._push_coalesce_s > 0:
            threading.Thread(target=self._push_flush_loop, daemon=True,
                             name="rtpu-raylet-pushflush").start()
        self.num_pulled = 0   # objects fetched from peers (transfer stat)
        # Overload plane (see docs/fault_tolerance.md "Overload
        # semantics"): bounded scheduler intake + node memory watchdog.
        self._max_queued = cfg.raylet_max_queued_tasks
        self.num_shed = 0          # submits shed at admission
        self.num_oom_kills = 0     # tasks killed by the memory watchdog
        # task_id -> {"retryable": bool, "name": str} for running tasks
        # (the watchdog's victim-selection input)
        self._running_meta: Dict[bytes, dict] = {}  # guarded-by: _lock
        # task_ids the watchdog killed: their worker-death completion
        # ships an OutOfMemoryError marker instead of a generic crash
        self._oom_victims: Dict[bytes, bool] = {}  # guarded-by: _lock
        from ray_tpu_torch._private.pip_env import PipEnvManager
        self._pip_envs = PipEnvManager(self._on_pip_env_requeue)

        self.server = RpcServer(component="raylet")
        self.address = self.server.address
        # Pull plane: deduped, deadline-budgeted, re-routed fetches
        # (docs/object_plane.md). progress= lets this raylet re-serve
        # chunks of an in-flight pull to its broadcast-tree children.
        self.pull_manager = PullManager(self.shm_store, self._peers,
                                        label="raylet")
        serve_store(self.server, self._object_view, self._free_object,
                    progress=self.pull_manager.progress)
        self.server.register("ping", lambda ctx: "pong")
        self.server.register("register_owner", self._register_owner)
        self.server.register("stats", lambda ctx: self.stats())
        self.server.register("read_logs", self._handle_read_logs)
        self.server.register("dump_stacks", self._handle_dump_stacks)
        self.server.register("submit", self._handle_submit)
        self.server.register("submit_many", self._handle_submit_many)
        self.server.register("submit_batch", self._handle_submit_batch)
        self.server.register("kill_actor", self._handle_kill_actor)
        self.server.register("cancel_actor_task",
                             self._handle_cancel_actor_task)
        self.server.register("cancel_task", self._handle_cancel_task)
        self.server.register("adjust_pool", self._handle_adjust_pool)
        self.server.register("shutdown", lambda ctx: self._request_shutdown())
        self.server.on_disconnect(self._on_conn_disconnect)
        self.rpc_methods = self.server.registered_methods  # introspection hook

        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="rtpu-raylet-disp")
        self._io_thread = threading.Thread(
            target=self._io_loop, daemon=True, name="rtpu-raylet-io")
        self._dispatch_thread.start()
        self._io_thread.start()
        if cfg.memory_watchdog_threshold > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name="rtpu-raylet-watchdog")
            self._watchdog_thread.start()

        self.gcs: Optional[GcsClient] = None
        if gcs_addr is not None:
            self.gcs = GcsClient(gcs_addr)
            # A severed/restarted GCS connection re-registers this node
            # the moment the channel is restored: a restarted GCS (or
            # one that declared us dead during the gap) relearns the
            # node and its health-check address without waiting for an
            # operator (reference: raylet re-registration on GCS
            # restart).
            self.gcs.on_reconnect = self._re_register_with_gcs
            self._re_register_with_gcs()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True, name="rtpu-raylet-hb")
            self._hb_thread.start()

    # -- object manager ------------------------------------------------

    def _object_view(self, oid_bytes: bytes):
        return self.shm_store.get_local(ObjectID(oid_bytes))

    def _free_object(self, oid_bytes: bytes) -> None:
        self.shm_store.free(ObjectID(oid_bytes))

    # -- owner channel -------------------------------------------------

    _UNDELIVERED_CAP = 10_000

    def _register_owner(self, ctx: ConnectionContext,
                        owner_id: Optional[str] = None) -> str:
        """Bind the owner channel. A RE-registration (the same owner's
        retrying client reconnected — ``owner_id`` is the driver's
        stable identity) adopts the routing state stranded on its OWN
        dead predecessor connections and replays pushes that found no
        live channel during the gap — a survived sever costs nothing
        but latency. Other drivers' dead connections keep their purge
        schedule: one owner's reconnect must not cancel another's
        teardown or steal its completions."""
        ctx.meta["owner_id"] = owner_id
        with self._lock:
            # Gate BEFORE the ctx becomes reachable: pushes racing the
            # replay must queue behind the backlog, not overtake it.
            if self._undelivered:
                self._replaying = True
        with self._owner_lock:
            self._owner_ctx = ctx
        with self._lock:
            for tid, c in list(self._task_ctx.items()):
                if (c is not ctx and not c.alive
                        and c.meta.get("owner_id") == owner_id):
                    self._task_ctx[tid] = ctx
            for aid, c in list(self._actor_ctx.items()):
                if (c is not ctx and not c.alive
                        and c.meta.get("owner_id") == owner_id):
                    self._actor_ctx[aid] = ctx
            for c in [c for c in self._dead_ctxs
                      if c.meta.get("owner_id") == owner_id]:
                self._dead_ctxs.pop(c, None)
        self._drain_undelivered(ctx)
        return "ok"

    def _drain_undelivered(self, target: ConnectionContext) -> None:
        """Replay buffered pushes to ``target``, re-buffering the
        remainder if it dies mid-drain. Loops until the buffer is
        empty so an append racing a concurrent drain is picked up
        (the _replaying gate routes concurrent pushes into the buffer,
        keeping per-task delivery order). A stale completion reaching
        the wrong driver is a no-op there (unknown task ids are
        discarded on the owner side)."""
        while True:
            with self._lock:
                if not self._undelivered:
                    self._replaying = False
                    return
                batch, self._undelivered = self._undelivered, []
            for i, (topic, payload) in enumerate(batch):
                if not target.push(topic, payload):
                    with self._lock:
                        self._undelivered = (batch[i:]
                                             + self._undelivered)
                        # target died: direct pushes will fail too, so
                        # buffering order is preserved without the gate
                        self._replaying = False
                    return

    def _push_owner(self, topic: str, payload,
                    ctx: Optional[ConnectionContext] = None) -> None:
        """Push to the submitting connection when known (``ctx``),
        falling back to the registered owner channel; with neither
        live, buffer for replay at the owner's re-registration (its
        retrying channel may be mid-reconnect)."""
        with self._lock:
            if self._replaying \
                    and len(self._undelivered) < self._UNDELIVERED_CAP:
                # registration replay in flight: queue behind the
                # backlog so stream items keep their delivery order
                self._undelivered.append((topic, payload))
                return
        if ctx is not None and ctx.push(topic, payload):
            return
        with self._owner_lock:
            owner = self._owner_ctx
        if owner is not None and owner is not ctx \
                and owner.push(topic, payload):
            return
        with self._lock:
            buffered = len(self._undelivered) < self._UNDELIVERED_CAP
            if buffered:
                self._undelivered.append((topic, payload))
        if not buffered:
            logger.warning("owner channel gone and replay buffer "
                           "full; dropping %s", topic)
            return
        # Close the race with a concurrent register_owner: if a live
        # owner appeared between our check and the append, its drain
        # may have missed the entry — drain to it now. Otherwise the
        # entry waits for the next registration.
        with self._owner_lock:
            now_owner = self._owner_ctx
        if now_owner is not None and now_owner.alive:
            self._drain_undelivered(now_owner)

    # -- completion-push coalescing (docs/data_plane.md) ----------------

    def _push_owner_buffered(self, topic: str, payload,
                             ctx: Optional[ConnectionContext] = None
                             ) -> None:
        """Ordered owner-push entry point for EVERY topic. task_done
        pushes coalesce into task_done_many frames; everything else
        flushes the buffer first and ships alone — the owner observes
        exactly the raylet's push order, so the PR-2 replay contract
        (exactly-once, per-caller order) and the PR-5 commit-after-
        completions ordering survive batching unchanged."""
        if self._push_coalesce_s <= 0:
            self._push_owner(topic, payload, ctx=ctx)
            return
        if topic != "task_done":
            # Order fence: ship the buffered completions AND this
            # topic as one serialized sequence — a concurrent drain
            # must not leave this push overtaking completions it must
            # trail (PR-5: commits never outrun their results).
            with self._push_order_lock:
                self._flush_pushes_locked()
                self._push_owner(topic, payload, ctx=ctx)
            return
        now = time.monotonic()
        direct = False
        with self._push_lock:
            if (not self._push_buf
                    and now - self._last_push_ts > self._push_coalesce_s):
                direct = True       # idle stream: don't tax latency
            else:
                self._push_buf.append((payload, ctx))
                depth = len(self._push_buf)
            self._last_push_ts = now
        if direct:
            # the order lock covers the (buffer-was-empty, send) pair:
            # a drain racing in between could otherwise ship LATER
            # buffered completions ahead of this one
            with self._push_order_lock:
                self._push_stats.record(1)
                self._push_owner("task_done", payload, ctx=ctx)
        elif depth >= self._push_coalesce_max:
            self._flush_pushes()
        elif depth == 1:
            self._push_armed.set()

    def _flush_pushes(self) -> None:
        with self._push_order_lock:
            self._flush_pushes_locked()

    def _flush_pushes_locked(self) -> None:  # lock-held: _push_order_lock
        with self._push_lock:
            if not self._push_buf:
                return
            items = list(self._push_buf)
            self._push_buf.clear()
        # group ADJACENT same-connection runs: order within the buffer
        # is exactly completion order and must survive the grouping
        i = 0
        while i < len(items):
            ctx = items[i][1]
            j = i
            while j < len(items) and items[j][1] is ctx:
                j += 1
            run = [p for p, _c in items[i:j]]
            self._push_stats.record(len(run))
            if len(run) == 1:
                self._push_owner("task_done", run[0], ctx=ctx)
            else:
                self._push_owner("task_done_many", run, ctx=ctx)
            i = j

    def _push_flush_loop(self) -> None:
        # no-deadline: daemon flusher; each pass blocks on the arm
        # event, then bounds buffered completions' age by one window
        while not self._shutdown.is_set():
            if not self._push_armed.wait(timeout=0.5):
                continue
            self._push_armed.clear()
            time.sleep(self._push_coalesce_s)
            try:
                self._flush_pushes()
            except Exception:
                logger.exception("completion push flush failed")

    def _ctx_for_task(self, task_id: bytes, pop: bool = False
                      ) -> Optional[ConnectionContext]:
        with self._lock:
            if pop:
                return self._task_ctx.pop(task_id, None)
            return self._task_ctx.get(task_id)

    def _on_conn_disconnect(self, ctx: ConnectionContext) -> None:
        """A driver's channel closed — but its retrying client may be
        mid-reconnect, so teardown is DEFERRED by a grace period (the
        owner's reconnect window plus slack). If register_owner
        arrives first, the new connection adopts this one's routing
        state and nothing is lost; only an expired grace purges."""
        with self._owner_lock:
            if self._owner_ctx is ctx:
                self._owner_ctx = None
        grace = get_config().raylet_channel_reconnect_ms / 1000.0 + 2.0
        with self._lock:
            self._dead_ctxs[ctx] = time.monotonic() + grace
        self._wake.set()

    def _sweep_dead_ctxs(self) -> None:
        """Purge disconnected channels whose reconnect grace expired
        (runs on the dispatch loop's tick)."""
        now = time.monotonic()
        with self._lock:
            expired = [c for c, deadline in self._dead_ctxs.items()
                       if deadline <= now]
            for c in expired:
                self._dead_ctxs.pop(c, None)
        for ctx in expired:
            self._purge_disconnected(ctx)

    def _purge_disconnected(self, ctx: ConnectionContext) -> None:
        """The owner really is gone: reap its non-detached actors
        (nothing will ever call them again); keep detached ones.
        Routing state a re-registered owner already adopted no longer
        points at ``ctx`` and is naturally spared."""
        doomed: List[bytes] = []
        with self._lock:
            for tid in [t for t, c in self._task_ctx.items() if c is ctx]:
                self._task_ctx.pop(tid, None)
            for aid in [a for a, c in self._actor_ctx.items() if c is ctx]:
                self._actor_ctx.pop(aid, None)
                if aid in self._detached:
                    continue
                if aid in self._actor_workers:
                    doomed.append(aid)
                    continue
                # Creation not finished: either mid-execution
                # (_creation_tasks) or still queued for dispatch. Purge
                # queued payloads outright; anything already executing
                # reaps at actor_ready via the orphan mark.
                purged = False
                for payload in list(self._dispatch_queue):
                    if (payload.get("type") == "create_actor"
                            and payload.get("actor_id") == aid):
                        self._dispatch_queue.remove(payload)
                        purged = True
                if not purged:
                    self._orphaned_creations.add(aid)
        for aid in doomed:
            logger.info("reaping actor %s: owner disconnected",
                        aid.hex()[:8])
            self._reap_actor(aid, "owner disconnected")

    def _forget_actor(self, actor_id: bytes, cause: str) -> None:
        """Shared detached-death bookkeeping: drop the ctx/detached
        marks and, for detached actors, record the death in the GCS —
        the creating driver may be long gone, so this raylet is the one
        observer."""
        with self._lock:
            self._actor_ctx.pop(actor_id, None)
            was_detached = actor_id in self._detached
            self._detached.discard(actor_id)
        if was_detached and self.gcs is not None:
            try:
                self.gcs.update_actor_state(
                    ActorID(actor_id), "DEAD", death_cause=cause)
            except Exception:
                pass    # GCS unreachable: health checks converge it

    def _reap_actor(self, actor_id: bytes, cause: str) -> None:
        with self._lock:
            worker = self._actor_workers.pop(actor_id, None)
            self._actor_demand.pop(actor_id, None)
        if worker is not None:
            try:
                worker.send(("shutdown",))
            except Exception:
                pass    # pipe broken: the kill below still lands
            worker.kill()
            self.worker_pool.remove_worker(worker)
        self._forget_actor(actor_id, cause)

    # -- lease / submit path -------------------------------------------

    def _handle_submit(self, ctx: ConnectionContext, payload: dict) -> str:
        """Admit a task payload. Returns "ok", or "refused" (spillback:
        the demand can never fit this node); a full intake queue sheds
        the submit with a typed BackpressureError instead (the RPC
        layer ships it as a RESOURCE_EXHAUSTED frame)."""
        status = self._admit_payload(ctx, payload)
        if status == "shed":
            raise self._backpressure_error()
        if status == "ok":
            self._wake.set()
        return status

    def _handle_submit_many(self, ctx: ConnectionContext,
                            payloads: list) -> list:
        """Admit N task payloads in ONE lease round trip (the owner
        coalesces per-raylet); per-payload statuses keep spillback
        refusals — and backpressure sheds — per-task. Sheds travel as
        ("shed", backoff_s) so the depth-scaled backoff suggestion
        reaches the owner on the batched path too, not just the
        single-submit error frame."""
        statuses = [self._admit_payload(ctx, p) for p in payloads]
        if any(s == "ok" for s in statuses):
            self._wake.set()
        if any(s == "shed" for s in statuses):
            hint = self._backpressure_error().backoff_s
            statuses = [("shed", hint) if s == "shed" else s
                        for s in statuses]
        return statuses

    def _backpressure_error(self) -> "BackpressureError":
        from ray_tpu_torch.exceptions import BackpressureError
        with self._lock:
            depth = len(self._dispatch_queue)
        base = get_config().backpressure_retry_base_ms / 1000.0
        return BackpressureError(
            f"raylet {self.node_id.hex()[:8]} intake full "
            f"({depth} queued >= {self._max_queued}); retry later",
            retryable=True,
            # Suggested backoff: 2x the base at a full queue (growing
            # toward 4x if the queue ever runs past the bound), so the
            # suggestion genuinely EXCEEDS the owner's own first-shed
            # schedule (which starts at base) and the wins-when-larger
            # branch is reachable.
            backoff_s=base * min(4.0, 2.0 * depth
                                 / max(1, self._max_queued)))

    def _admit_payload(self, ctx: ConnectionContext, payload: dict) -> str:
        # Cache the function blob BEFORE the admission check: within a
        # submit_many frame only the first payload of a function
        # carries the blob, and refusing that one must not strand its
        # admitted blob-less siblings on an unknown function.
        blob = payload.pop("function_blob", None)
        if blob is not None:
            self._functions[payload["function_id"]] = blob
        demand = payload.get("resources") or {}
        for name, need in demand.items():
            if need > self.resources_total.get(name, 0.0) + 1e-9:
                return "refused"
        with self._lock:
            # Bounded intake (reference: backpressured task submission):
            # beyond the bound, shed instead of queuing forever. Shed
            # BEFORE any routing state is recorded — the owner re-sends
            # the payload whole after its backoff.
            if (self._max_queued > 0
                    and len(self._dispatch_queue) >= self._max_queued):
                self.num_shed += 1
                return "shed"
            self._task_ctx[payload["task_id"]] = ctx
            if payload["type"] == "create_actor":
                aid = payload["actor_id"]
                self._actor_ctx[aid] = ctx
                if payload.pop("detached", False):
                    self._detached.add(aid)
            self._dispatch_queue.append(payload)
        return "ok"

    def _handle_submit_batch(self, ctx: ConnectionContext,
                             payloads: list) -> str:
        """Admit N ordered actor-call payloads in one RPC round trip
        (the remote-actor leg of the batched wire path). Actor calls
        ride the actor's standing allocation, so no admission check."""
        blob_updates = {}
        for payload in payloads:
            blob = payload.pop("function_blob", None)
            if blob is not None:
                blob_updates[payload["function_id"]] = blob
        if blob_updates:
            self._functions.update(blob_updates)
        with self._lock:
            for payload in payloads:
                self._task_ctx[payload["task_id"]] = ctx
            self._dispatch_queue.extend(payloads)
        self._wake.set()
        return "ok"

    def _handle_cancel_task(self, ctx: ConnectionContext,
                            task_id: bytes, force: bool = False) -> None:
        """Owner-directed cancellation: dequeue if still pending here,
        else SIGINT (or kill, with force) the executing worker. The
        owner already marked the task cancelled, so whatever failure
        this produces surfaces there as TaskCancelledError."""
        import signal as _signal
        with self._lock:
            for payload in list(self._dispatch_queue):
                if payload.get("task_id") == task_id:
                    self._dispatch_queue.remove(payload)
                    queued = True
                    break
            else:
                queued = False
            worker = self._running.get(task_id)
        if queued:
            self._push_owner_buffered("task_done", {
                "task_id": task_id, "results": [], "error_blob": None,
                "system_error": "cancelled by owner"},
                ctx=self._ctx_for_task(task_id, pop=True))
            return
        if worker is None:
            return
        pid = getattr(getattr(worker, "proc", None), "pid", None)
        if pid is None:
            return      # in-process thread: uninterruptible (killing
                        # the pool worker would not stop the task)
        try:
            if force:
                worker.kill()
                # kill() closed the worker's connection and marked it
                # dead, so the IO loop may never see its EOF: run the
                # death path here (a second run finds nothing to do)
                self._on_worker_death(worker)
            else:
                from ray_tpu_torch._private.worker_process import (
                    write_cancel_target)
                write_cancel_target(self.session, pid, task_id)
                os.kill(pid, _signal.SIGINT)
        except Exception:
            pass    # worker exited first: cancellation is moot

    def _handle_kill_actor(self, ctx: ConnectionContext,
                           actor_id: bytes) -> None:
        self._reap_actor(actor_id, "killed")

    def _handle_cancel_actor_task(self, ctx: ConnectionContext,
                                  actor_id: bytes,
                                  task_id: bytes) -> None:
        """Forward an async-actor call cancellation to the actor's
        worker pipe (handled at the worker's intake thread)."""
        with self._lock:
            worker = self._actor_workers.get(actor_id)
        if worker is not None:
            try:
                worker.send(("cancel_actor_task", actor_id, task_id))
            except Exception:
                pass    # actor worker died: the call dies with it

    def _handle_dump_stacks(self, ctx) -> dict:
        """On-demand host profiling (reference: the dashboard
        reporter's py-spy endpoint): live Python stacks for this raylet
        process and every process worker it manages."""
        from ray_tpu_torch._private.profiling import (dump_all_stacks,
                                                gather_pool_stacks)
        out = {"raylet": dump_all_stacks()}
        out.update(gather_pool_stacks(self.worker_pool))
        return out

    def _handle_read_logs(self, ctx, cursor):
        """Per-node agent log plane: incremental tail over this node's
        worker stdout/stderr files (the driver's log monitor and the
        ``logs --follow`` CLI poll this)."""
        from ray_tpu_torch._private.log_monitor import (read_new_log_bytes,
                                                  session_log_dir)
        return read_new_log_bytes(session_log_dir(self.session), cursor)

    def _handle_adjust_pool(self, ctx, delta: int) -> None:
        """Owner-directed worker-slot adjustment: a parent task blocked
        in a nested get() lends its node one extra slot."""
        with self._lock:
            self.worker_pool._max_process += delta
        self._wake.set()

    def _wake_dispatch(self) -> None:
        self._wake.set()

    def _unused_inproc_reply(self, worker, reply) -> None:
        # Remote raylets never host in-process (GPU) workers: the head
        # driver owns the cards, and this process sees none.
        self._handle_worker_reply(worker, reply)

    def _dispatch_loop(self) -> None:
        while not self._shutdown.is_set():
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            try:
                self._sweep_dead_ctxs()
                self._dispatch_all()
            except Exception:
                logger.exception("raylet dispatch error")

    def _dispatch_all(self) -> None:
        while True:
            with self._lock:
                if not self._dispatch_queue:
                    return
                payload = self._dispatch_queue.popleft()
            if payload["type"] == "exec_actor":
                self._dispatch_actor_task(payload)
                continue
            dedicated = payload["type"] == "create_actor"
            env_tag = python_exe = None
            pip_spec = (payload.get("runtime_env") or {}).get("pip")
            if pip_spec is not None:
                from ray_tpu_torch._private.pip_env import resolve_for_dispatch
                status, env_tag, python_exe = resolve_for_dispatch(
                    self._pip_envs, pip_spec, payload.get("resources"),
                    self.worker_pool.substrate_for,
                    lambda err, p=payload: self._fail_payload(p, err),
                    park_item=payload)
                if status != "go":
                    continue
            worker = self.worker_pool.pop_worker(
                payload.get("resources") or {"CPU": 1}, dedicated,
                env_tag=env_tag, python_exe=python_exe)
            if worker is None:
                with self._lock:
                    self._dispatch_queue.appendleft(payload)
                return
            self._run_on_worker(worker, payload)

    def _on_pip_env_requeue(self, parked: list) -> None:
        with self._lock:
            self._dispatch_queue.extend(parked)
        self._wake.set()

    def _fail_payload(self, payload: dict, err: Exception) -> None:
        """Complete a payload with an APP-level error (no retry)."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.exceptions import TaskError
        blob = serialization.get_context().serialize(
            TaskError(err, payload.get("name", "?"), str(err))).to_bytes()
        self._push_owner_buffered("task_done", {
            "task_id": payload["task_id"], "results": [],
            "error_blob": blob, "system_error": None},
            ctx=self._ctx_for_task(payload["task_id"], pop=True))

    def _dispatch_actor_task(self, payload: dict) -> None:
        actor_id = payload["actor_id"]
        with self._lock:
            worker = self._actor_workers.get(actor_id)
        if worker is None or not worker.alive:
            self._push_owner_buffered("task_done", {
                "task_id": payload["task_id"], "results": [],
                "error_blob": None, "system_error": "actor worker dead"},
                ctx=self._ctx_for_task(payload["task_id"], pop=True))
            return
        self._run_on_worker(worker, payload, actor=True)

    def _run_on_worker(self, worker: BaseWorker, payload: dict,
                       actor: bool = False) -> None:
        try:
            self._localize_args(payload)
        except ObjectTransferError as e:
            if not actor:
                self.worker_pool.push_worker(worker)
            self._push_owner_buffered("task_done", {
                "task_id": payload["task_id"], "results": [],
                "error_blob": None, "system_error": f"lost argument: {e}",
                "lost_arg": getattr(e, "oid_bytes", None)},
                ctx=self._ctx_for_task(payload["task_id"], pop=True))
            return
        fid = payload["function_id"]
        try:
            self.worker_pool.ensure_function(
                worker, fid, lambda: self._functions[fid])
            with self._lock:
                self._running[payload["task_id"]] = worker
                self._running_meta[payload["task_id"]] = {
                    "retryable": bool(payload.get("retryable", True)),
                    "name": payload.get("name", "?")}
                if payload["type"] != "exec_actor":
                    # actor METHOD calls ride the actor's standing
                    # allocation; exec/create_actor consume capacity
                    self._running_demand[payload["task_id"]] = dict(
                        payload.get("resources") or {})
                if payload["type"] == "create_actor":
                    self._creation_tasks[payload["actor_id"]] = \
                        payload["task_id"]
            worker.send((payload["type"], payload))
        except Exception as e:
            with self._lock:
                self._running.pop(payload["task_id"], None)
                self._running_meta.pop(payload["task_id"], None)
            if not actor:
                self.worker_pool.push_worker(worker)
            self._push_owner_buffered("task_done", {
                "task_id": payload["task_id"], "results": [],
                "error_blob": None,
                "system_error": f"worker send failed: {e}"},
                ctx=self._ctx_for_task(payload["task_id"], pop=True))

    def _localize_args(self, payload: dict) -> None:
        """Rewrite ("pull", oid, sources, size) arg descriptors into
        local ("shm", ...) ones, fetching missing objects through the
        PullManager: concurrent tasks needing the same object share ONE
        wire fetch, chunk calls are deadline-budgeted, and a dead
        source re-routes to the next holder (falling back to the
        owner's location table via ``owner_addr``). Raises only the
        typed ObjectTransferError taxonomy."""
        args = payload["args"]
        owner_addr = payload.get("owner_addr")
        for i, desc in enumerate(args):
            if desc[0] != "pull":
                continue
            _, oid_bytes, sources, size = desc
            oid = ObjectID(oid_bytes)
            if self.pull_manager.pull(oid_bytes, size, sources,
                                      owner_addr=owner_addr):
                self.num_pulled += 1
            info = self.shm_store.segment_for(oid)
            if info is None:
                err = ObjectTransferError(
                    f"object {oid} evicted during localization",
                    object_id_hex=oid.hex())
                err.oid_bytes = oid_bytes
                raise err
            args[i] = ("shm", oid_bytes, info[0], info[1])

    # -- worker replies ------------------------------------------------

    def _io_loop(self) -> None:
        from multiprocessing.connection import wait as conn_wait
        # no-deadline: daemon service loop, exits via _shutdown; each
        # pass blocks at most 0.1s in conn_wait / 0.01s in the idle sleep
        while not self._shutdown.is_set():
            conns = self.worker_pool.process_connections()
            if not conns:
                time.sleep(0.01)
                continue
            for c in conn_wait(conns, timeout=0.1):
                worker = self.worker_pool.worker_by_conn(c)
                if worker is None:
                    continue
                try:
                    msg = c.recv()
                except (EOFError, OSError):
                    try:
                        self._on_worker_death(worker)
                    except Exception:
                        logger.exception("worker-death handling failed")
                    continue
                try:
                    if msg[0] == "ready":
                        worker.ready = True
                    elif msg[0] == "pong":
                        pass
                    else:
                        self._handle_worker_reply(worker, msg)
                except Exception:
                    logger.exception("worker reply handling failed")

    def _handle_worker_reply(self, worker: BaseWorker, reply: tuple) -> None:
        op = reply[0]
        if op == "batch":
            # coalesced completions from a batched/async actor worker
            for r in reply[1]:
                self._handle_worker_reply(worker, r)
            return
        if op == "stacks":
            from ray_tpu_torch._private.profiling import deliver_stack_reply
            deliver_stack_reply(worker, reply[1])
            return
        if op == "stream":
            # streaming generator item: seal big items locally, relay
            # the (location) descriptors to the owner
            _, task_id, results = reply
            shipped = []
            for oid_b, kind, data, contained in results:
                if kind == "shm":
                    name, size = data
                    try:
                        self.shm_store.adopt(ObjectID(oid_b), size)
                    except FileNotFoundError:
                        logger.warning("stream segment vanished: %s", name)
                    shipped.append((oid_b, "remote", size, contained))
                else:
                    shipped.append((oid_b, kind, data, contained))
            self._push_owner_buffered("task_stream", {"task_id": task_id,
                                             "results": shipped},
                             ctx=self._ctx_for_task(task_id))
            return
        if op == "done":
            _, task_id, results, err_blob = reply[:4]
            timings = reply[4] if len(reply) > 4 else None
            with self._lock:
                self._running.pop(task_id, None)
                self._running_meta.pop(task_id, None)
                self._running_demand.pop(task_id, None)
                self._oom_victims.pop(task_id, None)  # finished first
            if not worker.is_actor_worker:
                self.worker_pool.push_worker(worker)
            # Seal big results into the node store; ship locations.
            shipped = []
            for oid_b, kind, data, contained in results:
                if kind == "shm":
                    name, size = data
                    try:
                        self.shm_store.adopt(ObjectID(oid_b), size)
                    except FileNotFoundError:
                        logger.warning("result segment vanished: %s",
                                       name)
                    shipped.append((oid_b, "remote", size, contained))
                else:
                    shipped.append((oid_b, kind, data, contained))
            self._push_owner_buffered("task_done", {
                "task_id": task_id, "results": shipped,
                "error_blob": err_blob, "system_error": None,
                "timings": timings},
                ctx=self._ctx_for_task(task_id, pop=True))
        elif op == "ckpt_saved":
            # relay a saved checkpoint generation to the owner (the
            # commit decision lives driver-side; ordering after this
            # actor's task_done pushes holds — same channel)
            _, actor_id, info = reply
            with self._lock:
                ckpt_ctx = self._actor_ctx.get(actor_id)
            self._push_owner_buffered(
                "actor_ckpt", {"actor_id": actor_id, "info": info},
                ctx=ckpt_ctx)
        elif op == "actor_ready":
            _, actor_id, err_blob = reply[:3]
            restore = reply[3] if len(reply) > 3 else None
            with self._lock:
                tid = self._creation_tasks.pop(actor_id, None)
                demand = {}
                if tid is not None:
                    self._running.pop(tid, None)
                    self._running_meta.pop(tid, None)
                    # the creation demand becomes the actor's standing
                    # allocation for its lifetime
                    demand = self._running_demand.pop(tid, {})
                orphaned = actor_id in self._orphaned_creations
                self._orphaned_creations.discard(actor_id)
                creation_ctx = self._actor_ctx.get(actor_id)
            if err_blob is None and not orphaned:
                with self._lock:
                    self._actor_workers[actor_id] = worker
                    if demand:
                        self._actor_demand[actor_id] = demand
            else:
                self.worker_pool.remove_worker(worker)
                try:
                    worker.send(("shutdown",))
                except Exception:
                    pass    # pipe broken: worker is already dying
                if orphaned:
                    return   # nobody left to tell
            self._push_owner_buffered("actor_ready", {
                "actor_id": actor_id, "error_blob": err_blob,
                "restore": restore},
                ctx=(self._ctx_for_task(tid, pop=True)
                     if tid is not None else creation_ctx))

    def _on_worker_death(self, worker: BaseWorker) -> None:
        self.worker_pool.remove_worker(worker)
        worker.kill()
        dead_tasks: List[bytes] = []
        dead_actors: List[bytes] = []
        oom: Dict[bytes, bool] = {}
        with self._lock:
            for tid, w in list(self._running.items()):
                if w is worker:
                    dead_tasks.append(tid)
                    self._running.pop(tid)
                    self._running_meta.pop(tid, None)
                    self._running_demand.pop(tid, None)
                    if tid in self._oom_victims:
                        oom[tid] = self._oom_victims.pop(tid)
            for aid, w in list(self._actor_workers.items()):
                if w is worker:
                    dead_actors.append(aid)
                    self._actor_workers.pop(aid)
                    self._actor_demand.pop(aid, None)
        for tid in dead_tasks:
            if tid in oom:
                # Killed by the memory watchdog: ship the typed marker
                # so the owner routes it through the OOM retry budget
                # (or surfaces OutOfMemoryError for non-retryable work).
                self._push_owner_buffered("task_done", {
                    "task_id": tid, "results": [], "error_blob": None,
                    "system_error": "task killed by the node memory "
                                    "watchdog (memory pressure)",
                    "oom": True, "oom_retryable": oom[tid]},
                    ctx=self._ctx_for_task(tid, pop=True))
                continue
            self._push_owner_buffered("task_done", {
                "task_id": tid, "results": [], "error_blob": None,
                "system_error": "worker process died while executing task"},
                ctx=self._ctx_for_task(tid, pop=True))
        for aid in dead_actors:
            with self._lock:
                creation_ctx = self._actor_ctx.get(aid)
            self._forget_actor(aid, "worker process died")
            self._push_owner_buffered("actor_died", {"actor_id": aid},
                             ctx=creation_ctx)
        self._wake.set()

    # -- gcs heartbeat -------------------------------------------------

    def _re_register_with_gcs(self) -> None:
        """(Re-)announce this node to the GCS; runs at startup and
        after every restored GCS connection."""
        self.gcs.register_node(
            NodeInfo(node_id=self.node_id,
                     resources_total=dict(self.resources_total),
                     labels=self.labels),
            rpc_addr=self.address)

    def available_resources(self) -> Dict[str, float]:
        """Actual free capacity: total minus what running tasks and
        resident actors nominally demand (the reference raylet's
        LocalResourceManager view)."""
        avail = dict(self.resources_total)
        with self._lock:
            demands = list(self._running_demand.values()) + list(
                self._actor_demand.values())
        for demand in demands:
            for k, v in demand.items():
                avail[k] = avail.get(k, 0.0) - v
        return {k: max(0.0, v) for k, v in avail.items()}

    def _heartbeat_loop(self) -> None:
        cfg = get_config()
        period = cfg.health_check_period_ms / 1000.0
        while not self._shutdown.wait(period):
            try:
                self.gcs.report_resources(self.node_id,
                                          self.available_resources(),
                                          stats=self._metric_stats())
            except Exception:
                pass    # transient GCS outage: next beat retries

    def _metric_stats(self) -> dict:
        """Small per-node stats dict shipped with each heartbeat; the
        driver exports these as per-node Prometheus series. The
        ``worker_rss`` sub-dict becomes the per-worker RSS series and
        the dashboard nodes table's memory column (reporter-agent
        role)."""
        from ray_tpu_torch._private import wire_stats
        from ray_tpu_torch._private.profiling import worker_rss_map
        store = self.shm_store.stats()
        rss = worker_rss_map(self.worker_pool)
        # Wire-plane observability (docs/data_plane.md): this raylet
        # process's channel counters (completion pushes, rpc frames)
        # plus the idempotency dedupe hit rate — the driver folds the
        # "wire" sub-dict into ray_tpu_rpc_batch_size{channel} /
        # ray_tpu_rpc_fastframe_hits and exports the scalars as
        # per-node ray_tpu_node_stat series.
        idem = self.server.idem_calls
        with self._lock:
            return {
                "queued_tasks": len(self._dispatch_queue),
                "running_tasks": len(self._running),
                "actors": len(self._actor_workers),
                "objects_pulled": self.num_pulled,
                "shed_tasks": self.num_shed,
                "oom_kills": self.num_oom_kills,
                "store_used_bytes": store["used_bytes"],
                "store_num_objects": store["num_objects"],
                "workers": self.worker_pool.stats()["total"],
                "workers_rss_bytes": sum(rss.values()),
                "worker_rss": rss,
                "dedupe_hits": self.server.dedupe_hits,
                "dedupe_calls": idem,
                "dedupe_hit_rate": (self.server.dedupe_hits / idem
                                    if idem else 0.0),
                "wire": wire_stats.snapshot(),
                # Pull-plane state counters: the driver sums these
                # across nodes into ray_tpu_object_pulls{state}
                # (docs/object_plane.md).
                "pulls": pull_counters(),
            }

    # -- memory watchdog -----------------------------------------------

    @staticmethod
    def _meminfo_bytes() -> Tuple[int, int]:
        """(MemTotal, MemAvailable) from /proc/meminfo; (0, 0) when
        unreadable (non-linux)."""
        total = avail = 0
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = int(line.split()[1]) * 1024
                    elif line.startswith("MemAvailable:"):
                        avail = int(line.split()[1]) * 1024
        except (OSError, ValueError, IndexError):
            return 0, 0
        return total, avail

    def _memory_usage_fraction(self) -> float:
        """Observed node memory pressure.

        Host mode (``memory_watchdog_total_bytes`` unset): system
        truth — ``(MemTotal - MemAvailable) / MemTotal`` counts every
        consumer (process RSS, tmpfs-backed shm segments) exactly once,
        like the reference memory monitor.

        Explicit-total mode (containers, tests): this raylet's own
        footprint — process-tree RSS plus object-store bytes. Shm
        pages a live process has mapped appear in both terms, so this
        is an UPPER bound: the watchdog errs toward shedding a
        retryable task early rather than letting the node OOM.
        """
        from ray_tpu_torch._private.profiling import (process_rss_bytes,
                                                worker_rss_map)
        cfg = get_config()
        configured = cfg.memory_watchdog_total_bytes
        own = (process_rss_bytes()
               + sum(worker_rss_map(self.worker_pool).values())
               + self.shm_store.stats()["used_bytes"])
        if not configured:
            total, avail = self._meminfo_bytes()
            if total <= 0:
                return 0.0
            frac = (total - avail) / total
            if frac >= cfg.memory_watchdog_threshold \
                    and own < (1.0 - cfg.memory_watchdog_threshold) \
                    * total:
                # The host is under pressure but OUR footprint doesn't
                # even cover the threshold's slack: killing our tasks
                # cannot relieve it (external consumer) — serially
                # executing innocents would burn their OOM budgets for
                # nothing. Report healthy; the external hog is the
                # operator's problem.
                return 0.0
            return frac
        return own / configured

    def _watchdog_loop(self) -> None:
        """Reference analog: the raylet memory monitor — sample node
        memory each heartbeat; above the threshold, kill the largest
        retryable running task so the node survives and the task
        retries (a saturated node costs latency, never results)."""
        period = get_config().health_check_period_ms / 1000.0
        while not self._shutdown.wait(period):
            try:
                self._watchdog_tick()
            except Exception:
                logger.exception("memory watchdog tick failed")

    def _watchdog_tick(self) -> None:
        from ray_tpu_torch._private import chaos
        from ray_tpu_torch._private.profiling import process_rss_bytes
        candidates = self._watchdog_candidates()
        if not candidates:
            # Nothing killable running: skip the sample (and the chaos
            # point — rules like `pressure=0.97@1` then deterministically
            # fire on the first sample at which a kill could matter).
            return
        frac = None
        if chaos._plane.armed:
            # The event method carries the candidate count
            # (`sampleN`): tests match `sample*` for any sample, or
            # `sample2` to inject pressure deterministically at the
            # first sample where exactly two victims are running.
            action, arg = chaos.fire_arg(
                "raylet", "watchdog", f"sample{len(candidates)}")
            if action == "pressure":
                frac = arg
        if frac is None:
            frac = self._memory_usage_fraction()
        if frac < get_config().memory_watchdog_threshold:
            return
        # Victim selection: retryable tasks strictly before
        # non-retryable ones; within a class, the largest worker RSS.
        # One victim per sample — the next sample re-measures before
        # deciding whether the node is still under pressure. RSS read
        # once per pid (it is also what the kill log reports — a read
        # after the SIGKILL would always say 0).
        rss = {c[3]: process_rss_bytes(c[3]) for c in candidates}
        candidates.sort(key=lambda c: (not c[0], -rss[c[3]]))
        retryable, tid, worker, pid = candidates[0]
        with self._lock:
            # Re-verify under the lock: the victim may have COMPLETED
            # during the RSS reads above, and its worker re-leased to
            # a fresh task — killing that would burn an innocent
            # task's crash budget (and leave a stale victim mark for a
            # reused task id). Skip; the next sample re-measures. The
            # same applies to a worker that CRASHED during selection —
            # its death handler must report a plain crash, not an OOM.
            if self._running.get(tid) is not worker \
                    or worker.proc.poll() is not None:
                return
            name = self._running_meta.get(tid, {}).get("name", "?")
            self._oom_victims[tid] = retryable
            self.num_oom_kills += 1
            # The kill itself stays under the lock: the done-handler
            # pops _running under this same lock, so check->mark->kill
            # is atomic against a completion racing in — once killed,
            # a late reply can no longer re-lease this worker to an
            # innocent task before the process dies.
            #
            # chaos-style exit path: the worker dies abruptly and the
            # normal worker-death machinery completes the task (with
            # the OOM marker recorded above). Killing the whole
            # process kills ONLY the victim: this raylet leases one
            # task per process worker at a time (no lease pipelining
            # on the remote path), and actor workers are never
            # candidates.
            worker.kill()
            try:
                # SIGKILL on top of the pool teardown's terminate():
                # an OOM victim must not be able to trap or defer its
                # death (a surviving hog would push the watchdog into
                # serially killing every innocent task instead).
                worker.proc.kill()
            except Exception:
                pass    # already exited
        # kill() closed the victim's connection and marked it dead, so
        # the IO loop (which watches live workers only) may never see
        # its EOF: complete the task here, with the OOM marker above. A
        # death the IO loop handled first already popped the task.
        self._on_worker_death(worker)
        logger.warning(
            "memory watchdog: node at %.2f usage (threshold %.2f); "
            "killed %s task %s (%s, rss=%d)",
            frac, get_config().memory_watchdog_threshold,
            "retryable" if retryable else "non-retryable",
            tid.hex()[:8], name, rss[pid])

    def _watchdog_candidates(self):
        """[(retryable, task_id, worker, pid)] for running tasks the
        watchdog may kill: process workers only (in-process threads
        cannot be killed), never resident actors (their state is not
        re-creatable by a retry), never an already-marked victim."""
        out = []
        with self._lock:
            for tid, worker in self._running.items():
                if tid in self._oom_victims or not worker.alive \
                        or worker.is_actor_worker:
                    continue
                proc = getattr(worker, "proc", None)
                pid = getattr(proc, "pid", None)
                if pid is None:
                    continue
                if proc.poll() is not None:
                    # Already dead of natural causes: the death
                    # handler owns it — marking it here would charge a
                    # plain crash to the OOM budget.
                    continue
                meta = self._running_meta.get(tid, {})
                out.append((bool(meta.get("retryable", True)), tid,
                            worker, pid))
        return out

    # -- lifecycle -----------------------------------------------------

    def _request_shutdown(self) -> str:
        threading.Thread(target=self.shutdown, daemon=True).start()
        return "ok"

    def shutdown(self) -> None:
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        self.worker_pool.shutdown()
        self.server.shutdown()
        self._peers.close()
        self.shm_store.shutdown()
        self.hub.shutdown()
        if self.gcs is not None:
            self.gcs.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "node_id": self.node_id.hex(),
                "queued": len(self._dispatch_queue),
                "running": len(self._running),
                "actors": len(self._actor_workers),
                "num_pulled": self.num_pulled,
                "num_shed": self.num_shed,
                "num_oom_kills": self.num_oom_kills,
                "available": self.available_resources(),
                "store": self.shm_store.stats(),
                "workers": self.worker_pool.stats(),
            }


# ---------------------------------------------------------------------------
# process entrypoint


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--session", required=True)
    p.add_argument("--node-id", required=True, help="hex node id")
    p.add_argument("--resources", required=True,
                   help="json dict of total resources")
    p.add_argument("--labels", default="{}")
    p.add_argument("--gcs", default="", help="host:port of the GCS")
    p.add_argument("--port-file", required=True)
    p.add_argument("--max-process-workers", type=int, default=2)
    p.add_argument("--object-store-memory", type=int, default=0)
    p.add_argument("--config", default="")
    args = p.parse_args(argv)

    import json
    if args.config:
        get_config().load_serialized(args.config)
    gcs_addr = None
    if args.gcs:
        host, port = args.gcs.rsplit(":", 1)
        gcs_addr = (host, int(port))
    raylet = RayletServer(
        session=args.session,
        node_id=NodeID.from_hex(args.node_id),
        resources_total=json.loads(args.resources),
        gcs_addr=gcs_addr,
        max_process_workers=args.max_process_workers,
        object_store_memory=args.object_store_memory or None,
        labels=json.loads(args.labels))
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{raylet.address[0]}:{raylet.address[1]}")
    os.rename(tmp, args.port_file)
    try:
        while not raylet._shutdown.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        raylet.shutdown()


def spawn_raylet_process(session: str, node_id: NodeID,
                         resources_total: Dict[str, float],
                         gcs_addr: Optional[Tuple[str, int]] = None,
                         max_process_workers: int = 2,
                         labels: Optional[Dict[str, str]] = None,
                         object_store_memory: int = 0):
    """Spawn a raylet as a separate process; returns (proc, addr)."""
    import json
    import subprocess
    d = session_dir(session)
    os.makedirs(d, exist_ok=True)
    port_file = os.path.join(d, f"raylet_{node_id.hex()[:12]}.addr")
    if os.path.exists(port_file):
        os.unlink(port_file)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    env["CUDA_VISIBLE_DEVICES"] = ""   # remote raylets never own a card
    cmd = [sys.executable, "-m", "ray_tpu_torch._private.raylet_server",
           "--session", session, "--node-id", node_id.hex(),
           "--resources", json.dumps(resources_total),
           "--labels", json.dumps(labels or {}),
           "--port-file", port_file,
           "--max-process-workers", str(max_process_workers),
           "--object-store-memory", str(object_store_memory),
           "--config", get_config().serialize()]
    if gcs_addr is not None:
        cmd += ["--gcs", f"{gcs_addr[0]}:{gcs_addr[1]}"]
    # non-durable-ok: append-only child log stream; a torn tail line
    # costs log text, never state
    log = open(os.path.join(d, f"raylet_{node_id.hex()[:12]}.log"), "ab")
    proc = subprocess.Popen(cmd, env=env, start_new_session=True,
                            stdout=log, stderr=log)
    log.close()
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            host, port = open(port_file).read().strip().rsplit(":", 1)
            return proc, (host, int(port))
        if proc.poll() is not None:
            raise RuntimeError(
                f"raylet died on startup (rc={proc.returncode})")
        time.sleep(0.02)
    proc.terminate()
    raise TimeoutError("raylet did not write its address in time")


if __name__ == "__main__":
    main()
