"""Request router: dynamic batching + queue-aware power-of-two-choices.

Reference: ``python/ray/serve/_private/replica_scheduler/
pow_2_scheduler.py`` + ``router.py`` [UNVERIFIED — mount empty,
SURVEY.md §0]: sample two replicas, send to the one with the shorter
queue. Queue length here is the router-tracked in-flight count per
replica PLUS the depth each replica piggybacks on its batch replies
(other routers' load — proxies, composed handles — becomes visible
with no extra RPC).

Batched dispatch (docs/serve.md): requests to ``@serve.batch``
methods park in per-(method, model) gather queues; a flusher thread
coalesces up to ``max_batch_size`` of them into ONE replica call
(``handle_request_batch``) and fans the reply back onto per-request
promise refs reserved at ``assign`` time — callers hold ordinary
ObjectRefs throughout. A new batch forms while the previous executes
(continuous re-fill), and the dispatch frames ride the PR-7 coalesced
submit / task_done_many / fastframe wire path like any other actor
call. An envelope-level dispatch failure (replica death) retries the
whole batch ONCE on another replica, then fails each request typed —
every request resolves exactly once either way.

Backpressure: when a deployment's total queue (pending + in-flight +
admission waiters) exceeds ``max_queued_requests``, ``assign`` sheds
with the PR-3 retryable ``BackpressureError`` instead of queueing
unboundedly; the HTTP ingress maps it to 503 + Retry-After.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ray_tpu_torch._private import serve_stats
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.exceptions import (
    ActorError,
    BackpressureError,
    ObjectLostError,
    SystemOverloadError,
    WorkerCrashedError,
)
from ray_tpu_torch.serve._private.replica import _batch_defaults

logger = logging.getLogger(__name__)

# Envelope-level failures that prove the dispatch never produced a
# user-visible result on a live replica — the ONLY failures a whole
# batch may be re-executed for. Anything else (e.g. a TaskError from a
# result that wouldn't serialize AFTER user code ran) fails typed:
# retrying it would re-run side effects.
_RETRYABLE_DISPATCH_ERRORS = (ActorError, WorkerCrashedError,
                              ObjectLostError, SystemOverloadError,
                              ConnectionError)


class _PendingReq:
    """One request parked for batched dispatch. ``ref`` is the
    caller's promise ObjectRef — held here (same instance) until
    fulfilled so an early caller-side drop can't reap the entry the
    fan-out is about to store."""

    __slots__ = ("ref", "value", "zc", "enq_t", "retried", "avoid")

    def __init__(self, ref, value, zc, enq_t):
        self.ref = ref
        self.value = value
        self.zc = zc              # ObjectRef of a zero-copy-routed arg
        self.enq_t = enq_t
        self.retried = False
        self.avoid = None         # replica key of a failed dispatch


def _zero_copy_promote(value):
    """Large leaf payloads are put into the object store ONCE and
    routed by ref (docs/serve.md §Zero-copy): returns (placeholder,
    ref) or (value, None). Only exact bytes/bytearray/ndarray leaves
    are promoted — size is known without serializing."""
    from ray_tpu_torch._private.config import get_config
    threshold = get_config().serve_zero_copy_threshold_bytes
    if not threshold:
        return value, None
    size = None
    if type(value) in (bytes, bytearray):
        size = len(value)
    else:
        try:
            import numpy as np
            if type(value) is np.ndarray and value.dtype != object:
                size = value.nbytes
        except ImportError:      # pragma: no cover - numpy is baked in
            pass
    if size is None or size < threshold:
        return value, None
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.replica import _ZC
    return _ZC(0), ray_tpu_torch.put(value)


def _rebuild_replica_set(name: str, replicas: List, max_ongoing=None,
                         batch_cfg=None, max_queued=None) -> "ReplicaSet":
    rs = ReplicaSet(name)
    rs.set_replicas(replicas)
    rs.max_ongoing = max_ongoing
    rs.batch_cfg = dict(batch_cfg or {})
    rs.max_queued = max_queued
    # Pickled copies (proxy actors, composed handles inside replicas)
    # NEVER block in the router: their in-flight counts are local, so
    # the cap they could enforce is approximate anyway — and a blocking
    # wait inside an async replica would stall its whole event loop.
    # The HARD per-replica cap is the replica-side admission semaphore;
    # copies lean on it and only load-balance here. They also never
    # run a flusher thread (promise refs need the driver's object
    # plane): their requests dispatch one-per-call and the REPLICA's
    # gather queue coalesces them.
    rs._router_wait = False
    rs._driver_side = False
    return rs


class ReplicaSet:
    """The router's view of one deployment's replicas + in-flight
    accounting. Thread-safe; shared by handles and the controller.

    Picklable (model composition: a DeploymentHandle shipped into
    another deployment's replica): the receiving process gets the
    replica list with fresh local in-flight counts — pow-2 then
    balances on that process's own traffic plus the piggybacked
    replica depths. The copy's membership is a snapshot; replaced
    replicas surface as actor-dead errors on call.
    """

    # how long begin() waits for a replica slot under a
    # max_ongoing_requests cap before giving up (backpressure bound)
    ADMISSION_TIMEOUT_S = 120.0

    def __reduce__(self):
        return (_rebuild_replica_set,
                (self.deployment_name, self.replicas(),
                 self.max_ongoing, self.batch_cfg, self.max_queued))

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name
        # The controller mutates replica sets while holding its own
        # locks (reconcile -> state -> this set); nothing under _lock
        # ever calls back into the controller (enforced by
        # graftcheck's lock-order pass):
        # lock-order: ServeController._reconcile_lock -> ServeController._lock -> _lock
        self._lock = threading.Lock()
        # both CVs share _lock — waiting on either releases the same
        # mutex, so they can never form a second lock-graph node
        self._slot_free = threading.Condition(self._lock)
        self._dispatch_cv = threading.Condition(self._lock)
        # per-replica in-flight cap (None = uncapped): the reference's
        # max_ongoing_requests admission control — requests beyond
        # cap × replicas WAIT here instead of piling onto replicas
        self.max_ongoing: Optional[int] = None
        # total-queue bound (pending + in-flight + admission waiters):
        # beyond it, assign() sheds with BackpressureError. None =
        # resolve from serve_max_queued_requests at first use.
        self.max_queued: Optional[int] = None
        # method -> {"max_batch_size", "batch_wait_timeout_ms"} for
        # @serve.batch methods (controller-discovered at deploy)
        self.batch_cfg: Dict[str, dict] = {}
        # the driver's original set gates admission in begin(); pickled
        # copies rely on the replica-side semaphore (see _rebuild)
        self._router_wait = True
        self._driver_side = True
        self._replicas: List = []  # ActorHandle list  # guarded-by: _lock
        self._inflight: Dict[int, int] = {}  # id(handle) -> count  # guarded-by: _lock
        # depth each replica reported on its last batch reply, minus
        # our own charges at that moment: OTHER routers' load there
        # (the piggybacked pow-2 signal)
        self._peer_load: Dict[int, int] = {}  # guarded-by: _lock
        # model multiplexing: sticky model_id -> replica key, so a
        # model's requests keep hitting the replica whose LRU already
        # holds it (reference: model-aware replica scheduling)
        self._model_routes: Dict[str, int] = {}  # guarded-by: _lock
        # batched-dispatch plane (driver-side only)
        # unbounded-ok: admission-bounded — assign() sheds beyond
        # max_queued_requests before appending, so depth never exceeds
        # that knob (plus in-flight requests already charged)
        self._pending: Dict[tuple, deque] = {}   # guarded-by: _lock
        # completed batch dispatches awaiting fan-out
        # unbounded-ok: bounded by outstanding dispatches, themselves
        # bounded by max_queued_requests / max_ongoing admission
        self._done: deque = deque()              # guarded-by: _lock
        self._outstanding = 0  # dispatched, unresolved batches  # guarded-by: _lock
        self._waiters = 0      # begin() admission waiters  # guarded-by: _lock
        self._flusher: Optional[threading.Thread] = None
        self._closed = False         # guarded-by: _lock
        self._rng = random.Random(0xF00D)
        self.total_assigned = 0

    # -- membership (controller-driven) --------------------------------

    def set_replicas(self, replicas: List) -> None:
        with self._lock:
            keep = {id(r) for r in replicas}
            self._replicas = list(replicas)
            self._inflight = {id(r): self._inflight.get(id(r), 0)
                              for r in replicas}
            self._peer_load = {k: v for k, v in self._peer_load.items()
                               if k in keep}
            # Drop model pins to departed replicas NOW: a later handle
            # object could reuse the freed id() and silently alias the
            # stale route to an unrelated replica.
            self._model_routes = {m: k
                                  for m, k in self._model_routes.items()
                                  if k in keep}
            self._slot_free.notify_all()   # membership may free slots
            self._dispatch_cv.notify_all()

    def replicas(self) -> List:
        with self._lock:
            return list(self._replicas)

    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def total_inflight(self) -> int:
        with self._lock:
            return sum(self._inflight.values())

    def total_queued(self) -> int:
        """Pending (batch-parked) + in-flight + admission waiters: the
        deployment's whole request queue in THIS routing process — the
        shed bound and the autoscaler's queue-depth signal."""
        with self._lock:
            return self._total_queued_locked()

    def _total_queued_locked(self):  # lock-held: _lock
        pending = sum(len(q) for q in self._pending.values())
        return pending + sum(self._inflight.values()) + self._waiters

    def _queue_bound(self) -> Optional[int]:
        bound = self.max_queued
        if bound is None:
            from ray_tpu_torch._private.config import get_config
            bound = get_config().serve_max_queued_requests
        return bound if bound and bound > 0 else None

    def _check_shed(self) -> None:
        """Shed (PR-3 BackpressureError, retryable) when the total
        queue is at its bound — callers/proxies retry with backoff or
        surface 503 instead of this process queueing unboundedly."""
        bound = self._queue_bound()
        if bound is None:
            return
        with self._lock:
            depth = self._total_queued_locked()
            if depth < bound:
                return
        serve_stats.incr("shed")
        raise BackpressureError(
            f"deployment {self.deployment_name!r} rejected the request: "
            f"{depth} queued >= max_queued_requests={bound}",
            retryable=True,
            backoff_s=min(5.0, 0.05 * max(1.0, depth / bound)))

    # -- assignment (direct path) --------------------------------------

    def begin(self, model_id: Optional[str] = None,
              nowait: bool = False):
        """Pick a replica (pow-2 / sticky-model) and charge one
        in-flight request to it. Returns the replica handle; the caller
        MUST balance with ``end(id(handle))`` when the request
        resolves (``assign`` wires this automatically).

        ``nowait=True`` (the async HTTP ingress): instead of parking
        the calling thread when every candidate is at its
        ``max_ongoing_requests`` cap (or membership is momentarily
        empty mid-rollout), raise a retryable ``BackpressureError`` —
        the event loop maps it to 503 + Retry-After and stays
        non-blocking."""
        deadline = None
        with self._lock:
            while True:
                if not self._replicas:
                    if nowait:
                        raise BackpressureError(
                            f"deployment {self.deployment_name!r} has "
                            "no live replicas (mid-rollout?)",
                            retryable=True, backoff_s=0.5)
                    raise RuntimeError(
                        f"deployment {self.deployment_name!r} has no "
                        "live replicas")
                cap = (self.max_ongoing if self._router_wait else None)
                pool = (self._replicas if cap is None else
                        [r for r in self._replicas
                         if self._inflight.get(id(r), 0) < cap])
                pinned_full = False
                chosen = None
                if model_id is not None:
                    key = self._model_routes.get(model_id)
                    if key is not None:
                        chosen = next((r for r in self._replicas
                                       if id(r) == key), None)
                        if chosen is not None and chosen not in pool:
                            # pinned replica alive but at cap: WAIT for
                            # its slot — re-pinning would bounce the
                            # model's hot weights between replicas
                            pinned_full = True
                            chosen = None
                if not pool or pinned_full:
                    if nowait:
                        raise BackpressureError(
                            f"deployment {self.deployment_name!r}: "
                            f"all replicas at max_ongoing_requests="
                            f"{cap}", retryable=True, backoff_s=0.25)
                    # every candidate at its cap: wait for a release
                    if deadline is None:
                        deadline = (time.monotonic()
                                    + self.ADMISSION_TIMEOUT_S)
                    remaining = deadline - time.monotonic()
                    self._waiters += 1
                    try:
                        if remaining <= 0 or not self._slot_free.wait(
                                timeout=remaining):
                            if time.monotonic() >= deadline:
                                raise RuntimeError(
                                    f"deployment "
                                    f"{self.deployment_name!r}: all "
                                    f"replicas at max_ongoing_requests="
                                    f"{cap} for "
                                    f"{self.ADMISSION_TIMEOUT_S:.0f}s")
                    finally:
                        self._waiters -= 1
                    continue
                if model_id is not None and chosen is None:
                    # first sight of this model (or its replica died):
                    # pin to the least-loaded replica
                    chosen = min(pool, key=lambda r: self._score(id(r)))
                    self._model_routes[model_id] = id(chosen)
                if chosen is None:
                    chosen = self._pow2_locked(pool)
                self._inflight[id(chosen)] = \
                    self._inflight.get(id(chosen), 0) + 1
                self.total_assigned += 1
                return chosen

    def _score(self, key: int) -> int:  # lock-held: _lock
        """Queue-length estimate for one replica: locally charged
        in-flight plus the depth other routers put there (piggybacked
        on batch replies — no extra RPC)."""
        return self._inflight.get(key, 0) + self._peer_load.get(key, 0)

    def _pow2_locked(self, pool: List):  # lock-held: _lock
        if len(pool) == 1:
            return pool[0]
        a, b = self._rng.sample(pool, 2)
        return a if self._score(id(a)) <= self._score(id(b)) else b

    def end(self, replica_key: int, n: int = 1) -> None:
        """Release ``n`` in-flight charges (ongoing-requests signal for
        pow-2, autoscaling, and admission waits)."""
        with self._lock:
            if replica_key in self._inflight:
                self._inflight[replica_key] = max(
                    0, self._inflight[replica_key] - n)
            self._slot_free.notify_all()
            self._dispatch_cv.notify_all()

    def assign(self, method: str, args: tuple, kwargs: dict,
               model_id: Optional[str] = None, stream: bool = False,
               nowait: bool = False):
        """Route one request. ``stream=True`` calls the replica's
        streaming endpoint and returns an ObjectRefGenerator whose
        items land as the replica yields them. May raise
        ``BackpressureError`` (retryable) when the deployment's queue
        bound is hit — always with ``nowait=True`` (event-loop
        callers), which sheds instead of parking in admission."""
        self._check_shed()
        serve_stats.incr("requests")
        bcfg = self.batch_cfg.get(method)
        if (bcfg is not None and not stream and self._driver_side
                and len(args) == 1 and not kwargs):
            return self._assign_batched(method, args[0], model_id, bcfg)
        chosen = self.begin(model_id, nowait=nowait)
        if stream:
            gen = chosen.handle_request_streaming.options(
                num_returns="streaming").remote(method, args, kwargs,
                                                model_id)
            self._watch(gen.completed(), id(chosen))
            return gen
        zc_refs = []
        if args:
            promoted = []
            for i, a in enumerate(args):
                value, ref = _zero_copy_promote(a)
                if ref is not None:
                    value.i = len(zc_refs)
                    zc_refs.append(ref)
                promoted.append(value)
            if zc_refs:
                args = tuple(promoted)
        ref = chosen.handle_request.remote(method, args, kwargs,
                                           model_id, *zc_refs)
        self._watch(ref, id(chosen))
        return ref

    def _watch(self, ref: ObjectRef, replica_key: int) -> None:
        """Decrement in-flight when the result lands. On the driver the
        hook rides the owner's completion path (no waiter threads); in
        a worker (proxy actor / composition) it falls back to a waiter
        future."""
        def _done(*_a):
            self.end(replica_key)

        from ray_tpu_torch._private.worker import try_global_worker
        w = try_global_worker()
        if w is not None and hasattr(w, "on_object_ready"):
            w.on_object_ready(ref.id(), _done)
        else:
            ref.future().add_done_callback(_done)

    # -- batched dispatch plane (driver-side) --------------------------

    def assign_promised(self, method: str, value,
                        model_id: Optional[str] = None):
        """The async HTTP ingress's dispatch: ALWAYS reserve a promise
        ObjectRef and park the request on the batched plane — even for
        methods without ``@serve.batch`` (``handle_request_batch``
        isolates per-item user errors, and the default gather knobs
        apply), so ingress traffic rides the gather layers and the
        event loop never blocks in admission. Returns the promise ref
        immediately; raises ``BackpressureError`` on shed. In a
        non-driver process (worker-hosted proxy) there is no promise
        plane: falls back to a non-blocking direct dispatch."""
        self._check_shed()
        serve_stats.incr("requests")
        bcfg = self.batch_cfg.get(method) or {}
        if not self._driver_side:
            chosen = self.begin(model_id, nowait=True)
            ref = chosen.handle_request.remote(method, (value,), {},
                                               model_id)
            self._watch(ref, id(chosen))
            return ref
        return self._assign_batched(method, value, model_id, bcfg)

    def _assign_batched(self, method: str, value, model_id, bcfg):
        """Reserve a promise ref, park the request in its gather
        queue, and let the flusher coalesce it into a replica
        dispatch. The caller gets an ordinary ObjectRef immediately."""
        from ray_tpu_torch._private.worker import try_global_worker
        w = try_global_worker()
        if w is None or not hasattr(w, "next_put_id"):
            # not a driver process after all: direct-dispatch fallback
            chosen = self.begin(model_id)
            ref = chosen.handle_request.remote(method, (value,), {},
                                               model_id)
            self._watch(ref, id(chosen))
            return ref
        value, zc_ref = _zero_copy_promote(value)
        oid = w.next_put_id()
        w.reference_counter.add_owned_object(oid)
        ref = ObjectRef(oid)
        req = _PendingReq(ref, value, zc_ref, time.monotonic())
        key = (method, model_id)
        max_b, _wait = self._batch_knobs(bcfg)
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} was deleted")
            # unbounded-ok: _check_shed caps total pending across keys
            # at max_queued_requests before this append is reached
            q = self._pending.setdefault(key, deque())
            q.append(req)
            if self._flusher is None or not self._flusher.is_alive():
                # is_alive covers a flusher killed by an unexpected
                # error (each iteration is also belt-and-suspenders
                # guarded): the batched path must never wedge forever
                self._flusher = threading.Thread(
                    target=self._flusher_loop, daemon=True,
                    name=f"rtpu-serve-batch-{self.deployment_name}")
                self._flusher.start()
            # wake the flusher only on the edges it acts on — first
            # arrival (window start / idle bypass) and a full batch;
            # mid-fill appends would wake it for nothing (hot path)
            if len(q) == 1 or len(q) >= max_b:
                self._dispatch_cv.notify_all()
        return ref

    def close(self) -> None:
        """Fail every parked request and stop the flusher (deployment
        deleted / serve shutdown)."""
        with self._lock:
            self._closed = True
            pending = list(self._pending.items())
            self._pending.clear()
            self._dispatch_cv.notify_all()
        err = RuntimeError(
            f"deployment {self.deployment_name!r} was deleted")
        for _key, q in pending:
            for req in q:
                self._fulfill_error(req, err)

    # flusher -----------------------------------------------------------

    def _flusher_loop(self) -> None:
        while True:
            batch = None
            done = None
            with self._lock:
                if (self._closed and not self._done
                        and self._outstanding == 0):
                    return
                if self._done:
                    done = self._done.popleft()
                else:
                    batch, wait_hint = self._next_batch_locked()
                    if batch is None:
                        self._dispatch_cv.wait(timeout=wait_hint)
                        continue
            try:
                if done is not None:
                    self._finish_batch(*done)
                    continue
                if batch[0] == "timeout":
                    # the batched analog of begin()'s admission bound:
                    # no dispatchable replica for ADMISSION_TIMEOUT_S
                    err = RuntimeError(
                        f"deployment {self.deployment_name!r}: no "
                        f"replica accepted a batched dispatch for "
                        f"{self.ADMISSION_TIMEOUT_S:.0f}s")
                    for req in batch[1]:
                        self._fulfill_error(req, err)
                    continue
                self._dispatch_batch(*batch)
            except Exception:  # noqa: BLE001 - thread must survive
                # _dispatch_batch/_finish_batch settle their own batch
                # on every anticipated failure; this guard only keeps
                # an UNanticipated one from killing the flusher and
                # wedging every subsequent batched request
                logger.exception("serve %s: flusher iteration failed",
                                 self.deployment_name)

    def _next_batch_locked(self):  # lock-held: _lock
        """Pick the key with the oldest head request; return
        ((key, reqs, replica), _) when its gather window is ready AND
        a replica slot is available, else (None, seconds-to-wait)."""
        best_key, best_q = None, None
        for key, q in self._pending.items():
            if q and (best_q is None or q[0].enq_t < best_q[0].enq_t):
                best_key, best_q = key, q
        if best_q is None:
            return None, 0.05
        method, model_id = best_key
        bcfg = self.batch_cfg.get(method) or {}
        max_b, wait_s = self._batch_knobs(bcfg)
        now = time.monotonic()
        live = len(self._replicas)
        window_left = wait_s - (now - best_q[0].enq_t)
        if now - best_q[0].enq_t >= self.ADMISSION_TIMEOUT_S:
            # nothing could take this key's requests for the whole
            # admission window (no replicas / all at cap): fail them
            # typed rather than parking forever
            reqs = [best_q.popleft() for _ in range(len(best_q))]
            del self._pending[best_key]
            return ("timeout", reqs), 0.0
        ready = (len(best_q) >= max_b
                 or window_left <= 0
                 or (live and self._outstanding < live))
        if not ready or not live:
            # wake exactly at window expiry (new arrivals and slot
            # frees notify the cv earlier)
            return None, max(1e-4, min(0.05, window_left))
        avoid = {r.avoid for r in list(best_q)[:max_b]
                 if r.avoid is not None}
        pool = [r for r in self._replicas if id(r) not in avoid]
        cap = self.max_ongoing if self._router_wait else None
        if cap is not None:
            capped = [r for r in (pool or self._replicas)
                      if self._inflight.get(id(r), 0) < cap]
            if not capped:
                return None, 0.05    # every replica at cap: wait
            pool = capped
        if not pool:
            pool = list(self._replicas)   # all avoided: retry anywhere
        if model_id is not None:
            pin = self._model_routes.get(model_id)
            chosen = next((r for r in pool if id(r) == pin), None)
            if chosen is None:
                chosen = min(pool, key=lambda r: self._score(id(r)))
                self._model_routes[model_id] = id(chosen)
        else:
            chosen = self._pow2_locked(pool)
        reqs = [best_q.popleft() for _ in range(min(max_b, len(best_q)))]
        if not best_q:
            del self._pending[best_key]
        self._inflight[id(chosen)] = \
            self._inflight.get(id(chosen), 0) + len(reqs)
        self.total_assigned += len(reqs)
        self._outstanding += 1
        return (best_key, reqs, chosen), 0.0

    @staticmethod
    def _batch_knobs(bcfg: dict):
        """(max_batch, wait_seconds) — same resolver the replica-side
        gather queues use (replica._batch_defaults), so both halves of
        the batching plane always agree on the effective knobs."""
        max_b, wait_ms = _batch_defaults(
            bcfg.get("max_batch_size"),
            bcfg.get("batch_wait_timeout_ms"))
        return max_b, wait_ms / 1e3

    def _dispatch_batch(self, key, reqs, chosen) -> None:
        method, model_id = key
        zc_refs, items = [], []
        for r in reqs:
            if r.zc is not None:
                r.value.i = len(zc_refs)
                zc_refs.append(r.zc)
            items.append(r.value)
        serve_stats.incr("batches")
        serve_stats.incr("batch_items", len(items))
        try:
            bref = chosen.handle_request_batch.remote(
                method, items, model_id, *zc_refs)
        except Exception as e:  # noqa: BLE001 - fanned per request
            self._settle_failed(key, reqs, id(chosen), e)
            return

        def _ready(*_a):
            with self._lock:
                self._done.append((key, reqs, id(chosen), bref))
                self._dispatch_cv.notify_all()

        try:
            from ray_tpu_torch._private.worker import global_worker
            global_worker().on_object_ready(bref.id(), _ready)
        except Exception as e:  # noqa: BLE001 - settle, never leak
            # runtime tearing down under the dispatch: without a
            # completion hook these requests would park forever
            self._settle_failed(key, reqs, id(chosen), e)

    def _finish_batch(self, key, reqs, replica_key, bref) -> None:
        """Fan a completed dispatch back onto its promise refs; on an
        envelope-level failure (replica death — per-item user errors
        ride INSIDE the envelope) retry each request once, then fail
        typed. Runs on the flusher thread, outside the lock."""
        from ray_tpu_torch._private.worker import global_worker
        w = global_worker()
        try:
            envelope = w.get([bref])[0]
            tag, results, depth = envelope
        except BaseException as e:  # noqa: BLE001 - fanned per request
            self._settle_failed(key, reqs, replica_key, e)
            return
        for req, res in zip(reqs, results):
            try:
                if tag == "b":
                    w._put_value(req.ref.id(), res)
                elif res[0] == 0:
                    w._put_value(req.ref.id(), res[1])
                else:
                    w._store_error(req.ref.id(), res[1])
            except Exception as e:  # noqa: BLE001 - per-request fate
                # a result that won't serialize must still resolve its
                # promise ref (one resolution per request, always)
                self._fulfill_error(req, e)
        with self._lock:
            if replica_key in self._inflight:
                self._inflight[replica_key] = max(
                    0, self._inflight[replica_key] - len(reqs))
                # piggybacked depth: what the replica holds beyond OUR
                # charges is other routers' load there
                self._peer_load[replica_key] = max(
                    0, depth - self._inflight[replica_key])
            self._outstanding -= 1
            self._slot_free.notify_all()
            self._dispatch_cv.notify_all()

    def _settle_failed(self, key, reqs, replica_key, err) -> None:
        """Whole-dispatch failure: each request is retried ONCE on
        another replica, then failed typed — exactly one resolution
        per promise ref either way (the chaos contract: no lost and
        no duplicated responses). Retry ONLY on the typed
        death/transport taxonomy: the replica never produced a result,
        so re-execution is safe. Any other envelope failure (e.g. a
        result that wouldn't serialize AFTER user code ran) fails
        typed immediately — retrying would re-run side effects."""
        retryable = isinstance(err, _RETRYABLE_DISPATCH_ERRORS)
        fail, requeue = [], []
        with self._lock:
            if replica_key in self._inflight:
                self._inflight[replica_key] = max(
                    0, self._inflight[replica_key] - len(reqs))
            self._outstanding -= 1
            for req in reqs:
                if req.retried or self._closed or not retryable:
                    fail.append(req)
                else:
                    req.retried = True
                    req.avoid = replica_key
                    requeue.append(req)
            if requeue:
                # unbounded-ok: re-queues previously admitted (shed-
                # checked) requests, each at most once
                q = self._pending.setdefault(key, deque())
                # front of the queue, oldest first: retries keep their
                # arrival order ahead of newer requests
                for req in reversed(requeue):
                    q.appendleft(req)
            self._slot_free.notify_all()
            self._dispatch_cv.notify_all()
        if requeue:
            serve_stats.incr("batch_retries")
        for req in fail:
            self._fulfill_error(req, err)

    def _fulfill_error(self, req: _PendingReq, err) -> None:
        from ray_tpu_torch._private.worker import global_worker
        try:
            global_worker()._store_error(req.ref.id(), err)
        except Exception:  # noqa: BLE001
            # runtime already torn down: the promise ref dies with it
            pass
