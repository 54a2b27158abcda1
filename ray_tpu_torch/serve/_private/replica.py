"""Replica actor: hosts one copy of a deployment.

Reference: ``python/ray/serve/_private/replica.py`` [UNVERIFIED —
mount empty, SURVEY.md §0]. A replica is a plain core-API actor (the
libraries-on-core invariant) — and, like the reference's replicas, an
ASYNC actor: requests execute on the replica's event loop, so async
deployments overlap I/O-bound requests and streaming responses yield
items as they are produced. A replica builds its model once at
construction (on the card when it demands ``num_gpus``) and serves it
from then on.

Dynamic batching (docs/serve.md): ``@serve.batch`` methods take ONE
request argument and a vectorized body over a list of them. Two
feeders converge on the same body:

- ``handle_request_batch``: the router's gathered dispatch — up to
  ``max_batch_size`` requests arrive as one actor call and run as one
  vectorized invocation (the 25k-RPS path; per-request wire cost is
  amortized over the batch).
- per-replica GATHER QUEUES: single-request calls (worker-hosted
  proxies, composed handles, undecorated callers) enqueue into an
  asyncio gather queue; a drainer coalesces whatever accumulates
  within ``batch_wait_timeout_ms`` (or a full batch, whichever first)
  into one vectorized call. A new batch forms while the previous
  executes — continuous re-fill.

User exceptions are captured PER ITEM and shipped in the reply
envelope; an envelope-level failure therefore always means the
replica (or its transport) died, which is what makes the router's
retry-once-then-typed-fail contract safe.

Concurrency contract (graftsan audit): this module holds NO locks on
purpose — every mutable field (`_items`, `_ongoing`, `_admission`,
batcher state) is confined to the replica's asyncio event loop, so
``# guarded-by:`` does not apply here. Cross-thread state for the
serve plane lives in the router (``router.py``, guarded by
``ReplicaSet._lock``) and the process-wide counters
(``_private/serve_stats.py``, guarded by its module ``_lock``). Adding
a thread to this module means adding a lock AND its annotations.
"""

from __future__ import annotations

import contextvars
import inspect

# Per-request model id (model multiplexing); re-exported by the public
# package — defined HERE so replicas never import the full serve
# package (controller/router machinery) just to reach one ContextVar.
# Requests run as asyncio tasks, so the ContextVar isolates per-request
# even while coroutines interleave.
_multiplex_ctx: "contextvars.ContextVar" = contextvars.ContextVar(
    "rtpu_serve_model_id", default=None)


class _ZC:
    """Placeholder for a zero-copy routed argument: the payload rides
    as a TOP-LEVEL ObjectRef of the replica call (resolved to its
    value by the runtime — shm read, no re-pickle per hop) and this
    marker says which resolved slot replaces it."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __reduce__(self):
        return (_ZC, (self.i,))


def _rehydrate(value, zc: tuple):
    return zc[value.i] if type(value) is _ZC else value


def _current_model_id():
    """Module-level accessor for the batch wrapper: the wrapper is
    cloudpickled BY VALUE with the user's deployment (functools.wraps
    stamps the user's __module__ onto it), and its globals ship along
    — a function global pickles by reference, a bare ContextVar global
    does not pickle at all."""
    return _multiplex_ctx.get()


# ---------------------------------------------------------------------------
# @serve.batch — vectorized request batching
# ---------------------------------------------------------------------------

def _batch_defaults(max_batch_size, batch_wait_timeout_ms):
    from ray_tpu_torch._private.config import get_config
    cfg = get_config()
    if max_batch_size is None:
        max_batch_size = cfg.serve_max_batch_size
    if batch_wait_timeout_ms is None:
        batch_wait_timeout_ms = cfg.serve_batch_wait_timeout_ms
    return max(1, int(max_batch_size)), max(0.0,
                                            float(batch_wait_timeout_ms))


class _GatherQueue:
    """Replica-side gather queue for one ``@serve.batch`` callable AND
    one multiplexed model id: single-request invocations park here; a
    drainer task slices the backlog into vectorized calls of up to
    ``max_batch_size``. Keying by model id keeps a batch
    model-homogeneous, and the drainer re-installs that id in the
    multiplex ContextVar (the task was created under the FIRST
    submitter's context — without the explicit set, a later model's
    items would execute under a stale id)."""

    def __init__(self, inner, owner, max_batch: int, wait_s: float,
                 model_id=None):
        import asyncio
        from collections import deque
        self._inner = inner
        self._owner = owner
        self._max = max_batch
        self._wait_s = wait_s
        self._model_id = model_id
        # unbounded-ok: admission is bounded upstream — the router
        # sheds beyond max_queued_requests and the replica admission
        # semaphore caps concurrent entrants; this deque only holds
        # requests already admitted to this replica.
        self._items: "deque" = deque()
        self._full = asyncio.Event()
        self._drainer = None

    async def submit(self, item):
        import asyncio
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._items.append((item, fut))
        if len(self._items) >= self._max:
            self._full.set()
        if self._drainer is None or self._drainer.done():
            self._drainer = loop.create_task(self._drain())
        return await fut

    async def _drain(self):
        import asyncio
        while self._items:
            if len(self._items) < self._max and self._wait_s > 0:
                # gather window: a full batch cuts the wait short
                try:
                    await asyncio.wait_for(self._full.wait(),
                                           timeout=self._wait_s)
                except asyncio.TimeoutError:
                    pass
            self._full.clear()
            batch = [self._items.popleft()
                     for _ in range(min(self._max, len(self._items)))]
            if not batch:
                continue
            values = [v for v, _f in batch]
            token = (_multiplex_ctx.set(self._model_id)
                     if self._model_id is not None else None)
            try:
                results = run_vectorized_sync(self._inner, self._owner,
                                              values)
                if inspect.isawaitable(results):
                    results = await results
                results = check_batch_result(results, len(values))
            except Exception as e:  # noqa: BLE001 - fan the batch error
                for _v, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            finally:
                if token is not None:
                    _multiplex_ctx.reset(token)
            for (_v, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)


def run_vectorized_sync(inner, owner, values):
    """One vectorized invocation of a ``@serve.batch`` body (methods
    get their instance back, function deployments don't)."""
    return inner(owner, values) if owner is not None else inner(values)


def check_batch_result(results, n: int):
    if not isinstance(results, (list, tuple)) or len(results) != n:
        raise TypeError(
            "@serve.batch function must return a list with one result "
            f"per request (got {type(results).__name__} for a batch "
            f"of {n})")
    return list(results)


def batch(_fn=None, *, max_batch_size=None, batch_wait_timeout_ms=None):
    """Decorate a deployment method (or function deployment) taking a
    LIST of request values with a vectorized body; callers keep
    sending single requests::

        @serve.deployment
        class Model:
            @serve.batch(max_batch_size=32, batch_wait_timeout_ms=5)
            async def __call__(self, inputs):      # list in
                return self.model(np.stack(inputs))  # list out

    The router gathers pending requests into one replica dispatch per
    batch, and the replica-side gather queue coalesces whatever still
    arrives one-by-one. Defaults come from ``serve_max_batch_size`` /
    ``serve_batch_wait_timeout_ms``. Batched methods must take exactly
    one request argument (after ``self``) and return one result per
    request, in order.
    """
    import functools

    def wrap(fn):
        cfg = {"max_batch_size": max_batch_size,
               "batch_wait_timeout_ms": batch_wait_timeout_ms}
        queue_attr = f"_rtpu_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(*call_args):
            if len(call_args) == 2:
                owner, item = call_args          # bound method
            elif len(call_args) == 1:
                owner, item = None, call_args[0]  # function deployment
            else:
                raise TypeError(
                    "@serve.batch methods take exactly one request "
                    f"argument, got {max(0, len(call_args) - 1)}")
            host = owner if owner is not None else wrapper
            per_model = getattr(host, queue_attr, None)
            if per_model is None:
                per_model = {}
                setattr(host, queue_attr, per_model)
            # one gather queue per multiplexed model id: a batch must
            # be model-homogeneous (the vectorized body runs once)
            model_id = _current_model_id()
            q = per_model.get(model_id)
            if q is None:
                mx, wait_ms = _batch_defaults(cfg["max_batch_size"],
                                              cfg["batch_wait_timeout_ms"])
                q = _GatherQueue(fn, owner, mx, wait_ms / 1e3, model_id)
                per_model[model_id] = q
            return await q.submit(item)

        wrapper._rtpu_batch_cfg = dict(cfg)
        wrapper._rtpu_batch_inner = fn
        return wrapper

    return wrap if _fn is None else wrap(_fn)


class ReplicaActor:
    """Wraps the user's deployment class/function."""

    def __init__(self, deployment_blob: bytes, init_args: tuple,
                 init_kwargs: dict, max_ongoing_requests=None):
        import cloudpickle
        target = cloudpickle.loads(deployment_blob)
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            if init_args or init_kwargs:
                raise TypeError("function deployments take no init args")
            self._callable = target
        # Replica-side admission (the HARD max_ongoing_requests cap):
        # router copies in proxies/composed handles count in-flight
        # locally, so only this semaphore bounds the true concurrency.
        # Created lazily on the replica's event loop. A batched
        # dispatch holds ONE unit (the router already caps the items
        # it charges per replica).
        self._max_ongoing = max_ongoing_requests
        self._admission = None
        # True in-flight count (admission waiters included): the
        # controller's graceful drain polls this until zero before a
        # replica is killed (reference: graceful_shutdown_wait_loop_s),
        # and batch replies piggyback it as the queue-depth signal the
        # router's power-of-two-choices reads.
        self._ongoing = 0

    def _admission_sem(self):
        if self._admission is None and self._max_ongoing:
            import asyncio
            self._admission = asyncio.Semaphore(int(self._max_ongoing))
        return self._admission

    def _resolve(self, method: str):
        if method in ("__call__", ""):
            return self._callable
        return getattr(self._callable, method)

    async def handle_request(self, method: str, args: tuple, kwargs: dict,
                             model_id=None, *zc):
        self._ongoing += 1
        try:
            if zc:
                args = tuple(_rehydrate(a, zc) for a in args)
                kwargs = {k: _rehydrate(v, zc) for k, v in kwargs.items()}
            sem = self._admission_sem()
            if sem is not None:
                async with sem:
                    return await self._invoke(method, args, kwargs,
                                              model_id)
            return await self._invoke(method, args, kwargs, model_id)
        finally:
            self._ongoing -= 1

    async def handle_request_batch(self, method: str, items: list,
                                   model_id=None, *zc):
        """Router-gathered dispatch: ``items`` holds one request value
        each (batched methods take a single argument). Returns an
        envelope — ``("b", results, depth)`` when every item
        succeeded, ``("be", [(0, value) | (1, exc)], depth)`` when any
        user code failed — so per-item errors NEVER fail the envelope;
        an envelope-level exception means the replica died and the
        whole batch is safe to retry. ``depth`` is this replica's
        remaining in-flight count, the piggybacked queue signal for
        the router's power-of-two-choices (no extra RPC)."""
        n = len(items)
        self._ongoing += n
        try:
            if zc:
                items = [_rehydrate(v, zc) for v in items]
            sem = self._admission_sem()
            if sem is not None:
                async with sem:
                    results, mixed = await self._run_batch(method, items,
                                                           model_id)
            else:
                results, mixed = await self._run_batch(method, items,
                                                       model_id)
            depth = max(0, self._ongoing - n)
            return ("be" if mixed else "b", results, depth)
        finally:
            self._ongoing -= n

    def _batch_target(self, method: str):
        """(inner, owner) of a ``@serve.batch`` body reachable as
        ``method``, or (None, None). ``__call__`` on a class
        deployment resolves to the INSTANCE, so the wrapper's marker
        attributes live on ``type(instance).__call__``, not on the
        resolved object itself."""
        fn = self._resolve(method)
        inner = getattr(fn, "_rtpu_batch_inner", None)
        if inner is not None:
            return inner, getattr(fn, "__self__", None)
        if fn is self._callable:
            call = getattr(type(self._callable), "__call__", None)
            inner = getattr(call, "_rtpu_batch_inner", None)
            if inner is not None:
                return inner, self._callable
        return None, None

    async def _run_batch(self, method: str, items: list, model_id):
        fn = self._resolve(method)
        inner, owner = self._batch_target(method)
        token = (_multiplex_ctx.set(model_id)
                 if model_id is not None else None)
        try:
            if inner is not None:
                try:
                    res = run_vectorized_sync(inner, owner, items)
                    if inspect.isawaitable(res):
                        res = await res
                    return check_batch_result(res, len(items)), False
                except Exception as e:  # noqa: BLE001 - per-item fanned
                    return [(1, e) for _ in items], True
            # undecorated method reached by a batched dispatch: run
            # per item, isolating each item's error
            out, mixed = [], False
            for value in items:
                try:
                    r = fn(value)
                    if inspect.isawaitable(r):
                        r = await r
                    out.append((0, r))
                except Exception as e:  # noqa: BLE001 - per-item fanned
                    out.append((1, e))
                    mixed = True
            if mixed:
                return out, True
            return [r for _s, r in out], False
        finally:
            if token is not None:
                _multiplex_ctx.reset(token)

    async def _invoke(self, method: str, args: tuple, kwargs: dict,
                      model_id):
        fn = self._resolve(method)
        token = (_multiplex_ctx.set(model_id)
                 if model_id is not None else None)
        try:
            result = fn(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
            return result
        finally:
            if token is not None:
                _multiplex_ctx.reset(token)

    async def handle_request_streaming(self, method: str, args: tuple,
                                       kwargs: dict, model_id=None):
        """Streaming responses (reference: generator deployments over
        the proxy's streaming path): the user method may return a sync
        generator, an async generator, or a plain value (streamed as a
        single item). Items flow to the caller AS they are yielded —
        consumers read them before the producer finishes. A streaming
        request holds its admission slot for the whole generation."""
        self._ongoing += 1
        try:
            sem = self._admission_sem()
            if sem is not None:
                async with sem:
                    async for item in self._invoke_streaming(
                            method, args, kwargs, model_id):
                        yield item
                return
            async for item in self._invoke_streaming(method, args, kwargs,
                                                     model_id):
                yield item
        finally:
            self._ongoing -= 1

    async def _invoke_streaming(self, method: str, args: tuple,
                                kwargs: dict, model_id=None):
        fn = self._resolve(method)
        token = (_multiplex_ctx.set(model_id)
                 if model_id is not None else None)
        try:
            result = fn(*args, **kwargs)
            if inspect.isawaitable(result):
                result = await result
            if inspect.isasyncgen(result):
                async for item in result:
                    yield item
            elif inspect.isgenerator(result):
                for item in result:
                    yield item
            else:
                yield result
        finally:
            if token is not None:
                _multiplex_ctx.reset(token)

    def ping(self) -> str:
        return "pong"

    def num_ongoing(self) -> int:
        return self._ongoing
