"""Worker-process main loop + the shared task-execution core.

Reference analog: the task-execution callback in ``python/ray/_raylet.pyx``
(``execute_task``) plus ``core_worker/transport/task_receiver.cc``
[UNVERIFIED — mount empty, SURVEY.md §0].

Two execution substrates share this code:

- **Process workers** (this module's ``worker_main``): spawned
  subprocesses for CPU-demand tasks. They import torch only if a task
  does, and with ``CUDA_VISIBLE_DEVICES`` empty — the driver owns the
  cards, so subprocesses never touch them.
- **In-process workers**: tasks/actors that demand GPU run on threads
  inside the driver/host process, which owns the cards. CUDA launches
  release the GIL while the device computes, so threads are the
  idiomatic host-side concurrency for device work. See
  ``worker_pool.InProcessWorker``.

Wire protocol (pickled tuples over a multiprocessing Pipe):
  driver -> worker:
    ("func", function_id, blob)                 cache a callable
    ("exec", payload)                           run a normal task
    ("create_actor", payload)                   instantiate actor
    ("exec_actor", payload)                     run actor method (ordered)
    ("exec_actor_batch", [payload, ...])        N ordered actor calls,
                                                ONE frame (hot path)
    ("actor_tmpl", actor_id, template)          constant half of this
                                                actor's call payloads
    ("shutdown",)
  worker -> driver:
    ("ready", pid)
    ("done", task_id, [(oid, kind, data, contained_refs)], err)
        kind: "inline" -> data = serialized blob
              "shm"    -> data = (segment_name, size)
    ("batch", [reply, ...])                     coalesced completions
    ("actor_ready", actor_id, err)

Async actors: an actor class with any ``async def`` method executes ALL
its calls on a dedicated per-actor asyncio event loop thread, with
``max_concurrency`` bounding in-flight coroutines (reference semantics:
``python/ray/actor.py`` async execution — calls START in submission
order and may interleave at awaits). Completions landing in the same
loop iteration coalesce into one ("batch", ...) frame.
"""

from __future__ import annotations

import contextvars
import inspect
import logging
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_store import (
    ShmClient,
    _segment_name,
    create_segment,
)
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.util import tracing

# Process-level fallback: user code may spawn its OWN threads inside a
# task and call the API from them; those threads inherit the process's
# most-recent task identity (exact per-thread identity only matters for
# blocked-parent resource release under max_concurrency>1).
_TASK_FALLBACK: Dict[str, Any] = {"owner_addr": None, "task_id": b"",
                                  "actor_id": b""}

# Async-actor coroutines interleave on ONE loop thread, so their task
# identity rides a contextvar (copied per asyncio task) instead of the
# thread-local.
_CTX_TASK: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "rtpt_ctx_task", default=None)


class _TaskLocal(threading.local):
    """Per-THREAD pointer at the currently-executing task's owner
    channel — thread-local because max_concurrency>1 actors execute
    calls on a pool, and nested API calls must bind to their own
    task's identity; threads the executor never tagged fall back to
    the process-level value. Asyncio-actor calls override via the
    per-asyncio-task contextvar."""

    owner_addr = None
    task_id = b""
    actor_id = b""

    def get(self, key, default=None):
        ctx = _CTX_TASK.get()
        if ctx is not None:
            value = ctx.get(key)
            if value:
                return value
        value = getattr(self, key, None)
        if value is None or value == b"":
            value = _TASK_FALLBACK.get(key)
        return default if value is None else value


_CURRENT_TASK = _TaskLocal()


class ExecutionEnv:
    """Per-worker execution state: function cache, shm access, session."""

    def __init__(self, session: str, max_inline_bytes: int,
                 in_process: bool = False):
        self.session = session
        self.max_inline_bytes = max_inline_bytes
        self.in_process = in_process    # on a thread of the driver
        self.functions: Dict[bytes, Callable] = {}
        self.actors: Dict[bytes, Any] = {}
        self._actor_envs: Dict[bytes, Optional[dict]] = {}
        self._actor_conc: Dict[bytes, int] = {}
        # Compiled-DAG stage templates: the constant half of a stage's
        # payload, registered once at compile time so per-execute
        # messages ship only {task_id, args, return_ids, publish}.
        self.dag_stages: Dict[bytes, dict] = {}
        # Actor-call templates: the constant half of every method-call
        # payload for one actor (function_id, owner_addr, ...),
        # registered when the actor worker is leased so the per-call
        # frame ships only the varying fields ("atmpl" key).
        self.actor_templates: Dict[bytes, dict] = {}
        # Normal-task exec templates, keyed by function_id: the
        # constant half of an exec payload, shipped once per worker so
        # per-task frames carry only task_id/args/return_ids ("xt"
        # key; see node_manager._send_task).
        self.exec_templates: Dict[bytes, dict] = {}
        # actor_id -> its thread pool (max_concurrency>1 sync actors)
        self._pools: Dict[bytes, Any] = {}
        # actor_id -> _AsyncActorLoop (actors with async def methods)
        self._aloops: Dict[bytes, "_AsyncActorLoop"] = {}
        # checkpointable SERIAL actors: autosave bookkeeping per actor
        # ({root, interval, count, gen, cursor}; see _private/
        # actor_checkpoint.py). Pooled/async actors restore at creation
        # but never autosave — concurrent in-flight calls make "state
        # after N calls" ill-defined there.
        self._actor_ckpt: Dict[bytes, dict] = {}
        self.shm_client = ShmClient(session)
        self.serde = serialization.get_context()
        self.current_task_name = ""

    def merge_stage(self, payload: dict) -> dict:
        key = payload.get("stage_key")
        if key is None:
            return payload
        template = self.dag_stages.get(key)
        if template is None:
            # Stage template lost (e.g. this worker restarted after the
            # DAG was compiled): fail the ONE task with an actionable
            # error instead of KeyError-ing the whole worker loop.
            return {**payload, "type": "exec_actor",
                    "num_returns": len(payload.get("return_ids", ())),
                    "kwargs_keys": [], "name": "compiled-dag-stage",
                    "_missing_stage": True}
        return {**template, **payload}

    def merge_exec(self, payload: dict) -> dict:
        key = payload.get("xt")
        if key is None:
            return payload
        template = self.exec_templates.get(key)
        if template is None:
            # Template never arrived (should be impossible — it rides
            # the same FIFO pipe ahead of the first templated exec):
            # fail the ONE task with an actionable error instead of
            # KeyError-ing the worker loop.
            return {**payload, "type": "exec", "kwargs_keys": [],
                    "num_returns": len(payload.get("return_ids", ())),
                    "name": "exec-task", "_missing_stage": True}
        return {**template, **payload}

    def merge_actor(self, payload: dict) -> dict:
        key = payload.get("atmpl")
        if key is None:
            return payload
        template = self.actor_templates.get(key)
        if template is None:
            return {**payload, "type": "exec_actor",
                    "actor_id": key,
                    "num_returns": len(payload.get("return_ids", ())),
                    "kwargs_keys": [], "name": "actor-call",
                    "_missing_stage": True}
        merged = {**template, **payload}
        if "name" not in payload:
            merged["name"] = (f"{template.get('cls', 'Actor')}"
                              f".{payload.get('method', '?')}")
        return merged

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, op: str, body, send: Callable[[tuple], None]) -> None:
        """Route one inbound exec-family message. ``send`` must be
        thread-safe (replies may come from pool threads or an actor's
        asyncio loop). Shared by process workers (worker_main) and
        in-process workers (worker_pool.InProcessWorker)."""
        if op == "exec_actor_batch":
            payloads = [self.merge_stage(self.merge_actor(p)) for p in body]
            if not payloads:
                return
            aid = payloads[0].get("actor_id")
            aloop = self._aloops.get(aid)
            if aloop is not None:
                aloop.submit_batch(payloads, send)
                return
            conc = self._actor_conc.get(aid, 1)
            if conc > 1:
                pool = self._pool_for(aid, conc)
                for p in payloads:
                    pool.submit(
                        lambda p=p: send(self.execute(p, emit=send)))
                return
            # One reply per call AS PRODUCED. Coalescing is tempting
            # (one frame per batch) but fundamentally unsafe here:
            # execution is serial and the next call's duration is
            # unknown, so ANY withheld reply can wait an unbounded
            # time behind a slow successor (a time-bounded flush was
            # tried and still withheld a finished reply for a 3 s
            # follower — the flush check runs between calls, when no
            # time has passed yet). Reply batching lives on the async
            # loop, whose event-loop iterations make it safe.
            for p in payloads:
                send(self.execute(p, emit=send))
                # AFTER the reply ships: the owner must process a
                # call's completion before the checkpoint that covers
                # it (FIFO pipe => a commit never outruns its results)
                self._maybe_autosave(p.get("actor_id"), send)
            return
        payload = self.merge_exec(self.merge_stage(self.merge_actor(body)))
        if op == "exec_actor":
            aid = payload.get("actor_id")
            aloop = self._aloops.get(aid)
            if aloop is not None:
                aloop.submit(payload, send)
                return
            conc = self._actor_conc.get(aid, 1)
            if conc > 1:
                pool = self._pool_for(aid, conc)
                pool.submit(lambda p=payload: send(self.execute(p,
                                                                emit=send)))
                return
        send(self.execute(payload, emit=send))
        if op == "exec_actor":
            self._maybe_autosave(payload.get("actor_id"), send)

    # -- actor checkpoints (docs/fault_tolerance.md "Checkpoint
    # semantics"): runtime-driven __ray_save__ snapshots ----------------

    def _maybe_autosave(self, actor_id, send) -> None:
        if not self._actor_ckpt:     # hot-path guard: no
            return                   # checkpointable actors here
        rec = self._actor_ckpt.get(actor_id)
        if (rec is None or rec["interval"] <= 0
                or rec["count"] < rec["interval"]):
            return
        self.save_actor_checkpoint(actor_id, send)

    def save_actor_checkpoint(self, actor_id: bytes, send) -> bool:
        """Snapshot one checkpointable actor: ``__ray_save__()`` ->
        crash-atomic generation dir -> ``ckpt_saved`` notification to
        the owner (which writes the COMMIT marker — immediately for a
        solo actor, after every rank reports for a gang). Runs AFTER
        the triggering call's reply was sent. A failed snapshot is
        logged and skipped: the previous committed generation stays
        the restore point, and the interval counter resets so a
        persistently-failing __ray_save__ can't hot-loop."""
        rec = self._actor_ckpt.get(actor_id)
        instance = self.actors.get(actor_id)
        if rec is None or instance is None:
            return False
        from ray_tpu_torch._private import actor_checkpoint as _ackpt
        rec["count"] = 0
        gen = rec["gen"] + 1
        # Deferred-reply fence (see ExecutionEnv.execute): the
        # triggering call's reply must be ON THE PIPE before
        # __ray_save__ (user code, chaos-killable) runs — "completions
        # precede the covering commit" assumes the completion ships.
        flush = getattr(send, "flush_deferred", None)
        if flush is not None:
            flush()
        try:
            state = instance.__ray_save__()
            nbytes = _ackpt.save_generation(rec["root"], gen,
                                            rec["cursor"], state)
        except BaseException:  # noqa: BLE001 — user __ray_save__ code
            logger.exception("checkpoint save failed for actor %s "
                             "(gen %d); previous generation stands",
                             actor_id.hex()[:8], gen)
            return False
        rec["gen"] = gen
        if nbytes <= 0:
            return False      # chaos-dropped save: nothing to commit
        try:
            send(("ckpt_saved", actor_id,
                  {"gen": gen, "cursor": rec["cursor"],
                   "bytes": nbytes}))
        except Exception:
            # owner pipe gone: the generation sits uncommitted and a
            # restore will discard it — correct either way
            return False
        return True

    def cancel_actor_task(self, actor_id: bytes, task_id: bytes) -> None:
        """Cancel an in-flight ASYNC actor call; a no-op for sync
        actors (their calls are not interruptible — the public API
        refuses them before it gets here)."""
        aloop = self._aloops.get(actor_id)
        if aloop is not None:
            aloop.cancel(task_id)

    def _pool_for(self, actor_id: bytes, conc: int):
        # one pool PER actor sized to its declared cap — max_concurrency
        # bounds in-flight calls, it is not a boolean
        pool = self._pools.get(actor_id)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=conc)
            self._pools[actor_id] = pool
        return pool

    def shutdown_exec(self) -> None:
        """Stop per-actor execution machinery (pools + async loops)."""
        for pool in self._pools.values():
            pool.shutdown(wait=False)
        self._pools.clear()
        for aloop in self._aloops.values():
            aloop.shutdown()
        self._aloops.clear()

    @staticmethod
    def _apply_runtime_env(runtime_env: Optional[dict]) -> Callable[[], None]:
        """Apply per-task env_vars / working_dir; returns the restore
        callback (reference: runtime-env plugins applied around
        execution)."""
        if not runtime_env:
            return lambda: None
        saved_env: Dict[str, Optional[str]] = {}
        for key, value in (runtime_env.get("env_vars") or {}).items():
            saved_env[key] = os.environ.get(key)
            os.environ[key] = value
        saved_cwd = None
        wd = runtime_env.get("working_dir")
        if wd:
            saved_cwd = os.getcwd()
            os.chdir(wd)

        def restore():
            for key, old in saved_env.items():
                if old is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = old
            if saved_cwd is not None:
                os.chdir(saved_cwd)

        return restore

    # -- argument resolution ----------------------------------------------

    def resolve_args(self, arg_descs: List[tuple], kwargs_keys: List[str]
                     ) -> Tuple[list, dict]:
        values = [self._resolve_arg(d) for d in arg_descs]
        if kwargs_keys:
            n = len(kwargs_keys)
            pos, kw_vals = values[:-n], values[-n:]
            return pos, dict(zip(kwargs_keys, kw_vals))
        return values, {}

    @staticmethod
    def _get_spilled_arg(oid: bytes):
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private.worker import global_worker
        return global_worker().get([ObjectRef(ObjectID(oid))])[0]

    def _resolve_arg(self, desc: tuple):
        kind = desc[0]
        if kind == "v":  # inline serialized value
            value, _refs = self.serde.deserialize_from_blob(memoryview(desc[1]))
            return value
        if kind == "shm":  # zero-copy read from the node store
            _oid, segment_name, size = desc[1], desc[2], desc[3]
            try:
                blob = self.shm_client.read(segment_name, size)
            except FileNotFoundError:
                # The store spilled the object after this descriptor was
                # made (it spills its oldest objects, which a queued
                # task's arguments often are): get it through the owner,
                # whose store restores it.
                return self._get_spilled_arg(_oid)
            value, _refs = self.serde.deserialize_from_blob(blob)
            return value
        if kind == "dev":  # device object, on a thread of its owner's
            # process: the very tensor that was put, no host copy
            from ray_tpu_torch._private.worker import try_global_worker
            w = try_global_worker()
            value = (w.device_store.get(ObjectID(desc[1]))
                     if w is not None else None)
            if value is None:
                from ray_tpu_torch.exceptions import ObjectLostError
                raise ObjectLostError(ObjectID(desc[1]).hex())
            return value
        if kind == "owned":  # worker-owned: fetch from the owner direct
            from ray_tpu_torch._private import worker_core
            from ray_tpu_torch._private.ids import ObjectID as _OID
            return worker_core.fetch_value_from_owner(
                tuple(desc[2]), _OID(desc[1]), timeout=30.0)
        if kind == "chanp":  # compiled-DAG channel: the upstream stage
            # PUSHES its result into this consumer's core, so resolution
            # is a local cv wait — no round trip on the data path. A
            # producer failure arrives as a pushed error and re-raises.
            from ray_tpu_torch._private import worker_core
            timeout = desc[2] if len(desc) > 2 else 60.0
            return worker_core.take_channel_value(ObjectID(desc[1]),
                                                  timeout=timeout)
        raise ValueError(f"bad arg descriptor {kind!r}")

    # -- result storage ----------------------------------------------------

    def store_results(self, return_ids: List[bytes], values: tuple,
                      pre_ser=None) -> List[tuple]:
        out = []
        for oid_bytes, value in zip(return_ids, values):
            ser = pre_ser if pre_ser is not None else \
                self.serde.serialize(value)
            pre_ser = None        # only valid for the first (sole) value
            contained = [self._contained_desc(r)
                         for r in ser.contained_refs]
            size = ser.size_with_header()
            if size <= self.max_inline_bytes:
                out.append((oid_bytes, "inline", ser.to_bytes(), contained))
            else:
                oid = ObjectID(oid_bytes)
                name = _segment_name(self.session, oid)
                try:
                    seg = create_segment(name, size)
                except FileExistsError:
                    # Orphan from a previous attempt of THIS task that
                    # died after creating the segment but before the
                    # owner heard about it (had the owner adopted it,
                    # the retry would have skipped this item). Reclaim
                    # the name.
                    from multiprocessing import shared_memory
                    old = shared_memory.SharedMemory(name=name,
                                                     create=False)
                    old.unlink()
                    old.close()
                    seg = create_segment(name, size)
                try:
                    ser.write_into(seg.buf)
                finally:
                    seg.close()  # driver adopts the segment by name
                out.append((oid_bytes, "shm", (name, size), contained))
        return out

    def _contained_desc(self, r):
        """Wire item for a ref captured inside a result value. For a
        worker-owned ref, register a borrow with the owner ON BEHALF of
        the recipient before the message ships (borrow handed off with
        the message — otherwise the owner could free the object in the
        window between this task ending and the recipient pinning it).
        On a thread of the driver the message never leaves the process:
        a driver-owned ref rides in it as the live ref, which keeps the
        object alive past the task's frame until the owner has pinned it
        as contained."""
        owner = getattr(r, "_owner_addr", None)
        if owner is None:
            return r if self.in_process else r.binary()
        from ray_tpu_torch._private import worker_core
        oid = r.id() if hasattr(r, "id") else r
        worker_core.register_borrow(owner, oid)
        return (r.binary(), tuple(owner))

    # -- task execution ----------------------------------------------------

    def execute(self, payload: dict, emit=None) -> tuple:
        """Run one task payload; returns a ("done", ...) message.
        ``emit`` ships incremental ("stream", ...) messages for
        streaming generator tasks."""
        import time as _time
        from ray_tpu_torch._private import chaos
        # Deferred-reply fence: completed-but-buffered replies must
        # reach the pipe BEFORE user code (which may crash the
        # process) runs — pipe contents survive writer death, the
        # coalescer's buffer does not. Without this, a kill at the
        # next call's entry re-runs already-executed calls on replay
        # (duplicate side effects).
        flush = getattr(emit, "flush_deferred", None)
        if flush is not None:
            flush()
        # chaos kill-at-point: a `worker.exec.<task-name>:kill` rule
        # dies HERE — after the payload reached this worker, before any
        # user code ran (the mid-task worker-death failure mode).
        # armed-check inline: this is the per-task hot path.
        if chaos._plane.armed:
            chaos.fire("worker", "exec", payload.get("name", ""))
        task_id = payload["task_id"]
        t_start = _time.perf_counter()
        # Expose the owner channel + identity to nested API calls made
        # by the user function (see _private/nested_client.py).
        _CURRENT_TASK.owner_addr = payload.get("owner_addr")
        _CURRENT_TASK.task_id = task_id
        _CURRENT_TASK.actor_id = payload.get("actor_id") or b""
        _TASK_FALLBACK["owner_addr"] = payload.get("owner_addr")
        _TASK_FALLBACK["task_id"] = task_id
        _TASK_FALLBACK["actor_id"] = payload.get("actor_id") or b""
        try:
            if payload.get("_missing_stage"):
                raise RuntimeError(
                    "compiled-DAG stage template missing (the actor's "
                    "worker restarted after compilation); recompile "
                    "the DAG with experimental_compile()")
            fn = self._get_callable(payload)
            args, kwargs = self.resolve_args(payload["args"],
                                             payload["kwargs_keys"])
            self.current_task_name = payload.get("name", "")
            restore_env = self._apply_runtime_env(
                payload.get("runtime_env"))
            try:
                if payload["type"] == "create_actor":
                    instance = fn(*args, **kwargs)
                    aid = payload["actor_id"]
                    # Restore-before-replay: a checkpointable actor
                    # (re)starting loads its newest COMMITTED snapshot
                    # HERE — after __init__, before any queued call can
                    # reach it (the owner flushes only once actor_ready
                    # lands). Restore failure falls back one committed
                    # generation; exhausting them fails the creation.
                    restore_info = None
                    is_async = _has_async_methods(instance)
                    from ray_tpu_torch._private import (
                        actor_checkpoint as _ackpt)
                    if _ackpt.is_checkpointable(instance):
                        root = _ackpt.actor_ckpt_dir(self.session, aid)
                        restore_info = _ackpt.restore_instance(
                            root, instance)
                        if payload.get("max_concurrency", 1) <= 1 \
                                and not is_async:
                            gens = _ackpt.list_generations(root)
                            self._actor_ckpt[aid] = {
                                "root": root,
                                "interval": payload.get(
                                    "checkpoint_interval", 0),
                                "count": 0,
                                "gen": max((g for g, _ok in gens),
                                           default=0),
                                "cursor": restore_info["cursor"],
                            }
                    self.actors[aid] = instance
                    # actors keep their runtime_env for their lifetime
                    self._actor_envs[aid] = payload.get("runtime_env")
                    conc = payload.get("max_concurrency", 1)
                    self._actor_conc[aid] = conc
                    if is_async:
                        # async actor: a dedicated event loop executes
                        # every call; max_concurrency caps in-flight
                        # coroutines (reference async-actor semantics).
                        self._aloops[aid] = _AsyncActorLoop(
                            self, aid, max(1, conc))
                    return ("actor_ready", aid, None, restore_info)
                if payload["type"] == "exec_actor":
                    instance = self.actors[payload["actor_id"]]
                    method = getattr(instance, payload["method"])
                    call = lambda: method(*args, **kwargs)  # noqa: E731
                else:
                    call = lambda: fn(*args, **kwargs)      # noqa: E731
                # Per-task device-time attribution: inside a torch
                # profiler capture, ops this task launches appear under
                # its name in the trace.
                result = self._with_trace_annotation(
                    payload.get("name", "task"), call)
                pre_ser = None
                if payload.get("streaming"):
                    return self._drain_generator(payload, result, emit)
                if payload.get("publish"):
                    pre_ser = self.serde.serialize(result)
                    self._publish_channels(payload["publish"],
                                           pre_ser.to_bytes())
            finally:
                if payload["type"] != "create_actor":
                    restore_env()
            n = payload["num_returns"]
            values = (result,) if n == 1 else tuple(result) if n > 0 else ()
            if n > 1 and len(values) != n:
                raise ValueError(
                    f"task declared num_returns={n} but returned "
                    f"{len(values)} values")
            # pre_ser: a terminal stage that also feeds channels reuses
            # the channel serialization instead of re-serializing.
            results = self.store_results(payload["return_ids"], values,
                                         pre_ser=pre_ser if n == 1 else
                                         None)
            # exec_ms includes result serialization, which forces any
            # pending device work — for tensor-returning GPU tasks this
            # is wall time INCLUDING device compute.
            return ("done", task_id, results, None,
                    {"exec_ms": 1e3 * (_time.perf_counter() - t_start)})
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, task_repr=payload.get("name", "?"),
                            traceback_str=traceback.format_exc())
            try:
                blob = self.serde.serialize(err).to_bytes()
            except Exception:
                blob = self.serde.serialize(
                    TaskError(None, payload.get("name", "?"),
                              traceback.format_exc())).to_bytes()
            if payload.get("publish"):
                # Unblock downstream channel consumers with the failure
                # instead of letting them time out.
                try:
                    self._publish_channels(payload["publish"], blob,
                                           kind="err")
                except Exception:
                    pass    # channel consumer gone: error already
                            # travels through the task reply
            # Failed before consuming our own channel args? Drain what
            # arrived so pushed entries / producer segments don't leak.
            try:
                from ray_tpu_torch._private import worker_core
                worker_core.drain_channel_args(payload.get("args"))
            except Exception:
                pass    # drain is itself best-effort leak hygiene
            if payload["type"] == "create_actor":
                return ("actor_ready", payload["actor_id"], blob, None)
            return ("done", task_id, [], blob,
                    {"exec_ms": 1e3 * (_time.perf_counter() - t_start)})
        finally:
            # empty-dict guard first: workers without checkpointable
            # actors must pay ~nothing here (dispatch hot path)
            if self._actor_ckpt and payload.get("type") == "exec_actor":
                # Advance the checkpoint cursor/interval for the call
                # that just ran (success or user error — either way it
                # will never be replayed, so the snapshot may cover it).
                rec = self._actor_ckpt.get(payload.get("actor_id"))
                if rec is not None:
                    rec["cursor"] = max(rec["cursor"],
                                        int(payload.get("seq") or 0))
                    rec["count"] += 1
            # Clear identity the moment user code is done — BEFORE the
            # reply is sent — so a targeted cancel SIGINT landing in
            # the send window can't match this finished task and kill
            # the worker. Guarded: pool threads running other calls
            # must not have their fallback clobbered.
            if getattr(_CURRENT_TASK, "task_id", b"") == task_id:
                _CURRENT_TASK.task_id = b""
            if _TASK_FALLBACK.get("task_id") == task_id:
                _TASK_FALLBACK["task_id"] = b""

    async def execute_async(self, payload: dict, emit=None) -> tuple:
        """Async-actor variant of ``execute``: runs ON the actor's event
        loop thread; awaits coroutine results and drains async
        generators for streaming calls. Sync methods of an async actor
        also run here (they hold the loop while executing — reference
        async-actor semantics). Returns the ("done", ...) reply."""
        import asyncio
        import time as _time
        from ray_tpu_torch._private import chaos
        # Same kill-at-exec-entry point as the sync path: async actors
        # (serve replicas, asyncio deployments) would otherwise be
        # unreachable by `worker.exec.<name>:kill` rules. Flush any
        # deferred replies first — completed-but-buffered replies must
        # outlive a kill here, or replay re-runs their calls.
        flush = getattr(emit, "flush_deferred", None)
        if flush is not None:
            flush()
        if chaos._plane.armed:
            chaos.fire("worker", "exec", payload.get("name", ""))
        task_id = payload["task_id"]
        t_start = _time.perf_counter()
        # Task identity rides the per-asyncio-task context: coroutines
        # interleave on one thread, so a thread-local would leak one
        # call's identity into another across awaits.
        _CTX_TASK.set({"owner_addr": payload.get("owner_addr"),
                       "task_id": task_id,
                       "actor_id": payload.get("actor_id") or b""})
        try:
            if payload.get("_missing_stage"):
                raise RuntimeError(
                    "actor-call template missing (the actor's worker "
                    "restarted mid-stream); retry the call")
            instance = self.actors[payload["actor_id"]]
            method = getattr(instance, payload["method"])
            args, kwargs = self.resolve_args(payload["args"],
                                             payload["kwargs_keys"])
            self.current_task_name = payload.get("name", "")
            result = method(*args, **kwargs)
            if payload.get("streaming"):
                return await self._drain_async_generator(payload, result,
                                                         emit)
            if inspect.isawaitable(result):
                result = await result
            pre_ser = None
            if payload.get("publish"):
                pre_ser = self.serde.serialize(result)
                self._publish_channels(payload["publish"],
                                       pre_ser.to_bytes())
            n = payload["num_returns"]
            values = (result,) if n == 1 else tuple(result) if n > 0 else ()
            if n > 1 and len(values) != n:
                raise ValueError(
                    f"task declared num_returns={n} but returned "
                    f"{len(values)} values")
            results = self.store_results(payload["return_ids"], values,
                                         pre_ser=pre_ser if n == 1 else
                                         None)
            return ("done", task_id, results, None,
                    {"exec_ms": 1e3 * (_time.perf_counter() - t_start)})
        except asyncio.CancelledError:
            # actor shutting down mid-call: no reply — the owner fails
            # the task through worker-death handling
            raise
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, task_repr=payload.get("name", "?"),
                            traceback_str=traceback.format_exc())
            try:
                blob = self.serde.serialize(err).to_bytes()
            except Exception:
                blob = self.serde.serialize(
                    TaskError(None, payload.get("name", "?"),
                              traceback.format_exc())).to_bytes()
            if payload.get("publish"):
                try:
                    self._publish_channels(payload["publish"], blob,
                                           kind="err")
                except Exception:
                    pass    # channel consumer gone: error already
                            # travels through the task reply
            return ("done", task_id, [], blob,
                    {"exec_ms": 1e3 * (_time.perf_counter() - t_start)})

    async def _drain_async_generator(self, payload: dict, result, emit
                                     ) -> tuple:
        """Streaming drain for async actors: accepts an async generator,
        a plain generator, or an awaitable resolving to either."""
        if inspect.isawaitable(result):
            result = await result
        if inspect.isgenerator(result):
            return self._drain_generator(payload, result, emit)
        if not inspect.isasyncgen(result):
            raise TypeError(
                "num_returns='streaming' requires the method to return "
                f"a generator or async generator, got "
                f"{type(result).__name__}")
        task_id = payload["task_id"]
        tid = TaskID(task_id)
        count = 0
        skip = payload.get("stream_skip", 0)
        async for item in result:
            count += 1
            if count <= skip:
                continue
            oid_b = ObjectID.from_index(tid, count + 1).binary()
            stored = self.store_results([oid_b], (item,))
            if emit is not None:
                emit(("stream", task_id, stored))
        done = self.store_results([payload["return_ids"][0]], (count,))
        return ("done", task_id, done, None)

    @staticmethod
    def _with_trace_annotation(name: str, call):
        """Run the user call inside ``tracing.span(name)``: while a
        ``torch.profiler`` capture runs in this worker, a span and a
        ``record_function`` of the task's name; otherwise one flag
        check (and no torch import)."""
        with tracing.span(name):
            return call()

    @staticmethod
    def _publish_channels(pubs, blob: bytes, kind: str = "blob") -> None:
        """Push one serialized result to each pre-arranged consumer core
        (the driver is not in the handoff). Channel values containing
        ObjectRefs rely on prompt consumer-side borrow registration via
        the deserialize hook — pass arrays/values, not ref graphs."""
        from ray_tpu_torch._private import worker_core
        for oid_b, consumers in pubs:
            worker_core.push_channel_value(ObjectID(oid_b), blob, kind,
                                           consumers)

    def _drain_generator(self, payload: dict, result, emit) -> tuple:
        """Streaming task: store + emit each yielded item as it lands;
        the final ("done", ...) carries the item count in the
        completion-marker object (return index 1; items take 2..)."""
        import inspect
        task_id = payload["task_id"]
        if not inspect.isgenerator(result):
            raise TypeError(
                "num_returns='streaming' requires the task to return a "
                f"generator, got {type(result).__name__}")
        tid = TaskID(task_id)
        count = 0
        # Retry resume: the owner already holds the first ``stream_skip``
        # items — drain past them without re-storing (their segments
        # exist and are owned elsewhere; re-creating them would collide).
        skip = payload.get("stream_skip", 0)
        for item in result:
            count += 1
            if count <= skip:
                continue
            oid_b = ObjectID.from_index(tid, count + 1).binary()
            stored = self.store_results([oid_b], (item,))
            if emit is not None:
                emit(("stream", task_id, stored))
        done = self.store_results([payload["return_ids"][0]], (count,))
        return ("done", task_id, done, None)

    def _get_callable(self, payload: dict) -> Callable:
        fid = payload["function_id"]
        fn = self.functions.get(fid)
        if fn is None:
            raise RuntimeError(f"function {fid.hex()} not cached on worker")
        return fn

    def cache_function(self, function_id: bytes, blob: bytes) -> None:
        import cloudpickle
        self.functions[function_id] = cloudpickle.loads(blob)


def cancel_target_path(session: str, pid: int) -> str:
    from ray_tpu_torch._private.session_dir import session_dir
    return session_dir(session, f"cancel_{pid}")


def write_cancel_target(session: str, pid: int,
                        task_id: bytes) -> None:
    """Record WHICH task a cancellation SIGINT is aimed at before
    signaling: the worker's handler compares it against the task it is
    actually running, so a signal that raced the target's completion
    cannot interrupt an innocent successor task."""
    path = cancel_target_path(session, pid)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(task_id.hex())
    os.replace(tmp, path)


def _has_async_methods(instance) -> bool:
    """True if any public method of the actor is ``async def`` (plain
    coroutine or async generator) — the trigger for the async-actor
    runtime. Inspects the CLASS, never the instance: instance getattr
    would execute property/descriptor getters during create_actor."""
    cls = type(instance)
    for name in dir(cls):
        if name.startswith("_"):
            continue
        m = inspect.getattr_static(cls, name, None)
        if isinstance(m, (staticmethod, classmethod)):
            m = m.__func__
        if m is not None and (inspect.iscoroutinefunction(m)
                              or inspect.isasyncgenfunction(m)):
            return True
    return False


class _AsyncActorLoop:
    """Per-actor asyncio event-loop thread: the async-actor runtime.

    Calls START in submission order (call_soon_threadsafe preserves the
    dispatch thread's order; so does create_task) and up to
    ``concurrency`` coroutines run interleaved; the rest queue on a
    FIFO semaphore. Completed-call replies landing in the same loop
    iteration coalesce into one ("batch", ...) frame back to the owner
    (the batched completion half of the hot wire path).
    """

    def __init__(self, env: ExecutionEnv, actor_id: bytes,
                 concurrency: int):
        import asyncio
        self._env = env
        self._actor_id = actor_id
        self._concurrency = concurrency
        self.loop = asyncio.new_event_loop()
        self._sem: Optional["asyncio.Semaphore"] = None
        self._inflight: Dict[bytes, "asyncio.Task"] = {}
        # insertion-ordered pre-arrival cancel markers (dict-as-set:
        # oldest-first eviction under the stale-entry bound)
        self._cancelled: Dict[bytes, None] = {}
        self._buf: list = []
        self._flush_scheduled = False
        self._send: Optional[Callable[[tuple], None]] = None
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"rtpu-async-actor-{actor_id[:4].hex()}")
        self._thread.start()
        self._started.wait(5)

    def _run(self) -> None:
        import asyncio
        asyncio.set_event_loop(self.loop)
        self._sem = asyncio.Semaphore(self._concurrency)
        self.loop.call_soon(self._started.set)
        try:
            self.loop.run_forever()
        finally:
            # Cancellation-on-kill: anything still in flight is
            # cancelled so the process/thread can exit; the owner fails
            # those tasks through actor-death handling.
            try:
                tasks = asyncio.all_tasks(self.loop)
                for t in tasks:
                    t.cancel()
                if tasks:
                    self.loop.run_until_complete(
                        asyncio.gather(*tasks, return_exceptions=True))
            except Exception:
                pass    # loop already closing: cancellation is moot
            self.loop.close()

    def submit(self, payload: dict, send: Callable[[tuple], None]) -> None:
        self.submit_batch([payload], send)

    def submit_batch(self, payloads: List[dict],
                     send: Callable[[tuple], None]) -> None:
        """One loop wakeup per inbound frame, however many calls it
        carries."""
        self._send = send
        try:
            self.loop.call_soon_threadsafe(self._start_batch, payloads)
        except RuntimeError:
            # loop already closed (actor shutting down): the owner
            # fails these tasks via worker/actor-death handling
            pass

    def _start_batch(self, payloads: List[dict]) -> None:
        for p in payloads:
            task = self.loop.create_task(self._call(p))
            self._inflight[p["task_id"]] = task
            if p["task_id"] in self._cancelled:
                # the cancel RACED AHEAD of the call frame (owner-side
                # queue flush vs cancel delivery): honor it on arrival.
                # DEFERRED past the coroutine's first step — cancelling
                # a never-started coroutine skips _call's body entirely,
                # so no reply would ever reach the owner (hung ref).
                self._cancelled.pop(p["task_id"], None)
                self.loop.call_soon(task.cancel)

    def cancel(self, task_id: bytes) -> None:
        """Cancel one in-flight call via asyncio cancellation
        (reference: ray.cancel on async-actor tasks). Queued calls
        (semaphore waiters) cancel immediately; a running coroutine
        gets CancelledError at its next await point; a cancel arriving
        BEFORE its call frame is remembered and applied on arrival.
        Thread-safe."""
        def _do():
            task = self._inflight.get(task_id)
            if task is not None:
                # deferred for the same never-started-coroutine reason
                # as in _start_batch
                self.loop.call_soon(task.cancel)
                return
            while len(self._cancelled) > 4096:
                # bound stale markers by evicting the OLDEST — a
                # wholesale clear would drop live racing cancels too
                self._cancelled.pop(next(iter(self._cancelled)), None)
            self._cancelled[task_id] = None
        try:
            self.loop.call_soon_threadsafe(_do)
        except RuntimeError:
            pass   # loop closed: actor already dying

    async def _call(self, payload: dict) -> None:
        try:
            async with self._sem:
                # blocking-ok: _sem is the actor's concurrency
                # limiter — a chaos delay sleeping under it occupies
                # a slot exactly like a slow user method would; that
                # IS the injected fault
                reply = await self._env.execute_async(payload,
                                                      emit=self._emit)
        except BaseException as e:   # noqa: BLE001 — incl. CancelledError
            err = TaskError(e, payload.get("name", "?"),
                            f"{type(e).__name__}: {e}")
            reply = ("done", payload["task_id"], [],
                     self._env.serde.serialize(err).to_bytes(), None)
        finally:
            self._inflight.pop(payload["task_id"], None)
        self._buf.append(reply)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self.loop.call_soon(self._flush)

    def _emit(self, msg: tuple) -> None:
        # stream items ship immediately (latency over batching); reply
        # ordering vs the final done is preserved by the shared send
        send = self._send
        if send is not None:
            send(msg)

    def _flush(self) -> None:
        self._flush_scheduled = False
        buf, self._buf = self._buf, []
        send = self._send
        if not buf or send is None:
            return
        send(buf[0] if len(buf) == 1 else ("batch", buf))

    def shutdown(self) -> None:
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            pass


class _ReplyCoalescer:
    """Worker-side completion batching: deferred replies ('done',
    'stream') buffer under the send lock and ship as one
    ('batch', [...]) frame — one pickle + one pipe write for a burst
    of completions instead of one per task. Three flush triggers:

    - size: ``worker_reply_flush_max`` buffered replies;
    - idle: the main loop flushes when its intake runs dry (a serial
      round trip pays ~zero added latency);
    - deadline: a daemon flusher ships anything older than
      ``worker_reply_flush_ms`` — the bound that makes deferral safe
      even when a finished reply sits behind an arbitrarily slow
      successor task (the failure mode that forbids coalescing
      inline on the serial-actor execution path).

    Urgent sends (control replies) flush the buffer ahead of
    themselves, so the peer observes exactly the send order.
    """

    def __init__(self, conn, send_lock: threading.Lock):
        from ray_tpu_torch._private.config import get_config
        cfg = get_config()
        self._conn = conn
        self._lock = send_lock
        self._buf: list = []  # guarded-by: _lock (bounded by _max)
        self._flush_s = max(0.0, cfg.worker_reply_flush_ms / 1000.0)
        self._max = max(1, cfg.worker_reply_flush_max)
        self._armed = threading.Event()
        if self._flush_s > 0:
            threading.Thread(target=self._deadline_loop, daemon=True,
                             name="rtpu-worker-flush").start()

    def send(self, reply, defer: bool = False) -> None:
        if not defer or self._flush_s <= 0:
            with self._lock:
                self._flush_locked()
                self._conn.send(reply)
            return
        with self._lock:
            self._buf.append(reply)
            if len(self._buf) >= self._max:
                self._flush_locked()
            elif len(self._buf) == 1:
                self._armed.set()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:  # lock-held: _lock
        buf = self._buf
        if not buf:
            return
        self._buf = []
        self._conn.send(buf[0] if len(buf) == 1 else ("batch", buf))

    def _deadline_loop(self) -> None:
        # no-deadline: daemon flusher; each pass blocks on the arm
        # event, then bounds buffered replies' age by one flush window
        while True:
            self._armed.wait()
            self._armed.clear()
            time.sleep(self._flush_s)
            try:
                self.flush()
            except (OSError, ValueError):
                return      # pipe gone: the worker is shutting down


def worker_main(conn, session: str, max_inline_bytes: int,
                env_vars: Optional[dict] = None) -> None:
    """Message loop of a process worker (conn already registered).

    Execution routing lives in ``ExecutionEnv.dispatch``: sync actors
    with ``max_concurrency > 1`` run on a per-actor thread pool
    (ordering across in-flight calls not guaranteed — threaded-actor
    semantics), async actors on a per-actor event loop, everything else
    on this loop thread. All sends share one lock — Connection.send is
    not thread-safe.
    """
    if env_vars:
        os.environ.update(env_vars)

    from ray_tpu_torch._private import chaos
    chaos.maybe_arm()
    chaos.fire("worker", "boot")

    if os.environ.get("RTPU_WORKER_PROFILE"):
        # Debug: cProfile this worker's whole loop, dumped at exit —
        # the worker-side complement of `ray_tpu_torch stack` sampling.
        import atexit
        import cProfile
        _prof = cProfile.Profile()
        _prof.enable()

        def _dump_profile():
            _prof.disable()
            path = (f"{os.environ['RTPU_WORKER_PROFILE']}."
                    f"{os.getpid()}.pstats")
            _prof.dump_stats(path)
        atexit.register(_dump_profile)

    from ray_tpu_torch._private import worker_core
    worker_core.configure(session, max_inline_bytes)
    env = ExecutionEnv(session, max_inline_bytes)
    send_lock = threading.Lock()
    coalescer = _ReplyCoalescer(conn, send_lock)

    # Completion coalescing (data-plane fast path, layer 2, worker
    # half): 'done'/'stream' replies buffer and leave as one
    # ('batch', ...) frame — flushed when the intake runs dry, the
    # deadline passes, or the buffer fills. Control replies (stolen,
    # actor_ready, ...) flush the buffer ahead of themselves, so
    # global reply order is exactly the send order.
    def send(reply) -> None:
        coalescer.send(reply, defer=reply[0] in ("done", "stream"))

    # Pre-user-code fence consulted by ExecutionEnv (execute /
    # save_actor_checkpoint): deferral must never hold a completed
    # reply across a crashable user-code boundary.
    send.flush_deferred = coalescer.flush

    # On-demand stack dumps MUST work while the loop thread is busy
    # executing a task (that is when you want them), so the request
    # arrives as SIGUSR1 — not a pipe message the busy loop would never
    # read. The handler only sets an event; a dedicated responder
    # thread does the dump + send (signal handlers can't take the send
    # lock safely).
    _stack_req = threading.Event()

    def _respond_stacks() -> None:
        from ray_tpu_torch._private.profiling import dump_all_stacks
        while True:
            _stack_req.wait()
            _stack_req.clear()
            try:
                send(("stacks", dump_all_stacks()))
            except Exception:
                return
    try:
        import signal as _signal
        _signal.signal(_signal.SIGUSR1,
                       lambda *_a: _stack_req.set())
        threading.Thread(target=_respond_stacks, daemon=True,
                         name="rtpu-stack-responder").start()
    except (ValueError, OSError):
        pass    # non-main thread / exotic platform: pipe path only

    # Targeted cancellation: SIGINT only interrupts the task it was
    # aimed at (the sender writes the target's id first). A signal
    # racing the target's completion finds a different current task and
    # is dropped instead of failing an innocent successor.
    _cancel_path = cancel_target_path(session, os.getpid())

    def _on_sigint(signum, frame):
        target = None
        try:
            with open(_cancel_path) as f:
                target = f.read().strip()
            # one-shot marker: consume it, or a stale target would
            # silently swallow every later non-cancel SIGINT
            os.unlink(_cancel_path)
        except OSError:
            pass
        if target:
            # The handler runs on the MAIN thread, so its thread-local
            # names the task the signal would actually interrupt; the
            # process-wide fallback (which pool threads overwrite)
            # is only consulted when the local is unset.
            current = (getattr(_CURRENT_TASK, "task_id", b"")
                       or _TASK_FALLBACK.get("task_id") or b"")
            cur_hex = (current.hex() if isinstance(current, bytes)
                       else str(current))
            if target != cur_hex:
                return          # aimed at a task that already finished
        raise KeyboardInterrupt

    try:
        import signal as _signal
        _signal.signal(_signal.SIGINT, _on_sigint)
    except (ValueError, OSError):
        pass

    # Inbound frames flow through an intake thread into ``inbox`` so
    # the owner can STEAL back pipelined tasks that are queued behind a
    # long/blocked task (lease pipelining would otherwise deadlock a
    # parent blocked on a child queued on its own pipe). The intake
    # thread answers ("steal", ids) immediately — removing still-queued
    # exec payloads — even while the main loop is deep in user code.
    from collections import deque as _deque
    inbox: "_deque" = _deque()
    inbox_lock = threading.Lock()
    inbox_evt = threading.Event()
    conn_closed = [False]
    # Steal targets the intake could NOT find (task_id -> deadline):
    # the steal frame beat the exec frame onto the pipe (the owner's
    # per-tick exec_batch buffer had not flushed yet). When the exec
    # finally lands, drop it and answer stolen — a cancelled pipelined
    # task must NEVER run. Rescue-steal entries expire: a miss can
    # also mean the task was already executing (it completes
    # normally), and a rescued task may legitimately be re-dispatched
    # here later. CANCEL-steal entries (deadline None) never expire —
    # a cancelled task id is never legitimately re-sent, and expiry
    # would re-open the race for an exec frame delayed past the TTL;
    # a size cap bounds the pathological-miss case instead.
    pending_steal: dict = {}
    PENDING_STEAL_TTL_S = 10.0
    PENDING_STEAL_STICKY_CAP = 256
    # pop() default distinguishable from the sticky entries' None VALUE
    # — `pop(tid, None) is not None` would read every sticky entry as
    # absent and silently destroy it
    _PENDING_MISSING = object()

    def _expire_pending_steals() -> None:
        # inbox_lock held
        now = time.monotonic()
        for tid in [t for t, dl in pending_steal.items()
                    if dl is not None and dl < now]:
            del pending_steal[tid]
        sticky = [t for t, dl in pending_steal.items() if dl is None]
        for tid in sticky[:-PENDING_STEAL_STICKY_CAP]:
            del pending_steal[tid]    # oldest first (insertion order)

    def _intercept_stolen_exec(payload: dict) -> bool:
        # inbox_lock held; True -> payload consumed (answer stolen)
        _expire_pending_steals()
        return (pending_steal.pop(payload["task_id"], _PENDING_MISSING)
                is not _PENDING_MISSING)

    def _intake() -> None:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                conn_closed[0] = True
                inbox_evt.set()
                return
            op0 = msg[0]
            if op0 == "steal":
                wanted = set(msg[1])
                # third element marks a targeted CANCEL steal: its
                # misses are recorded sticky (no TTL)
                is_cancel = len(msg) > 2 and msg[2]
                taken = []
                with inbox_lock:
                    kept = []
                    for m in inbox:
                        if m[0] == "exec" and m[1]["task_id"] in wanted:
                            taken.append(m[1]["task_id"])
                        else:
                            kept.append(m)
                    inbox.clear()
                    inbox.extend(kept)
                    deadline = (None if is_cancel else
                                time.monotonic() + PENDING_STEAL_TTL_S)
                    for tid in wanted:
                        if tid in taken:
                            continue
                        if pending_steal.get(tid, 0) is None:
                            continue    # never downgrade a sticky
                                        # cancel entry to a TTL one
                        pending_steal[tid] = deadline
                try:
                    # third element: the ids this reply COVERS — the
                    # owner sweeps its cancel-steal targets only for
                    # requests actually answered (a reply to an earlier
                    # unrelated steal must not pop a target whose own
                    # steal is still in flight)
                    send(("stolen", taken, list(wanted)))
                except Exception:
                    return
                continue
            if op0 == "cancel_actor_task":
                # Async-actor call cancellation: handled at intake (the
                # main loop may be busy) — the actor's event loop
                # cancels the asyncio task at its next await point.
                try:
                    env.cancel_actor_task(msg[1], msg[2])
                except Exception:
                    pass    # unknown/finished call: nothing to cancel
                continue
            stolen_late = []
            if op0 == "exec_batch":
                # flatten so individual queued tasks stay stealable
                with inbox_lock:
                    for p in msg[1]:
                        if _intercept_stolen_exec(p):
                            stolen_late.append(p["task_id"])
                        else:
                            inbox.append(("exec", p))
            elif op0 == "exec":
                with inbox_lock:
                    if _intercept_stolen_exec(msg[1]):
                        stolen_late.append(msg[1]["task_id"])
                    else:
                        inbox.append(msg)
            else:
                with inbox_lock:
                    inbox.append(msg)
            if stolen_late:
                try:
                    send(("stolen", stolen_late, list(stolen_late)))
                except Exception:
                    return
            inbox_evt.set()

    threading.Thread(target=_intake, daemon=True,
                     name="rtpu-worker-intake").start()

    try:
        while True:
            with inbox_lock:
                msg = inbox.popleft() if inbox else None
            if msg is None:
                if conn_closed[0]:
                    break
                try:
                    # intake ran dry: ship whatever completions are
                    # buffered before blocking (the idle-flush trigger)
                    coalescer.flush()
                except (OSError, ValueError):
                    break       # pipe gone: owner hung up
                try:
                    inbox_evt.wait(timeout=1.0)
                    inbox_evt.clear()
                except KeyboardInterrupt:
                    # A cancellation SIGINT that raced the task's own
                    # completion lands here while idle: the cancel was
                    # for work that already finished — keep serving.
                    pass
                continue
            op = msg[0]
            if op == "shutdown":
                break
            elif op == "func":
                env.cache_function(msg[1], msg[2])
            elif op == "dag_stage":
                env.dag_stages[msg[1]] = msg[2]
            elif op == "actor_tmpl":
                env.actor_templates[msg[1]] = msg[2]
            elif op == "exec_tmpl":
                env.exec_templates[msg[1]] = msg[2]
            elif op in ("exec", "create_actor", "exec_actor",
                        "exec_actor_batch"):
                try:
                    env.dispatch(op, msg[1], send)
                except KeyboardInterrupt:
                    # A cancel SIGINT that slipped past execute()'s
                    # handlers (landed between user code finishing and
                    # the reply send): the target already completed —
                    # keep serving instead of killing the worker and
                    # every other in-flight task on it.
                    pass
                finally:
                    if op == "exec":
                        # the cancellation-SIGINT guard compares
                        # against this marker: once the task is done
                        # (reply sent), a late signal must find NO
                        # current task, not the finished one's id
                        _TASK_FALLBACK["task_id"] = b""
            elif op == "ckpt_save":
                # save-NOW (autoscaler drain): same snapshot + commit
                # path as the interval autosave; a non-checkpointable
                # actor is a no-op and the owner's commit poll times out
                try:
                    env.save_actor_checkpoint(msg[1], send)
                except Exception:
                    logger.exception("ckpt_save failed")
            elif op == "core_addr":
                # Compiled-DAG channel binding: report this process's
                # owner-core address (creates the core on first ask).
                send(("core_addr",
                      worker_core.get_worker_core().address))
            elif op == "dump_stacks":
                # on-demand host-side profiling (py-spy role)
                from ray_tpu_torch._private.profiling import dump_all_stacks
                send(("stacks", dump_all_stacks()))
            elif op == "ping":
                send(("pong",))
    finally:
        try:
            # graceful shutdown: completed-but-buffered replies must
            # reach the owner before the pipe closes
            coalescer.flush()
        except Exception:
            pass    # pipe already gone: owner handles via worker death
        env.shutdown_exec()
        env.shm_client.close()
        core = worker_core.try_worker_core()
        if core is not None:
            # Owner death: objects this process owns die with it
            # (ownership is not replicated) — unlink their segments.
            core.shutdown()
        try:
            conn.close()
        except Exception:
            pass    # owner side already hung up


def _standalone_main() -> None:
    """``python -m ray_tpu_torch._private.worker_process`` entry: connect back
    to the node's hub socket and serve tasks."""
    import argparse

    from multiprocessing.connection import Client

    # A stack-dump SIGUSR1 can arrive the moment the hub registration
    # lands — BEFORE worker_main installs the real handler. The default
    # disposition would terminate the starting worker; ignore until the
    # real handler takes over.
    try:
        import signal as _signal
        _signal.signal(_signal.SIGUSR1, _signal.SIG_IGN)
    except (ValueError, OSError):
        pass

    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True)
    parser.add_argument("--token", required=True)
    parser.add_argument("--session", required=True)
    parser.add_argument("--max-inline", type=int, required=True)
    args = parser.parse_args()

    from ray_tpu_torch._private.connection_hub import hub_socket_address
    conn = Client(hub_socket_address(args.address), "AF_UNIX")
    conn.send(("register", args.token, os.getpid()))
    worker_main(conn, args.session, args.max_inline)


if __name__ == "__main__":
    _standalone_main()

