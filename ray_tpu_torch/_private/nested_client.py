"""Nested-call client: the public API inside task/actor workers.

Reference: every Ray worker embeds a full CoreWorker, so user code can
call ``ray.remote/get/put/wait`` from anywhere [UNVERIFIED — mount
empty, SURVEY.md §0]. Split ownership model (round 3):

- **Objects this worker creates (`put`) are OWNED HERE** — stored in
  the process's ``WorkerCore`` (``_private/worker_core.py``), counted
  here, served to peers owner-direct. The driver is not in the data
  path of a worker→worker handoff, and owner death loses the objects
  (reference semantics).
- **Task/actor submission and task returns** ride the driver's
  nested-API handlers (``Worker._register_nested_handlers``): the
  driver is this framework's scheduling plane by design
  (ARCHITECTURE.md §2), and return-object ownership stays with it.

Deadlock avoidance: a nested ``get`` against the driver reports the
calling task's id; the owner releases that task's CPU allocation and
lends its node one extra worker slot while the parent blocks (the
reference's CPU-release-while-blocked).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task_spec import FunctionDescriptor, TaskOptions
from ray_tpu_torch.exceptions import (
    BackpressureError,
    GetTimeoutError,
    TaskError,
)

# Deadlines on the nested control protocol (retry-discipline): these
# are owner round trips that answer promptly on a live driver — only
# nested_get/nested_wait block on object readiness, and they compute
# their own user-timeout-derived deadlines. _SHIP covers calls that
# carry function/object blobs (serialization + transfer time).
_CONTROL_TIMEOUT = 60.0
_SHIP_TIMEOUT = 300.0

_SHIPPED_OPTION_FIELDS = (
    "num_cpus", "num_tpus", "num_gpus", "memory", "resources",
    "num_returns", "max_retries", "name", "scheduling_strategy",
    "placement_group", "placement_group_bundle_index")
_SHIPPED_ACTOR_FIELDS = _SHIPPED_OPTION_FIELDS + (
    "max_restarts", "max_task_retries", "max_concurrency", "namespace",
    "get_if_exists", "lifetime")


class _NoopRefCounter:
    """Ref lifetime of nested borrows is pinned owner-side."""

    def add_local_reference(self, oid) -> None:
        pass

    def remove_local_reference(self, oid) -> None:
        pass


class NestedClient:
    """Duck-type of the Worker surface the public API uses."""

    def __init__(self, owner_addr: Tuple[str, int]):
        from ray_tpu_torch._private.rpc import RpcClient
        self._client = RpcClient(tuple(owner_addr))
        self.serde = serialization.get_context()
        self.reference_counter = _NoopRefCounter()
        self.session = f"nested-{owner_addr[1]}"
        from ray_tpu_torch._private.ids import JobID
        self.job_id = JobID.from_int(1)    # pg-id minting (random suffix)
        self._fn_lock = threading.Lock()
        self._shipped_fids: set = set()
        self._fn_blobs: Dict[bytes, bytes] = {}
        from ray_tpu_torch._private.backoff import make_rng
        self._bp_lock = threading.Lock()
        self._bp_rng = make_rng()  # guarded-by: _bp_lock

    def _backpressured_call(self, method: str, *args,
                            timeout: float):
        """One logical owner call that honors shed replies: a
        BackpressureError (RESOURCE_EXHAUSTED frame) re-sends after a
        jittered exponential backoff, all inside ``timeout``."""
        from ray_tpu_torch._private.backoff import jittered, next_backoff
        from ray_tpu_torch._private.config import get_config
        cfg = get_config()
        deadline = time.monotonic() + timeout
        base = cfg.backpressure_retry_base_ms / 1000.0
        cap = cfg.backpressure_retry_max_ms / 1000.0
        delay = 0.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise BackpressureError(
                    f"owner kept shedding {method!r} past the "
                    f"{timeout}s deadline")
            try:
                return self._client.call(method, *args,
                                         timeout=max(0.05, remaining))
            except BackpressureError as e:
                delay = next_backoff(delay, base, cap,
                                     hint_s=e.backoff_s)
                with self._bp_lock:
                    wait = jittered(delay, self._bp_rng)
                if time.monotonic() + wait >= deadline:
                    raise
                time.sleep(wait)

    # -- functions -----------------------------------------------------

    def register_function(self, fn) -> FunctionDescriptor:
        blob = cloudpickle.dumps(fn)
        fid = hashlib.sha1(blob).digest()
        with self._fn_lock:
            self._fn_blobs.setdefault(fid, blob)
        return FunctionDescriptor(
            function_id=fid,
            module=getattr(fn, "__module__", "") or "",
            name=getattr(fn, "__qualname__", repr(fn)))

    # -- task submission -----------------------------------------------

    def _ser_args(self, args: tuple, kwargs: dict):
        kwargs_keys = list(kwargs.keys())
        arg_descs = []
        for value in list(args) + [kwargs[k] for k in kwargs_keys]:
            if isinstance(value, ObjectRef):
                owner = value.owner_addr()
                if owner is not None:
                    arg_descs.append(("ro", value.binary(), tuple(owner)))
                else:
                    arg_descs.append(("r", value.binary()))
            else:
                arg_descs.append(
                    ("v", self.serde.serialize(value).to_bytes()))
        return arg_descs, kwargs_keys

    def _fn_shipment(self, fid: bytes):
        with self._fn_lock:
            if fid in self._shipped_fids:
                return None
            self._shipped_fids.add(fid)
            return self._fn_blobs.get(fid)

    def submit_task(self, fn_descriptor: FunctionDescriptor, args: tuple,
                    kwargs: dict, options: TaskOptions) -> List[ObjectRef]:
        arg_descs, kwargs_keys = self._ser_args(args, kwargs)
        options_dict = {f: getattr(options, f)
                        for f in _SHIPPED_OPTION_FIELDS}
        fid = fn_descriptor.function_id
        refs_b = self._backpressured_call(
            "nested_submit", fid, self._fn_shipment(fid),
            fn_descriptor.name, arg_descs, kwargs_keys, options_dict,
            timeout=_SHIP_TIMEOUT)
        return [ObjectRef(ObjectID(b)) for b in refs_b]

    # -- object plane ----------------------------------------------------

    @staticmethod
    def _current_task_id() -> bytes:
        # Read per-call, per-thread: concurrent actor calls each bind
        # their own identity (resource release on blocking get).
        from ray_tpu_torch._private.worker_process import _CURRENT_TASK
        return _CURRENT_TASK.get("task_id", b"")

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        # Worker-owned refs resolve owner-direct — no driver hop — the
        # decentralized-ownership data path. One batched round trip per
        # owner; the user timeout is a shared deadline, not per-ref.
        if not any(r.owner_addr() is not None for r in refs):
            return self._get_driver(refs, timeout)
        import time as _time
        from collections import defaultdict

        from ray_tpu_torch._private import worker_core
        deadline = None if timeout is None else _time.monotonic() + timeout
        out: List[Any] = [None] * len(refs)
        by_owner = defaultdict(list)
        driver_refs, driver_idx = [], []
        for i, r in enumerate(refs):
            if r.owner_addr() is None:
                driver_refs.append(r)
                driver_idx.append(i)
            else:
                by_owner[r.owner_addr()].append(i)
        for owner, idxs in by_owner.items():
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - _time.monotonic())
            values = worker_core.fetch_values_from_owner(
                owner, [refs[i].id() for i in idxs], remaining)
            for i, v in zip(idxs, values):
                out[i] = v
        if driver_refs:
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - _time.monotonic())
            for i, v in zip(driver_idx,
                            self._get_driver(driver_refs, remaining)):
                out[i] = v
        return out

    def _get_driver(self, refs: Sequence[ObjectRef],
                    timeout: Optional[float]) -> List[Any]:
        rpc_timeout = None if timeout is None else timeout + 30.0
        status, items = self._client.call(
            "nested_get", self._current_task_id(),
            [r.id().binary() for r in refs], timeout,
            timeout=rpc_timeout)
        if status == "timeout":
            raise GetTimeoutError("nested get() timed out")
        out = []
        for kind, blob in items:
            value, _ = self.serde.deserialize_from_blob(memoryview(blob))
            if kind == "err":
                raise value.as_instanceof_cause() \
                    if isinstance(value, TaskError) else value
            out.append(value)
        return out

    def put(self, value: Any) -> ObjectRef:
        # The creating worker OWNS the object (reference semantics):
        # stored in this process's WorkerCore, served owner-direct.
        from ray_tpu_torch._private import worker_core
        return worker_core.get_worker_core().put(value)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        from ray_tpu_torch._private import worker_core
        owned_ready = set()
        driver_refs = []
        for r in refs:
            owner = r.owner_addr()
            if owner is None:
                driver_refs.append(r)
                continue
            try:
                if worker_core.owner_contains(owner, r.id()):
                    owned_ready.add(r.id())
            except Exception:
                owned_ready.add(r.id())   # dead owner: get() will raise
        ready_set = set(owned_ready)
        need = max(0, num_returns - len(owned_ready))
        if driver_refs:
            rpc_timeout = None if timeout is None else timeout + 30.0
            ready_b = self._client.call(
                "nested_wait", self._current_task_id(),
                [r.id().binary() for r in driver_refs],
                need, timeout, timeout=rpc_timeout)
            ready_set |= {ObjectID(b) for b in ready_b}
        ready, not_ready = [], []
        for r in refs:
            (ready if r.id() in ready_set and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    # -- actors ----------------------------------------------------------

    def create_actor(self, fn_descriptor: FunctionDescriptor,
                     args: tuple, kwargs: dict, options: TaskOptions,
                     class_name: str, method_names: tuple = (),
                     is_async: bool = False):
        from ray_tpu_torch._private.ids import ActorID
        arg_descs, kwargs_keys = self._ser_args(args, kwargs)
        options_dict = {f: getattr(options, f)
                        for f in _SHIPPED_ACTOR_FIELDS}
        options_dict.pop("num_returns", None)
        fid = fn_descriptor.function_id
        actor_id_b = self._client.call(
            "nested_create_actor", fid, self._fn_shipment(fid),
            class_name, arg_descs, kwargs_keys, options_dict,
            tuple(method_names), bool(is_async),
            timeout=_SHIP_TIMEOUT)
        return ActorID(actor_id_b)

    def submit_actor_task(self, actor_id, method_name: str, args: tuple,
                          kwargs: dict, options: TaskOptions
                          ) -> List[ObjectRef]:
        arg_descs, kwargs_keys = self._ser_args(args, kwargs)
        options_dict = {"num_returns": options.num_returns}
        refs_b = self._client.call(
            "nested_actor_task", actor_id.binary(), method_name,
            arg_descs, kwargs_keys, options_dict,
            timeout=_SHIP_TIMEOUT)
        return [ObjectRef(ObjectID(b)) for b in refs_b]

    def kill_actor(self, actor_id) -> None:
        self._client.call("nested_kill_actor", actor_id.binary(),
                          timeout=_CONTROL_TIMEOUT)

    def cancel_task(self, ref, force: bool = False) -> None:
        """Proxy ray_tpu_torch.cancel() to the owner (the driver runs the
        actual queue removal / worker interruption)."""
        self._client.call("nested_cancel", ref.id().binary(),
                          bool(force), timeout=_CONTROL_TIMEOUT)

    @property
    def gcs(self):
        client = self

        class _NestedGcs:
            def get_named_actor(self, name: str, namespace: str):
                return client._client.call("nested_named_actor", name,
                                           namespace,
                                           timeout=_CONTROL_TIMEOUT)

        return _NestedGcs()

    # -- placement groups ------------------------------------------------

    def create_placement_group(self, pg_id, bundles, strategy, name):
        self._client.call("nested_create_pg", pg_id.binary(),
                          [dict(b) for b in bundles], strategy, name,
                          timeout=_CONTROL_TIMEOUT)

    def remove_placement_group(self, pg_id) -> None:
        self._client.call("nested_remove_pg", pg_id.binary(),
                          timeout=_CONTROL_TIMEOUT)

    def pg_ready_ref(self, pg_id) -> ObjectRef:
        return ObjectRef(ObjectID(
            self._client.call("nested_pg_ready", pg_id.binary(),
                              timeout=_CONTROL_TIMEOUT)))

    @property
    def pg_manager(self):
        client = self

        class _Info:
            def __init__(self, state, bundles):
                self.state = state
                self.bundles = bundles

        class _Shim:
            def get(self, pg_id):
                out = client._client.call("nested_pg_info",
                                          pg_id.binary(),
                                          timeout=_CONTROL_TIMEOUT)
                return None if out is None else _Info(*out)

            def table(self):
                return client._client.call("nested_pg_table",
                                            timeout=_CONTROL_TIMEOUT)

        return _Shim()

    def cluster_resources(self) -> dict:
        return self._client.call("nested_cluster_resources",
                                 timeout=_CONTROL_TIMEOUT)

    def available_resources(self) -> dict:
        return self._client.call("nested_available_resources",
                                 timeout=_CONTROL_TIMEOUT)

    def close(self) -> None:
        self._client.close()


_nested: Optional[NestedClient] = None
_nested_lock = threading.Lock()  # blocking-ok: singleton dial — the one nested-client connect runs under the lock BY DESIGN


def get_nested_client() -> Optional[NestedClient]:
    """The current task's owner channel, or None outside a task. Task
    identity is read per-call from the thread-local (see
    ``NestedClient._current_task_id``), not bound to the client."""
    global _nested
    from ray_tpu_torch._private.worker_process import _CURRENT_TASK
    addr = _CURRENT_TASK.get("owner_addr")
    if addr is None:
        return None
    with _nested_lock:
        if _nested is None or _nested._client.address != tuple(addr) \
                or not _nested._client.alive:
            if _nested is not None:
                _nested.close()
            _nested = NestedClient(tuple(addr))
        return _nested


class ClientWorker(NestedClient):
    """Proxied remote driver (the Ray Client / ``ray://`` analog,
    reference ``python/ray/util/client/`` [UNVERIFIED — mount empty,
    SURVEY.md §0]): a thin client over ONE RPC connection to a
    client-server's embedded driver. The entire public API rides the
    same nested-call protocol workers use — submit/get/put/wait,
    actors, placement groups, streaming generators.

    Difference from the in-worker NestedClient: ``put`` proxies to the
    driver (the client machine may not be reachable from cluster
    workers, so client-side object ownership would strand consumers);
    objects a client puts are driver-owned and pinned until the
    session ends.
    """

    def __init__(self, addr):
        super().__init__(tuple(addr))
        self.session = f"client-{addr[0]}:{addr[1]}"

    def put(self, value):
        blob = self.serde.serialize(value).to_bytes()
        oid_b = self._client.call("nested_put", blob,
                                  timeout=_SHIP_TIMEOUT)
        return ObjectRef(ObjectID(oid_b))

    def _get_function_blob(self, fid: bytes) -> bytes:
        return self._client.call("nested_function_blob", fid,
                                 timeout=_SHIP_TIMEOUT)

    def shutdown(self) -> None:
        self.close()


def parse_client_address(address: str):
    """'rtpu://host:port' -> (host, port) or None for other schemes."""
    if not address.startswith("rtpu://"):
        return None
    hostport = address[len("rtpu://"):]
    host, port = hostport.rsplit(":", 1)
    return (host, int(port))
