"""ray_tpu_torch.dag — static task/actor graphs with a compiled execute path.

Reference: ``python/ray/dag/`` + ``python/ray/experimental/channel/``
(compiled graphs / "aDAG": a static actor DAG pre-allocates channels
and bypasses per-call scheduling for µs dispatch) [UNVERIFIED — mount
empty, SURVEY.md §0].

Two compile targets, per SURVEY §7 step 6:

- **Actor DAGs** (``experimental_compile``): the graph is validated,
  topologically frozen, and truly pre-compiled:

  * constant arguments are serialized ONCE at compile time (big
    constants are promoted to driver-store objects and referenced by
    shm descriptor, so repeated executes never re-ship the bytes);
  * each stage's worker channel is resolved and bound ONCE — execute
    sends payloads straight down the already-open pipe, skipping the
    actor queue, dependency bookkeeping, and GCS lookups;
  * stage→stage handoffs ride **pre-arranged channels**: the upstream
    worker PUSHES its result one-way into the downstream worker's core
    under a channel id agreed at submit time (big values stay in the
    producer as a consumer-counted shm segment; consumers get a
    locator and map it directly). The downstream resolve is a local
    wait — no round trip on the data path, and the driver is NOT in
    the path of an intermediate edge: it submits all stages up front
    and only sees the terminal result.
  * producer failures are pushed INTO the channel as errors, so
    downstream stages unblock with the cause instead of timing out.

  There is no per-execute global lock; concurrent executes interleave
  freely (per-stage ordering rides the per-actor pipe). Compiled tasks
  do not retry — a failed stage fails that execution, like the
  reference's compiled graphs. The fast path engages when every
  non-input node is an actor-method call on a driver-machine actor;
  DAGs with task nodes or remote-raylet actors fall back to the replay
  path below, and ``compiled.is_fast`` says which one you got.

- **Pure-function DAGs** (``compile_to_jit``): when every node is a
  plain function, the whole DAG composes into ONE callable that runs
  eagerly in the caller's process, on its inputs' device —
  intermediate values never go through the object store; each node
  launches what its function launches (a CUDA graph of the composition
  would be a speed change of its own).

Build graphs with ``InputNode`` and ``.bind``::

    with InputNode() as inp:
        dag = actor.step.bind(other.prep.bind(inp))
    compiled = dag.experimental_compile()
    ref = compiled.execute(x)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["InputNode", "DAGNode", "FunctionNode", "ClassMethodNode",
           "MultiOutputNode", "CompiledDAG", "compile_to_jit"]

# Channel objects use a return-index far above any declared num_returns
# so they can never collide with a stage's real return ids.
_CHANNEL_INDEX = 250


class DAGNode:
    """Base: a node's args may contain other DAGNodes (data edges)."""

    def __init__(self, args: tuple, kwargs: dict):
        self.args = args
        self.kwargs = kwargs

    def _upstream(self) -> List["DAGNode"]:
        ups = [a for a in self.args if isinstance(a, DAGNode)]
        ups += [v for v in self.kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def experimental_compile(self,
                             _channel_timeout: float = 60.0
                             ) -> "CompiledDAG":
        compiled = CompiledDAG(self, channel_timeout=_channel_timeout)
        compiled._precompile()
        return compiled

    def execute(self, *input_values):
        """Uncompiled convenience execution (replay path)."""
        return CompiledDAG(self).execute(*input_values)


class InputNode(DAGNode):
    """Placeholder for the value passed to ``execute``."""

    def __init__(self, index: int = 0):
        super().__init__((), {})
        self.index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self.remote_function = remote_function

    def _submit(self, args, kwargs):
        return self.remote_function.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, actor_method, args, kwargs):
        super().__init__(args, kwargs)
        self.actor_method = actor_method

    def _submit(self, args, kwargs):
        return self.actor_method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Terminal fan-out: execute returns one ref per listed node."""

    def __init__(self, nodes: List[DAGNode]):
        super().__init__(tuple(nodes), {})


class _Stage:
    """Per-actor-method-node compile record (fast path)."""

    __slots__ = ("pos", "actor_id", "function", "method_name", "name",
                 "arg_plan", "kwargs_keys", "consumer_pushes", "terminal",
                 "core_addr", "runtime_env", "stage_key")

    def __init__(self):
        # [(consumer_core_addr, takes), ...] — where to PUSH the stage
        # result; ``takes`` covers a consumer using the value in more
        # than one arg position.
        self.consumer_pushes = []
        self.terminal = False
        self.core_addr = None
        self.runtime_env = None
        self.stage_key = None


class CompiledDAG:
    """Frozen topological schedule over a DAG.

    ``execute`` uses the pre-bound channel fast path when
    ``_precompile`` succeeded (``is_fast``); otherwise it replays the
    schedule through the normal ``.remote()`` machinery.
    """

    def __init__(self, output: DAGNode, channel_timeout: float = 60.0):
        self.output = output
        self._order: List[DAGNode] = []
        self._chan_timeout = channel_timeout
        self._torn = False
        self.is_fast = False
        self._stages: List[_Stage] = []
        self._const_refs: List[Any] = []   # keep big-const objects alive
        seen: Dict[int, bool] = {}
        temp: Dict[int, bool] = {}

        def visit(node: DAGNode):
            key = id(node)
            if seen.get(key):
                return
            if temp.get(key):
                raise ValueError("cycle in DAG")
            temp[key] = True
            for up in node._upstream():
                visit(up)
            temp.pop(key)
            seen[key] = True
            self._order.append(node)

        visit(output)
        self.num_inputs = 1 + max(
            (n.index for n in self._order if isinstance(n, InputNode)),
            default=-1)

    # -- fast-path compilation --------------------------------------------

    def _precompile(self) -> None:
        """Bind channels + pre-serialize constants. Leaves ``is_fast``
        False (replay fallback) if the DAG contains task nodes,
        remote-raylet actors, or actors that never came alive."""
        from ray_tpu_torch._private.worker import global_worker

        body = [n for n in self._order
                if not isinstance(n, (InputNode, MultiOutputNode))]
        if not body or not all(isinstance(n, ClassMethodNode)
                               for n in body):
            return
        w = global_worker()
        serde = w.serde
        from ray_tpu_torch._private.config import get_config
        inline_limit = get_config().max_direct_call_object_size

        # Terminal set: the output node, or every member of a terminal
        # MultiOutputNode. A terminal node may ALSO feed other nodes.
        if isinstance(self.output, MultiOutputNode):
            terminals = {id(a) for a in self.output.args}
            if not all(isinstance(a, ClassMethodNode)
                       for a in self.output.args):
                return
        else:
            terminals = {id(self.output)}

        pos_of: Dict[int, int] = {}
        stages: List[_Stage] = []
        for node in self._order:
            if not isinstance(node, ClassMethodNode):
                continue
            handle = node.actor_method._handle
            actor_id = handle._actor_id
            info = self._wait_actor_alive(w, actor_id)
            if info is None:
                return
            core_addr = w.node_group.worker_core_addr(actor_id)
            if core_addr is None:      # remote-raylet actor
                return
            creation = (w._actor_specs.get(actor_id)
                        or info.creation_spec)
            if creation is None:
                return
            st = _Stage()
            st.pos = len(stages)
            st.actor_id = actor_id
            st.function = creation.function
            st.method_name = node.actor_method._method_name
            st.name = (f"{handle._class_name}."
                       f"{st.method_name} [compiled]")
            st.core_addr = tuple(core_addr)
            st.runtime_env = None
            plan: List[tuple] = []
            flat_args = list(node.args) + list(node.kwargs.values())
            st.kwargs_keys = list(node.kwargs.keys())
            edge_takes: Dict[int, int] = {}
            for a in flat_args:
                if isinstance(a, InputNode):
                    plan.append(("i", a.index))
                elif isinstance(a, DAGNode):
                    up = pos_of.get(id(a))
                    if up is None:     # e.g. MultiOutputNode as an arg
                        return
                    edge_takes[up] = edge_takes.get(up, 0) + 1
                    plan.append(("e", up))
                else:
                    plan.append(("c", self._compile_const(
                        w, serde, a, inline_limit)))
            for up, takes in edge_takes.items():
                # Aggregate per consumer CORE: two consumer stages on
                # the same actor/process must arrive as ONE push with a
                # combined take budget (a second push for the same
                # channel id would overwrite the first).
                pushes = stages[up].consumer_pushes
                for i, (addr, t) in enumerate(pushes):
                    if addr == st.core_addr:
                        pushes[i] = (addr, t + takes)
                        break
                else:
                    pushes.append((st.core_addr, takes))
            st.arg_plan = plan
            st.terminal = id(node) in terminals
            pos_of[id(node)] = st.pos
            stages.append(st)
        # Register each stage's constant payload half with its worker
        # ONCE — per-execute messages ship only the dynamic fields.
        import os as _os
        owner_addr = w.node_group.object_server_addr
        for st in stages:
            st.stage_key = _os.urandom(12)
            template = {
                "type": "exec_actor",
                "actor_id": st.actor_id.binary(),
                "method": st.method_name,
                "function_id": st.function.function_id,
                "kwargs_keys": st.kwargs_keys,
                "num_returns": 1 if st.terminal else 0,
                "name": st.name,
                "runtime_env": st.runtime_env,
                "owner_addr": owner_addr,
            }
            worker = w.node_group.actor_worker(st.actor_id)
            if worker is None:
                return
            worker.send(("dag_stage", st.stage_key, template))
        self._stages = stages
        self._terminal_order = (
            [pos_of[id(a)] for a in self.output.args]
            if isinstance(self.output, MultiOutputNode)
            else [pos_of[id(self.output)]])
        self.is_fast = True

    @staticmethod
    def _wait_actor_alive(w, actor_id, timeout: float = 60.0):
        """Block until the actor is ALIVE with a registered worker;
        returns its ActorInfo, or None (dead / unknown / timed out)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = w.gcs.get_actor_info(actor_id)
            if info is None or info.state == "DEAD":
                return None
            if (info.state == "ALIVE"
                    and w.node_group.actor_worker(actor_id) is not None):
                return info
            time.sleep(0.005)
        return None

    def _compile_const(self, w, serde, value, inline_limit) -> tuple:
        """Serialize a constant ONCE. Values past the inline limit are
        promoted to a driver-store object (shm) so each execute ships a
        descriptor, not the bytes; the ref pins it for the DAG's life."""
        ser = serde.serialize(value)
        if ser.size_with_header() <= inline_limit and \
                not ser.contained_refs:
            return ("v", ser.to_bytes())
        import ray_tpu_torch
        ref = ray_tpu_torch.put(value)
        self._const_refs.append(ref)
        entry = w.memory_store.get(ref.id(), timeout=5.0)
        if entry.kind == "device":
            info = w._ensure_host_copy(ref.id())
            return ("shm", ref.binary(), info[0], info[1])
        if entry.kind == "shm":
            name, size = entry.data
            return ("shm", ref.binary(), name, size)
        return ("v", entry.data)

    # -- execution ---------------------------------------------------------

    def execute(self, *input_values):
        """Run the DAG once; returns the terminal ObjectRef (or a list
        for MultiOutputNode)."""
        if self._torn:
            raise ValueError(
                "compiled DAG was torn down; recompile with "
                "experimental_compile()")
        if len(input_values) < self.num_inputs:
            raise ValueError(
                f"DAG needs {self.num_inputs} input(s), got "
                f"{len(input_values)}")
        if self.is_fast:
            return self._execute_fast(input_values)
        return self._execute_replay(input_values)

    def _execute_fast(self, input_values):
        from ray_tpu_torch._private.ids import ObjectID, TaskID
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private.task_spec import TaskSpec, TaskType
        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.exceptions import ActorDiedError

        w = global_worker()
        serde = w.serde
        input_descs = [("v", serde.serialize(v).to_bytes())
                       for v in input_values]
        chan_descs: List[Optional[tuple]] = [None] * len(self._stages)
        out_refs: List[Optional[ObjectRef]] = [None] * len(self._stages)
        for st in self._stages:
            task_id = TaskID.of(st.actor_id)
            return_ids = ([ObjectID.from_index(task_id, 1)]
                          if st.terminal else [])
            publish = []
            if st.consumer_pushes:
                chan_oid = ObjectID.from_index(task_id, _CHANNEL_INDEX)
                publish.append((chan_oid.binary(), st.consumer_pushes))
                chan_descs[st.pos] = ("chanp", chan_oid.binary(),
                                      self._chan_timeout)
            args = [d if k == "c" else
                    input_descs[d] if k == "i" else
                    chan_descs[d]
                    for k, d in st.arg_plan]
            spec = TaskSpec(
                task_id=task_id, job_id=w.job_id,
                task_type=TaskType.ACTOR_TASK,
                function=st.function, args=[],
                kwargs_keys=st.kwargs_keys,
                num_returns=len(return_ids), resources={},
                max_retries=0, actor_id=st.actor_id,
                name=st.name, return_ids=return_ids)
            spec.method_name = st.method_name  # type: ignore[attr-defined]
            for oid in return_ids:
                w.reference_counter.add_owned_object(oid)
            w.task_manager.add_pending_task(spec)
            w.task_manager.mark_running(task_id)
            payload = {
                "stage_key": st.stage_key,
                "task_id": task_id.binary(),
                "args": args,
                "return_ids": [o.binary() for o in return_ids],
                "publish": publish,
            }
            if not self._submit_with_retry(w, st, spec, payload):
                err = ActorDiedError(
                    f"compiled-DAG stage {st.name} has no live worker "
                    "(actor died or is restarting); re-create the actor "
                    "and recompile")
                # Unwind: complete the stage task (records + terminal
                # refs get the error) and push the error to consumers
                # already waiting on this stage's channel, so they fail
                # fast instead of blocking out the channel timeout.
                blob = w.serde.serialize(err).to_bytes()
                w.task_manager.complete_task(task_id, [], blob, None)
                for oid_b, consumers in publish:
                    self._push_error_to_consumers(oid_b, blob, consumers)
                raise err
            if st.terminal:
                out_refs[st.pos] = ObjectRef(return_ids[0])
        outs = [out_refs[p] for p in self._terminal_order]
        return outs if isinstance(self.output, MultiOutputNode) \
            else outs[0]

    @staticmethod
    def _push_error_to_consumers(oid_b: bytes, err_blob: bytes,
                                 consumers) -> None:
        """Driver-side stand-in for the dead producer: deliver its
        failure into each consumer core's channel slot."""
        from ray_tpu_torch._private import worker_core
        from ray_tpu_torch._private.ids import ObjectID
        for addr, takes in consumers:
            try:
                worker_core._peer(tuple(addr)).oneway(
                    "chan_push", oid_b, ("err", err_blob), takes)
            except Exception:
                pass    # consumer gone: its own failure surfaces it

    @staticmethod
    def _submit_with_retry(w, st: _Stage, spec, payload,
                           timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            if w.node_group.submit_actor_task(st.actor_id, spec, payload):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def _execute_replay(self, input_values):
        """Fire every node through the normal submit machinery —
        downstream tasks chain on upstream ObjectRefs."""
        values: Dict[int, Any] = {}
        for node in self._order:
            if isinstance(node, InputNode):
                values[id(node)] = input_values[node.index]
                continue
            args = tuple(values[id(a)] if isinstance(a, DAGNode) else a
                         for a in node.args)
            kwargs = {k: values[id(v)] if isinstance(v, DAGNode) else v
                      for k, v in node.kwargs.items()}
            if isinstance(node, MultiOutputNode):
                values[id(node)] = list(args)
            else:
                values[id(node)] = node._submit(args, kwargs)
        return values[id(self.output)]

    def teardown(self) -> None:
        """Release compile-time resources (pinned big constants). The
        compiled DAG is invalid afterwards — its fast path may hold shm
        descriptors for the just-released objects."""
        self._torn = True
        self._const_refs.clear()


def compile_to_jit(output: DAGNode, donate: bool = False) -> Callable:
    """Compose a pure-function DAG into one callable.

    Every non-input node must be a FunctionNode; the composed function
    calls each node's python function in topological order, in this
    process and on the inputs' device — intermediate values never leave
    it. ``donate`` is accepted for the JAX package's signature and not
    used (it is not read there either).
    """
    compiled = CompiledDAG(output)

    def composed(*inputs):
        values: Dict[int, Any] = {}
        for node in compiled._order:
            if isinstance(node, InputNode):
                values[id(node)] = inputs[node.index]
                continue
            if isinstance(node, MultiOutputNode):
                values[id(node)] = tuple(
                    values[id(a)] for a in node.args)
                continue
            if not isinstance(node, FunctionNode):
                raise TypeError(
                    "compile_to_jit requires a pure-function DAG "
                    f"(found {type(node).__name__}); use "
                    "experimental_compile for actor DAGs")
            fn = node.remote_function._function
            args = tuple(values[id(a)] if isinstance(a, DAGNode) else a
                         for a in node.args)
            kwargs = {k: values[id(v)] if isinstance(v, DAGNode) else v
                      for k, v in node.kwargs.items()}
            values[id(node)] = fn(*args, **kwargs)
        return values[id(compiled.output)]

    return composed
