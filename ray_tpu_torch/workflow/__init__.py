"""ray_tpu_torch.workflow — durable DAG execution with resume, per-step
retries, and dynamic continuations.

Reference: ``python/ray/workflow/`` [UNVERIFIED — mount empty,
SURVEY.md §0]: run a DAG of tasks with every step's result persisted;
after a crash, ``resume`` re-executes only the steps without a
persisted result. The DAG itself is persisted at submission, so resume
needs nothing but the workflow id. Beyond the static DAG:

- **Steps are independent retryable tasks**: every ready step (all
  dependencies persisted) is submitted concurrently through the normal
  task path, and per-step ``max_retries`` / ``retry_exceptions`` ride
  the runtime's own retry machinery
  (``f.options(max_retries=3, retry_exceptions=True).bind(...)``).
- **catch_exceptions** (``workflow.options(catch_exceptions=True)(node)``):
  the step's durable value becomes ``(result, None)`` or
  ``(None, exception)`` instead of failing the workflow — the
  reference's step-level exception capture.
- **Dynamic continuations** (``workflow.continuation(sub_dag)``): a
  step may RETURN a new DAG; it is persisted as the step's
  continuation and executed (and resumed) like any other workflow,
  nested arbitrarily — the reference's ``workflow.continuation``
  dynamic-workflow semantics.

Storage layout ({storage}/{workflow_id}/):
  dag.pkl               the cloudpickled (dag, args)
  status                RUNNING | SUCCEEDED | FAILED
  step_<k>.pkl          pickled (FORMAT, "v", value) — step k's
                        durable value — or (FORMAT, "cont",) — step k
                        returned a continuation; FORMAT tags the record
                        layout so a resume against records from an
                        incompatible ray_tpu_torch version fails with a clear
                        error instead of silently misreading
  step_<k>_cont/        the continuation's own workflow directory
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.dag import CompiledDAG, DAGNode, FunctionNode, InputNode

# Durable step-record layout version (see module docstring). The JAX
# package tags its records "rtpu-step-v2": a record holds the package's
# own classes, so each package refuses the other's.
_STEP_FORMAT = "rtpt-step-v2"

__all__ = ["run", "resume", "list_all", "delete", "get_status",
           "options", "continuation", "Continuation", "WorkflowError"]

_DEFAULT_STORAGE = os.path.expanduser("~/.ray_tpu_torch/workflows")


class WorkflowError(RuntimeError):
    pass


class Continuation:
    """A step's returned sub-DAG: marks 'the value of this step is the
    result of executing this DAG' (dynamic workflows)."""

    def __init__(self, dag: DAGNode):
        if not isinstance(dag, DAGNode):
            raise TypeError("continuation() takes a DAG node "
                            f"(got {type(dag).__name__})")
        self.dag = dag


def continuation(dag: DAGNode) -> Continuation:
    """Return from a step to continue the workflow with ``dag``."""
    return Continuation(dag)


def options(*, catch_exceptions: bool = False,
            name: Optional[str] = None) -> Callable[[DAGNode], DAGNode]:
    """Per-step WORKFLOW options, applied to a bound node::

        node = workflow.options(catch_exceptions=True)(f.bind(x))

    (Task-level retry policy rides the normal task options:
    ``f.options(max_retries=3, retry_exceptions=True).bind(x)``.)
    """
    def apply(node: DAGNode) -> DAGNode:
        node._wf_catch = catch_exceptions
        if name is not None:
            node._wf_name = name
        return node
    return apply


def _dir(workflow_id: str, storage: Optional[str]) -> str:
    return os.path.join(storage or _DEFAULT_STORAGE, workflow_id)


def _write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def run(dag: DAGNode, *args, workflow_id: str,
        storage: Optional[str] = None) -> Any:
    """Execute a pure-task DAG durably; returns the final result.

    Each step's result persists before any dependent starts; a re-run
    (or ``resume``) skips persisted steps. Independent ready steps run
    CONCURRENTLY as ordinary retryable tasks."""
    d = _dir(workflow_id, storage)
    os.makedirs(d, exist_ok=True)
    _check_nodes(CompiledDAG(dag))
    _write(os.path.join(d, "dag.pkl"), cloudpickle.dumps((dag, args)))
    return _drive(dag, args, d)


def resume(workflow_id: str, storage: Optional[str] = None) -> Any:
    """Re-drive a workflow from its persisted DAG + step results
    (including through persisted continuations)."""
    d = _dir(workflow_id, storage)
    dag_path = os.path.join(d, "dag.pkl")
    if not os.path.exists(dag_path):
        raise WorkflowError(f"no workflow {workflow_id!r} at {d}")
    with open(dag_path, "rb") as f:
        dag, args = cloudpickle.loads(f.read())
    return _drive(dag, args, d)


def _check_nodes(compiled: CompiledDAG) -> None:
    for node in compiled._order:
        if not isinstance(node, (FunctionNode, InputNode)):
            raise WorkflowError(
                "workflows support task DAGs only (FunctionNode/"
                f"InputNode); found {type(node).__name__}")


def _drive(dag: DAGNode, args: tuple, d: str) -> Any:
    _write(os.path.join(d, "status"), b"RUNNING")
    try:
        result = _execute(dag, args, d)
    except BaseException:
        _write(os.path.join(d, "status"), b"FAILED")
        raise
    _write(os.path.join(d, "status"), b"SUCCEEDED")
    return result


def _execute(dag: DAGNode, inputs: tuple, d: str) -> Any:
    """One workflow level: submit every ready step (deps persisted),
    persist results as they land, recurse into continuations."""
    compiled = CompiledDAG(dag)
    _check_nodes(compiled)
    order = compiled._order
    values: Dict[int, Any] = {}
    done: set = set()
    submitted: set = set()
    inflight: Dict[Any, int] = {}      # ref -> step index

    def ready(k: int, node: DAGNode) -> bool:
        return all(id(up) in values for up in node._upstream())

    def resolve_args(node: DAGNode):
        a = tuple(values[id(x)] if isinstance(x, DAGNode) else x
                  for x in node.args)
        kw = {key: values[id(v)] if isinstance(v, DAGNode) else v
              for key, v in node.kwargs.items()}
        return a, kw

    def run_continuation(node: DAGNode, sub_dag: DAGNode,
                         cont_dir: str):
        """Execute (or finish resuming) a step's continuation,
        honoring the step's catch_exceptions: a catching step's
        durable value is (result, None) / (None, error) whether the
        value came from the step body or its continuation."""
        catch = getattr(node, "_wf_catch", False)
        try:
            value = _execute(sub_dag, (), cont_dir)
        except BaseException as e:  # noqa: BLE001
            if not catch:
                raise
            value = (None, e)
        else:
            if catch:
                value = (value, None)
        _write(os.path.join(cont_dir, "result.pkl"),
               pickle.dumps(value))
        return value

    def settle(k: int, node: DAGNode, payload) -> None:
        """Persist step k's durable value (running its continuation
        first if it returned one) and publish it to dependents."""
        step_path = os.path.join(d, f"step_{k}.pkl")
        if isinstance(payload, Continuation):
            cont_dir = os.path.join(d, f"step_{k}_cont")
            os.makedirs(cont_dir, exist_ok=True)
            _write(os.path.join(cont_dir, "dag.pkl"),
                   cloudpickle.dumps((payload.dag, ())))
            # the marker persists BEFORE the sub-workflow runs: resume
            # finds it and re-enters the continuation, never re-running
            # the step that produced it
            _write(step_path, pickle.dumps((_STEP_FORMAT, "cont")))
            value = run_continuation(node, payload.dag, cont_dir)
        else:
            value = payload
            _write(step_path, pickle.dumps((_STEP_FORMAT, "v", value)))
        values[id(node)] = value
        done.add(k)

    # resume pass: load persisted steps (re-entering continuations)
    for k, node in enumerate(order):
        if isinstance(node, InputNode):
            values[id(node)] = inputs[node.index]
            done.add(k)
            continue
        step_path = os.path.join(d, f"step_{k}.pkl")
        if not os.path.exists(step_path):
            continue
        with open(step_path, "rb") as f:
            record = pickle.load(f)
        if (not isinstance(record, tuple) or not record
                or record[0] != _STEP_FORMAT):
            raise RuntimeError(
                f"incompatible workflow storage format in {step_path}: "
                f"expected records tagged {_STEP_FORMAT!r} (this "
                f"workflow was persisted by a different ray_tpu_torch "
                f"version; re-run it from scratch)")
        if record[1] == "v":
            values[id(node)] = record[2]
        else:                       # persisted continuation
            cont_dir = os.path.join(d, f"step_{k}_cont")
            res_path = os.path.join(cont_dir, "result.pkl")
            if os.path.exists(res_path):
                with open(res_path, "rb") as f:
                    values[id(node)] = pickle.load(f)
            else:
                with open(os.path.join(cont_dir, "dag.pkl"), "rb") as f:
                    sub_dag, _ = cloudpickle.loads(f.read())
                values[id(node)] = run_continuation(node, sub_dag,
                                                    cont_dir)
        done.add(k)

    multi: Dict[Any, list] = {}        # primary ref -> full ref list
    while len(done) < len(order):
        # submit every ready, unsubmitted step (independent branches
        # run concurrently — steps are ordinary retryable tasks)
        for k, node in enumerate(order):
            if k in done or k in submitted or not ready(k, node):
                continue
            a, kw = resolve_args(node)
            out = node._submit(a, kw)
            submitted.add(k)
            if isinstance(out, list):
                # num_returns > 1 step: wait keys on the first ref,
                # the step's durable value is the list of all values
                inflight[out[0]] = k
                multi[out[0]] = out
            else:
                inflight[out] = k
        if not inflight:
            raise WorkflowError("workflow deadlocked: no step ready "
                                "(cycle or missing input)")
        ready_refs, _ = ray_tpu_torch.wait(list(inflight), num_returns=1,
                                     timeout=None)
        for ref in ready_refs:
            k = inflight.pop(ref)
            node = order[k]
            try:
                refs_full = multi.pop(ref, None)
                if refs_full is not None:
                    payload = ray_tpu_torch.get(refs_full)
                else:
                    payload = ray_tpu_torch.get(ref)
            except BaseException as e:  # noqa: BLE001
                if getattr(node, "_wf_catch", False):
                    settle(k, node, (None, e))
                    continue
                raise
            if getattr(node, "_wf_catch", False) \
                    and not isinstance(payload, Continuation):
                payload = (payload, None)
            settle(k, node, payload)

    out = compiled.output
    return values[id(out)]


def get_status(workflow_id: str, storage: Optional[str] = None) -> str:
    path = os.path.join(_dir(workflow_id, storage), "status")
    if not os.path.exists(path):
        return "NOT_FOUND"
    return open(path, "rb").read().decode()


def list_all(storage: Optional[str] = None) -> List[tuple]:
    base = storage or _DEFAULT_STORAGE
    if not os.path.isdir(base):
        return []
    return [(wid, get_status(wid, storage))
            for wid in sorted(os.listdir(base))]


def delete(workflow_id: str, storage: Optional[str] = None) -> None:
    import shutil
    shutil.rmtree(_dir(workflow_id, storage), ignore_errors=True)
