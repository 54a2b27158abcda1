"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

It imports torch, never jax, and nothing of ``ray_tpu``. Module names
mirror the JAX package's, so each has its counterpart there. Importing
the package loads no torch: the runtime imports it when a device path
runs.

Ported so far: the single-host runtime core (``init``/``shutdown``,
``remote`` tasks and actors, ``put``/``get``/``wait``/``kill``/``cancel``,
the object plane with its device tier for ``torch.Tensor``s, and the
actor-level collective groups of ``collective``), with its public API
below; the flagship transformer's forward (``models.transformer``) and
training step (``models.training``), with attention through hand-written
CUDA flash-attention kernels (``ops.flash_attention``): the forward in
``csrc/flash_attention.cu``, the dQ and dK/dV backward in
``csrc/flash_attention_bwd.cu``; the scheduler's device programs
(``_private.scheduler``: the class-fill policy and the placement-group
packer) as CUDA kernels in ``csrc/scheduler.cu``, and its native CPU
policy (``native/scheduler.cc``); the mesh layer (``parallel``: meshes,
slice meshes, multi-host process groups, the pipeline over ``pp``;
``collective.xla``; the sharded train step of ``models.sharded``); and
the ViT family (``models.vit``).
"""

from __future__ import annotations

import os as _os

# graftsan must patch the lock factories BEFORE any runtime module
# creates its locks (module-level locks are born at import time), so
# this gate sits above every other ray_tpu_torch import. With
# RTPU_SANITIZE unset the sanitizer package is never imported at all.
if _os.environ.get("RTPU_SANITIZE") == "1":
    from ray_tpu_torch.devtools.analysis import contracts as _contracts
    from ray_tpu_torch.devtools import sanitizer as _graftsan

    _graftsan_manifest = _contracts.load_manifest() or {}
    _graftsan.install(_graftsan_manifest)

from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.worker import is_initialized
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor
from ray_tpu_torch.remote_function import RemoteFunction, remote
from ray_tpu_torch import exceptions

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "get_actor", "ObjectRef", "ActorClass", "ActorHandle",
    "RemoteFunction", "cluster_resources", "available_resources",
    "exceptions", "nodes", "timeline", "dump_stacks",
    "get_runtime_context", "cancel",
]


def init(num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[dict] = None,
         object_store_memory: Optional[int] = None,
         ignore_reinit_error: bool = True,
         _system_config: Optional[dict] = None,
         **kwargs):
    """Start (or connect to) the runtime in this process.

    ``num_gpus`` is the node's GPU resource; by default it is the number
    of CUDA cards this process sees, and without a card ``init`` raises
    unless the caller passes ``num_gpus`` (``num_gpus=0`` for a CPU-only
    runtime). Work that demands ``GPU`` runs on threads of this process,
    which owns the cards; other work runs in process workers that see no
    card."""
    if is_initialized() and not ignore_reinit_error:
        raise RuntimeError("ray_tpu_torch.init() called twice")
    return _worker_mod.init(
        num_cpus=num_cpus, num_gpus=num_gpus, resources=resources,
        object_store_memory=object_store_memory,
        _system_config=_system_config, **kwargs)


def shutdown():
    _worker_mod.shutdown()


def put(value: Any) -> ObjectRef:
    return _worker_mod.global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    w = _worker_mod.global_worker()
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError("get() expects an ObjectRef or a list of them")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() got a non-ObjectRef: {type(r)}")
    return w.get(list(refs), timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return _worker_mod.global_worker().wait(list(refs), num_returns, timeout)


def kill(actor: ActorHandle):
    from ray_tpu_torch.actor import kill as _kill
    _kill(actor)


def cluster_resources() -> dict:
    return _worker_mod.global_worker().cluster_resources()


def available_resources() -> dict:
    return _worker_mod.global_worker().available_resources()


def nodes() -> List[dict]:
    w = _worker_mod.global_worker()
    return [
        {
            "NodeID": info.node_id.hex(),
            "Alive": info.alive,
            "Resources": dict(info.resources_total),
        }
        for info in w.gcs.get_all_node_info()
    ]


def timeline() -> List[dict]:
    """Chrome-trace events for completed tasks (reference: ray timeline)."""
    from ray_tpu_torch._private.events import get_task_events
    return get_task_events()


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task that produces ``ref`` (best-effort, reference
    ``ray.cancel``): queued tasks never run; running tasks receive
    KeyboardInterrupt (``force=True`` kills the worker); cancelled
    tasks never retry and their refs raise TaskCancelledError. A task
    that already finished keeps its result. Actor calls raise
    TypeError."""
    return _worker_mod.global_worker().cancel_task(ref, force=force)


def get_runtime_context():
    """Identity of the calling context (driver/task/actor) — the
    reference's ``ray.get_runtime_context()``."""
    from ray_tpu_torch.runtime_context import get_runtime_context as _grc
    return _grc()


def dump_stacks(node_id: Optional[str] = None) -> dict:
    """Live Python stacks per node (host process + every process
    worker) — the on-demand py-spy-style host profiler. ``node_id``
    (hex) restricts to one node."""
    from ray_tpu_torch._private.ids import NodeID
    nid = NodeID.from_hex(node_id) if node_id else None
    return _worker_mod.global_worker().dump_stacks(nid)


# Arming happens at the bottom: the guarded-attribute descriptors
# need the annotated classes importable, and those modules need the
# public API above.
if _os.environ.get("RTPU_SANITIZE") == "1":
    _graftsan.arm(_graftsan_manifest)
