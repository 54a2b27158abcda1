"""Sharded-tensor checkpointing (``torch.distributed.checkpoint``-backed).

Reference: checkpointing is library-layer in the reference (Train's
``Checkpoint`` directories via pyarrow.fs), and torch state dicts
gather to one host before writing. Sharded state must not: a DTensor
saves with EVERY rank writing its own shards in parallel and restores
directly into a target layout. This module is the thin seam over
``torch.distributed.checkpoint`` (DCP) so Train/Tune checkpoints can
carry device-sharded state without host gathers; the async path keeps
the save off the training step's critical path.

The port's copy of ``ray_tpu/train/array_checkpoint.py``, with DCP in
the place of orbax:
- a tree of dicts, lists and tuples is flattened to one DCP state dict
  keyed by the leaves' paths; its leaves are DTensors, tensors (a 0-d
  one for a step count), numpy arrays, or Python scalars, which DCP
  stores as objects and which come back as they were, as orbax gives
  them back;
- ``restore_sharded`` allocates every leaf of its template in the
  template's layout and loads into it; DCP matches saved and wanted
  blocks by their global offsets, so the restore may change the layout
  and the world size (the reference's resharded restore);
- :class:`ArraySpec` is the counterpart of
  ``jax.ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(...))``,
  with the port's ``parallel.mesh.NamedSharding``;
- an async save copies every tensor to host memory before it returns
  (a DTensor keeps its layout around the copy of its own block), so the
  caller may update the tensors in place at once, as the port's AdamW
  does; a background thread then runs ``dcp.save`` on the copies;
- DCP's own collectives (object exchanges while it plans a save or a
  load) run on a gloo group of their own, made once for each default
  process group: on the default group, a background save's collectives
  would share one communicator with training's collectives on the main
  thread, and could meet them in another order on each rank.

torch is imported inside the functions, so that importing Train loads
none of it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ArraySpec", "AsyncSave", "restore_sharded", "save_sharded"]

_GROUP: Dict[str, Any] = {}


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """An abstract leaf of a restore template: the global shape, the
    torch dtype and, for a DTensor, the port's ``NamedSharding``. A leaf
    without a sharding is a whole tensor on ``device``."""
    shape: Tuple[int, ...]
    dtype: Any
    sharding: Any = None
    device: str = "cuda"


class AsyncSave:
    """Handle for an in-flight async save; ``wait()`` to finalize (it
    re-raises what the background write raised)."""

    def __init__(self, thread: threading.Thread, outcome: Dict[str, Any]):
        self._thread = thread
        self._outcome = outcome

    def wait(self) -> None:
        self._thread.join()
        if "error" in self._outcome:
            raise self._outcome["error"]


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in the
    tree's order; paths join keys and indices with ``/``."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return leaves[prefix[:-1]]


def _state_leaf(leaf: Any) -> Any:
    import torch
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    if isinstance(leaf, np.generic):
        return leaf.item()
    return leaf


def _staged(leaf: Any) -> Any:
    """A host copy of ``leaf`` that later in-place updates of the leaf
    do not reach: a DTensor keeps its layout around a CPU copy of its
    own block (the writer reads only the block and the layout)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        local = leaf.to_local().detach().to("cpu", copy=True)
        return DTensor(local, leaf._spec, requires_grad=False)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _dcp_group() -> Any:
    """The gloo group that DCP's collectives run on, or None without a
    process group (one process). Every rank saves and restores together,
    so every rank makes the group at the same point, on its calling
    thread."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return None
    world = dist.group.WORLD
    if _GROUP.get("world") is not world:
        _GROUP.update(world=world, group=dist.new_group(backend="gloo"))
    return _GROUP["group"]


def save_sharded(path: str, pytree: Any, *,
                 async_save: bool = False) -> Optional[AsyncSave]:
    """Write a tree of (possibly sharded) tensors. Each rank writes only
    its own shards. With ``async_save`` the call returns once the
    tensors are copied to host memory, and the write goes on in a
    background thread — training may overwrite the tensors in place
    while the bytes stream out."""
    import torch
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    group = _dcp_group()
    state = {key: _state_leaf(leaf) for key, leaf in _flatten(pytree)}
    if not async_save:
        dcp.save(state, checkpoint_id=path, process_group=group)
        return None
    state = {key: _staged(leaf) for key, leaf in state.items()}
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    outcome: Dict[str, Any] = {}

    def write():
        try:
            dcp.save(state, checkpoint_id=path, process_group=group)
        except BaseException as e:  # wait() re-raises it
            outcome["error"] = e

    thread = threading.Thread(target=write, daemon=True,
                              name="rtpu-array-checkpoint")
    thread.start()
    return AsyncSave(thread, outcome)


def _allocate(leaf: Any) -> Any:
    """An empty tensor in the layout ``leaf`` asks for (or the leaf
    itself, for a value DCP stores as an object)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, ArraySpec):
        if leaf.sharding is None:
            from ray_tpu_torch._private.device import resolve_device
            return torch.empty(leaf.shape, dtype=leaf.dtype,
                               device=resolve_device(leaf.device))
        from ray_tpu_torch.parallel.mesh import to_global
        mesh, spec = leaf.sharding.mesh, leaf.sharding.spec
        local = torch.empty(leaf.sharding.shard_shape(leaf.shape),
                            dtype=leaf.dtype, device=mesh.device_type)
        return to_global(mesh, local, spec)
    if isinstance(leaf, DTensor):
        return DTensor.from_local(
            torch.empty_like(leaf.to_local()), leaf.device_mesh,
            leaf.placements, run_check=False, shape=leaf.shape,
            stride=leaf.stride())
    if isinstance(leaf, torch.Tensor):
        return torch.empty_like(leaf)
    if isinstance(leaf, np.ndarray):
        return torch.empty(leaf.shape, dtype=torch.from_numpy(
            np.empty(0, leaf.dtype)).dtype)
    return _state_leaf(leaf)


def restore_sharded(path: str, template: Any) -> Any:
    """Restore into the shapes, dtypes and layouts of ``template`` — a
    tree of tensors, DTensors, numpy arrays, scalars or
    :class:`ArraySpec`s carrying a ``sharding``. Each rank reads only
    the blocks its shards cover; no host gather. Numpy leaves of the
    template come back as numpy arrays."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    flat = _flatten(template)
    state = {key: _allocate(leaf) for key, leaf in flat}
    dcp.load(state, checkpoint_id=path, process_group=_dcp_group())
    out = {key: (state[key].numpy() if isinstance(leaf, np.ndarray)
                 else state[key]) for key, leaf in flat}
    return _unflatten(template, out)
