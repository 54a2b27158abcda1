"""Device mesh and sharding substrate, on ``torch.distributed``.

Counterpart of ``ray_tpu/parallel/mesh.py``: a named mesh over the ranks of
a process group, sharding rules as PartitionSpec trees, and the blocks each
rank holds. The JAX package's ``jax.sharding.Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` over ranks 0..n-1 in row-major
order (the order in which JAX reshapes its device list), so rank r holds the
block that device r holds in JAX. A ``NamedSharding`` becomes this module's
``NamedSharding`` (the mesh, the spec and its DTensor placements), and
``jax.device_put`` becomes ``shard``, which gives a DTensor made from this
rank's block, with no communication.

Axes follow the JAX package:
  dp    pure data parallel (gradients summed over the axis)
  fsdp  data parallel with parameter sharding (ZeRO-3)
  tp    tensor parallel (weight matrices sharded, activations summed at
        block boundaries)
  sp    sequence parallel (ring attention's KV rotation)
  ep    expert parallel (MoE all-to-all); it reuses the data axes and is not
        a mesh dimension
  pp    pipeline stages
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ray_tpu_torch._private.device import resolve_device

AXES = ("dp", "fsdp", "pp", "sp", "tp", "ep")
MESH_AXES = ("dp", "fsdp", "pp", "sp", "tp")


class P(tuple):
    """A PartitionSpec: one entry per tensor dim, each ``None`` (not
    sharded), a mesh axis name, or a tuple of names (the dim sharded over
    all of them, the first the most significant)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one entry of a spec, as a tuple of names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout. Unset axes default to 1.

    ``ep`` shares ranks with (dp, fsdp, sp) in MoE layers rather than
    occupying its own mesh dimension, so it is not multiplied into the rank
    count.
    """

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.pp * self.sp * self.tp

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    @staticmethod
    def auto(n_devices: Optional[int] = None, *,
             tp: int = 1, sp: int = 1, pp: int = 1) -> "MeshSpec":
        """Fill the leftover rank factor into fsdp. ``n_devices`` defaults
        to the world size of the initialised process group."""
        n = n_devices or _world_size()
        rest = n // (tp * sp * pp)
        if rest * tp * sp * pp != n:
            raise ValueError(f"{n} devices not divisible by tp*sp*pp="
                             f"{tp * sp * pp}")
        return MeshSpec(fsdp=rest, tp=tp, sp=sp, pp=pp)


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group (one rank per device) first")
    return dist.get_world_size()


def make_mesh(spec: MeshSpec, device="cuda") -> DeviceMesh:
    """A DeviceMesh with dims ``MESH_AXES`` over ranks 0..n-1 of the
    initialised process group, row-major. The world size must equal
    ``spec.num_devices``. ``device`` is the device type of every rank's
    tensors: ``"cuda"`` (NCCL) unless the caller asks for ``"cpu"``
    (gloo)."""
    dev = resolve_device(device)
    world = _world_size()
    if world != spec.num_devices:
        raise ValueError(f"mesh spec needs {spec.num_devices} ranks, the "
                         f"process group has {world}")
    shape = tuple(spec.axis_sizes().values())
    grid = torch.arange(spec.num_devices).reshape(shape)
    return DeviceMesh(dev.type, grid, mesh_dim_names=MESH_AXES)


def local_mesh(n: int = 0, device="cuda") -> DeviceMesh:
    """Mesh over all (or the first n, which must be all) ranks, fsdp-only:
    the default single-host layout."""
    return make_mesh(MeshSpec(fsdp=n or _world_size()), device)


# Composite axis groups used in shardings: batch is split over every
# data-ish axis; model (hidden) dims over tp.
BATCH_AXES = ("dp", "fsdp")
DATA_AXES = ("dp", "fsdp", "sp")  # full data extent incl. seq shards


def batch_spec() -> P:
    return P(BATCH_AXES, "sp", None)  # [batch, seq, ...]


def axis_size(mesh: DeviceMesh, names) -> int:
    """Ranks along a mesh axis or a tuple of axes."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in spec_axes(names))


def axis_index(mesh: DeviceMesh, names) -> int:
    """This rank's index along a mesh axis or a tuple of axes (row-major,
    the first axis the most significant), as ``lax.axis_index``."""
    coord = mesh.get_coordinate()
    idx = 0
    for a in spec_axes(names):
        i = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _check_spec(mesh: DeviceMesh, spec: P, ndim: int) -> None:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    seen = []
    for entry in spec:
        names = spec_axes(entry)
        for a in names:
            if a not in mesh.mesh_dim_names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {mesh.mesh_dim_names}")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.append(a)
        order = [mesh.mesh_dim_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: the axes of one dim must come in "
                             f"mesh order {mesh.mesh_dim_names}")


def placements(mesh: DeviceMesh, spec: P, ndim: Optional[int] = None
               ) -> Tuple[Placement, ...]:
    """DTensor placements of a spec: ``Shard(i)`` on each mesh dim that the
    spec names at tensor dim i, ``Replicate()`` on every other."""
    _check_spec(mesh, spec, len(spec) if ndim is None else ndim)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if name in spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_shape(mesh: DeviceMesh, shape: Sequence[int], spec: P
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    _check_spec(mesh, spec, len(shape))
    out = list(shape)
    for i, entry in enumerate(spec):
        n = axis_size(mesh, entry)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} is not divisible by "
                             f"the {n} ranks of {entry!r}")
        out[i] //= n
    return tuple(out)


def local_block(mesh: DeviceMesh, x: torch.Tensor, spec: P) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``: a view
    (narrowed along each sharded dim), differentiable."""
    block = shard_shape(mesh, x.shape, spec)
    for i, entry in enumerate(spec):
        if spec_axes(entry):
            x = x.narrow(i, axis_index(mesh, entry) * block[i], block[i])
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Counterpart of ``jax.sharding.NamedSharding``: a mesh and a spec."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return shard_shape(self.mesh, shape, self.spec)


def sharding_for(mesh: DeviceMesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def to_global(mesh: DeviceMesh, local: torch.Tensor, spec: P) -> DTensor:
    """A DTensor from this rank's block under ``spec`` (no communication;
    every rank passes its own block)."""
    shape = list(local.shape)
    for i, entry in enumerate(spec):
        shape[i] *= axis_size(mesh, entry)
    return DTensor.from_local(local, mesh, placements(mesh, spec, local.dim()),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def shard(mesh: DeviceMesh, x: torch.Tensor, spec: P) -> DTensor:
    """Counterpart of ``jax.device_put(x, NamedSharding(mesh, spec))``: every
    rank passes the same global ``x`` and keeps its own block, copied onto
    the mesh's device type, as a DTensor. No communication."""
    block = local_block(mesh, x, spec).to(mesh.device_type).contiguous()
    return to_global(mesh, block, spec)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists and tuples (a ``P``
    is a leaf), with the matching leaves of the trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_shardings(mesh: DeviceMesh, spec_tree) -> object:
    """Map a tree of PartitionSpecs to NamedShardings."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)
