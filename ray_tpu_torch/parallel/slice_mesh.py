"""Slice meshes: fast links within a slice, the network across slices.

Counterpart of ``ray_tpu/parallel/slice_mesh.py``. On the TPU a slice is an
island of chips joined by ICI, and slices are joined by the data-center
network (DCN). On NVIDIA cards a slice is an NVLink island, in practice one
host, and hosts are joined by the network. Either way the multi-slice plane
reduces to one invariant of the mesh's construction:

    **exactly one logical axis spans slices; every other axis's rank
    groups stay inside a single slice.**

``SliceTopology`` names that axis (``cross``, usually ``dp``) and the
per-slice layout (``inner``); ``make_slice_mesh`` builds the global
``DeviceMesh`` that honours the invariant, so that every program of the
port runs unchanged over it, and NCCL carries each axis's collectives over
the links its ranks share.

A rank is described by a ``RankDevice``: its global rank, the index of its
host (``process_index``), an optional hardware ``slice_index`` and its
platform. ``rank_devices()`` gathers them over the process group: the host
index is torchrun's ``GROUP_RANK`` where it is set, else the order of first
appearance of the ranks' hostnames; a CUDA rank's slice is its host (one
NVLink island), a CPU rank has none.

Slice membership is discovered, in order:
  1. ``slice_index``: real islands (all CUDA ranks);
  2. ``process_index``: simulated slices, each host (or a contiguous block
     of hosts) one slice;
  3. contiguous blocks of the rank list (CPU ranks of one host).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.collective import xla
from ray_tpu_torch.parallel.mesh import MESH_AXES, MeshSpec, axis_index, \
    tree_map


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """S slices, each laid out as ``inner``; ``cross`` spans slices.

    ``inner`` must leave the ``cross`` axis at 1: the global spec is
    ``inner`` with ``cross`` set to ``num_slices``.
    """

    num_slices: int
    inner: MeshSpec
    cross: str = "dp"

    def __post_init__(self):
        if self.num_slices < 1:
            raise ValueError(f"num_slices must be >= 1, got {self.num_slices}")
        if self.cross not in MESH_AXES:
            raise ValueError(
                f"cross axis {self.cross!r} not one of {MESH_AXES}")
        if getattr(self.inner, self.cross) != 1:
            raise ValueError(
                f"inner spec must leave the cross axis {self.cross!r} at 1 "
                f"(got {getattr(self.inner, self.cross)}); the global extent "
                f"of {self.cross!r} is num_slices")

    @property
    def devices_per_slice(self) -> int:
        return self.inner.num_devices

    @property
    def global_spec(self) -> MeshSpec:
        return dataclasses.replace(self.inner, **{self.cross: self.num_slices})

    def axis_sizes(self) -> Dict[str, int]:
        return self.global_spec.axis_sizes()


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One rank of the process group: its global rank (``id``), its host
    (``process_index``), its hardware slice, if any, and its platform
    (``"cuda"`` or ``"cpu"``)."""
    id: int
    process_index: int = 0
    slice_index: Optional[int] = None
    platform: str = "cuda"

    def __repr__(self):
        return f"r{self.id}"


def _host_indices() -> List[int]:
    """Each rank's host index: torchrun's ``GROUP_RANK`` where it is set,
    else the rank of its hostname's first appearance. A collective: every
    rank calls it."""
    group_rank = os.environ.get("GROUP_RANK")
    key = int(group_rank) if group_rank is not None else socket.gethostname()
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    if group_rank is not None:
        return keys
    first: Dict[str, int] = {}
    for k in keys:
        first.setdefault(k, len(first))
    return [first[k] for k in keys]


def rank_devices() -> List[RankDevice]:
    """A ``RankDevice`` for every rank of the initialised process group, in
    rank order (a collective: every rank calls it)."""
    platform = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return [RankDevice(rank, host, host if platform == "cuda" else None,
                       platform)
            for rank, host in enumerate(_host_indices())]


def _slice_id_of(dev) -> Optional[int]:
    """Hardware slice id if the rank has one."""
    sid = getattr(dev, "slice_index", None)
    if isinstance(sid, int) and sid >= 0:
        return sid
    return None


def group_devices_by_slice(devices: Sequence, num_slices: int,
                           per: Optional[int] = None,
                           allow_split_slices: bool = False
                           ) -> List[List]:
    """Partition ``devices`` (``RankDevice``s) into ``num_slices`` groups
    of ``per`` ranks each, honouring physical boundaries.

    Grouping keys, in priority order: ``slice_index`` (real islands:
    surplus slices and ranks beyond the topology are dropped from the END,
    never mixed), ``process_index`` (simulated slices: one host, a
    contiguous block of hosts, or a fraction of one host per slice, never
    straddling), positional blocks (one host of CPU ranks). Physical
    boundaries are discovered on the FULL list before any surplus is
    dropped. A grouping that would put one slice's ranks on both sides of a
    physical boundary raises instead of silently degrading;
    ``allow_split_slices=True`` opts out of the hardware tier, to simulate
    several slices on one island.
    """
    devs = list(devices)
    if per is None:
        if len(devs) % num_slices != 0:
            raise ValueError(
                f"{len(devs)} devices not divisible into "
                f"{num_slices} slices")
        per = len(devs) // num_slices

    # Tier 1: hardware slice ids (including the all-one-slice case:
    # splitting a real island in two would put the cross axis on its fast
    # links, so that asks for an explicit allow_split_slices). CPU ranks
    # have no hardware to misrepresent, so the strict tier skips them.
    sids = [_slice_id_of(d) for d in devs]
    all_cpu = all(getattr(d, "platform", "") == "cpu" for d in devs)
    if all(s is not None for s in sids) and not all_cpu \
            and not allow_split_slices:
        groups: Dict[int, List] = {}
        for d, s in zip(devs, sids):
            groups.setdefault(s, []).append(d)
        if len(groups) < num_slices:
            raise ValueError(
                f"hardware reports {len(groups)} slice(s) "
                f"({sorted(groups)}), topology wants {num_slices}; "
                f"pass allow_split_slices=True to simulate more "
                f"slices than the hardware has")
        out = []
        for s in sorted(groups)[:num_slices]:
            if len(groups[s]) < per:
                raise ValueError(
                    f"hardware slice {s} has {len(groups[s])} devices, "
                    f"topology needs {per} per slice")
            out.append(groups[s][:per])
        return out

    # Tier 2: host boundaries, discovered on the full list.
    pids = sorted({getattr(d, "process_index", 0) for d in devs})
    if len(pids) > 1:
        by_pid: Dict[int, List] = {p: [] for p in pids}
        for d in devs:
            by_pid[getattr(d, "process_index", 0)].append(d)
        if len(pids) % num_slices == 0:
            # A contiguous block of hosts per slice.
            procs_per_slice = len(pids) // num_slices
            out = []
            for s in range(num_slices):
                block: List = []
                for p in pids[s * procs_per_slice:
                              (s + 1) * procs_per_slice]:
                    block.extend(by_pid[p])
                if len(block) < per:
                    raise ValueError(
                        f"slice {s} (processes "
                        f"{pids[s * procs_per_slice:(s + 1) * procs_per_slice]}) "
                        f"has {len(block)} devices, topology needs {per}")
                out.append(block[:per])
            return out
        if num_slices % len(pids) == 0:
            # Several simulated slices inside each host: sound because no
            # block straddles a host.
            slices_per_proc = num_slices // len(pids)
            out = []
            for p in pids:
                if len(by_pid[p]) < slices_per_proc * per:
                    raise ValueError(
                        f"process {p} has {len(by_pid[p])} devices, "
                        f"needs {slices_per_proc * per} for "
                        f"{slices_per_proc} slices")
                for s in range(slices_per_proc):
                    out.append(by_pid[p][s * per:(s + 1) * per])
            return out
        raise ValueError(
            f"cannot partition devices across {len(pids)} processes "
            f"into {num_slices} slices without a slice straddling a "
            f"process boundary; use a slice count that divides (or is "
            f"a multiple of) the process count")

    # Tier 3: positional blocks (one host, no hardware ids).
    devs = devs[:num_slices * per]
    if len(devs) < num_slices * per:
        raise ValueError(
            f"need {num_slices * per} devices, have {len(devs)}")
    return [devs[i * per:(i + 1) * per] for i in range(num_slices)]


class SliceMesh:
    """A global mesh and its slice decomposition.

    ``devices`` is the grid of ``RankDevice``s in mesh order (dims
    ``MESH_AXES``); ``mesh`` the ``DeviceMesh`` over their ranks, made on
    first use (it needs the process group, the geometry does not). It
    knows which axis spans slices and gives each slice's own mesh.
    """

    def __init__(self, topology: SliceTopology, grid: np.ndarray,
                 slice_groups: List[List]):
        self.topology = topology
        self.devices = grid
        self._slice_groups = slice_groups
        self._mesh = None

    @property
    def mesh(self) -> DeviceMesh:
        if self._mesh is None:
            ranks = torch.tensor(np.vectorize(lambda d: d.id)(self.devices))
            self._mesh = DeviceMesh(self.devices.flat[0].platform, ranks,
                                    mesh_dim_names=MESH_AXES)
        return self._mesh

    @property
    def axis_names(self):
        return MESH_AXES

    @property
    def shape(self) -> Dict[str, int]:
        return self.topology.axis_sizes()

    # -- slice plane -------------------------------------------------
    @property
    def num_slices(self) -> int:
        return self.topology.num_slices

    @property
    def dcn_axis(self) -> str:
        """The logical axis whose collectives cross slices."""
        return self.topology.cross

    @property
    def ici_axes(self) -> tuple:
        return tuple(a for a in MESH_AXES if a != self.topology.cross)

    def slice_devices(self, i: int) -> List:
        return list(self._slice_groups[i])

    def local_slice_index(self) -> int:
        """The slice this rank landed in, under every grouping tier."""
        me = dist.get_rank()
        hits = [i for i, g in enumerate(self._slice_groups)
                if any(d.id == me for d in g)]
        if len(hits) != 1:
            raise ValueError(f"rank {me} belongs to slices {hits}; per-slice "
                             f"gating needs exactly one")
        return hits[0]

    def slice_submesh(self, i: int) -> DeviceMesh:
        """Slice i's ranks as a mesh of their own (``inner`` layout), for
        per-slice work (slice-local eval, per-slice data loading). Every
        rank of the process group calls it, as it makes process groups."""
        shape = tuple(self.topology.inner.axis_sizes().values())
        ranks = torch.tensor([d.id for d in self._slice_groups[i]]
                             ).reshape(shape)
        return DeviceMesh(self.devices.flat[0].platform, ranks,
                          mesh_dim_names=MESH_AXES)

    def describe(self) -> Dict[str, object]:
        return {
            "slices": self.num_slices,
            "devices_per_slice": self.topology.devices_per_slice,
            "dcn_axis": self.dcn_axis,
            "global": dict(self.topology.axis_sizes()),
        }


def make_slice_mesh(topology: SliceTopology,
                    devices: Optional[Sequence] = None,
                    allow_split_slices: bool = False) -> SliceMesh:
    """Build the global mesh with the cross-slice axis aligned to slice
    boundaries.

    The rank grid is assembled per slice (each slice's ranks reshaped to
    the ``inner`` grid), then stacked along the ``cross`` dimension, so
    indexing along ``cross`` walks across slices and every other axis stays
    inside one slice. ``devices`` defaults to ``rank_devices()`` (a
    collective)."""
    devs = list(devices if devices is not None else rank_devices())
    need = topology.num_slices * topology.devices_per_slice
    if len(devs) < need:
        raise ValueError(
            f"topology needs {need} devices "
            f"({topology.num_slices} slices x "
            f"{topology.devices_per_slice}), have {len(devs)}")
    # The full list goes to the grouper: hardware slice boundaries must be
    # discovered before any surplus ranks are dropped.
    groups = group_devices_by_slice(devs, topology.num_slices,
                                    per=topology.devices_per_slice,
                                    allow_split_slices=allow_split_slices)
    inner_shape = tuple(topology.inner.axis_sizes().values())
    per_slice = []
    for g in groups:
        block = np.empty(len(g), dtype=object)
        block[:] = g
        per_slice.append(block.reshape(inner_shape))
    grid = np.concatenate(per_slice, axis=MESH_AXES.index(topology.cross))
    return SliceMesh(topology, grid, groups)


def broadcast_one_slice_to_all(in_tree, source_slice: int,
                               slice_mesh: SliceMesh):
    """Disseminate one slice's data to every slice over the cross-slice
    axis: a checkpoint read from storage by ONE slice reaches the rest
    through the network instead of every slice reading storage again.

    Every rank passes a tree of arrays or tensors of the same shapes; the
    source slice's ranks hold the data, the others' contents are ignored.
    Each leaf is summed over the cross axis, the source slice's data
    against zeros from every other slice, one leaf at a time. Returns the
    tree of the source slice's leaves as tensors on the mesh's device type,
    the same on every rank."""
    num = slice_mesh.num_slices
    if not 0 <= source_slice < num:
        raise ValueError(
            f"source_slice {source_slice} out of range for {num} slices")
    mesh = slice_mesh.mesh
    cross = slice_mesh.dcn_axis
    mine = axis_index(mesh, cross) == source_slice

    def one(x):
        t = torch.as_tensor(np.asarray(x)).to(mesh.device_type)
        return xla.psum(t if mine else torch.zeros_like(t), cross)

    with torch.no_grad(), xla.axis_env(mesh):
        return tree_map(one, in_tree)


def slice_index() -> int:
    """This rank's hardware slice id (a CUDA rank's host), else 0. Under
    simulated topologies CPU ranks carry no slice id, so this returns 0
    everywhere: use ``SliceMesh.local_slice_index()``, which knows the
    topology's actual grouping, for per-slice gating. A collective: every
    rank calls it."""
    sid = _slice_id_of(rank_devices()[dist.get_rank()])
    return sid if sid is not None else 0
