"""In-program collectives: the device plane, over ``torch.distributed``.

Counterpart of ``ray_tpu/collective/xla.py``, whose helpers wrap the
``jax.lax`` collectives that XLA compiles into a program. Here each rank is
a process and each helper is a ``torch.distributed`` collective over the
process group of one mesh axis (or of a tuple of axes, which flatten to one
group in mesh order), on NCCL for CUDA tensors and gloo for CPU tensors.

The helpers run inside a per-shard body, as the JAX ones run inside
``jax.shard_map``: ``shard_map_fn`` (or ``axis_env``) names the mesh whose
axes they refer to. Each differentiable helper has the transpose JAX uses:
``all_gather`` and ``reduce_scatter`` are each other's, ``all_to_all``'s is
the inverse exchange, ``ppermute``'s the inverse permutation, and
``psum``'s is the identity on its (replicated) result, paired with
``pvary``, the identity whose transpose is ``psum``. ``pmax`` and ``pmin``
carry no gradient.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.parallel.mesh import P

AxisName = Union[str, Sequence[str]]

# The meshes of the enclosing axis_env blocks, innermost last: the
# counterpart of JAX's axis environment while it traces a shard_map body.
_mesh_stack: List[DeviceMesh] = []


@contextlib.contextmanager
def axis_env(mesh: DeviceMesh):
    """Within the block, axis names refer to ``mesh``."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def current_mesh() -> DeviceMesh:
    if not _mesh_stack:
        raise RuntimeError("no mesh: call collectives inside shard_map_fn or "
                           "an axis_env(mesh) block")
    return _mesh_stack[-1]


def _axis(mesh: DeviceMesh, axis: AxisName
          ) -> Tuple[object, List[int]]:
    """(process group, global ranks in axis-index order) of a mesh axis or
    a tuple of axes. Groups of tuples are made once per mesh, by every rank
    in the same order, as ``new_group`` requires, and kept on the mesh."""
    names = mesh_lib.spec_axes(axis)
    groups: Dict[Tuple[str, ...], tuple] = mesh.__dict__.setdefault(
        "_ray_tpu_torch_groups", {})
    if names not in groups:
        mesh_lib._check_spec(mesh, P(names), 1)
        dims = [mesh.mesh_dim_names.index(a) for a in names]
        rest = [i for i in range(mesh.ndim) if i not in dims]
        grid = mesh.mesh.permute(*rest, *dims).reshape(
            -1, mesh_lib.axis_size(mesh, names)).tolist()
        me = dist.get_rank()
        mine = next(row for row in grid if me in row)
        if len(dims) == 1:
            group = mesh.get_group(dims[0])
        else:
            for row in grid:
                g = dist.new_group(ranks=row)
                if row is mine:
                    group = g
        groups[names] = (group, mine)
    return groups[names]


def axis_index(axis: AxisName) -> int:
    return mesh_lib.axis_index(current_mesh(), axis)


def axis_size(axis: AxisName) -> int:
    return mesh_lib.axis_size(current_mesh(), axis)


# ------------------------------------------------------------ primitives
# Each takes the mesh explicitly: a backward runs outside the axis_env
# block of its forward.

# Newer torch names the tensor forms *_single and deprecates the old names.
_all_gather_tensor = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)

def _all_reduce(mesh, x, axis, op):
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=_axis(mesh, axis)[0])
    return out


def _all_gather(mesh, x, axis, dim, tiled):
    n = mesh_lib.axis_size(mesh, axis)
    flat = x.new_empty(n * x.numel())  # gloo takes the concatenated form
    _all_gather_tensor(flat, x.detach().reshape(-1).contiguous(),
                                group=_axis(mesh, axis)[0])
    out = flat.view(n, *x.shape)
    if tiled:
        return torch.cat(out.unbind(0), dim=dim)
    return out.movedim(0, dim)


def _reduce_scatter(mesh, x, axis, dim, tiled):
    """Sum over the axis, each rank keeping its chunk of ``dim``; with
    ``tiled=False`` ``dim`` is a device dim of the axis's size, dropped."""
    n = mesh_lib.axis_size(mesh, axis)
    src = x.detach().movedim(dim, 0)
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by "
                         f"the {n} ranks of {axis!r}")
    src = src.contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    _reduce_scatter_tensor(out, src, group=_axis(mesh, axis)[0])
    if not tiled:
        return out[0]
    return out.movedim(0, dim)


def _all_to_all(mesh, x, axis, split_axis, concat_axis):
    n = mesh_lib.axis_size(mesh, axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} is not "
                         f"divisible by the {n} ranks of {axis!r}")
    src = torch.stack(x.detach().chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=_axis(mesh, axis)[0])
    return torch.cat(out.unbind(0), dim=concat_axis)


def _ppermute(mesh, x, axis, perm):
    group, ranks = _axis(mesh, axis)
    me = mesh_lib.axis_index(mesh, axis)
    src = x.detach().contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, ranks[d], group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _check_perm(perm, n):
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"perm {perm} is not a partial permutation of "
                         f"range({n})")


# ------------------------------------------------------------ autograd

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(mesh, x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _all_reduce(mesh, g, axis, dist.ReduceOp.SUM), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tiled):
        ctx.args = (mesh, axis, dim, tiled)
        return _all_gather(mesh, x, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return (_ReduceScatter.apply(g, *ctx.args),) + (None,) * 4


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tiled):
        ctx.args = (mesh, axis, dim, tiled)
        return _reduce_scatter(mesh, x, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return (_AllGather.apply(g, *ctx.args),) + (None,) * 4


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(mesh, x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_AllToAll.apply(g, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _ppermute(mesh, x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inverse = tuple((d, s) for s, d in perm)
        return _Ppermute.apply(g, mesh, axis, inverse), None, None, None


# ------------------------------------------------------------ public API

def psum(x, axis: AxisName):
    """All-reduce sum over a mesh axis. Its gradient is the identity: the
    result is the same on every rank of the axis, and so is its
    cotangent."""
    return _Psum.apply(x, current_mesh(), axis)


def pvary(x, axis: AxisName):
    """The identity, whose gradient is summed over the axis: marks a
    replicated value that each rank of the axis goes on to use
    differently (the transpose of ``psum``)."""
    return _Pvary.apply(x, current_mesh(), axis)


def pmean(x, axis: AxisName):
    return psum(x, axis) / axis_size(axis)


def pmax(x, axis: AxisName):
    """All-reduce max over the axis; carries no gradient."""
    return _all_reduce(current_mesh(), x, axis, dist.ReduceOp.MAX)


def pmin(x, axis: AxisName):
    """All-reduce min over the axis; carries no gradient."""
    return _all_reduce(current_mesh(), x, axis, dist.ReduceOp.MIN)


def all_gather(x, axis: AxisName, *, gather_axis: int = 0,
               tiled: bool = True):
    """Gather shards along ``gather_axis`` from every rank on the mesh axis.
    ``tiled=True`` concatenates (the usual layout); ``False`` stacks a new
    device dimension at ``gather_axis``."""
    return _AllGather.apply(x, current_mesh(), axis,
                            gather_axis % (x.dim() + (not tiled)), tiled)


def reduce_scatter(x, axis: AxisName, *, scatter_axis: int = 0):
    """Reduce-sum across the axis, leaving each rank with its shard along
    ``scatter_axis``."""
    return _ReduceScatter.apply(x, current_mesh(), axis,
                                scatter_axis % x.dim(), True)


def all_to_all(x, axis: AxisName, *, split_axis: int, concat_axis: int):
    """Transpose data across the axis: split locally along ``split_axis``,
    exchange (chunk i goes to the rank of index i), concatenate along
    ``concat_axis`` in rank order: the Ulysses and MoE-dispatch primitive."""
    return _AllToAll.apply(x, current_mesh(), axis, split_axis % x.dim(),
                           concat_axis % x.dim())


def ppermute(x, axis: AxisName, perm: Sequence[tuple]):
    """Point-to-point permutation: ``perm`` is [(src, dst), ...] by axis
    index; a rank that no pair sends to receives zeros."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    _check_perm(perm, axis_size(axis))
    return _Ppermute.apply(x, current_mesh(), axis, perm)


def ring_shift(x, axis: AxisName, *, shift: int = 1,
               axis_size: Optional[int] = None):
    """Rotate shards around the mesh axis by ``shift``."""
    n = (axis_size if axis_size is not None
         else mesh_lib.axis_size(current_mesh(), axis))
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)])


def barrier(axis: AxisName):
    """A synchronisation point across the axis (an all-reduce of a
    scalar)."""
    mesh = current_mesh()
    return psum(torch.zeros((), dtype=torch.int32,
                            device=mesh.device_type), axis)


def _to_local(mesh, x, spec):
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    if isinstance(x, DTensor):
        want = mesh_lib.placements(mesh, spec, x.dim())
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()
    return mesh_lib.local_block(mesh, x, spec)


def _to_global(mesh, x, spec):
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    return mesh_lib.to_global(mesh, x, spec)


def shard_map_fn(mesh: DeviceMesh, in_specs, out_specs):
    """Decorator: run a per-shard function over the mesh with explicit
    collectives inside (``jax.shard_map``). The wrapped function takes
    global inputs, full tensors (the same on every rank) or DTensors, and
    splits each to this rank's block by its spec in ``in_specs``; the body
    runs on local tensors with the mesh's axis names in scope; each output
    becomes a DTensor laid out by its spec in ``out_specs``. Specs may be
    trees matching the arguments and outputs; ``None`` passes a value as
    it is. The wrapped function keeps the body as ``.body``, and the mesh
    and the in_specs as ``.mesh`` and ``.in_specs``."""
    specs = (in_specs,) if isinstance(in_specs, P) else tuple(in_specs)

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args):
            if len(specs) != len(args):
                raise ValueError(f"{len(args)} arguments for {len(specs)} "
                                 f"in_specs")
            local = [mesh_lib.tree_map(lambda s, a: _to_local(mesh, a, s),
                                       s, a) for s, a in zip(specs, args)]
            with axis_env(mesh):
                out = fn(*local)
            return mesh_lib.tree_map(lambda s, o: _to_global(mesh, o, s),
                                     out_specs, out)
        wrapped.body = fn
        wrapped.mesh = mesh
        wrapped.in_specs = specs
        return wrapped
    return deco


def device_put_sharded(x, mesh: DeviceMesh, spec: P):
    return mesh_lib.shard(mesh, x, spec)
