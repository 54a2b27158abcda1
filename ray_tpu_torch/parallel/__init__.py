"""Parallelism substrate of the port: meshes and shardings over
``torch.distributed`` (``mesh``), slice meshes (``slice_mesh``), multi-host
process groups (``multihost``), the pipeline over ``pp`` (``pipeline``)
and a launcher of local ranks (``launch``)."""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES, BATCH_AXES, DATA_AXES, MeshSpec, NamedSharding, P, batch_spec,
    local_mesh, make_mesh, shard, sharding_for, tree_shardings)
from ray_tpu_torch.parallel.slice_mesh import (  # noqa: F401
    SliceMesh, SliceTopology, make_slice_mesh, slice_index)
