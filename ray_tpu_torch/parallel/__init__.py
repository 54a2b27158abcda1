"""Parallelism substrate of the port: meshes and shardings over
``torch.distributed`` (``mesh``), and a launcher of local ranks
(``launch``)."""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXES, BATCH_AXES, DATA_AXES, MeshSpec, NamedSharding, P, batch_spec,
    local_mesh, make_mesh, shard, sharding_for, tree_shardings)
