"""Collectives of the port: actor-level groups (host plane,
``collective.py``) and the device plane (``xla``), in-program
collectives over ``torch.distributed``."""

from ray_tpu_torch.collective.collective import (
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    cleanup_stale_epochs,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_group_epoch,
    get_rank,
    group_root,
    init_collective_group,
    recv,
    reducescatter,
    send,
    write_abort_marker,
    write_group_state,
)
from ray_tpu_torch.exceptions import CollectiveAbortError


def __getattr__(name):
    # ``xla`` imports torch: load it on first use, so that an actor on
    # the host plane in a process worker does not pay for torch.
    if name == "xla":
        import importlib
        return importlib.import_module("ray_tpu_torch.collective.xla")
    raise AttributeError(name)


__all__ = [
    "CollectiveAbortError", "ReduceOp", "allgather", "allreduce",
    "barrier", "broadcast", "cleanup_stale_epochs",
    "create_collective_group", "destroy_collective_group",
    "get_collective_group_size", "get_group_epoch", "get_rank",
    "group_root", "init_collective_group", "recv", "reducescatter",
    "send", "write_abort_marker", "write_group_state", "xla",
]
