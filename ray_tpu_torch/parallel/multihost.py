"""Multi-host meshes: one process group over the ranks of several hosts.

Counterpart of ``ray_tpu/parallel/multihost.py``. There ``jax.distributed``
connects one process per host, each holding several devices. A torch rank
holds one card, so a host here is a block of ``local_device_count()``
consecutive ranks, and ``initialize`` joins this rank into one process
group that meets at a TCP store on the coordinator's address. The same
SPMD programs then run on meshes that span hosts, their collectives
crossing hosts over NCCL (gloo for CPU ranks).

Usage (the same code on every rank; torchrun's ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` say which rank of its host this one is)::

    from ray_tpu_torch.parallel import multihost
    multihost.initialize("10.0.0.1:7777", num_processes=4, process_id=host)
    mesh = multihost.global_mesh(MeshSpec.auto())   # spans all hosts

Tests simulate hosts with processes on one machine (``spawn_local_group``),
each host a block of ranks, with torchrun's variables set for each.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.mesh import (
    MeshSpec, P, axis_index, make_mesh, shard_shape, spec_axes, to_global)

# This rank's host and the ranks a host holds, set by initialize.
_host = {"process_index": 0, "local_device_count": 1, "initialized": False}


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, local_rank: Optional[int] = None,
               local_device_count: Optional[int] = None,
               device="cuda", timeout_s: float = 600.0) -> None:
    """Join this rank into the process group of ``num_processes`` hosts of
    ``local_device_count`` ranks each (default torchrun's
    ``LOCAL_WORLD_SIZE``, else 1), as rank ``local_rank`` (default
    ``LOCAL_RANK``, else 0) of host ``process_id``, at a TCP store on
    ``coordinator_address`` ("host:port"). On ``device="cuda"`` the rank
    takes card ``local_rank`` and NCCL; on ``"cpu"``, gloo. Idempotent per
    process."""
    if _host["initialized"]:
        return
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if local_device_count is None:
        local_device_count = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        rank=process_id * local_device_count + local_rank,
        world_size=num_processes * local_device_count,
        timeout=datetime.timedelta(seconds=timeout_s))
    _host.update(process_index=process_id,
                 local_device_count=local_device_count, initialized=True)


def is_initialized() -> bool:
    return _host["initialized"]


def global_device_count() -> int:
    """Ranks of the process group, every host's."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    """Ranks of this host."""
    return _host["local_device_count"]


def process_index() -> int:
    """This rank's host."""
    return _host["process_index"]


def global_mesh(spec: Optional[MeshSpec] = None, device="cuda"):
    """A mesh over every rank of every host. With no spec, fsdp over
    all of them."""
    if spec is None:
        spec = MeshSpec(fsdp=global_device_count())
    return make_mesh(spec, device)


def host_local_batch(local_rows: torch.Tensor, mesh, spec: P):
    """This host's rows of a batch split over hosts, as the global DTensor
    laid out by ``spec``: host h passes rows [h n, (h + 1) n) of the global
    batch (n rows a host, whole along every other dim), and each rank makes
    its block from them, with no communication (``DTensor.from_local``).
    A rank's block must lie within its host's rows."""
    n = local_rows.shape[0]
    hosts = global_device_count() // local_device_count()
    shape = (n * hosts, *local_rows.shape[1:])
    block_shape = shard_shape(mesh, shape, spec)
    local = local_rows
    for dim, entry in enumerate(spec):
        if not spec_axes(entry):
            continue
        start = axis_index(mesh, entry) * block_shape[dim]
        if dim == 0:
            first = process_index() * n
            if not first <= start <= first + n - block_shape[0]:
                raise ValueError(
                    f"rank {dist.get_rank()}'s rows [{start}, "
                    f"{start + block_shape[0]}) lie outside host "
                    f"{process_index()}'s rows [{first}, {first + n})")
            start -= first
        local = local.narrow(dim, start, block_shape[dim])
    return to_global(mesh, local.to(mesh.device_type).contiguous(), spec)


def spawn_local_group(script: str, num_processes: int,
                      devices_per_process: int, port: int = 0,
                      timeout: float = 300.0,
                      extra_args: Optional[Sequence[str]] = None
                      ) -> List[subprocess.CompletedProcess]:
    """Test harness: run ``script`` as ``num_processes`` simulated hosts of
    ``devices_per_process`` ranks each, every rank a process started as
    ``script coordinator num_processes process_id *extra_args`` with
    torchrun's ``GROUP_RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``RANK`` and ``WORLD_SIZE`` set. Returns each rank's completed process,
    output in ``stdout``, in rank order. When a rank fails the others get
    30 s to end; at ``timeout`` every rank left is killed and it raises."""
    if port == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    coord = f"127.0.0.1:{port}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    world = num_processes * devices_per_process
    procs, logs = [], []
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_hosts_") as tmp:
        try:
            for rank in range(world):
                pid, local = divmod(rank, devices_per_process)
                env = dict(os.environ, GROUP_RANK=str(pid),
                           LOCAL_RANK=str(local),
                           LOCAL_WORLD_SIZE=str(devices_per_process),
                           RANK=str(rank), WORLD_SIZE=str(world))
                env["PYTHONPATH"] = os.pathsep.join(
                    [root] + env.get("PYTHONPATH", "").split(os.pathsep))
                logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, script, coord, str(num_processes),
                     str(pid), *(extra_args or ())],
                    env=env, stdout=logs[-1], stderr=subprocess.STDOUT,
                    text=True))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    raise RuntimeError(_outputs(
                        "multihost member timed out", procs, logs))
                if any(p.returncode for p in procs):
                    deadline = min(deadline, time.monotonic() + 30)
                time.sleep(0.05)
            done = []
            for p, log in zip(procs, logs):
                log.seek(0)
                done.append(subprocess.CompletedProcess(
                    p.args, p.returncode, log.read(), None))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
    return done


def _outputs(what, procs, logs) -> str:
    parts = [what]
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.flush()
        log.seek(0)
        parts.append(f"--- rank {rank} (exit {p.poll()}):\n"
                     f"{log.read()[-3000:]}")
    return "\n".join(parts)
