"""TorchTrainer: torch-DDP training on the actor gang.

Reference: ``python/ray/train/torch/`` — ``TorchTrainer`` +
``TorchConfig`` set up a c10d process group across the worker gang and
``prepare_model`` wraps the model in DistributedDataParallel
[UNVERIFIED — mount empty, SURVEY.md §0]. Here the gang is the same
placement-group actor gang every trainer uses; the backend hook brings
up a gloo process group over a per-attempt TCP rendezvous.

The port's copy of ``ray_tpu/train/torch.py``, as the reference has it:
gloo, process workers, and ``get_device()`` the CPU. The port's own
accelerator path is the mesh of ``ray_tpu_torch.parallel`` (NCCL inside
the program), not DDP. ``dist.init_process_group`` sets one default
group per process, so two workers on threads of the driver (GPU-demand
workers) cannot both hold one: give TorchTrainer workers no ``GPU``.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Any, Dict, Optional

from ray_tpu_torch.train.trainer import DataParallelTrainer


@dataclasses.dataclass
class TorchConfig:
    backend: str = "gloo"
    init_timeout_s: float = 120.0


def _torch_backend_setup(ctx):
    """Runs in every gang worker before the user loop."""
    import datetime

    import torch.distributed as dist

    cfg = ctx.backend_config
    dist.init_process_group(
        backend=cfg.get("backend", "gloo"),
        init_method=(f"tcp://{cfg['master_addr']}:{cfg['master_port']}"),
        rank=ctx.rank, world_size=ctx.world_size,
        timeout=datetime.timedelta(
            seconds=cfg.get("init_timeout_s", 120.0)))

    def teardown():
        dist.destroy_process_group()

    return teardown


def prepare_model(model):
    """Wrap for distributed training (DDP when world_size > 1)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel
        return DistributedDataParallel(model)
    return model


def get_device():
    import torch
    return torch.device("cpu")


class TorchTrainer(DataParallelTrainer):
    def __init__(self, train_loop_per_worker, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        super().__init__(train_loop_per_worker, **kwargs)
        self._torch_config = torch_config or TorchConfig()
        self._backend_setup = _torch_backend_setup

    def _attempt_backend_config(self) -> Dict[str, Any]:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return {"master_addr": "127.0.0.1", "master_port": port,
                "backend": self._torch_config.backend,
                "init_timeout_s": self._torch_config.init_timeout_s}
