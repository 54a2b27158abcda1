"""ray_tpu_torch.train: data-parallel training on actor gangs (the role
of Ray Train: in-worker sync is the worker's own program, cross-worker
sync is the host collective plane, recovery is gang restart from
checkpoint). The port's copy of ``ray_tpu.train``, less its
``JaxTrainer`` alias."""

from ray_tpu_torch.train._session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, load_pytree, save_pytree
from ray_tpu_torch.train.multislice import MultiSliceConfig, MultiSliceTrainer
from ray_tpu_torch.train.trainer import (
    CheckpointConfig,
    DataParallelTrainer,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)

__all__ = [
    "Checkpoint", "CheckpointConfig", "DataParallelTrainer",
    "FailureConfig", "MultiSliceConfig",
    "MultiSliceTrainer", "Result", "RunConfig", "ScalingConfig",
    "TrainContext", "get_checkpoint", "get_context", "get_dataset_shard",
    "load_pytree", "report", "save_pytree",
]
