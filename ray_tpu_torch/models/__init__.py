"""Models of the port: the flagship transformer, its training step (on
one device or sharded over a mesh), the ViT family on the same block
stack, and their parameter conversion from the JAX package."""

from ray_tpu_torch.models.convert import params_from_jax, shard_params_from_jax
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
    param_specs,
)
from ray_tpu_torch.models.training import (
    TrainState,
    init_state,
    make_optimizer,
    make_train_step,
    state_specs,
)
from ray_tpu_torch.models.vit import (
    ViTConfig,
    init_vit_params,
    vit_forward,
    vit_loss_fn,
    vit_param_specs,
)

__all__ = ["TrainState", "TransformerConfig", "ViTConfig", "forward",
           "init_params", "init_state", "init_vit_params", "loss_fn",
           "make_optimizer", "make_train_step", "param_specs",
           "params_from_jax", "shard_params_from_jax", "state_specs",
           "vit_forward", "vit_loss_fn", "vit_param_specs"]
