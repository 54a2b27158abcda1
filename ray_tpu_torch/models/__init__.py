"""Models of the port: the flagship transformer, its training step, and
its parameter conversion from the JAX package."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
)
from ray_tpu_torch.models.training import (
    TrainState,
    init_state,
    make_optimizer,
    make_train_step,
)

__all__ = ["TrainState", "TransformerConfig", "forward", "init_params",
           "init_state", "loss_fn", "make_optimizer", "make_train_step",
           "params_from_jax"]
