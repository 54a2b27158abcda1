"""Ops of the port: the flash-attention kernels and the dense reference,
sequence-parallel attention (ring, Ulysses) and expert-parallel MoE."""

from ray_tpu_torch.ops.flash_attention import flash_attention, mha_reference
from ray_tpu_torch.ops.moe import make_moe_fn, moe_mlp_shard
from ray_tpu_torch.ops.ring_attention import (
    make_attention_fn,
    ring_attention_shard,
    ulysses_attention_shard,
)

__all__ = [
    "flash_attention", "mha_reference", "make_attention_fn",
    "make_moe_fn", "moe_mlp_shard",
    "ring_attention_shard", "ulysses_attention_shard",
]
