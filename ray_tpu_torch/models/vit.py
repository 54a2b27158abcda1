"""Vision Transformer on the shared block stack, in PyTorch.

Counterpart of ``ray_tpu/models/vit.py``, the second model family: patch
embedding in, the flagship's decoder block with non-causal attention
inside, mean-pool and a linear head out. Position information is 1D RoPE
over the patch index, as in the JAX package. Attention is always the dense
non-causal ``_attention``, as there (no flash route).

Parameters are a dictionary of fp32 tensors with the JAX package's names
and shapes, cast to ``cfg.dtype`` at each use; logits come back in fp32.
``models/sharded.py::vit_loss_fn_shard`` runs the loss on a rank's blocks
of a mesh, laid out by ``vit_param_specs``: ``vit_forward`` itself, with
the hooks of a rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.transformer import (
    TransformerConfig, _attention, _dense_init, apply_blocks, init_params,
    param_specs, rms_norm)
from ray_tpu_torch.parallel.mesh import P
from ray_tpu_torch.util.tracing import span


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10
    d_model: int = 128
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 352
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    def block_config(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=8, d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            d_ff=self.d_ff, max_seq_len=self.num_patches,
            dtype=self.dtype, remat=self.remat)


def init_vit_params(cfg: ViTConfig, seed: int = 0, *,
                    device="cuda") -> Dict:
    """Random parameters with the JAX package's distributions: the blocks
    and the final norm of ``init_params(cfg.block_config(), seed)``, the
    patch embedding and the head from a generator seeded with
    ``seed + 1``, the patch bias zero."""
    dev = resolve_device(device)
    inner = init_params(cfg.block_config(), seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    init = functools.partial(_dense_init, gen, device=dev)
    return {
        "patch_embed": init((cfg.patch_dim, cfg.d_model)),
        "patch_bias": torch.zeros(cfg.d_model, dtype=torch.float32,
                                  device=dev),
        "blocks": inner["blocks"],
        "final_norm": inner["final_norm"],
        "head": init((cfg.d_model, cfg.num_classes)),
    }


def vit_param_specs(cfg: ViTConfig) -> Dict:
    inner = param_specs(cfg.block_config())
    return {
        "patch_embed": P(None, "tp"),
        "patch_bias": P(None),
        "blocks": inner["blocks"],
        "final_norm": P(None),
        "head": P("tp", None),
    }


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, P*P*C] (row-major patch grid)."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def patch_positions(x: torch.Tensor) -> torch.Tensor:
    """[B, N] patch indices of the embedded patches ``x`` [B, N, D]."""
    return torch.arange(x.shape[1], dtype=torch.int32,
                        device=x.device)[None, :].expand(x.shape[:2])


def vit_attention(q, k, v):
    """The dense non-causal attention every ViT block runs."""
    return _attention(q, k, v, causal=False)


class ViTHooks:
    """Where ViT on a mesh differs from ViT on one device, outside its
    blocks (whose differences are ``BlockHooks``). Each hook is the
    identity here; ``models/sharded.py`` overrides them with a rank's
    share of the patch embedding and the head."""

    blocks = None   # one BlockHooks per block; None: NO_MESH for each

    def patch_embed(self, params: Dict) -> torch.Tensor:
        """The patch embedding [P*P*C, D] as the product uses it."""
        return params["patch_embed"]

    def enter_head(self, pooled: torch.Tensor) -> torch.Tensor:
        """The pooled features [B, D] the head's rows contract."""
        return pooled

    def leave_head(self, logits: torch.Tensor) -> torch.Tensor:
        """The (partial) logits the head leaves."""
        return logits


NO_MESH = ViTHooks()


def vit_forward(params: Dict, images: torch.Tensor, cfg: ViTConfig,
                hooks: ViTHooks = NO_MESH) -> torch.Tensor:
    """images [B, H, W, C] float -> logits [B, num_classes] fp32."""
    dt = cfg.dtype
    x = patchify(images.to(dt), cfg)
    x = x @ hooks.patch_embed(params).to(dt) + params["patch_bias"].to(dt)
    x = apply_blocks(params["blocks"], x, patch_positions(x),
                     cfg.block_config(), vit_attention, hooks.blocks)
    x = rms_norm(x, params["final_norm"])
    pooled = hooks.enter_head(x.mean(dim=1))
    return hooks.leave_head(pooled @ params["head"].to(dt)).float()


def vit_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[B] negative log-likelihoods of ``labels`` under ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def vit_loss_fn(params: Dict, batch: Dict[str, torch.Tensor],
                cfg: ViTConfig) -> torch.Tensor:
    """Mean cross-entropy of ``batch["labels"]`` [B] under the logits of
    ``batch["images"]``."""
    with span("rt.train.forward"):
        return vit_nll(vit_forward(params, batch["images"], cfg),
                       batch["labels"]).mean()
