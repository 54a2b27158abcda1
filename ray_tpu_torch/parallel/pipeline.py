"""Pipeline parallelism: the transformer's blocks staged over the ``pp`` axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``. JAX runs the GPipe
schedule as one ``lax.scan`` under ``shard_map`` and differentiates it;
here every rank of the mesh runs the same Python loop of T = M + S - 1
steps (M microbatches, S stages): at step t stage s runs its blocks on
microbatch t - s, and the activations pass one stage on around the ring by
``collective.xla.ppermute``. At S = 1 the exchange is a copy on the rank.

Every rank is given the whole parameters and the whole batch, as JAX's
program is given global arrays, and gets the gradients of the global loss:

- a stage takes its blocks from the stacked blocks through ``pvary`` over
  pp, so the gradient of each stacked leaf is summed over the stages, each
  adding its own slice;
- the embedded input enters through ``pvary`` too: only stage 0 reads it,
  and the sum carries its gradient to every rank;
- the outputs leave the last stage through a masked ``psum`` over pp, whose
  gradient is the identity, so the final norm and the unembedding run on
  every rank with the same cotangent and their gradients need no sum.

Every rank runs the same operations in the same order (stage 0 picks its
input with ``torch.where``, not a branch), so that the backward issues the
same collectives in the same order on every rank. With ``cfg.remat`` each
stage's forward is checkpointed; no collective sits inside it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint

from ray_tpu_torch.collective import xla
from ray_tpu_torch.models.transformer import _block_forward, rms_norm
from ray_tpu_torch.parallel.mesh import axis_size


def stack_pipeline_blocks(blocks: List[Dict[str, torch.Tensor]],
                          num_stages: int) -> Dict[str, torch.Tensor]:
    """[layer list of blocks] -> one tensor per leaf with leading
    [num_stages, layers_per_stage] dims (the leading one split over
    pp)."""
    n_layers = len(blocks)
    if n_layers % num_stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{num_stages} stages")
    per = n_layers // num_stages
    return {name: torch.stack([b[name] for b in blocks]).reshape(
                num_stages, per, *leaf.shape)
            for name, leaf in blocks[0].items()}


def pipeline_apply(mesh, stacked_blocks: Dict[str, torch.Tensor],
                   x: torch.Tensor, positions: torch.Tensor, cfg,
                   num_microbatches: int, attn_fn=None) -> torch.Tensor:
    """Apply the staged block stack to ``x`` [B, S, D] with a GPipe
    microbatch schedule over the mesh's ``pp`` axis; the result is the
    same on every rank.

    ``positions`` must be identical across microbatches (the standard
    [B, S] arange layout): each stage reads the first microbatch's."""
    num_stages = axis_size(mesh, "pp")
    batch = x.shape[0]
    if batch % num_microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by "
                         f"{num_microbatches} microbatches")
    for name, leaf in stacked_blocks.items():
        if leaf.shape[0] != num_stages:
            raise ValueError(f"stacked {name} has {leaf.shape[0]} stages, "
                             f"the mesh's pp axis {num_stages}")
    m = num_microbatches
    mb = batch // m
    pos = positions[:mb]
    ring = [(i, (i + 1) % num_stages) for i in range(num_stages)]

    with xla.axis_env(mesh):
        stage = xla.axis_index("pp")
        local = {name: xla.pvary(leaf, "pp")[stage]
                 for name, leaf in stacked_blocks.items()}
        per = next(iter(local.values())).shape[0]
        layers = [{name: t[i] for name, t in local.items()}
                  for i in range(per)]

        def stage_fn(h):
            for block in layers:
                h = _block_forward(block, h, pos, cfg, attn_fn=attn_fn)
            return h

        remat = cfg.remat and torch.is_grad_enabled()
        xm = xla.pvary(x, "pp").reshape(m, mb, *x.shape[1:])
        first = torch.tensor(stage == 0, device=x.device)
        last = torch.tensor(stage == num_stages - 1, device=x.device)
        state = torch.zeros_like(xm[0])
        outputs = []
        for t in range(m + num_stages - 1):
            x_in = torch.where(first, xm[min(t, m - 1)], state)
            if remat:
                y = torch.utils.checkpoint.checkpoint(stage_fn, x_in,
                                                      use_reentrant=False)
            else:
                y = stage_fn(x_in)
            if t >= num_stages - 1:       # microbatch t - (S - 1) is done
                outputs.append(y)
            if t < m + num_stages - 2:    # the last rotation feeds nothing
                state = xla.ppermute(y, "pp", ring)
        # The outputs live on the last stage; replicate them for the caller.
        out = xla.psum(torch.where(last, torch.stack(outputs), 0.0), "pp")
    return out.reshape(batch, *out.shape[2:])


def forward_pipelined(params, tokens: torch.Tensor, cfg, mesh,
                      num_microbatches: int,
                      positions: Optional[torch.Tensor] = None,
                      attn_fn=None) -> torch.Tensor:
    """Pipelined twin of ``models.transformer.forward``: embed -> staged
    blocks over pp -> final norm + unembed. tokens [B, S] -> logits
    [B, S, V] fp32, the same on every rank. As in the JAX package,
    attention is ``attn_fn`` or the dense ``_attention`` (``cfg.use_flash``
    is not read)."""
    num_stages = axis_size(mesh, "pp")
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(
                                     tokens.shape)
    x = params["embed"][tokens].to(cfg.dtype)
    stacked = stack_pipeline_blocks(params["blocks"], num_stages)
    x = pipeline_apply(mesh, stacked, x, positions, cfg, num_microbatches,
                       attn_fn=attn_fn)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["unembed"].to(cfg.dtype)).float()
