"""The flagship's and ViT's losses on a mesh, as one SPMD program per rank.

The JAX package runs ``loss_fn`` on global arrays and lets GSPMD place the
collectives. Here each rank runs this module's ``loss_fn_shard`` (or
``vit_loss_fn_shard``) on its own blocks of the parameters (laid out by
``param_specs``) and of the batch, with the collectives written out
(``collective.xla``). The decoder block is ``transformer._block_forward``
itself, run with ``MeshHooks``, which put the collectives where the
block's hooks are:

- fsdp: each weight is gathered over ``fsdp`` on its d_model dim where it
  is used (``all_gather``, whose gradient is the ``reduce_scatter`` that
  sums the fsdp ranks' gradients and leaves each its block);
- tp (Megatron): the residual stream is replicated over ``tp``; a block's
  input enters the head- or ff-sharded products through ``pvary`` (the
  identity, its gradient summed over tp) and their output leaves through
  ``psum`` (summed over tp, its gradient the identity), so the gradient of
  every activation and every tp-replicated weight is the same on every tp
  rank. GQA holds on contiguous head blocks: local query head j reads local
  KV head j // rep when ``n_kv_heads % tp == 0``. MoE experts shard over
  tp the same way, their routing weights entering through ``pvary``;
- the embedding and the unembedding are vocab-parallel: a token's row is
  looked up on the tp rank that holds it (``psum`` of masked lookups), and
  the cross entropy takes its max (``pmax``) and its sum of exponentials
  and target logit (``psum``) over the vocab shards, so no rank holds the
  full [B, S, V] logits;
- sp: the rank's sequence shard runs at global RoPE positions
  (``idx * S_local + arange``) and attention crosses shards (ring attention
  by default). The next-token targets of a shard's last position are the
  next shard's first token: every rank is given the whole token batch and
  takes its targets from it, so the shift needs no exchange; the last
  shard has one prediction fewer.

The rank's loss is its share of the global mean, the sum of its tokens'
negative log-likelihoods over the global count, so the global loss is the
``psum`` of the ranks' losses over the data axes and its gradient on each
rank is the gradient of the global loss, up to the sums over the data axes
that ``sync_grads`` adds.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ray_tpu_torch.collective import xla
from ray_tpu_torch.models.transformer import (
    BlockHooks, TransformerConfig, _attention, apply_blocks, param_specs,
    rms_norm)
from ray_tpu_torch.models.vit import (
    ViTConfig, ViTHooks, vit_forward, vit_nll, vit_param_specs)
from ray_tpu_torch.parallel.mesh import (
    BATCH_AXES, DATA_AXES, MESH_AXES, P, axis_size, spec_axes)


def _gather_fsdp(w: torch.Tensor, spec: P) -> torch.Tensor:
    """``w`` whole along its fsdp-sharded dim (tp dims stay local)."""
    for dim, entry in enumerate(spec):
        if "fsdp" in spec_axes(entry):
            return xla.all_gather(w, "fsdp", gather_axis=dim)
    return w


def check_shardable(cfg: TransformerConfig, mesh) -> None:
    """Raise on a config that the mesh cannot shard as param_specs says.
    A pp axis is taken as the JAX package's GSPMD step takes it: no spec
    names it, so its ranks hold and compute the same."""
    _check_divisible(mesh, _block_sizes(cfg) + [
        ("vocab_size", cfg.vocab_size, "tp")])


def _block_sizes(cfg: TransformerConfig):
    sizes = [("n_heads", cfg.n_heads, "tp"),
             ("n_kv_heads (GQA reads whole KV heads on each tp rank)",
              cfg.n_kv_heads, "tp"),
             ("d_ff", cfg.d_ff, "tp"),
             ("d_model", cfg.d_model, "fsdp")]
    if cfg.use_moe:
        sizes.append(("n_experts", cfg.n_experts, "tp"))
    return sizes


def _check_divisible(mesh, sizes) -> None:
    for name, n, axis in sizes:
        by = axis_size(mesh, axis)
        if n % by:
            raise ValueError(f"{name} = {n} is not divisible by "
                             f"{axis} = {by}")


def check_vit_shardable(cfg: ViTConfig, mesh) -> None:
    """Raise on a ViT config that the mesh cannot shard as
    ``vit_param_specs`` says, or on an sp axis (the patch sequence is not
    split)."""
    if axis_size(mesh, "sp") != 1:
        raise ValueError(f"vit_loss_fn_shard splits no patch sequence: sp "
                         f"must be 1, not {axis_size(mesh, 'sp')}")
    _check_divisible(mesh, _block_sizes(cfg.block_config()) + [
        ("d_model (patch embedding columns, head rows)", cfg.d_model,
         "tp")])


def attention_body(attn_fn, sp: int):
    """The per-shard attention that ``loss_fn_shard`` calls: ``attn_fn``'s
    body if it is a ``shard_map_fn``, else ``attn_fn`` itself. With sp > 1
    only a ``shard_map_fn`` that splits q's sequence over sp (ring,
    Ulysses) attends across the sequence shards; any other function would
    attend within this rank's shard alone, so it is refused."""
    body = getattr(attn_fn, "body", None)
    if sp > 1:
        specs = getattr(attn_fn, "in_specs", None) or (None,)
        q_spec = specs[0]
        if (body is None or q_spec is None or len(q_spec) < 2
                or "sp" not in spec_axes(q_spec[1])):
            raise ValueError(
                f"sp = {sp}: attn_fn must attend across the sequence "
                f"shards, a shard_map_fn over sp such as "
                f"make_attention_fn(mesh, impl='ring' or 'ulysses'); "
                f"{attn_fn!r} would attend within each shard")
    return attn_fn if body is None else body


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a vocab-sharded table [V/tp, D]: each tp rank looks up the
    tokens in its shard, zero elsewhere, and the sum over tp has them
    all."""
    vl = table.shape[0]
    ids = tokens.long() - xla.axis_index("tp") * vl
    inside = (ids >= 0) & (ids < vl)
    rows = table[ids.clamp(0, vl - 1)] * inside[..., None]
    return xla.psum(rows, "tp")


def _vocab_parallel_nll(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] with logits [..., V/tp] sharded over
    tp: fp32, its max over all shards (no gradient flows through a
    max that only shifts), its sum of exponentials and the target's logit
    summed over the shards."""
    vl = logits.shape[-1]
    top = xla.pmax(logits.detach().amax(dim=-1), "tp")
    sum_exp = xla.psum(torch.exp(logits - top[..., None]).sum(dim=-1), "tp")
    ids = targets.long() - xla.axis_index("tp") * vl
    inside = (ids >= 0) & (ids < vl)
    picked = torch.gather(logits, -1, ids.clamp(0, vl - 1)[..., None])[..., 0]
    target = xla.psum(picked * inside, "tp")
    return torch.log(sum_exp) + top - target


class MeshHooks(BlockHooks):
    """The block's hooks on a rank of a mesh: each weight gathered over
    fsdp where it is used, the tp-sharded products entered through
    ``pvary`` and left through ``psum``, and the routing weights of this
    tp rank's experts (the routing is computed whole on every tp rank,
    each rank runs its experts, and the partial sums add over tp)."""

    def __init__(self, specs):
        self.specs = specs

    def weight(self, block, name):
        return _gather_fsdp(block[name], self.specs[name])

    def enter_tp(self, h):
        return xla.pvary(h, "tp")

    def leave_tp(self, y):
        return xla.psum(y, "tp")

    def experts(self, combine, block):
        e_loc = block["wi"].shape[0]
        e0 = xla.axis_index("tp") * e_loc
        return xla.pvary(combine, "tp")[..., e0:e0 + e_loc]


def loss_fn_shard(params, batch: Dict[str, torch.Tensor],
                  cfg: TransformerConfig, attn_fn=None) -> torch.Tensor:
    """This rank's share of the global next-token loss (call within
    ``xla.axis_env(mesh)``). ``params`` are the rank's blocks under
    ``param_specs(cfg)``; ``batch`` holds the whole ``tokens`` [B, S] (and
    optional ``loss_mask``), the same on every rank, split here over
    (dp, fsdp) x sp. ``attn_fn`` runs on local [B/(dp fsdp), S/sp, N/tp, H]
    tensors (a ``shard_map_fn`` is called through its per-shard body; with
    sp > 1 it must be one over sp, see ``attention_body``); without one,
    attention is ring attention when sp > 1, else the flash kernels with
    ``cfg.use_flash`` or the dense ``_attention``."""
    specs = param_specs(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    n_data, sp = xla.axis_size(BATCH_AXES), xla.axis_size("sp")
    if b % n_data or s % sp:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not split over "
                         f"{n_data} data ranks and sp = {sp}")
    bl, sl = b // n_data, s // sp
    r0, s0 = xla.axis_index(BATCH_AXES) * bl, xla.axis_index("sp") * sl
    n_pred = sl if s0 + sl < s else sl - 1   # positions with a next token
    local = tokens[r0:r0 + bl, s0:s0 + sl]
    targets = tokens[r0:r0 + bl, s0 + 1:s0 + 1 + n_pred]
    positions = (s0 + torch.arange(sl, dtype=torch.int32,
                                   device=tokens.device)).expand(bl, sl)

    if attn_fn is None:
        if sp > 1:
            from ray_tpu_torch.ops.ring_attention import ring_attention_shard
            attn_fn = ring_attention_shard
        elif cfg.use_flash:
            from ray_tpu_torch.ops.flash_attention import flash_attention
            attn_fn = flash_attention
        else:
            attn_fn = _attention
    else:
        attn_fn = attention_body(attn_fn, sp)

    x = _embed(_gather_fsdp(params["embed"], specs["embed"]),
               local).to(cfg.dtype)
    x = apply_blocks(params["blocks"], x, positions, cfg, attn_fn,
                     [MeshHooks(bspecs) for bspecs in specs["blocks"]])
    x = xla.pvary(rms_norm(x, params["final_norm"])[:, :n_pred], "tp")
    unembed = _gather_fsdp(params["unembed"], specs["unembed"])
    logits = (x @ unembed.to(cfg.dtype)).float()        # [bl, n_pred, V/tp]
    nll = _vocab_parallel_nll(logits, targets)
    mask = batch.get("loss_mask")
    if mask is not None:
        total = mask[:, 1:].float().sum().clamp_min(1.0)
        local_mask = mask[r0:r0 + bl, s0 + 1:s0 + 1 + n_pred].float()
        return (nll * local_mask).sum() / total
    return nll.sum() / (b * (s - 1))


class ViTMeshHooks(ViTHooks):
    """``vit_forward``'s hooks on a rank of a mesh: the patch embedding's
    columns gathered over tp into the weight that every tp rank then uses
    alike (its gradient this rank's columns, not the tp ranks' sum), the
    blocks run with ``MeshHooks`` on the replicated activation, and the
    head's rows sharded over tp: each tp rank contracts its slice of the
    pooled features and the logits are summed over tp."""

    def __init__(self, cfg: ViTConfig):
        self.blocks = [MeshHooks(bspecs)
                       for bspecs in vit_param_specs(cfg)["blocks"]]

    def patch_embed(self, params):
        return xla.all_gather_invariant(params["patch_embed"], "tp",
                                        gather_axis=1)

    def enter_head(self, pooled):
        dl = pooled.shape[-1] // xla.axis_size("tp")
        d0 = xla.axis_index("tp") * dl
        return xla.pvary(pooled, "tp")[..., d0:d0 + dl]

    def leave_head(self, logits):
        return xla.psum(logits, "tp")


def vit_loss_fn_shard(params, batch: Dict[str, torch.Tensor],
                      cfg: ViTConfig) -> torch.Tensor:
    """This rank's share of ``vit_loss_fn`` (call within
    ``xla.axis_env(mesh)``), the rank's blocks ``params`` laid out by
    ``vit_param_specs(cfg)``: ``vit_forward`` with ``ViTMeshHooks`` on
    this rank's images. ``batch`` holds the whole ``images`` [B, H, W, C]
    and ``labels`` [B], the same on every rank, split here over (dp,
    fsdp)."""
    check_vit_shardable(cfg, xla.current_mesh())
    images, labels = batch["images"], batch["labels"]
    b = images.shape[0]
    n_data = xla.axis_size(BATCH_AXES)
    if b % n_data:
        raise ValueError(f"{b} images do not split over {n_data} data "
                         f"ranks")
    bl = b // n_data
    r0 = xla.axis_index(BATCH_AXES) * bl
    logits = vit_forward(params, images[r0:r0 + bl], cfg,
                         ViTMeshHooks(cfg))
    return vit_nll(logits, labels[r0:r0 + bl]).sum() / b


def replicated_axes(spec: P) -> List[str]:
    """The mesh axes a leaf of this spec is replicated over."""
    named = {a for entry in spec for a in spec_axes(entry)}
    return [a for a in MESH_AXES if a not in named]


@torch.no_grad()
def sync_grads(grads: Sequence[torch.Tensor],
               specs: Sequence[P]) -> List[torch.Tensor]:
    """Sum each leaf's gradient over the data axes whose ranks hold the
    same block (dp and sp, and fsdp where the leaf is not fsdp-sharded:
    the fsdp gather's reduce-scatter summed the rest), one all-reduce per
    set of axes. tp needs no sum (see the module docstring)."""
    out = list(grads)
    by_axes: Dict[tuple, List[int]] = {}
    for i, spec in enumerate(specs):
        axes = tuple(a for a in DATA_AXES if a in replicated_axes(spec))
        if axes:
            by_axes.setdefault(axes, []).append(i)
    for axes, idx in by_axes.items():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        flat = xla.psum(flat, axes)
        for i, piece in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = piece.view_as(out[i])
    return out


@torch.no_grad()
def global_norm(grads: Sequence[torch.Tensor],
                specs: Sequence[P]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of the global
    gradients, each replicated leaf counted once: a rank adds a leaf's
    squares only where its index is 0 on every axis the leaf is replicated
    over, and one psum over the whole mesh adds the ranks."""
    total = None
    for g, spec in zip(grads, specs):
        if any(xla.axis_index(a) for a in replicated_axes(spec)):
            continue
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    return torch.sqrt(xla.psum(total, MESH_AXES))
