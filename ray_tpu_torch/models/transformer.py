"""Flagship model: decoder-only transformer, in PyTorch.

Counterpart of ``ray_tpu/models/transformer.py``, function for function.
Parameters are a plain
dictionary of fp32 tensors with the JAX package's names and shapes, cast
to ``cfg.dtype`` at each use; logits come back in fp32. The decoder block
is the same: GQA, interleaved RoPE, RMSNorm, SwiGLU or a dense-einsum MoE.

With ``use_flash`` the attention runs through the port's flash attention
(``ray_tpu_torch.ops.flash_attention``), forward and backward: the CUDA
kernels for tensors on the card, their plain versions on the CPU.

``param_specs`` gives the sharding layout over a mesh, the JAX package's
tree with the port's ``P``; ``models/sharded.py`` runs the forward and the
loss on each rank's blocks. ``_block_forward`` is the only decoder block:
the sharded loss runs it with hooks that add the collectives
(``BlockHooks``, each the identity here), the pipeline's stages and the
ViT run it as it is.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.mesh import P, local_block
from ray_tpu_torch.util.tracing import span


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4          # GQA: kv heads <= heads
    d_ff: int = 1408             # SwiGLU hidden
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16    # compute dtype
    # Rematerialisation per block: with gradients on, each block runs under
    # torch.utils.checkpoint and is recomputed in the backward. A forward
    # without gradients keeps nothing to rematerialise.
    remat: bool = True
    # Flash attention (ops/flash_attention.py): the fused blockwise
    # kernel, no S×S tensor in device memory.
    use_flash: bool = False
    use_moe: bool = False
    n_experts: int = 8
    expert_top_k: int = 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _dense_init(gen, shape, device, in_axis=0):
    fan_in = shape[in_axis] if isinstance(in_axis, int) else \
        math.prod(shape[a] for a in in_axis)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) / math.sqrt(fan_in)


def init_params(cfg: TransformerConfig, seed: int = 0, *,
                device="cuda", mesh=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's distributions, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``.

    With ``mesh``, each rank keeps only its block of every leaf under
    ``param_specs(cfg)``: every rank draws the same numbers, leaf by leaf,
    so the full tree never exists on a rank (one full leaf at a time
    does), and the blocks together are the parameters drawn without a
    mesh."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    hd = cfg.head_dim
    specs = param_specs(cfg)

    def keep(x, spec):
        return x if mesh is None else local_block(mesh, x, spec).clone()

    init = functools.partial(_dense_init, gen, device=dev)
    ones = functools.partial(torch.ones, cfg.d_model, dtype=torch.float32,
                             device=dev)
    params: Dict[str, Any] = {
        "embed": keep(torch.randn((cfg.vocab_size, cfg.d_model),
                                  generator=gen, dtype=torch.float32,
                                  device=dev) * 0.02, specs["embed"]),
        "final_norm": keep(ones(), specs["final_norm"]),
        "blocks": [],
    }
    for i in range(cfg.n_layers):
        bs = specs["blocks"][i]
        block = {
            "attn_norm": ones(),
            "wq": init((cfg.d_model, cfg.n_heads, hd)),
            "wk": init((cfg.d_model, cfg.n_kv_heads, hd)),
            "wv": init((cfg.d_model, cfg.n_kv_heads, hd)),
            "wo": init((cfg.n_heads, hd, cfg.d_model), in_axis=(0, 1)),
            "mlp_norm": ones(),
        }
        block = {name: keep(x, bs[name]) for name, x in block.items()}
        if cfg.use_moe:
            block["router"] = keep(init((cfg.d_model, cfg.n_experts)),
                                   bs["router"])
            for name, shape in (("wi", (cfg.d_model, cfg.d_ff)),
                                ("wg", (cfg.d_model, cfg.d_ff)),
                                ("wo_mlp", (cfg.d_ff, cfg.d_model))):
                block[name] = keep(init((cfg.n_experts, *shape), in_axis=1),
                                   bs[name])
        else:
            for name, shape in (("wi", (cfg.d_model, cfg.d_ff)),
                                ("wg", (cfg.d_model, cfg.d_ff)),
                                ("wo_mlp", (cfg.d_ff, cfg.d_model))):
                block[name] = keep(init(shape), bs[name])
        params["blocks"].append(block)
    params["unembed"] = keep(init((cfg.d_model, cfg.vocab_size)),
                             specs["unembed"])
    return params


def param_specs(cfg: TransformerConfig) -> Dict:
    """PartitionSpec tree matching init_params.

    Layout: megatron-style tp on head/ff dims, fsdp on the d_model dim
    (ZeRO-3); norms replicated. MoE experts shard over tp, each expert's
    ff dim unsharded.
    """
    block: Dict[str, Any] = {
        "attn_norm": P(None),
        "wq": P("fsdp", "tp", None),
        "wk": P("fsdp", "tp", None),
        "wv": P("fsdp", "tp", None),
        "wo": P("tp", None, "fsdp"),
        "mlp_norm": P(None),
    }
    if cfg.use_moe:
        block.update({
            "router": P("fsdp", None),
            "wi": P("tp", "fsdp", None),
            "wg": P("tp", "fsdp", None),
            "wo_mlp": P("tp", None, "fsdp"),
        })
    else:
        block.update({
            "wi": P("fsdp", "tp"),
            "wg": P("fsdp", "tp"),
            "wo_mlp": P("tp", "fsdp"),
        })
    return {
        "embed": P("tp", "fsdp"),
        "final_norm": P(None),
        "blocks": [dict(block) for _ in range(cfg.n_layers)],
        "unembed": P("fsdp", "tp"),
    }


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-6):
    # The variance is taken in fp32; x times the fp32 rsqrt promotes to
    # fp32 before the cast back, as in the JAX package.
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, S, N, Hd]; positions: [B, S]. Interleaved pairs: element
    2i rotates with element 2i+1."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    angles = positions[..., None].float() * freqs            # [B,S,Hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _attention(q, k, v, *, causal: bool = True):
    """Plain blockless attention. [B,S,N,Hd] layout. The causal mask is
    aligned to the bottom right, as in the JAX package; the flash path
    aligns it to the top left, and the two agree when Sq == Sk."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqnh,bknh->bnqk", q, k) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs.to(v.dtype), v)


class BlockHooks:
    """Where the block on a mesh differs from the block on one device.
    Each hook is the identity here; ``models/sharded.py`` overrides them
    with the collectives of a rank's share of the block."""

    def weight(self, block, name: str) -> torch.Tensor:
        """The weight ``name`` of ``block`` as the products use it."""
        return block[name]

    def enter_tp(self, h: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering a head- or ff-sharded
        product."""
        return h

    def leave_tp(self, y: torch.Tensor) -> torch.Tensor:
        """The partial sum a head- or ff-sharded product leaves."""
        return y

    def experts(self, combine: torch.Tensor, block) -> torch.Tensor:
        """The routing weights [B, S, E] of the experts this block
        holds."""
        return combine


NO_MESH = BlockHooks()


def _block_forward(block, x, positions, cfg: TransformerConfig,
                   attn_fn=None, hooks: BlockHooks = NO_MESH):
    """One decoder block, the only one: ``forward``, the sharded loss
    (with its hooks) and the pipeline's stages all run it."""
    dt = cfg.dtype

    def weight(name):
        return hooks.weight(block, name).to(dt)

    h = hooks.enter_tp(rms_norm(x, block["attn_norm"]))
    q = torch.einsum("bsd,dnh->bsnh", h, weight("wq"))
    k = torch.einsum("bsd,dnh->bsnh", h, weight("wk"))
    v = torch.einsum("bsd,dnh->bsnh", h, weight("wv"))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # GQA: each kv head serves `rep` consecutive query heads.
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    attn = (attn_fn or _attention)(q, k, v)
    x = x + hooks.leave_tp(torch.einsum("bsnh,nhd->bsd", attn, weight("wo")))

    h = rms_norm(x, block["mlp_norm"])
    if "router" in block:
        return x + _moe_mlp(block, h, cfg, hooks)
    hf = hooks.enter_tp(h)
    gate = F.silu(hf @ weight("wg"))
    up = hf @ weight("wi")
    return x + hooks.leave_tp((gate * up) @ weight("wo_mlp"))


def _moe_mlp(block, h, cfg: TransformerConfig, hooks: BlockHooks = NO_MESH):
    """Dense-einsum MoE: every expert sees every token, masked by the
    router weights. The routing is computed whole; ``hooks.experts``
    keeps the weights of the experts the block holds."""
    dt = cfg.dtype
    logits = h @ hooks.weight(block, "router").to(dt)        # [B,S,E]
    weights = torch.softmax(logits.float(), dim=-1)
    top_w, top_i = torch.topk(weights, cfg.expert_top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    mask = F.one_hot(top_i, cfg.n_experts).float()
    combine = torch.einsum("bsk,bske->bse", top_w, mask).to(dt)
    combine = hooks.experts(combine, block)
    hf = hooks.enter_tp(h)
    wg, wi, wo = (hooks.weight(block, n).to(dt)
                  for n in ("wg", "wi", "wo_mlp"))
    gate = F.silu(torch.einsum("bsd,edf->bsef", hf, wg))
    up = torch.einsum("bsd,edf->bsef", hf, wi)
    out = torch.einsum("bsef,efd->bsed", gate * up, wo)
    return hooks.leave_tp(torch.einsum("bsed,bse->bsd", out, combine))


def apply_blocks(blocks, x, positions, cfg: TransformerConfig, attn_fn=None,
                 hooks=None):
    """``x`` through ``blocks`` in turn, each under
    ``torch.utils.checkpoint`` when ``cfg.remat`` and gradients are on.
    ``hooks``: one ``BlockHooks`` per block (default ``NO_MESH``)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for i, block in enumerate(blocks):
        args = (block, x, positions, cfg, attn_fn,
                NO_MESH if hooks is None else hooks[i])
        if remat:
            x = torch.utils.checkpoint.checkpoint(_block_forward, *args,
                                                  use_reentrant=False)
        else:
            x = _block_forward(*args)
    return x


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig,
            positions: Optional[torch.Tensor] = None,
            attn_fn=None) -> torch.Tensor:
    """tokens [B, S] integer -> logits [B, S, V] fp32."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :].expand(
                                     tokens.shape)
    # Gathering before the cast equals casting the whole table first.
    x = params["embed"][tokens].to(cfg.dtype)
    if attn_fn is None and cfg.use_flash:
        from ray_tpu_torch.ops.flash_attention import flash_attention
        attn_fn = lambda q, k, v, causal=True: flash_attention(  # noqa: E731
            q, k, v, causal=causal)
    x = apply_blocks(params["blocks"], x, positions, cfg, attn_fn)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["unembed"].to(cfg.dtype)).float()


def loss_fn(params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, attn_fn=None) -> torch.Tensor:
    """Next-token cross-entropy. batch: tokens [B,S]; optional
    loss_mask [B,S]. The forward runs on the full S; the shift to next-
    token targets happens on the logits."""
    tokens = batch["tokens"]
    with span("rt.train.forward"):
        logits = forward(params, tokens, cfg, attn_fn=attn_fn)[:, :-1]
        targets = tokens[:, 1:].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:].float()
            return (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return nll.mean()
