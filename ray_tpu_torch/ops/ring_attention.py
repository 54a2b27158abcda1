"""Sequence parallelism: ring attention and Ulysses.

Counterpart of ``ray_tpu/ops/ring_attention.py``:

- **Ring attention** (blockwise attention + ``ppermute`` KV rotation):
  each rank keeps its Q shard and sees every KV shard once as they rotate
  around the ``sp`` ring; an online softmax (running max and normaliser)
  in fp32 accumulates exactly, without the full S x S scores.
- **Ulysses**: an all-to-all re-shards heads over ``sp`` while the sequence
  gathers, attention runs over the whole sequence for this rank's heads,
  and the inverse all-to-all brings the sequence shards back. With
  ``inner="flash"`` that attention is the port's flash attention: the
  CUDA kernels on CUDA tensors, forward and backward.

Both are per-shard bodies for ``collective.xla.shard_map_fn``
(``make_attention_fn``), differentiable through the collectives' autograd.

Layout: [B, S, N, H]; ``sp`` shards S; ``tp`` shards N.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ray_tpu_torch.collective import xla
from ray_tpu_torch.ops.flash_attention import flash_attention, mha_reference
from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.parallel.mesh import P

_NEG = -1e30  # the masked logit, as in the JAX package


def ring_attention_shard(q, k, v, *, axis_name: str = "sp",
                         causal: bool = True,
                         sm_scale: Optional[float] = None):
    """Per-shard ring attention body (call inside shard_map_fn).

    q, k, v: [B, S_local, N, H], this rank's sequence shard. The causal
    mask compares global positions (shard index times S_local plus the
    offset)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    sp = xla.axis_size(axis_name)
    idx = xla.axis_index(axis_name)
    b, s_loc, n, h = q.shape

    q32 = q.float()
    offsets = torch.arange(s_loc, device=q.device)
    q_pos = idx * s_loc + offsets                      # global query positions
    fwd_perm = [(r, (r + 1) % sp) for r in range(sp)]

    o = torch.zeros((b, s_loc, n, h), dtype=torch.float32, device=q.device)
    m = torch.full((b, n, s_loc), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, s_loc), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for j in range(sp):
        src = (idx - j) % sp                           # origin shard of k_blk
        logits = torch.einsum("bqnh,bknh->bnqk", q32,
                              k_blk.float()) * sm_scale
        if causal:
            mask = q_pos[:, None] >= (src * s_loc + offsets)[None, :]
            logits = torch.where(mask, logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))      # [B,N,Sq]
        p = torch.exp(logits - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)                    # [B,N,Sq]
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bnqk,bknh->bqnh", p, v_blk.float())
        o = o * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        if j + 1 < sp:  # rotate KV one hop around the ring
            k_blk = xla.ppermute(k_blk, axis_name, fwd_perm)
            v_blk = xla.ppermute(v_blk, axis_name, fwd_perm)
    out = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention_shard(q, k, v, *, axis_name: str = "sp",
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            inner: str = "reference"):
    """Per-shard Ulysses body (call inside shard_map_fn).

    all-to-all: [B, S/sp, N, H] -> [B, S, N/sp, H], attention over the full
    sequence for this rank's head subset (``inner``: "reference" dense,
    "flash" the flash kernels), inverse all-to-all back. Requires the local
    head count divisible by sp."""
    sp = xla.axis_size(axis_name)
    n = q.shape[2]
    if n % sp != 0:
        raise ValueError(f"ulysses needs heads ({n}) divisible by "
                         f"sp ({sp})")

    def scatter_heads(x):
        return xla.all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    def gather_heads(x):
        return xla.all_to_all(x, axis_name, split_axis=1, concat_axis=2)

    qg, kg, vg = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if inner == "flash":
        out = flash_attention(qg, kg, vg, causal, sm_scale)
    else:
        out = mha_reference(qg, kg, vg, causal=causal, sm_scale=sm_scale)
    return gather_heads(out)


def make_attention_fn(mesh=None, *, impl: str = "auto", causal: bool = True,
                      batch_axes=("dp", "fsdp"), sp_axis: str = "sp",
                      tp_axis: str = "tp"):
    """Build the attn_fn the transformer block calls: q, k, v [B,S,N,H] ->
    attention output.

    impl: "auto" | "ring" | "ulysses" | "flash" | "reference". With a mesh
    whose ``sp`` axis > 1, "auto" = ring; without, "auto" = flash. "ring"
    and "ulysses" return a ``shard_map_fn`` over the mesh, which takes
    global tensors (or DTensors) sharded as [batch_axes, sp, tp, None]
    and returns a DTensor; its per-shard body is ``fn.body``, which the
    sharded train step calls on local tensors.
    """
    sp = mesh_lib.axis_size(mesh, sp_axis) if mesh is not None else 1
    if impl == "auto":
        impl = "ring" if sp > 1 else "flash"
    if impl in ("ring", "ulysses") and (mesh is None or sp <= 1):
        raise ValueError(f"impl={impl!r} needs a mesh with {sp_axis}>1")

    if impl == "reference":
        return functools.partial(mha_reference, causal=causal)
    if impl == "flash":
        return lambda q, k, v: flash_attention(q, k, v, causal)
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown attention impl {impl!r}")

    spec = P(batch_axes, sp_axis, tp_axis, None)
    body = (ring_attention_shard if impl == "ring"
            else ulysses_attention_shard)
    return xla.shard_map_fn(mesh, in_specs=(spec, spec, spec),
                            out_specs=spec)(
        functools.partial(body, axis_name=sp_axis, causal=causal))
