"""Mixture-of-Experts with expert parallelism over a mesh axis.

Counterpart of ``ray_tpu/ops/moe.py``: capacity-based top-k routing, dense
dispatch and combine einsums (one-hots, no gather or scatter), and a pair
of ``all_to_all`` exchanges over the expert axis: each token goes to the
rank that owns its expert, and the FFN output comes back. A per-shard
function for ``collective.xla.shard_map_fn``; the expert weight tables
shard their leading E dim over the same axis.

Shapes (per shard): tokens [T, D]; wi/wg [E_local, D, F];
wo [E_local, F, D]; router [D, E_global].
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ray_tpu_torch.collective import xla
from ray_tpu_torch.parallel import mesh as mesh_lib
from ray_tpu_torch.parallel.mesh import P

AxisName = Union[str, Sequence[str]]


def _one_hot(idx, n):
    """``jax.nn.one_hot``: fp32, all zeros where ``idx`` is outside
    [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k_routing(h, router_w, n_experts: int, top_k: int,
                   capacity: int):
    """Returns dispatch [T,E,C] one-hot and combine [T,E,C] weights."""
    logits = h.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                    # [T,E]
    top_w, top_i = torch.topk(probs, top_k, dim=-1)          # [T,k]
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    # expert assignment mask per routing slot: [k,T,E]
    slot_onehot = _one_hot(top_i.T, n_experts)
    # position of each token within its expert's queue, counted over
    # slots-major order (slot 0 of all tokens first, then slot 1, ...)
    flat = slot_onehot.reshape(-1, n_experts)                # [k*T,E]
    pos = torch.cumsum(flat, dim=0) - flat                   # [k*T,E]
    pos = pos.reshape(top_k, -1, n_experts)                  # [k,T,E]
    keep = (pos < capacity).float() * slot_onehot            # [k,T,E]
    pos_onehot = _one_hot((pos * slot_onehot).sum(dim=-1).long(),
                          capacity)                          # [k,T,C]
    # dispatch[t,e,c] = 1 iff token t occupies slot c of expert e
    dispatch = torch.einsum("kte,ktc->tec", keep, pos_onehot)
    combine = torch.einsum("kte,kt,ktc->tec", keep, top_w.T, pos_onehot)
    return dispatch, combine


def moe_mlp_shard(h, router_w, wi, wg, wo, *,
                  axis_name: Optional[AxisName] = "ep",
                  n_experts: int, top_k: int = 2,
                  capacity_factor: float = 2.0):
    """Per-shard expert-parallel SwiGLU MoE (call inside shard_map_fn).

    With ``axis_name=None`` runs single-shard (all experts local): the same
    code path, minus the exchanges.
    """
    t, _ = h.shape
    ep = xla.axis_size(axis_name) if axis_name is not None else 1
    e_local = wi.shape[0]
    if e_local * ep != n_experts:
        raise ValueError(f"{e_local} local experts on {ep} ranks, expected "
                         f"{n_experts} in all")
    capacity = max(1, int(math.ceil(t * top_k / n_experts
                                    * capacity_factor)))
    dispatch, combine = _top_k_routing(h, router_w, n_experts, top_k,
                                       capacity)
    dt = h.dtype
    x = torch.einsum("tec,td->ecd", dispatch.to(dt), h)      # [E,C,D]
    if ep > 1:
        # -> [E_local, ep*C, D]: tokens from every shard for my experts
        x = xla.all_to_all(x, axis_name, split_axis=0, concat_axis=1)
    gate = F.silu(torch.einsum("ecd,edf->ecf", x, wg.to(dt)))
    up = torch.einsum("ecd,edf->ecf", x, wi.to(dt))
    out = torch.einsum("ecf,efd->ecd", gate * up, wo.to(dt))
    if ep > 1:
        out = xla.all_to_all(out, axis_name, split_axis=1,
                             concat_axis=0)                  # [E,C,D]
    return torch.einsum("tec,ecd->td", combine.to(dt), out)


def make_moe_fn(mesh, *, n_experts: int, top_k: int = 2,
                capacity_factor: float = 2.0,
                token_axes: AxisName = ("dp", "fsdp", "sp"),
                ep_axis: Optional[str] = None):
    """Build a global-tensors MoE fn over the mesh; returns (fn, ep).

    Tokens shard over ``token_axes``; expert tables shard E over the same
    ranks (ep reuses the data axes rather than a dedicated mesh dimension).
    Pass ``ep_axis`` to use a dedicated axis instead.
    """
    axis = ep_axis if ep_axis is not None else token_axes
    ep = mesh_lib.axis_size(mesh, axis)
    body = functools.partial(
        moe_mlp_shard, axis_name=axis, n_experts=n_experts,
        top_k=top_k, capacity_factor=capacity_factor)
    tok_spec = P(token_axes, None)
    ew_spec = P(token_axes if ep_axis is None else ep_axis, None, None)
    return xla.shard_map_fn(
        mesh, in_specs=(tok_spec, P(None, None), ew_spec, ew_spec, ew_spec),
        out_specs=tok_spec)(body), ep
