"""The decoder block's equations in fp32: RMSNorm, rotary embedding on
interleaved pairs, grouped-query attention, SwiGLU.

RoPE rotates element 2i of a head with element 2i + 1, at frequency
theta^(-2i / head_dim). (Hugging Face's Mistral rotates element i with
i + head_dim / 2; with random weights the two are the same model up to a
fixed permutation of each head's query and key columns.)"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x [B, S, N, H]; positions [S]."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = positions.float()[:, None] * inv                   # [S, H/2]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def attention(prec, q, k, v, causal):
    """q [B, S, N, H]; k, v [B, S, G, H] with N = G * R: query head j
    attends with key/value head j // R. Softmax in fp32; a causal query
    sees the keys at its position and before."""
    b, s, n, h = q.shape
    g = k.shape[2]
    qg = q.reshape(b, s, g, n // g, h)
    scores = prec.einsum("bqgrh,bkgh->bgrqk", qg, k) / math.sqrt(h)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = prec.einsum("bgrqk,bkgh->bqgrh", probs, v)
    return out.reshape(b, s, n, h)


def block(prec, p, x, positions, theta, eps, causal):
    """One pre-norm block: x + attention, then + SwiGLU MLP."""
    h = rms_norm(x, p["attn_norm"], eps)
    q = rope(prec.einsum("bsd,dnh->bsnh", h, p["wq"]), positions, theta)
    k = rope(prec.einsum("bsd,dnh->bsnh", h, p["wk"]), positions, theta)
    v = prec.einsum("bsd,dnh->bsnh", h, p["wv"])
    x = x + prec.einsum("bsnh,nhd->bsd", attention(prec, q, k, v, causal),
                        p["wo"])
    h = rms_norm(x, p["mlp_norm"], eps)
    gate = F.silu(prec.einsum("bsd,df->bsf", h, p["wg"]))
    up = prec.einsum("bsd,df->bsf", h, p["wi"])
    return x + prec.einsum("bsf,fd->bsd", gate * up, p["wo_mlp"])


def blocks(prec, params, x, positions, theta, eps, causal, checkpoint):
    """Every block in turn; under ``checkpoint`` each block keeps only
    its input for the backward and runs again there (it fits the card)."""
    for p in params["blocks"]:
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                block, prec, p, x, positions, theta, eps, causal,
                use_reentrant=False)
        else:
            x = block(prec, p, x, positions, theta, eps, causal)
    return x
