"""The training job's optimizer, written out: clip the gradients by their
global norm (scaled by max_norm / norm when norm >= max_norm), then AdamW
with decoupled weight decay on every leaf, on a learning rate that rises
linearly from 0 at step 0 to its peak at ``warmup_steps`` and then follows
a cosine to 0 at ``total_steps``."""

from __future__ import annotations

import math
from typing import Dict, List

import torch


class AdamW:
    def __init__(self, spec: Dict):
        self.spec = spec
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def lr(self, step: int) -> float:
        s = self.spec
        peak, warm = s["lr"], s["warmup_steps"]
        if step < warm:
            return peak * step / warm
        span = max(s["total_steps"], warm + 1) - warm
        t = min(step - warm, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        """Update ``params`` in place; returns (global norm before
        clipping, the clipped gradients)."""
        s = self.spec
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        if norm >= s["max_norm"]:
            grads = [g / norm * s["max_norm"] for g in grads]
        if not self.mu:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = s["b1"], s["b2"]
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            adam = (mu / c1) / ((nu / c2).sqrt() + s["eps"])
            p.sub_(lr * (adam + s["weight_decay"] * p))
        return float(norm), grads
