"""The reference's first training steps, and the numbers the run compares
with the program's: each step's loss, the global gradient norm before
clipping, every leaf's norm of the first clipped gradient, and every
leaf's norm of the change of the parameters over the steps."""

from __future__ import annotations

from typing import Dict

import torch

from portbench import feed, weights
from portbench.reference import models
from portbench.reference.optim import AdamW
from portbench.reference.precision import Precision, strict_fp32


def run(c: Dict, traffic: Dict, seed: int, device, steps: int,
        precision: str = "fp32", half_batch: bool = False) -> Dict:
    """``steps`` steps of the reference from the weights of ``seed`` on
    batches 0..steps-1. ``half_batch`` is a fault: each loss is the mean
    over the first half of the batch's rows alone."""
    strict_fp32()
    prec = Precision(precision)
    params = weights.make(c, seed, device)
    names, leaves = weights.leaf_names(params), weights.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = AdamW(traffic["optimizer"])
    chunk = traffic["reference_rows"]
    out = {"names": names, "loss": [], "grad_norm": []}
    for i in range(steps):
        batch = feed.batch(c, traffic, seed, i, device)
        rows, denom = models.loss_terms(c, batch)
        if half_batch:
            denom = denom * (rows // 2) // rows
            rows //= 2
        grads, loss = None, 0.0
        for r0 in range(0, rows, chunk):
            part = models.nll_sum(prec, params, c, batch,
                                  slice(r0, min(r0 + chunk, rows))) / denom
            g = torch.autograd.grad(part, leaves)
            if grads is None:
                grads = list(g)
            else:
                for a, b in zip(grads, g):
                    a.add_(b)
            loss += float(part.detach())
            del part, g
        norm, clipped = opt.step(leaves, grads)
        out["loss"].append(loss)
        out["grad_norm"].append(norm)
        if i == 0:
            out["grad1"] = [float(g.norm()) for g in clipped]
        del grads, clipped
    out["update"] = weights.change_norms(c, seed, params, device)
    return out
