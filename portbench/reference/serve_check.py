"""The reference's logits over served prompts, and the gap of each served
token: how far its logit lies below the best logit at its position."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import weights
from portbench.reference import models
from portbench.reference.precision import Precision, strict_fp32


@torch.no_grad()
def widest_gaps(c: Dict, seed: int, device, prompts: List[np.ndarray],
                served: List[np.ndarray], control: bool = False) -> Dict:
    """The widest gap of the served tokens over all ``prompts`` (position
    t's served token is the prediction after tokens 0..t). With
    ``control``, also the widest gap of the tokens the fp8 reference puts
    first at the same positions."""
    strict_fp32()
    params = weights.make(c, seed, device)
    fp32, fp8 = Precision("fp32"), Precision("fp8")
    out = {"served": 0.0, "control": 0.0 if control else None,
           "positions": 0}
    for tokens, ids in zip(prompts, served):
        t = torch.as_tensor(np.asarray(tokens, dtype=np.int64),
                            device=device)[None]
        logits = models.decoder_logits(fp32, params, c, t)[0]
        best = logits.max(dim=-1).values
        ids = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)
        gap = best - logits.gather(-1, ids[:, None])[:, 0]
        out["served"] = max(out["served"], float(gap.max()))
        out["positions"] += int(ids.numel())
        if control:
            low = models.decoder_logits(fp8, params, c, t)[0].argmax(-1)
            gap = best - logits.gather(-1, low[:, None])[:, 0]
            out["control"] = max(out["control"], float(gap.max()))
        del logits
    return out
