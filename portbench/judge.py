"""The numbers that decide ``correct``, and their limits.

Training: the program's first steps against the reference's, as
``compare_train`` reads them. Serving: the widest gap by which a served
token's logit lies below the reference's best at its position. Each number
has its limit in ``limits/<cell>.json``; a run is correct when every
number is finite and at or under its limit (and, for serving, every due
request came back, each answer of its prompt's length)."""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List, Optional

# A leaf whose first gradient in the reference is under this share of the
# median leaf's moves by round-off alone; its change is not compared.
STILL_LEAF = 1e-3


def _leaf_gap(got: List[float], want: List[float],
              keep: Optional[List[bool]] = None) -> float:
    """The worst leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    median = statistics.median(want[i] for i in idx)
    return max(abs(got[i] - want[i]) / max(want[i], median, 1e-30)
               for i in idx)


def compare_train(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold, for the same steps: ``loss`` and
    ``grad_norm`` (global, before clipping) per step; ``grad1``, each
    leaf's norm of the first clipped gradient; ``update``, each leaf's
    norm of the change over the steps."""
    if prog["names"] != ref["names"]:
        raise ValueError("the program's leaves are not the reference's")
    median = statistics.median(ref["grad1"])
    moving = [g >= STILL_LEAF * median for g in ref["grad1"]]
    return {
        "loss": max(abs(a - b) / abs(b)
                    for a, b in zip(prog["loss"], ref["loss"])),
        "grad_norm": max(abs(a - b) / b
                         for a, b in zip(prog["grad_norm"], ref["grad_norm"])),
        "grad1_leaf": _leaf_gap(prog["grad1"], ref["grad1"]),
        "update_leaf": _leaf_gap(prog["update"], ref["update"], moving),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            other_faults: List[str]) -> Dict:
    """``correct`` and the numbers beside their limits, as the result line
    carries them under ``checks``."""
    checks = {name: {"value": numbers.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    ok = not other_faults and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return {"correct": ok, "checks": checks, "faults": list(other_faults)}


def print_checks(v: Dict) -> None:
    """The numbers beside their limits, as the last lines on stderr."""
    for fault in v["faults"]:
        print(f"check fault: {fault}", file=sys.stderr)
    for name, c in v["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct {v['correct']}", file=sys.stderr, flush=True)
