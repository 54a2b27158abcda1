#!/usr/bin/env python3
"""Compare the flagship's serving and training numbers of two checkouts on
one card, in turns.

Usage, from the root of a checkout:

    python3 ray_tpu_torch/tools/flagship_ab.py PARENT_DIR CHANGE_DIR

Each of PARENT_DIR and CHANGE_DIR is the root of a checkout with its own
``chip_smoke.py`` and ``ray_tpu_torch``. The script runs, in a fresh
process in each directory and in the order parent, change, change,
parent, that checkout's ``chip_smoke`` device phase (which builds its
kernels), serving phase and training phase, and prints one line of JSON
per run and a table. It needs one CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = r"""
import json, torch
import chip_smoke as c
name, count, *_ = c.phase_device()
serving, _ = c.phase_serving()
torch.cuda.empty_cache()
training, _ = c.phase_training()
print("AB_RESULT " + json.dumps({
    "device": name,
    "batch_latency_s": serving["batch_latency_s"],
    "step_time_s": training["step_time_s"],
    "mean_step_s_2_to_last": training["mean_step_s_2_to_last"],
    "tokens_per_s": training["tokens_per_s"],
    "peak_train_bytes": training["peak_mem_bytes"]}))
"""


def run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                          capture_output=True, text=True, timeout=1200)
    for line in proc.stdout.splitlines():
        if line.startswith("AB_RESULT "):
            return json.loads(line[len("AB_RESULT "):])
    raise RuntimeError(f"no result from {tree} (exit {proc.returncode}):\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2])}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    results = []
    for label in ("parent", "change", "change", "parent"):
        out = {"tree": label, **run(trees[label])}
        results.append(out)
        print(json.dumps(out), flush=True)
    print("| run | served batch s | training step s (2-6) | tokens/s |")
    for r in results:
        print(f"| {r['tree']} | "
              + ", ".join(f"{t:.5f}" for t in r["batch_latency_s"])
              + f" | {r['mean_step_s_2_to_last']:.5f} | "
              f"{r['tokens_per_s']:.1f} |")
    print(json.dumps({"ab": results, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
