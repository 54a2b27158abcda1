#!/usr/bin/env python3
"""The flagship's sharded train step across the cards of one host.

Usage, from the root of a checkout, on a host with 4 CUDA cards:

    python3 -m ray_tpu_torch.tools.mesh_cards

One NCCL rank per card (``LocalRanks``, a file rendezvous). On each of the
meshes below, every rank builds its blocks of
the seed-0 state (``init_state(..., mesh=mesh)``) and takes STEPS steps of
``make_train_step(cfg, tx, mesh)`` on ``chip_smoke.py``'s training batch
(4 x 2048 tokens from ``RandomState(0)``), with the flagship at full width
and depth. Then rank 0 takes the same steps without a mesh, and every
mesh's losses and grad norms are held against those, per step, to
``chip_smoke.py``'s bounds. It prints a JSON line per run (step times,
tokens/s, peak memory of each rank, kernel launches per step) and a table,
and exits non-zero if a run fails or disagrees. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ray_tpu_torch.parallel.launch import LocalRanks

STEPS = 4
CARDS = 4
MESHES = ({"fsdp": 4}, {"fsdp": 2, "tp": 2}, {"tp": 2, "sp": 2})


def _run(mesh_kw):
    """On each rank: STEPS steps on the mesh ``mesh_kw`` (None: rank 0
    alone, without a mesh); losses, grad norms, step times, peak memory
    and flash launches per step."""
    import torch.distributed as dist
    import chip_smoke as cs
    from ray_tpu_torch.models import init_state, make_optimizer, \
        make_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    if mesh_kw is None and dist.get_rank() != 0:
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.flagship_config()
    tx = make_optimizer(total_steps=1000)
    mesh = (None if mesh_kw is None
            else make_mesh(MeshSpec(**mesh_kw), device="cuda"))
    state = init_state(cfg, tx, seed=cs.SEED, device="cuda", mesh=mesh)
    step = make_train_step(cfg, tx, mesh)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (cs.BATCH, cs.SEQ))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "grad_norms": [], "step_time_s": [],
           "launches_per_step": []}
    for _ in range(STEPS):
        before = cs.launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        out["step_time_s"].append(time.perf_counter() - t0)
        out["launches_per_step"].append(
            [a - b for a, b in zip(cs.launch_counts(), before)])
        out["losses"].append(metrics["loss"].item())
        out["grad_norms"].append(metrics["grad_norm"].item())
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import chip_smoke as cs
    n_cards = torch.cuda.device_count()
    if n_cards != CARDS:
        print(f"mesh_cards: needs {CARDS} CUDA cards, found {n_cards}",
              file=sys.stderr)
        return 1
    cs.native_loader.build()
    ok = True
    with LocalRanks(n_cards, device="cuda") as ranks:
        results = {json.dumps(kw): ranks.run(_run, kw) for kw in MESHES}
        reference = ranks.run(_run, None)[0]
    print(json.dumps({"mesh": None, "ranks": 1, **reference}))
    rows = [("none", 1, reference, 0.0, 0.0)]
    for key, per_rank in results.items():
        first = per_rank[0]
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(first["losses"], reference["losses"]))
        norm_err = max(abs(a - b) / abs(b) for a, b in
                       zip(first["grad_norms"], reference["grad_norms"]))
        same = all(r["losses"] == first["losses"] and
                   r["grad_norms"] == first["grad_norms"] for r in per_rank)
        passed = (same and loss_err <= cs.MESH_LOSS_REL
                  and norm_err <= cs.MESH_NORM_REL)
        ok &= passed
        print(json.dumps({"mesh": json.loads(key), "ranks": n_cards,
                          "loss_rel_err": loss_err,
                          "grad_norm_rel_err": norm_err,
                          "ranks_agree": same, "passed": passed,
                          "per_rank": per_rank}))
        rows.append((key, n_cards, first, loss_err, norm_err))
    print(f"{'mesh':28s} {'ranks':>5s} {'step s (2-)':>12s} "
          f"{'tokens/s':>10s} {'peak GB r0':>10s} {'loss err':>9s} "
          f"{'norm err':>9s} launches/step")
    for key, n, r, le, ne in rows:
        step_s = sum(r["step_time_s"][1:]) / (STEPS - 1)
        print(f"{key:28s} {n:5d} {step_s:12.5f} "
              f"{cs.BATCH * cs.SEQ / step_s:10.1f} "
              f"{r['peak_mem_bytes'] / 1e9:10.3f} {le:9.2e} {ne:9.2e} "
              f"{r['launches_per_step'][-1]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
