#!/usr/bin/env python3
"""The port's mesh paths across the cards of one host.

Usage, from the root of a checkout, on a host with 4 CUDA cards:

    python3 -m ray_tpu_torch.tools.mesh_cards

One NCCL rank per card (``LocalRanks``, a file rendezvous); every run
starts from the seed-0 weights and ``chip_smoke.py``'s batches. Runs:

- the flagship's sharded train step (``make_train_step(cfg, tx, mesh)``,
  full width and depth, 4 x 2048 tokens from ``RandomState(0)``), STEPS
  steps on each of MESHES;
- the slice mesh of 2 slices x fsdp 2, dp across slices, one host split in
  two (``allow_split_slices=True``), and the same layout as one flat (dp 2,
  fsdp 2) mesh: their losses equal to SLICE_REL;
- the pipeline (``forward_pipelined`` with ``attn_fn=flash_attention``,
  M = 4) at pp = 4 (2 layers a stage) and at pp = 2 x dp 2: STEPS
  gradients of the next-token loss on the same weights;
- ViT-B/16 (``chip_smoke.vit_b16_config``, 64 images) on fsdp 2 x tp 2:
  STEPS gradients of ``vit_loss_fn_shard``.

Rank 0 then runs each without a mesh, and every run's losses and grad
norms are held against those, per step, to ``chip_smoke.py``'s mesh
bounds. It prints a JSON line per run (step times, tokens or images a
second, peak memory of each rank, kernel launches per step) and a table,
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
PIPELINES = ({"pp": 4}, {"dp": 2, "pp": 2})
PIPE_MICROBATCHES = 4
SLICE_STEPS = 2
SLICE_REL = 1e-5       # tests/test_slice_mesh.py:199
VIT_MESH = {"fsdp": 2, "tp": 2}


def _steps(n, fn):
    """``n`` calls of ``fn() -> (loss, grad_norm)`` (0-d tensors or
    floats), each timed on the host clock to a synchronize; the losses,
    grad norms, times, peak memory and flash launches of each call."""
    import chip_smoke as cs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "grad_norms": [], "step_time_s": [],
           "launches_per_step": []}
    for _ in range(n):
        before = cs.launch_counts()
        t0 = time.perf_counter()
        loss, norm = fn()
        torch.cuda.synchronize()
        out["step_time_s"].append(time.perf_counter() - t0)
        out["launches_per_step"].append(
            [a - b for a, b in zip(cs.launch_counts(), before)])
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(norm))
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return out


def _tokens(cfg):
    import chip_smoke as cs
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (cs.BATCH, cs.SEQ))).cuda()


def _train(mesh, n_steps=STEPS):
    import chip_smoke as cs
    from ray_tpu_torch.models import init_state, make_optimizer, \
        make_train_step
    cfg = cs.flagship_config()
    tx = make_optimizer(total_steps=1000)
    state = init_state(cfg, tx, seed=cs.SEED, device="cuda", mesh=mesh)
    step = make_train_step(cfg, tx, mesh)
    batch = {"tokens": _tokens(cfg)}

    def one():
        nonlocal state
        state, metrics = step(state, batch)
        return metrics["loss"], metrics["grad_norm"]
    return _steps(n_steps, one)


def _run(mesh_kw):
    """On each rank: STEPS train steps on the mesh ``mesh_kw`` (None: rank
    0 alone, without a mesh)."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    if mesh_kw is None and dist.get_rank() != 0:
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    return _train(None if mesh_kw is None
                  else make_mesh(MeshSpec(**mesh_kw), device="cuda"))


def _run_slice():
    """On each rank: SLICE_STEPS train steps on the slice mesh, then on
    the flat mesh of the same layout."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.slice_mesh import (
        SliceTopology, make_slice_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    smesh = make_slice_mesh(
        SliceTopology(num_slices=2, inner=MeshSpec(fsdp=2), cross="dp"),
        allow_split_slices=True)
    out = _train(smesh.mesh, SLICE_STEPS)
    out["flat"] = _train(make_mesh(MeshSpec(dp=2, fsdp=2), device="cuda"),
                         SLICE_STEPS)
    out["describe"] = smesh.describe()
    out["slices"] = [[d.id for d in smesh.slice_devices(i)]
                     for i in range(smesh.num_slices)]
    return out


def _gradient_steps(params, loss_fn):
    """STEPS gradients of ``loss_fn()`` for every leaf of ``params``; the
    norm is of the whole gradient, which every rank holds."""
    from ray_tpu_torch.models.training import global_norm, param_leaves
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def one():
        loss = loss_fn()
        return loss.detach(), global_norm(torch.autograd.grad(loss, leaves))
    return _steps(STEPS, one)


def _run_pipeline(mesh_kw):
    """On each rank: STEPS gradients of the next-token loss through
    ``forward_pipelined`` on the mesh ``mesh_kw`` (None: rank 0 alone,
    through ``forward``)."""
    import torch.distributed as dist
    import chip_smoke as cs
    from ray_tpu_torch.models import forward, init_params
    from ray_tpu_torch.ops import flash_attention
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.pipeline import forward_pipelined
    if mesh_kw is None and dist.get_rank() != 0:
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.flagship_config()
    params = init_params(cfg, seed=cs.SEED, device="cuda")
    tokens = _tokens(cfg)
    if mesh_kw is None:
        def logits():
            return forward(params, tokens, cfg)
    else:
        mesh = make_mesh(MeshSpec(**mesh_kw), device="cuda")

        def logits():
            return forward_pipelined(params, tokens, cfg, mesh,
                                     PIPE_MICROBATCHES,
                                     attn_fn=flash_attention)
    return _gradient_steps(
        params, lambda: cs.next_token_loss(logits(), tokens))


def _run_vit(mesh_kw):
    """On each rank: STEPS gradients of ViT-B/16's loss on its 64 images,
    ``vit_loss_fn_shard`` on the mesh ``mesh_kw`` (None: rank 0 alone,
    ``vit_loss_fn``)."""
    import torch.distributed as dist
    import chip_smoke as cs
    from ray_tpu_torch.models import (
        init_vit_params, vit_loss_fn, vit_param_specs)
    from ray_tpu_torch.models.sharded import vit_loss_fn_shard
    from ray_tpu_torch.models.training import (
        param_leaves, sharded_value_and_grad)
    from ray_tpu_torch.parallel.mesh import (
        MeshSpec, local_block, make_mesh, tree_map)
    if mesh_kw is None and dist.get_rank() != 0:
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.vit_b16_config()
    params = init_vit_params(cfg, seed=cs.SEED, device="cuda")
    rng = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(rng.rand(
                 cs.VIT_IMAGES, cfg.image_size, cfg.image_size,
                 cfg.channels).astype(np.float32)).cuda(),
             "labels": torch.from_numpy(rng.randint(
                 0, cfg.num_classes, cs.VIT_IMAGES)).cuda()}
    if mesh_kw is None:
        return _gradient_steps(params,
                               lambda: vit_loss_fn(params, batch, cfg))
    mesh = make_mesh(MeshSpec(**mesh_kw), device="cuda")
    specs = vit_param_specs(cfg)
    params = tree_map(lambda x, spec: local_block(mesh, x, spec).clone(),
                      params, specs)
    for p in param_leaves(params):
        p.requires_grad_(True)

    def one():
        loss, _, norm = sharded_value_and_grad(
            vit_loss_fn_shard, params, specs, mesh, batch, cfg)
        return loss, norm
    return _steps(STEPS, one)


def _compare(name, per_rank, reference, n):
    """Every rank's losses and grad norms against the reference's, per
    step, to chip_smoke's mesh bounds; all ranks alike."""
    import chip_smoke as cs
    first = per_rank[0]
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(first["losses"], reference["losses"]))
    norm_err = max(abs(a - b) / abs(b) for a, b in
                   zip(first["grad_norms"], reference["grad_norms"]))
    same = all(r["losses"] == first["losses"] and
               r["grad_norms"] == first["grad_norms"] for r in per_rank)
    passed = (same and loss_err <= cs.MESH_LOSS_REL
              and norm_err <= cs.MESH_NORM_REL)
    print(json.dumps({"run": name, "ranks": n, "loss_rel_err": loss_err,
                      "grad_norm_rel_err": norm_err, "ranks_agree": same,
                      "passed": passed, "per_rank": per_rank}))
    return passed, (name, n, first, loss_err, norm_err)


def main() -> int:
    import chip_smoke as cs
    n_cards = torch.cuda.device_count()
    if n_cards != CARDS:
        print(f"mesh_cards: needs {CARDS} CUDA cards, found {n_cards}",
              file=sys.stderr)
        return 1
    cs.native_loader.build()
    with LocalRanks(n_cards, device="cuda") as ranks:
        train = {json.dumps(kw): ranks.run(_run, kw) for kw in MESHES}
        train_ref = ranks.run(_run, None)[0]
        sliced = ranks.run(_run_slice)
        pipes = {json.dumps(kw): ranks.run(_run_pipeline, kw)
                 for kw in PIPELINES}
        pipe_ref = ranks.run(_run_pipeline, None)[0]
        vits = ranks.run(_run_vit, VIT_MESH)
        vit_ref = ranks.run(_run_vit, None)[0]
    ok = True
    rows = []
    for name, reference, runs in (
            ("train", train_ref, train), ("pipeline", pipe_ref, pipes),
            ("vit", vit_ref, {json.dumps(VIT_MESH): vits})):
        print(json.dumps({"run": f"{name} mesh=None", "ranks": 1,
                          **reference}))
        rows.append((f"{name} none", 1, reference, 0.0, 0.0))
        for key, per_rank in runs.items():
            passed, row = _compare(f"{name} {key}", per_rank, reference,
                                   n_cards)
            ok &= passed
            rows.append(row)
    passed, row = _compare("train slice 2 x fsdp 2", sliced, train_ref,
                           n_cards)
    rows.append(row)
    flat = [r["flat"] for r in sliced]
    passed_flat, row = _compare("train flat dp 2 x fsdp 2", flat,
                                train_ref, n_cards)
    rows.append(row)
    slice_err = max(abs(a - b) / abs(b) for a, b in
                    zip(sliced[0]["losses"], flat[0]["losses"]))
    slice_ok = slice_err <= SLICE_REL
    print(json.dumps({"run": "slice vs flat", "loss_rel_err": slice_err,
                      "bound": SLICE_REL, "passed": slice_ok,
                      "describe": sliced[0]["describe"],
                      "slices": sliced[0]["slices"]}))
    ok &= passed and passed_flat and slice_ok
    print(f"{'run':32s} {'ranks':>5s} {'step s (2-)':>12s} "
          f"{'peak GB r0':>10s} {'loss err':>9s} {'norm err':>9s} "
          f"launches/step")
    for key, n, r, le, ne in rows:
        times = r["step_time_s"][1:]
        print(f"{key:32s} {n:5d} {sum(times) / len(times):12.5f} "
              f"{r['peak_mem_bytes'] / 1e9:10.3f} {le:9.2e} {ne:9.2e} "
              f"{r['launches_per_step'][-1]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
