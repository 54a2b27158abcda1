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

Then the RL learner over the 4 cards (``rl``): the algorithms of
``ray_tpu_torch.rl`` built in this process with a learner gang of 4 NCCL
ranks (``learner_devices=4``; multi-agent PPO takes every card). PPO at
the reference's learning-test settings (``tests/test_rl.py:46-64``): its
first RL_CHECKED updates held against the one-card update on the same
params and batch to RL_TOL in every parameter, then up to RL_ITERS
iterations to reach RL_BEST; RL_OTHER_ITERS updates each of IMPALA and
multi-agent PPO held the same way. Update times of both ways are printed beside it.

    python3 -m ray_tpu_torch.tools.mesh_cards --only rl    # the RL run alone
    python3 -m ray_tpu_torch.tools.mesh_cards --only mesh  # the others
"""

from __future__ import annotations

import argparse
import json
import subprocess
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
RL_LEARNERS = 4
RL_TOL = 1e-4          # abs, every parameter: gang vs one-card update
RL_CHECKED = 3         # PPO updates held against the one-card update
RL_ITERS = 30          # the reference's budget and threshold
RL_BEST = 120.0        # (tests/test_rl.py:46-64, seed 1)
RL_OTHER_ITERS = 2     # IMPALA and multi-agent PPO: the first update
                       # includes the gang's first call; both checked


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


def _max_abs(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b)


class _GangChecked:
    """An algorithm's gang update, timed; each of its first ``checked``
    calls is also run by the one-card update on the same inputs (timed
    too) and every parameter of the two held within RL_TOL."""

    def __init__(self, gang, one_card, checked, sync):
        self.gang, self.one_card, self.checked = gang, one_card, checked
        self.sync = sync
        self.gang_ms, self.one_card_ms, self.errs = [], [], []

    def _timed(self, fn, args):
        self.sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self.sync()
        return out, (time.perf_counter() - t0) * 1e3

    def __call__(self, *args):
        out, ms = self._timed(self.gang, args)
        self.gang_ms.append(ms)
        if len(self.errs) < self.checked:
            want, ms = self._timed(self.one_card, args)
            self.one_card_ms.append(ms)
            self.errs.append(_max_abs(out[0], want[0]))
        return out

    def summary(self):
        return {"gang_ms": self.gang_ms, "one_card_ms": self.one_card_ms,
                "param_max_abs": self.errs,
                "passed": bool(self.errs)
                and max(self.errs) <= RL_TOL}


def run_rl(device="cuda", learners=RL_LEARNERS):
    """The RL learner over ``learners`` ranks on ``device`` (module
    docstring); returns (passed, the runs' records)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl import impala, multi_agent, ppo
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    rt.init(**({} if on_card else {"num_gpus": 0}))
    try:
        algo = (rl.PPOConfig()
                .environment("CartPole")
                .env_runners(num_env_runners=2, num_envs_per_runner=16,
                             rollout_length=128)
                .training(lr=3e-3, epochs=10, entropy_coeff=0.01, seed=1,
                          device=device)
                .resources(learner_devices=learners)
                .build())
        try:
            upd = algo._update = _GangChecked(
                algo._update, ppo.make_update(algo.config, device),
                RL_CHECKED, sync)
            best, iters, walls = 0.0, 0, []
            while (iters < RL_CHECKED or best < RL_BEST) \
                    and iters < 1 + RL_ITERS:
                result = algo.train()
                iters += 1
                walls.append(result["time_this_iter_s"])
                if iters > 1:
                    best = max(best, result["episode_return_mean"])
            out["ppo"] = {**upd.summary(), "learners": algo.learners,
                          "iterations": iters, "best": best,
                          "iteration_s": walls}
            out["ppo"]["passed"] &= (best >= RL_BEST
                                     and algo.learners == learners)
        finally:
            algo.stop()
        for name, module, config in (
                ("impala", impala, rl.IMPALAConfig(
                    lr=3e-3, seed=3, device=device,
                    learner_devices=learners)),
                ("multi_agent", multi_agent, rl.MultiAgentPPOConfig(
                    seed=3, device=device))):
            algo = config.build()
            try:
                upd = algo._update = _GangChecked(
                    algo._update, module.make_update(config, device),
                    RL_OTHER_ITERS, sync)
                for _ in range(RL_OTHER_ITERS):
                    algo.train()
                out[name] = {**upd.summary(), "learners": algo.learners}
                out[name]["passed"] &= algo.learners == learners
            finally:
                algo.stop()
    finally:
        rt.shutdown()
    for name, rec in out.items():
        print(json.dumps({"run": f"rl {name}", "ranks": rec["learners"],
                          **rec}))
        print(f"rl {name}: {rec['learners']} learners, gang vs one card "
              f"{max(rec['param_max_abs']):.3e} (bound {RL_TOL}); update "
              f"ms through the gang {[round(t, 2) for t in rec['gang_ms']]}"
              f", on one card {[round(t, 2) for t in rec['one_card_ms']]}"
              + (f"; best {rec['best']:.1f} after {rec['iterations']} "
                 f"iterations" if name == "ppo" else "")
              + ("" if rec["passed"] else "  FAILED"))
    return all(rec["passed"] for rec in out.values()), out


def main(argv=None) -> int:
    import chip_smoke as cs
    parser = argparse.ArgumentParser(prog="mesh_cards")
    parser.add_argument("--only", choices=("mesh", "rl"),
                        help="run only the mesh runs or only the RL run")
    args = parser.parse_args(argv)
    n_cards = torch.cuda.device_count()
    if n_cards != CARDS:
        print(f"mesh_cards: needs {CARDS} CUDA cards, found {n_cards}",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    ok = True
    if args.only != "rl":
        ok &= run_meshes(cs, n_cards)
    if args.only != "mesh":
        ok &= run_rl()[0]
    return 0 if ok else 1


def run_meshes(cs, n_cards) -> bool:
    """The flagship, slice, pipeline and ViT runs (module docstring)."""
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
    return ok


if __name__ == "__main__":
    sys.exit(main())
