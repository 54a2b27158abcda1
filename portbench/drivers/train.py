"""Training through ``ray_tpu_torch.train``: one worker of
``DataParallelTrainer`` on one card, running the benchmark's loop.

The loop builds the training state once from the seed (weights from
``portbench.weights``, the program's ``make_optimizer`` and, for a decoder,
``make_train_step``; for a ViT the program's ``vit_loss_fn`` and the same
optimizer), drives it through the mix's checked steps, reads what the
check needs from that same state, and hands it to the measured window:
steps on fresh batches until ``seconds`` have passed, each followed by
``train.report`` of its loss. The window ends with the report of the last
step. A card worker runs on a thread of this process, so the loop finds
its run in ``JOBS``.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
import uuid
from typing import Dict

import torch
from torch.profiler import record_function

from portbench import feed, judge, program, trace, weights
from portbench.counts import model as model_counts
from portbench.reference import train_check

JOBS: Dict[str, "object"] = {}


def make_step(c: Dict, traffic: Dict, cfg, tx):
    """``step(state, batch) -> (state, metrics)`` of the program."""
    from ray_tpu_torch.models import training
    if c["model"] == "decoder":
        return training.make_train_step(cfg, tx)
    from ray_tpu_torch.models.vit import vit_loss_fn

    def step(state, batch):
        leaves = training.param_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss = vit_loss_fn(state.params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        norm = tx.update_(state.params, grads, state.opt_state)
        metrics = {"loss": loss.detach(), "grad_norm": norm,
                   "step": state.step}
        state.step += 1
        return state, metrics

    return step


def train_loop(config):
    from ray_tpu_torch import train
    r = JOBS[config["job"]]
    c, traffic, dev = r.cell.config, r.cell.traffic, r.device
    from ray_tpu_torch.models import training
    cfg = program.config(c, traffic)
    opt = traffic["optimizer"]
    tx = training.make_optimizer(lr=opt["lr"],
                                 weight_decay=opt["weight_decay"],
                                 warmup_steps=opt["warmup_steps"],
                                 total_steps=opt["total_steps"])
    if (tx.b1, tx.b2, tx.eps, tx.max_norm) != (
            opt["b1"], opt["b2"], opt["eps"], opt["max_norm"]):
        raise ValueError("the program's AdamW constants are not the mix's")
    r.mark("the loop starts on the gang's worker")
    params = weights.make(c, r.seed, dev)
    state = training.TrainState(step=0, params=params,
                                opt_state=tx.init(params))
    del params
    step = make_step(c, traffic, cfg, tx)

    # the checked steps: the window's own call and feed, batches 0..n-1
    checked = traffic["checked_steps"]
    prog = {"names": weights.leaf_names(state.params), "loss": [],
            "grad_norm": []}
    for i in range(checked):
        state, m = step(state, feed.batch(c, traffic, r.seed, i, dev))
        prog["loss"].append(float(m["loss"]))
        prog["grad_norm"].append(float(m["grad_norm"]))
        train.report({"loss": prog["loss"][-1], "step": i})
        if i == 0:
            prog["grad1"] = [float(mu.norm()) / (1.0 - tx.b1)
                             for mu in state.opt_state.mu]
    prog["update"] = weights.change_norms(c, r.seed, state.params, dev)
    r.record["program"] = prog
    r.mark("the checked steps and their readings are done")

    # the window
    tokens = feed.tokens_per_step(c, traffic)
    steps, step_s, failed = 0, 0.0, 0
    span = r.spans.span
    with trace.capture(dev, r.spans, r.traced,
                       traffic.get("trace_ops", False)) as held:
        with span(trace.WINDOW), record_function(trace.WINDOW):
            r.window_start = time.perf_counter()
            deadline = r.window_start + r.seconds
            index = checked
            while True:
                with span("pb.feed"):
                    batch = feed.batch(c, traffic, r.seed, index, dev)
                t0 = time.perf_counter()
                with span("pb.step"):
                    state, m = step(state, batch)
                    loss = float(m["loss"])
                step_s += time.perf_counter() - t0
                with span("pb.report"):
                    train.report({"loss": loss, "step": index})
                failed += not math.isfinite(loss)
                steps += 1
                index += 1
                if time.perf_counter() >= deadline:
                    break
            window_s = time.perf_counter() - r.window_start
    r.memory_peak_bytes = r.peak_memory()
    r.trace = held.trace
    r.record.update(steps=steps, failed=failed, window_s=window_s,
                    step_s=step_s, tokens_per_step=tokens,
                    flops_per_step=model_counts.train_step(c, traffic))
    if c["model"] == "decoder":
        n = c["num_attention_heads"]
        r.record["attn"] = (traffic["batch"], traffic["seq_len"], n,
                            c["num_key_value_heads"],
                            c["hidden_size"] // n, True)
    del state, step, batch, m


def run(r) -> None:
    from ray_tpu_torch import train
    c, traffic = r.cell.config, r.cell.traffic
    job = uuid.uuid4().hex
    JOBS[job] = r
    program.start_runtime(r.device)
    r.mark("the runtime is up")
    try:
        trainer = train.DataParallelTrainer(
            train_loop, train_loop_config={"job": job},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(
                name=f"portbench-{job[:8]}",
                storage_path=os.path.join(tempfile.gettempdir(),
                                          "portbench_train")))
        result = trainer.fit()
        if result.error is not None:
            raise result.error
    finally:
        program.stop_runtime()
        del JOBS[job]
    r.free_device()

    window_s = r.record["window_s"]
    r.attempted, r.failed = r.record["steps"], r.record["failed"]
    r.end_to_end["train_tokens_per_s"] = (
        r.record["steps"] * r.record["tokens_per_step"] / window_s)

    ref = train_check.run(c, traffic, r.seed, r.device,
                          traffic["checked_steps"])
    r.numbers.update(judge.compare_train(r.record["program"], ref))
