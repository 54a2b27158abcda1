"""The plain reference agrees with the port's CPU path at a small size,
both in fp32: logits of the decoder and the ViT, the loss and every
gradient, three optimizer steps, and the whole checked steps."""

import copy

import pytest
import torch

from portbench import feed, judge, program, weights
from portbench.reference import models, train_check
from portbench.reference.optim import AdamW
from portbench.reference.precision import Precision
from portbench.tests import tiny


def _fp32(cell):
    cfg = program.config(cell.config, cell.traffic)
    return type(cfg)(**{**cfg.__dict__, "dtype": torch.float32})


@pytest.mark.parametrize("name", ["mistral7b.train.s4096",
                                  "vitb16.train.b256"])
def test_forward_and_gradients(name):
    from ray_tpu_torch.models import training, transformer, vit
    cell = tiny.cell(name)
    c, cfg = cell.config, _fp32(cell)
    params = weights.make(c, 5, "cpu")
    batch = feed.batch(c, cell.traffic, 5, 0, "cpu")
    leaves = training.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    if c["model"] == "decoder":
        got = transformer.forward(params, batch["tokens"], cfg)
        want = models.decoder_logits(Precision(), params, c, batch["tokens"])
        loss = transformer.loss_fn(params, batch, cfg)
    else:
        got = vit.vit_forward(params, batch["images"], cfg)
        want = models.vit_logits(Precision(), params, c, batch["images"])
        loss = vit.vit_loss_fn(params, batch, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    rows, denom = models.loss_terms(c, batch)
    ref = models.nll_sum(Precision(), params, c, batch, slice(0, rows),
                         checkpoint=False) / denom
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=1e-6)
    for g, h in zip(torch.autograd.grad(loss, leaves),
                    torch.autograd.grad(ref, leaves)):
        torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-6)


def test_optimizer_steps():
    from ray_tpu_torch.models import training
    spec = dict(tiny.cell("mistral7b.train.s4096").traffic["optimizer"],
                warmup_steps=2)
    tx = training.make_optimizer(lr=spec["lr"],
                                 weight_decay=spec["weight_decay"],
                                 warmup_steps=2,
                                 total_steps=spec["total_steps"])
    gen = torch.Generator().manual_seed(0)
    a = [torch.randn(5, 3, generator=gen) for _ in range(3)]
    b = copy.deepcopy(a)
    state, ref = tx.init(a), AdamW(spec)
    for _ in range(3):
        grads = [torch.randn(5, 3, generator=gen) for _ in range(3)]
        tx.update_(a, grads, state)
        ref.step(b, grads)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["mistral7b.train.s4096",
                                  "vitb16.train.b256"])
def test_checked_steps_in_fp32_agree(name):
    """The driver's step and its readings, in fp32, against the reference:
    every compared number at rounding."""
    from ray_tpu_torch.models import training
    from portbench.drivers import train as driver
    cell = tiny.cell(name)
    c, traffic = cell.config, cell.traffic
    cfg = _fp32(cell)
    o = traffic["optimizer"]
    tx = training.make_optimizer(lr=o["lr"], weight_decay=o["weight_decay"],
                                 warmup_steps=o["warmup_steps"],
                                 total_steps=o["total_steps"])
    params = weights.make(c, 9, "cpu")
    state = training.TrainState(0, params, tx.init(params))
    step = driver.make_step(c, traffic, cfg, tx)
    prog = {"names": weights.leaf_names(params), "loss": [], "grad_norm": []}
    for i in range(3):
        state, m = step(state, feed.batch(c, traffic, 9, i, "cpu"))
        prog["loss"].append(float(m["loss"]))
        prog["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            prog["grad1"] = [float(mu.norm()) / 0.1
                             for mu in state.opt_state.mu]
    prog["update"] = weights.change_norms(c, 9, state.params, "cpu")
    ref = train_check.run(c, traffic, 9, "cpu", 3)
    numbers = judge.compare_train(prog, ref)
    assert max(numbers.values()) < 1e-4, numbers
