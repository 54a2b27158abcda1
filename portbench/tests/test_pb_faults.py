"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run at a small size on the CPU, once sound and once for each fault its
cell can have: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, and a served token altered
where it is produced. (These cells run on one card: none has an exchange
between cards to leave out.)"""

import pytest

from portbench import run
from portbench.tests import tiny

TRAIN = ["mistral7b.train.s4096", "vitb16.train.b256"]


def _run(name, seed=21):
    r = run.Run(tiny.cell(name), seed, 0.3, False, device="cpu")
    line, verdict = run.execute(r)
    return line, {k: v["value"] for k, v in line["checks"].items()}


@pytest.mark.parametrize("name", TRAIN + ["mistral7b.serve.open"])
def test_sound_run_is_correct(name):
    line, numbers = _run(name)
    assert line["correct"], numbers
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name", TRAIN)
def test_state_unchanged(name, monkeypatch):
    from ray_tpu_torch.models import training

    def update_nothing(self, params, grads, state, norm=None):
        return training.global_norm(grads) if norm is None else norm

    monkeypatch.setattr(training.AdamW, "update_", update_nothing)
    line, numbers = _run(name)
    assert not line["correct"]
    assert numbers["update_leaf"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_left_out(name, monkeypatch):
    from ray_tpu_torch.models import training, vit

    def half(batch):
        n = next(iter(batch.values())).shape[0] // 2
        return {k: v[:n] for k, v in batch.items()}

    loss_fn, vit_loss_fn = training.loss_fn, vit.vit_loss_fn
    monkeypatch.setattr(training, "loss_fn",
                        lambda p, b, *a: loss_fn(p, half(b), *a))
    monkeypatch.setattr(vit, "vit_loss_fn",
                        lambda p, b, *a: vit_loss_fn(p, half(b), *a))
    line, numbers = _run(name)
    assert not line["correct"], numbers


def test_served_token_altered(monkeypatch):
    from ray_tpu_torch.models import transformer
    forward = transformer.forward

    def altered(params, tokens, cfg, *a, **kw):
        logits = forward(params, tokens, cfg, *a, **kw)
        worst = logits[0, -1].argmin()
        logits[0, -1, worst] = logits[0, -1].max() + 1.0
        return logits

    monkeypatch.setattr(transformer, "forward", altered)
    line, numbers = _run("mistral7b.serve.open")
    assert not line["correct"]
    assert numbers["served_gap"] > 1.0
