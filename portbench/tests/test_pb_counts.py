"""The operation and byte counts against counts made by hand at small
shapes, and against a count of the reference's own products."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import attention, model
from portbench.reference import models
from portbench.reference.precision import Precision
from portbench import weights


def test_pairs_by_hand():
    assert attention.pairs(4, True) == 1 + 2 + 3 + 4
    assert attention.pairs(4, False) == 16


def test_attention_counts_by_hand():
    # B 2, S 3, N 4, KV 2, H 8: 6 causal pairs a head
    assert attention.fwd_flops(2, 3, 4, 8, True) == 2 * 2 * (2 * 4 * 8 * 6)
    assert attention.bwd_flops(2, 3, 4, 8, True) == 4 * 2 * (2 * 4 * 8 * 6)
    q_o = 2 * 3 * 4 * 8 * 2               # bf16 bytes of q (or o, dO, dQ)
    k_v = 2 * 3 * 2 * 8 * 2               # of k (or v, dK, dV) at 2 heads
    lse = 2 * 4 * 3 * 4
    assert attention.fwd_bytes(2, 3, 4, 2, 8) == 2 * q_o + 2 * k_v + lse
    assert attention.bwd_bytes(2, 3, 4, 2, 8) == 4 * q_o + 4 * k_v + lse


DEC = {"model": "decoder", "hidden_size": 32, "intermediate_size": 48,
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "num_hidden_layers": 2, "vocab_size": 64, "rms_norm_eps": 1e-6,
       "rope_theta": 10000.0}
VIT = {"model": "vit", "image_size": 16, "patch_size": 4, "num_channels": 3,
       "hidden_size": 32, "intermediate_size": 48, "num_attention_heads": 4,
       "num_key_value_heads": 4, "num_hidden_layers": 2, "num_labels": 10,
       "rms_norm_eps": 1e-6, "rope_theta": 10000.0}


def test_decoder_forward_by_hand():
    d, ff, v, s = 32, 48, 64, 5
    per_layer = 2 * d * d + 2 * d * 16 + 3 * d * ff    # q, o; k, v; MLP
    dense = 2 * s * (2 * per_layer + d * v)
    attn = 2 * 4 * 4 * 8 * 15                          # 2 layers, 15 pairs
    assert model.decoder_forward(DEC, s) == dense + attn


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_decoder_forward_matches_the_reference_products():
    """The reference computes attention over the whole square, masked:
    the count of its products less the masked half is ours."""
    s = 6
    p = weights.make(DEC, 1, "cpu")
    tokens = torch.zeros((1, s), dtype=torch.int64)
    counted = _counted(lambda: models.decoder_logits(
        Precision(), p, DEC, tokens))
    square = 2 * 4 * 4 * 8 * s * s
    assert counted - square + 2 * 4 * 4 * 8 * attention.pairs(s, True) \
        == model.decoder_forward(DEC, s)


def test_vit_forward_matches_the_reference_products():
    p = weights.make(VIT, 1, "cpu")
    images = torch.zeros((3, 16, 16, 3))
    counted = _counted(lambda: models.vit_logits(Precision(), p, VIT, images))
    assert counted == model.vit_forward(VIT, 3)


@pytest.mark.parametrize("c,traffic", [
    (DEC, {"batch": 2, "seq_len": 8}), (VIT, {"batch": 3})])
def test_train_step_is_three_forwards(c, traffic):
    one = (traffic["batch"] * model.decoder_forward(c, 8)
           if c["model"] == "decoder" else model.vit_forward(c, 3))
    assert model.train_step(c, traffic) == 3 * one
