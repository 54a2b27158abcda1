"""Cells at a size the CPU runs in seconds, for the tests: the same
configuration keys, mixes and limits as the benchmark's cells, with small
widths, depth, batches and vocabulary."""

from __future__ import annotations

import copy

from portbench import cells

TINY = {
    "decoder": {"hidden_size": 64, "intermediate_size": 128,
                "num_attention_heads": 4, "num_key_value_heads": 2,
                "num_hidden_layers": 2, "vocab_size": 256,
                "max_position_embeddings": 256},
    "vit": {"image_size": 32, "patch_size": 8, "hidden_size": 64,
            "intermediate_size": 128, "num_attention_heads": 4,
            "num_key_value_heads": 4, "num_hidden_layers": 2,
            "num_labels": 10},
}
TINY_TRAFFIC = {
    "train": {"batch": 4, "seq_len": 32, "reference_rows": 2},
    "serve": {"rate_per_s": 20.0, "check_tokens": 256,
              "length": {"median": 24, "sigma": 1.0, "min": 8, "max": 64,
                         "multiple": 8}},
}


# The CPU runs' own limits: a tiny bf16 run on the CPU reads other gaps
# than the card's at full size (loss 2.4e-3, the rest under 3e-3 for the
# seeds tried), so the tests hold it to these and leave the cells' limits
# to the card.
TINY_LIMITS = {"loss": 0.02, "grad_norm": 0.02, "grad1_leaf": 0.02,
               "update_leaf": 0.02, "served_gap": 0.25}


def cell(name: str) -> cells.Cell:
    c = copy.deepcopy(cells.load_cell(name))
    c.config.update(TINY[c.config["model"]])
    c.traffic.update(TINY_TRAFFIC[c.driver])
    c.limits = {k: TINY_LIMITS[k] for k in c.limits}
    if c.config["model"] == "vit":
        c.traffic.pop("seq_len", None)
    return c
