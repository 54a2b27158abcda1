"""A model's operations, from its configuration file's sizes.

Products count 2 operations a multiply-add. A forward over a sequence
counts every weight product (the embedding's gather is none) and the
attention's pairs (``counts.attention``); a training step counts three
forwards, recomputation not counted."""

from portbench.counts import attention


def layer_weights(c) -> int:
    """Weights a layer multiplies each token by."""
    d, n = c["hidden_size"], c["num_attention_heads"]
    kv, ff = c["num_key_value_heads"], c["intermediate_size"]
    hd = d // n
    return 2 * d * n * hd + 2 * d * kv * hd + 3 * d * ff


def decoder_forward(c, length: int) -> float:
    """One causal sequence of ``length`` real tokens."""
    d, n = c["hidden_size"], c["num_attention_heads"]
    layers = c["num_hidden_layers"]
    dense = 2.0 * length * (layers * layer_weights(c) + d * c["vocab_size"])
    return dense + layers * attention.fwd_flops(1, length, n, d // n, True)


def vit_forward(c, images: int) -> float:
    d, n = c["hidden_size"], c["num_attention_heads"]
    p = c["patch_size"]
    t = (c["image_size"] // p) ** 2
    per_image = (2.0 * t * p * p * c["num_channels"] * d
                 + 2.0 * t * c["num_hidden_layers"] * layer_weights(c)
                 + c["num_hidden_layers"] * attention.fwd_flops(
                     1, t, n, d // n, False)
                 + 2.0 * d * c["num_labels"])
    return images * per_image


def train_step(c, traffic) -> float:
    if c["model"] == "decoder":
        return 3.0 * traffic["batch"] * decoder_forward(c, traffic["seq_len"])
    return 3.0 * vit_forward(c, traffic["batch"])
