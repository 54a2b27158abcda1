"""The two models the configurations name, in fp32.

``decoder``: token embedding, the blocks (causal), final RMSNorm, an
untied unembedding; the loss is the mean next-token cross-entropy over
every position but the last. ``vit``: 16 x 16 patches of the image
(row-major patch grid, each patch's pixels row by row, channels last)
times the patch embedding plus its bias, the blocks (not causal, RoPE over
the patch index), final RMSNorm, the mean over patches, a linear head; the
loss is the mean cross-entropy of the labels. These are the repo's models
(``ray_tpu_torch/models/{transformer,vit}.py``), written out again."""

from __future__ import annotations

import torch

from portbench.reference import layers


def _eps(c):
    return float(c["rms_norm_eps"])


def decoder_logits(prec, params, c, tokens, checkpoint=False):
    """tokens [B, S] -> logits [B, S, V]."""
    x = params["embed"][tokens]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = layers.blocks(prec, params, x, pos, float(c["rope_theta"]), _eps(c),
                      True, checkpoint)
    x = layers.rms_norm(x, params["final_norm"], _eps(c))
    return prec.einsum("bsd,dv->bsv", x, params["unembed"])


def decoder_nll_sum(prec, params, c, tokens, checkpoint):
    """The summed next-token negative log-likelihood of ``tokens``."""
    logits = decoder_logits(prec, params, c, tokens, checkpoint)[:, :-1]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).sum()


def patches(images, p):
    b, h, w, ch = images.shape
    x = images.reshape(b, h // p, p, w // p, p, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * ch)


def vit_logits(prec, params, c, images, checkpoint=False):
    x = prec.einsum("bnp,pd->bnd", patches(images, c["patch_size"]),
                    params["patch_embed"]) + params["patch_bias"]
    pos = torch.arange(x.shape[1], device=x.device)
    x = layers.blocks(prec, params, x, pos, float(c["rope_theta"]), _eps(c),
                      False, checkpoint)
    x = layers.rms_norm(x, params["final_norm"], _eps(c)).mean(dim=1)
    return prec.einsum("bd,dk->bk", x, params["head"])


def vit_nll_sum(prec, params, c, images, labels, checkpoint):
    logp = torch.log_softmax(vit_logits(prec, params, c, images, checkpoint),
                             dim=-1)
    return -logp.gather(-1, labels[:, None]).sum()


def loss_terms(c, batch):
    """(rows, loss denominator) of a batch: the loss is the sum over rows
    divided by the denominator."""
    if c["model"] == "decoder":
        b, s = batch["tokens"].shape
        return b, b * (s - 1)
    return batch["labels"].shape[0], batch["labels"].shape[0]


def nll_sum(prec, params, c, batch, rows: slice, checkpoint=True):
    if c["model"] == "decoder":
        return decoder_nll_sum(prec, params, c, batch["tokens"][rows],
                               checkpoint)
    return vit_nll_sum(prec, params, c, batch["images"][rows],
                       batch["labels"][rows], checkpoint)
