"""The program under test: ``ray_tpu_torch``'s configuration objects built
from a configuration file, and the runtime brought up and down.

Everything the harness takes from the program passes through the drivers
and this module; the reference never imports either."""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import torch

# The program's RMSNorm takes no epsilon (ray_tpu_torch/models/
# transformer.py::rms_norm); a configuration must state the one it fixes.
PROGRAM_RMS_EPS = 1e-6


def config(c: Dict, traffic: Dict):
    """The program's config for configuration file ``c`` under a mix:
    bf16 compute, the flash kernels for a decoder, remat as the mix
    says."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.models.vit import ViTConfig
    if float(c["rms_norm_eps"]) != PROGRAM_RMS_EPS:
        raise ValueError(f"the program's RMSNorm fixes eps {PROGRAM_RMS_EPS}, "
                         f"the configuration states {c['rms_norm_eps']}")
    if c["torch_dtype"] != "bfloat16":
        raise ValueError(f"the program computes in bf16, the configuration "
                         f"states {c['torch_dtype']}")
    remat = bool(traffic.get("remat", False))
    if c["model"] == "decoder":
        return TransformerConfig(
            vocab_size=c["vocab_size"], d_model=c["hidden_size"],
            n_layers=c["num_hidden_layers"],
            n_heads=c["num_attention_heads"],
            n_kv_heads=c["num_key_value_heads"],
            d_ff=c["intermediate_size"],
            max_seq_len=c["max_position_embeddings"],
            rope_theta=float(c["rope_theta"]), dtype=torch.bfloat16,
            remat=remat, use_flash=True)
    if float(c["rope_theta"]) != 10_000.0:
        raise ValueError("the program's ViT fixes rope_theta 10000")
    return ViTConfig(
        image_size=c["image_size"], patch_size=c["patch_size"],
        channels=c["num_channels"], num_classes=c["num_labels"],
        d_model=c["hidden_size"], n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        dtype=torch.bfloat16, remat=remat)


def start_runtime(device) -> None:
    """``ray_tpu_torch.init`` for one run: the host-plane collective files
    under this run's temporary directory; one GPU resource a card (on a
    CPU device, one, so that the same gang and replica run)."""
    import ray_tpu_torch as rt
    os.environ.setdefault("RAY_TPU_COLL_DIR", os.path.join(
        tempfile.gettempdir(), "portbench_coll"))
    if torch.device(device).type == "cuda":
        rt.init(num_cpus=4)
    else:
        rt.init(num_cpus=4, num_gpus=1)


def stop_runtime() -> None:
    import ray_tpu_torch as rt
    rt.shutdown()
