"""Parameters from the JAX package's pytree.

The port keeps the JAX package's parameter layout, so the mapping is the
identity on names and shapes (V vocab, D d_model, N heads, K kv heads,
Hd head dim, F d_ff, E experts):

=====================  ============  ===================================
name                   dense shape   MoE shape
=====================  ============  ===================================
embed                  [V, D]
final_norm             [D]
blocks[i].attn_norm    [D]
blocks[i].wq           [D, N, Hd]
blocks[i].wk, .wv      [D, K, Hd]
blocks[i].wo           [N, Hd, D]
blocks[i].mlp_norm     [D]
blocks[i].router       (absent)      [D, E]
blocks[i].wi, .wg      [D, F]        [E, D, F]
blocks[i].wo_mlp       [F, D]        [E, F, D]
unembed                [D, V]
=====================  ============  ===================================

A ViT tree (``init_vit_params``, P patch size, C channels, L classes)
holds ``patch_embed`` [P*P*C, D], ``patch_bias`` [D], ``blocks`` and
``final_norm`` as above, and ``head`` [D, L].

Both packages contract these with the same einsums, so the same numbers
give the same logits. ``shard_params_from_jax`` gives a rank its blocks of
the same tree over a mesh, the blocks that ``jax.device_put(x,
NamedSharding(mesh, spec))`` puts on device r.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.mesh import local_block

_BLOCK_KEYS = frozenset(
    {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "wi", "wg", "wo_mlp"})
# The top-level keys of the flagship's tree and of a ViT's, in the order
# of the port's init_params and init_vit_params.
_TOP_KEYS = (("embed", "final_norm", "blocks", "unembed"),
             ("patch_embed", "patch_bias", "blocks", "final_norm", "head"))


def params_from_jax(tree, device="cuda") -> Dict[str, Any]:
    """The port's parameters from the JAX package's ``init_params`` (or
    ``init_vit_params``) tree, given as numpy arrays (or anything
    ``np.asarray`` takes). Every array becomes an fp32 tensor on
    ``device``."""
    return _convert(tree, device, lambda x, path: x)


def shard_params_from_jax(tree, mesh, specs, device="cuda"
                          ) -> Dict[str, Any]:
    """This rank's blocks of the JAX package's parameter tree (numpy, as
    for ``params_from_jax``) over ``mesh`` under the spec tree ``specs``
    (``param_specs(cfg)``, or ``vit_param_specs(cfg)`` for a ViT tree):
    fp32 tensors on ``device``, the same blocks that ``jax.device_put(x,
    NamedSharding(mesh, spec))`` puts on the device of this rank's
    index."""
    def block(x, path):
        spec = specs
        for key in path:
            spec = spec[key]
        return local_block(mesh, x, spec)
    return _convert(tree, device, block)


def _convert(tree, device, take) -> Dict[str, Any]:
    dev = resolve_device(device)
    top = next((keys for keys in _TOP_KEYS if set(tree) == set(keys)), None)
    if top is None:
        raise ValueError(f"expected keys {sorted(_TOP_KEYS[0])} or "
                         f"{sorted(_TOP_KEYS[1])}, got {sorted(tree)}")

    def tensor(x, *path):
        full = torch.from_numpy(np.asarray(x, dtype=np.float32))
        return take(full, path).to(dev).clone()

    blocks = []
    for i, block in enumerate(tree["blocks"]):
        keys = set(block)
        if keys not in (_BLOCK_KEYS, _BLOCK_KEYS | {"router"}):
            raise ValueError(f"block {i}: unexpected keys {sorted(keys)}")
        blocks.append({name: tensor(x, "blocks", i, name)
                       for name, x in block.items()})
    return {key: blocks if key == "blocks" else tensor(tree[key], key)
            for key in top}
