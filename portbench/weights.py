"""Weights made from the seed, in the benchmark's hands.

The program under test and the plain reference both take their weights
from here, so neither takes anything the other made. A model's leaves fall
into groups (the outer leaves, then one group a layer); each group is one
``torch.randn`` call on the device from a generator seeded by the run's
seed and the group's index, then cut into leaves and scaled. So any one
group can be made again alone (``group``), which is how the change of the
parameters over the first steps is measured without a second copy of the
whole model.

Every leaf is fp32, in the layout and under the names of
``ray_tpu_torch.models`` (``transformer.init_params``, ``vit.init_vit_params``).
Scales: dense weights 1/sqrt(fan in), the embedding 0.02, norm scales
1 + 0.1 z, the patch bias 0.02 z.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

MASK64 = (1 << 64) - 1


def group_seed(seed: int, group: int) -> int:
    """A 64-bit generator seed for ``group`` of the weights of ``seed``."""
    x = (seed * 0x9E3779B97F4A7C15 + (group + 1) * 0xBF58476D1CE4E5B9) & MASK64
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & MASK64


# A leaf: (name, shape, kind), kind one of "dense:<fan-in axes>", "embed",
# "norm", "bias".
Leaf = Tuple[str, Tuple[int, ...], str]


def _block_leaves(c: Dict) -> List[Leaf]:
    d, n, kv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd, ff = d // n, c["intermediate_size"]
    return [("attn_norm", (d,), "norm"),
            ("wq", (d, n, hd), "dense:0"),
            ("wk", (d, kv, hd), "dense:0"),
            ("wv", (d, kv, hd), "dense:0"),
            ("wo", (n, hd, d), "dense:01"),
            ("mlp_norm", (d,), "norm"),
            ("wi", (d, ff), "dense:0"),
            ("wg", (d, ff), "dense:0"),
            ("wo_mlp", (ff, d), "dense:0")]


def _outer_leaves(c: Dict) -> List[Leaf]:
    d = c["hidden_size"]
    if c["model"] == "decoder":
        return [("embed", (c["vocab_size"], d), "embed"),
                ("final_norm", (d,), "norm"),
                ("unembed", (d, c["vocab_size"]), "dense:0")]
    patch_dim = c["patch_size"] ** 2 * c["num_channels"]
    return [("patch_embed", (patch_dim, d), "dense:0"),
            ("patch_bias", (d,), "bias"),
            ("final_norm", (d,), "norm"),
            ("head", (d, c["num_labels"]), "dense:0")]


def groups(c: Dict) -> List[List[Leaf]]:
    """The leaves of each group: the outer leaves, then each layer's."""
    return [_outer_leaves(c)] + [
        _block_leaves(c) for _ in range(c["num_hidden_layers"])]


def _scaled(z: torch.Tensor, shape, kind: str) -> torch.Tensor:
    if kind == "embed":
        return z.mul_(0.02)
    if kind == "norm":
        return z.mul_(0.1).add_(1.0)
    if kind == "bias":
        return z.mul_(0.02)
    axes = [int(a) for a in kind.split(":")[1]]
    return z.mul_(1.0 / math.sqrt(math.prod(shape[a] for a in axes)))


def group(c: Dict, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """The leaves of group ``index``, each a tensor of its own."""
    leaves = groups(c)[index]
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, index))
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out, offset = {}, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        out[name] = _scaled(flat[offset:offset + n].view(shape).clone(),
                            shape, kind)
        offset += n
    return out


def make(c: Dict, seed: int, device) -> Dict:
    """The whole parameter tree of configuration ``c``: a dict with the
    program's keys and insertion order (``blocks`` a list of dicts)."""
    outer = group(c, seed, 0, device)
    blocks = [group(c, seed, 1 + i, device)
              for i in range(c["num_hidden_layers"])]
    if c["model"] == "decoder":
        return {"embed": outer["embed"], "final_norm": outer["final_norm"],
                "blocks": blocks, "unembed": outer["unembed"]}
    return {"patch_embed": outer["patch_embed"],
            "patch_bias": outer["patch_bias"], "blocks": blocks,
            "final_norm": outer["final_norm"], "head": outer["head"]}


def leaf_names(tree, prefix: str = "") -> List[str]:
    """Names of the leaves of a tree of dicts and lists, in the order the
    program's ``param_leaves`` walks it: insertion order, depth first."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def group_of(name: str) -> int:
    """The group that makes the leaf ``name`` (as ``leaf_names`` gives)."""
    parts = name.split("/")
    return 1 + int(parts[1]) if parts[0] == "blocks" else 0


def n_params(c: Dict) -> int:
    return sum(math.prod(shape) for g in groups(c) for _, shape, _ in g)


@torch.no_grad()
def change_norms(c: Dict, seed: int, params, device) -> List[float]:
    """The norm of each leaf's change from the weights of ``seed``, in
    ``leaf_names`` order; each group of the starting weights is made again
    in turn, so the whole model is never held twice."""
    names, current = leaf_names(params), leaves(params)
    out: List[float] = [0.0] * len(names)
    for g in range(1 + c["num_hidden_layers"]):
        start = group(c, seed, g, device)
        for i, name in enumerate(names):
            if group_of(name) == g:
                out[i] = float((current[i].detach()
                                - start[name.split("/")[-1]]).norm())
        del start
    return out
