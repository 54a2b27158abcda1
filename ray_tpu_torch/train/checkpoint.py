"""Checkpoint: directory abstraction + pytree (de)serialization.

Reference: ``ray.train.Checkpoint`` (directory abstraction uploaded via
pyarrow.fs) [UNVERIFIED — mount empty, SURVEY.md §0]. The port's copy
of ``ray_tpu/train/checkpoint.py``: ``save_pytree``/``load_pytree``
flatten with ``torch.utils._pytree`` (dicts, lists, tuples, None) where
the reference uses ``jax.tree``, write every leaf to CPU numpy as npz
and the structure as a pickled string (``treespec_dumps``), off the
step path. A ``torch.bfloat16`` leaf, which has no numpy dtype, is
stored bit for bit as its 16-bit view and comes back as a CPU bf16
tensor; every other leaf comes back as numpy, as in the reference.

Torch's pytree keeps a dict's insertion order where ``jax.tree`` sorts
its keys, so the leaf files of the two packages are not in the same
order; neither package reads the other's files.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Any, Optional

import numpy as np


class Checkpoint:
    """A directory of files produced by training.

    ``to_directory``/``as_directory`` hand out a COPY in a fresh temp
    dir, never the live stored path: a consumer that mutates (or
    deletes files from) the directory it was given must not corrupt
    the stored checkpoint — it is the only copy recovery restores
    from."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="rtpt_ckpt_")
        if os.path.abspath(path) == self.path:
            raise ValueError(
                "to_directory target is the checkpoint's own storage "
                "directory; materialize into a different path (or pass "
                "None for a fresh temp dir) — mutating the live copy "
                "would corrupt the stored checkpoint")
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    def as_directory(self):
        """Context manager yielding a private materialized copy,
        removed on exit. Mutations inside the ``with`` affect only the
        copy."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            path = self.to_directory()
            try:
                yield path
            finally:
                shutil.rmtree(path, ignore_errors=True)
        return cm()

    def __repr__(self):
        return f"Checkpoint({self.path})"


def _host_leaf(leaf: Any):
    """A leaf as CPU numpy, and whether it was a bf16 tensor (then the
    array is its 16-bit view). Never imports torch."""
    import sys
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), True
        return t.numpy(), False
    return np.asarray(leaf), False


def save_pytree(tree: Any, directory: str, name: str = "state") -> None:
    """Write a pytree of tensors, arrays and scalars: leaves as npz,
    structure pickled. Both files land crash-atomically
    (``_private/durable``): a crash mid-write leaves the previous
    checkpoint intact instead of tearing the only copy."""
    from torch.utils import _pytree as pytree

    from ray_tpu_torch._private import durable
    os.makedirs(directory, exist_ok=True)
    leaves, spec = pytree.tree_flatten(tree)
    arrays, bf16, none = {}, [], []
    for i, leaf in enumerate(leaves):
        if leaf is None:     # a leaf to torch's pytree, a node to jax's
            none.append(i)
            continue
        arrays[f"leaf_{i}"], is_bf16 = _host_leaf(leaf)
        if is_bf16:
            bf16.append(i)
    durable.atomic_savez(os.path.join(directory, f"{name}.npz"), arrays)
    durable.atomic_pickle(
        os.path.join(directory, f"{name}.treedef.pkl"),
        {"treespec": pytree.treespec_dumps(spec), "num_leaves": len(leaves),
         "bfloat16": bf16, "none": none})


def load_pytree(directory: str, name: str = "state") -> Any:
    import torch
    from torch.utils import _pytree as pytree
    with open(os.path.join(directory, f"{name}.treedef.pkl"), "rb") as f:
        structure = pickle.load(f)
    none = set(structure["none"])
    with np.load(os.path.join(directory, f"{name}.npz")) as data:
        leaves = [None if i in none else data[f"leaf_{i}"]
                  for i in range(structure["num_leaves"])]
    for i in structure["bfloat16"]:
        leaves[i] = torch.from_numpy(leaves[i]).view(torch.bfloat16)
    return pytree.tree_unflatten(
        leaves, pytree.treespec_loads(structure["treespec"]))
