"""Glue between the streaming data plane and the trainers
(docs/data_pipeline.md §Trainer ingestion).

The trainer's grad functions run on plain numpy (the multislice
contract), while pipelines hand out numpy batches or tensors.
``to_numpy_batch`` normalizes either: a torch tensor comes to the CPU
first (a CUDA tensor cannot become numpy where it lies), and a bf16
one, which has no numpy dtype, stays a CPU bf16 tensor, as
``load_pytree`` gives it back. ``iter_train_batches`` is the one-call
path from a Dataset to a prefetched numpy-batch iterator sized by the
``data_prefetch_batches`` knob.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np


def _to_numpy(leaf: Any) -> Any:
    import sys
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf
    try:
        return np.asarray(leaf)
    except Exception:
        return leaf


def to_numpy_batch(batch: Any) -> Any:
    """Normalize a batch's leaves to numpy arrays (dict batches
    leaf-wise, bare arrays directly). Non-array leaves pass through."""
    if isinstance(batch, dict):
        return {k: _to_numpy(v) for k, v in batch.items()}
    return _to_numpy(batch)


def iter_train_batches(ds, *, batch_size: Optional[int] = 256,
                       prefetch_batches: Optional[int] = None,
                       drop_last: bool = False) -> Iterator[Any]:
    """Numpy batches off a ``ray_tpu_torch.data`` Dataset with prefetch —
    the iterator ``MultiSliceTrainer.run_with_data`` consumes. The
    prefetch depth defaults to the ``data_prefetch_batches`` knob."""
    if prefetch_batches is None:
        from ray_tpu_torch.data.context import DataContext
        prefetch_batches = DataContext.get_current().prefetch_batches
    for batch in ds.iter_batches(batch_size=batch_size,
                                 batch_format="numpy",
                                 drop_last=drop_last,
                                 prefetch_batches=prefetch_batches):
        yield to_numpy_batch(batch)
