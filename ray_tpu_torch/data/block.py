"""Blocks: the unit of data movement. Arrow tables in the object
store, exactly like the reference (``python/ray/data/block.py``,
blocks = Arrow tables in plasma [UNVERIFIED — mount empty,
SURVEY.md §0]). Zero-copy numpy views come out of Arrow columns; a
block travelling through the shm store costs one serialize, readers
mmap it.

The port's copy of ``ray_tpu/data/block.py``. Where the reference's
``np.asarray`` brings a jax array to the host, a user's ``map_batches``
function here may return torch tensors, often on the card: a tensor
column comes to the CPU first (``np.asarray`` of a CUDA tensor raises).
A bfloat16 tensor has no numpy or arrow type; it is refused with
pyarrow's ``ArrowNotImplementedError``, the error the reference raises
for a bfloat16 ``jax.Array`` column. torch is never imported here: a
tensor is recognised only when torch is already loaded.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

Block = pa.Table
BatchFormat = str  # "numpy" | "pandas" | "pyarrow"

_VALUE_COL = "__value__"  # column name for simple (non-dict) rows


def block_from_rows(rows: List[Any]) -> Block:
    """Rows are dicts (columns) or plain values (single __value__ col)."""
    if not rows:
        return pa.table({})
    if isinstance(rows[0], dict):
        cols: Dict[str, List] = {k: [] for k in rows[0]}
        for r in rows:
            for k in cols:
                cols[k].append(r[k])
        return pa.table({k: _to_arrow_array(v) for k, v in cols.items()})
    return pa.table({_VALUE_COL: _to_arrow_array(rows)})


def _torch_tensor(v) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(v, torch.Tensor)


def _host(v):
    """A torch tensor as a numpy array on the host; anything else as is."""
    if not _torch_tensor(v):
        return v
    v = v.detach()
    if v.dtype == sys.modules["torch"].bfloat16:
        raise pa.ArrowNotImplementedError(
            "a bfloat16 tensor has no numpy or arrow type; cast it (for "
            "example to float32) before it goes into a block")
    return v.cpu().numpy()


def _to_arrow_array(values: List[Any]) -> pa.Array:
    values = [_host(v) for v in values]
    if values and isinstance(values[0], np.ndarray):
        # tensor column: fixed-shape -> FixedShapeTensorArray
        arr = np.stack(values)
        return pa.FixedShapeTensorArray.from_numpy_ndarray(arr)
    return pa.array(values)


def block_from_batch(batch: Any) -> Block:
    """A batch (dict of arrays / pandas / arrow / list of rows) -> Block."""
    if isinstance(batch, pa.Table):
        return batch
    if isinstance(batch, dict):
        return pa.table({k: _to_arrow_array(list(v))
                         if isinstance(v, list) else _np_col(v)
                         for k, v in batch.items()})
    try:
        import pandas as pd
        if isinstance(batch, pd.DataFrame):
            return pa.Table.from_pandas(batch, preserve_index=False)
    except ImportError:
        pass
    if isinstance(batch, list):
        return block_from_rows(batch)
    if isinstance(batch, np.ndarray) or _torch_tensor(batch):
        return pa.table({_VALUE_COL: _np_col(batch)})
    raise TypeError(f"cannot convert {type(batch)} to a block")


def _np_col(v) -> pa.Array:
    v = np.asarray(_host(v))
    if v.ndim > 1:
        return pa.FixedShapeTensorArray.from_numpy_ndarray(v)
    return pa.array(v)


def block_to_batch(block: Block, batch_format: BatchFormat = "numpy"):
    if batch_format == "pyarrow":
        return block
    if batch_format == "pandas":
        return block.to_pandas()
    if batch_format != "numpy":
        raise ValueError(
            f"unknown batch_format {batch_format!r}; use 'numpy', "
            "'pyarrow', 'pandas' (tensors: "
            "Dataset.iter_device_batches / iter_torch_batches)")
    out: Dict[str, np.ndarray] = {}
    for name in block.column_names:
        col = block.column(name)
        if isinstance(col.type, pa.FixedShapeTensorType):
            out[name] = col.combine_chunks().to_numpy_ndarray()
        else:
            out[name] = col.to_numpy(zero_copy_only=False)
    return out


def batch_to_rows(block: Block) -> Iterator[Any]:
    simple = block.column_names == [_VALUE_COL]
    for row in block.to_pylist():
        yield row[_VALUE_COL] if simple else row


def block_size_bytes(block: Block) -> int:
    return block.nbytes


def block_num_rows(block: Block) -> int:
    return block.num_rows


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if b.num_rows > 0]
    if not blocks:
        return pa.table({})
    return pa.concat_tables(blocks, promote_options="default")


def slice_block(block: Block, start: int, end: int) -> Block:
    """Rows ``[start, end)`` of ``block``, holding only their own bytes,
    so that the slice may go to the object store. An arrow slice shares
    its parent's buffers and pickles them whole: each of a block's 16
    partitions would store all of the block. A slice whose buffers hold
    little more than its rows (an eighth, or 4 KiB) is not copied."""
    return _compact(block.slice(start, end - start))


def view_block(block: Block, start: int, end: int) -> Block:
    """Rows ``[start, end)`` of ``block`` sharing its buffers: for a
    transient remainder that is sliced again and never stored."""
    return block.slice(start, end - start)


def _compact(block: Block) -> Block:
    extra = block.get_total_buffer_size() - block.nbytes
    if block.num_rows == 0 or extra <= max(4096, block.nbytes // 8):
        return block
    return pa.Table.from_arrays(
        [pa.concat_arrays(col.chunks) for col in block.columns],
        schema=block.schema)
