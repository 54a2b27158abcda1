"""Dataset: lazy logical plan -> streaming execution over tasks.

Reference surface: ``python/ray/data/dataset.py`` + ``read_api.py``
[UNVERIFIED — mount empty, SURVEY.md §0]. Laziness, operator fusion,
streaming execution, and the blocks-in-object-store model match; the
TPU-native extension is ``iter_jax_batches`` handing back device-ready
(optionally sharded) arrays, alongside ``iter_torch_batches``.
"""

from __future__ import annotations

import builtins
import functools
import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as blib
from ray_tpu_torch.data._internal.executor import StreamingExecutor
from ray_tpu_torch.data._internal.plan import (
    AbstractMap,
    AllToAll,
    InputData,
    Limit,
    LogicalOp,
    MapTransform,
    Read,
    Union as UnionOp,
    plan as lower,
)


class Dataset:
    def __init__(self, op: LogicalOp, max_in_flight=None):
        # None -> DataContext.max_in_flight at execution time
        self._op = op
        self._max_in_flight = max_in_flight

    # -- transforms (lazy) -------------------------------------------------

    def _map(self, name: str, transform: MapTransform,
             concurrency=None, num_cpus=None, num_gpus=None) -> "Dataset":
        return Dataset(
            AbstractMap(name, self._op, transform, concurrency=concurrency,
                        num_cpus=num_cpus, num_gpus=num_gpus),
            self._max_in_flight)

    def map(self, fn: Callable, *, concurrency=None, num_cpus=None,
            num_gpus=None, fn_args=(), fn_kwargs=None) -> "Dataset":
        return self._map("Map", MapTransform(
            "rows", fn, tuple(fn_args), fn_kwargs or {}),
            concurrency, num_cpus, num_gpus)

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy", concurrency=None,
                    num_cpus=None, num_gpus=None, fn_args=(),
                    fn_kwargs=None, zero_copy_batch: bool = False
                    ) -> "Dataset":
        return self._map("MapBatches", MapTransform(
            "batches", fn, tuple(fn_args), fn_kwargs or {},
            batch_size=batch_size, batch_format=batch_format,
            zero_copy=zero_copy_batch),
            concurrency, num_cpus, num_gpus)

    def filter(self, fn: Callable) -> "Dataset":
        return self._map("Filter", MapTransform("filter", fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._map("FlatMap", MapTransform("flat", fn))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch
        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            for c in cols:
                batch.pop(c, None)
            return batch
        return self.map_batches(drop)

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda b: {c: b[c] for c in cols})

    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(AllToAll("Repartition", self._op, "repartition",
                                num_partitions=num_blocks),
                       self._max_in_flight)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        return Dataset(AllToAll("RandomShuffle", self._op, "shuffle",
                                num_partitions=num_blocks,
                                seed=seed if seed is not None else 0),
                       self._max_in_flight)

    def sort(self, key: str, *, descending: bool = False,
             num_partitions: Optional[int] = None) -> "Dataset":
        return Dataset(AllToAll("Sort", self._op, "sort", key=key,
                                descending=descending,
                                num_partitions=num_partitions),
                       self._max_in_flight)

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def limit(self, n: int) -> "Dataset":
        return Dataset(Limit(self._op, n), self._max_in_flight)

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(UnionOp(self._op, [o._op for o in others]),
                       self._max_in_flight)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two same-length datasets (reference:
        ``Dataset.zip``; right-side column-name collisions get a
        ``_1`` suffix). Materializes both sides to align rows."""
        import pyarrow as pa
        left = blib.concat_blocks(list(self.iter_blocks()))
        right = blib.concat_blocks(list(other.iter_blocks()))
        if left.num_rows != right.num_rows:
            raise ValueError(
                f"zip needs equal row counts: {left.num_rows} vs "
                f"{right.num_rows}")
        cols: Dict[str, Any] = {n: left.column(n)
                                for n in left.column_names}
        for n in right.column_names:
            # walk the suffix until free — a fixed "_1" would silently
            # overwrite a real left column named f"{n}_1"
            out_name, i = n, 0
            while out_name in cols:
                i += 1
                out_name = f"{n}_{i}"
            cols[out_name] = right.column(n)
        return Dataset(InputData([ray_tpu_torch.put(pa.table(cols))]),
                       self._max_in_flight)

    # -- execution ---------------------------------------------------------

    def _execute(self) -> Iterator[Any]:
        return StreamingExecutor(
            lower(self._op), max_in_flight=self._max_in_flight).run()

    def iter_blocks(self) -> Iterator[blib.Block]:
        for ref in self._execute():
            yield ray_tpu_torch.get(ref)

    def materialize(self) -> "Dataset":
        refs = list(self._execute())
        return Dataset(InputData(refs), self._max_in_flight)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_batches: int = 0) -> Iterator[Any]:
        """Stream batches; blocks are re-chunked to batch_size.

        Consumption is INCREMENTAL: batches come off the streaming
        executor as blocks complete — the first batch arrives while
        later blocks are still being produced, never after a full
        materialization. ``prefetch_batches > 0`` additionally runs
        the pipeline on a background thread with that many batches
        buffered ahead (docs/data_pipeline.md §Prefetch)."""
        if prefetch_batches and prefetch_batches > 0:
            from ray_tpu_torch.data._internal.prefetch import PrefetchIterator
            pf = PrefetchIterator(
                self._iter_batches_local(batch_size, batch_format,
                                         drop_last),
                depth=prefetch_batches)
            try:
                yield from pf
            finally:
                pf.close()
            return
        yield from self._iter_batches_local(batch_size, batch_format,
                                            drop_last)

    def _iter_batches_local(self, batch_size, batch_format,
                            drop_last) -> Iterator[Any]:
        carry: List[blib.Block] = []
        carry_rows = 0
        for blk in self.iter_blocks():
            if blk.num_rows == 0:
                continue
            if batch_size is None:
                yield blib.block_to_batch(blk, batch_format)
                continue
            carry.append(blk)
            carry_rows += blk.num_rows
            while carry_rows >= batch_size:
                merged = blib.concat_blocks(carry)
                out = blib.slice_block(merged, 0, batch_size)
                rest = blib.view_block(merged, batch_size,
                                       merged.num_rows)
                yield blib.block_to_batch(out, batch_format)
                carry = [rest] if rest.num_rows else []
                carry_rows = rest.num_rows
        if carry and not drop_last:
            merged = blib.concat_blocks(carry)
            if merged.num_rows:
                yield blib.block_to_batch(merged, batch_format)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device: Optional[str] = None,
                           drop_last: bool = False,
                           prefetch_batches: Optional[int] = None
                           ) -> Iterator[Any]:
        """numpy batches converted to torch tensors (reference:
        ``Dataset.iter_torch_batches`` feeding TorchTrainer loops).
        ``prefetch_batches`` defaults to the DataContext setting —
        device-feeding loops want execution overlapped with the step."""
        import torch
        if prefetch_batches is None:
            from ray_tpu_torch.data.context import DataContext
            prefetch_batches = DataContext.get_current().prefetch_batches
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last,
                                       prefetch_batches=prefetch_batches):
            out = {}
            for key, arr in batch.items():
                t = torch.as_tensor(arr)
                want = None
                if dtypes is not None:
                    want = (dtypes.get(key) if isinstance(dtypes, dict)
                            else dtypes)
                if want is not None or device is not None:
                    t = t.to(device=device, dtype=want)
                out[key] = t
            yield out

    def iter_device_batches(self, *, batch_size: Optional[int] = 256,
                            device: str = "cuda", sharding=None,
                            drop_last: bool = False,
                            prefetch_batches: Optional[int] = None
                            ) -> Iterator[Any]:
        """numpy batches placed as tensors on ``device`` (the card unless
        the caller passes ``device="cpu"``), or, given the port's
        ``parallel.mesh.NamedSharding``, as DTensors laid out by
        ``mesh.shard`` (every rank passes the whole batch and keeps its
        own block). The counterpart of the reference's
        ``Dataset.iter_jax_batches`` (``jax.numpy.asarray`` or
        ``jax.device_put(v, sharding)``). ``prefetch_batches`` defaults
        to the DataContext setting (``data_prefetch_batches``): the
        pipeline runs ahead of the train step so the trainer never
        starves on block production. Raises ``RuntimeError`` on a
        machine without a card unless ``device="cpu"``, before any
        block is produced."""
        from ray_tpu_torch._private.device import resolve_device
        if sharding is None:
            target = resolve_device(device)
        if prefetch_batches is None:
            from ray_tpu_torch.data.context import DataContext
            prefetch_batches = DataContext.get_current().prefetch_batches
        import torch
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last,
                                       prefetch_batches=prefetch_batches):
            # arrow's buffers are read-only: a tensor must own its bytes
            batch = {k: torch.from_numpy(np.require(v, requirements="W"))
                     for k, v in batch.items()}
            if sharding is None:
                yield {k: v.to(target) for k, v in batch.items()}
            else:
                from ray_tpu_torch.parallel.mesh import shard
                yield {k: shard(sharding.mesh, v, sharding.spec)
                       for k, v in batch.items()}

    def iter_rows(self) -> Iterator[Any]:
        for blk in self.iter_blocks():
            yield from blib.batch_to_rows(blk)

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_batch(self, batch_size: int = 20, *,
                   batch_format: str = "numpy"):
        """First ``batch_size`` rows as one batch (reference:
        ``Dataset.take_batch`` — like it, raises on an empty
        dataset rather than returning a keyless dict)."""
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format):
            return batch
        raise ValueError("dataset is empty")

    def unique(self, col: str) -> List[Any]:
        """Distinct values of a column (reference: ``Dataset.unique``;
        returned sorted for determinism)."""
        out: set = set()
        for blk in self.iter_blocks():
            if not blk.num_rows:
                continue            # filtered-empty blocks are schema-less
            out.update(blk.column(col).to_pylist())
        try:
            return sorted(out)
        except TypeError:               # mixed un-orderable types
            return list(out)

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(blk.num_rows for blk in self.iter_blocks())

    def schema(self):
        for blk in self.iter_blocks():
            if blk.num_rows or blk.column_names:
                return blk.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    def sum(self, col: str) -> float:
        return float(sum(
            np.sum(blib.block_to_batch(b)[col]) for b in self.iter_blocks()
            if b.num_rows))

    def min(self, col: str):
        vals = [np.min(blib.block_to_batch(b)[col])
                for b in self.iter_blocks() if b.num_rows]
        return min(vals) if vals else None

    def max(self, col: str):
        vals = [np.max(blib.block_to_batch(b)[col])
                for b in self.iter_blocks() if b.num_rows]
        return max(vals) if vals else None

    def std(self, col: str, ddof: int = 1) -> float:
        """Sample standard deviation of a numeric column (reference:
        ``Dataset.std``), streamed block-by-block. Accumulates around
        a shift (the first value) — the naive sum-of-squares formula
        catastrophically cancels when the mean dwarfs the spread."""
        import math
        n = 0
        s = 0.0
        ss = 0.0
        shift = None
        for blk in self.iter_blocks():
            if not blk.num_rows:
                continue
            v = np.asarray(blib.block_to_batch(blk)[col], dtype=float)
            if shift is None:
                shift = float(v[0])
            d = v - shift
            n += d.size
            s += float(d.sum())
            ss += float((d * d).sum())
        if n - ddof <= 0:
            return float("nan")
        return math.sqrt(max((ss - s * s / n) / (n - ddof), 0.0))

    def mean(self, col: str):
        tot, n = 0.0, 0
        for b in self.iter_blocks():
            if b.num_rows:
                v = blib.block_to_batch(b)[col]
                tot += float(np.sum(v))
                n += len(v)
        return tot / n if n else None

    # -- splits ------------------------------------------------------------

    def split(self, n: int) -> List["Dataset"]:
        """Materializing equal split into n datasets (reference:
        Dataset.split)."""
        refs = list(self._execute())
        blocks = [ray_tpu_torch.get(r) for r in refs]
        merged = blib.concat_blocks(blocks)
        rows = merged.num_rows
        per = rows // n
        out = []
        for i in builtins.range(n):
            start = i * per
            end = rows if i == n - 1 else (i + 1) * per
            out.append(Dataset(InputData(
                [ray_tpu_torch.put(blib.slice_block(merged, start, end))]),
                self._max_in_flight))
        return out

    def streaming_split(self, n: int, *, equal: bool = True
                        ) -> List["DataIterator"]:
        """n iterators fed round-robin from one streaming execution —
        per-train-worker ingest (reference: streaming_split)."""
        import queue
        import threading

        queues = [queue.Queue(maxsize=4) for _ in builtins.range(n)]

        def driver():
            try:
                for i, ref in enumerate(self._execute()):
                    queues[i % n].put(("blk", ref))
            except BaseException as e:  # propagate to consumers
                for q in queues:
                    q.put(("err", e))
                return
            for q in queues:
                q.put(("end", None))

        t = threading.Thread(target=driver, daemon=True,
                             name="rtpu-data-split")
        t.start()
        return [DataIterator(q) for q in queues]

    # -- writes ------------------------------------------------------------

    def write_parquet(self, path: str) -> None:
        import os
        os.makedirs(path, exist_ok=True)
        import pyarrow.parquet as pq
        for i, blk in enumerate(self.iter_blocks()):
            if blk.num_rows:
                pq.write_table(blk, os.path.join(path,
                                                 f"part-{i:05d}.parquet"))

    def write_csv(self, path: str) -> None:
        import os
        os.makedirs(path, exist_ok=True)
        import pyarrow.csv as pcsv
        for i, blk in enumerate(self.iter_blocks()):
            if blk.num_rows:
                pcsv.write_csv(blk, os.path.join(path,
                                                 f"part-{i:05d}.csv"))

    def write_json(self, path: str) -> None:
        import json
        import os
        os.makedirs(path, exist_ok=True)
        for i, blk in enumerate(self.iter_blocks()):
            if blk.num_rows:
                with open(os.path.join(path, f"part-{i:05d}.json"),
                          "w") as f:
                    for row in blk.to_pylist():
                        f.write(json.dumps(row) + "\n")

    def __repr__(self):
        return f"Dataset(plan={'->'.join(o.name for o in self._op.chain())})"


class DataIterator:
    """One consumer's stream out of streaming_split."""

    def __init__(self, q):
        self._q = q

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy"):
        carry: List[blib.Block] = []
        carry_rows = 0
        while True:
            kind, val = self._q.get()
            if kind == "err":
                raise val
            if kind == "end":
                break
            blk = ray_tpu_torch.get(val)
            if blk.num_rows == 0:
                continue
            if batch_size is None:
                yield blib.block_to_batch(blk, batch_format)
                continue
            carry.append(blk)
            carry_rows += blk.num_rows
            while carry_rows >= batch_size:
                merged = blib.concat_blocks(carry)
                out = blib.slice_block(merged, 0, batch_size)
                rest = blib.view_block(merged, batch_size,
                                       merged.num_rows)
                yield blib.block_to_batch(out, batch_format)
                carry = [rest] if rest.num_rows else []
                carry_rows = rest.num_rows
        if carry:
            merged = blib.concat_blocks(carry)
            if merged.num_rows:
                yield blib.block_to_batch(merged, batch_format)


class GroupedData:
    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, aggs: List) -> Dataset:
        return Dataset(AllToAll("GroupBy", self._ds._op, "groupby",
                                key=self._key, aggs=aggs),
                       self._ds._max_in_flight)

    def count(self) -> Dataset:
        return self._agg([(self._key, "count", "count()")])

    def sum(self, col: str) -> Dataset:
        return self._agg([(col, "sum", f"sum({col})")])

    def mean(self, col: str) -> Dataset:
        return self._agg([(col, "mean", f"mean({col})")])

    def min(self, col: str) -> Dataset:
        return self._agg([(col, "min", f"min({col})")])

    def max(self, col: str) -> Dataset:
        return self._agg([(col, "max", f"max({col})")])

    def map_groups(self, fn: Callable) -> Dataset:
        """Apply ``fn`` once per group (reference:
        ``GroupedData.map_groups``): rows are partitioned by key via
        the two-level shuffle, then each group arrives at ``fn`` as a
        numpy batch; ``fn`` returns a batch."""
        return Dataset(AllToAll("MapGroups", self._ds._op, "groupby",
                                key=self._key, group_fn=fn),
                       self._ds._max_in_flight)


# --------------------------------------------------------------------------
# read API
# --------------------------------------------------------------------------

def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    n = max(1, min(parallelism, len(items) or 1))
    chunk = (len(items) + n - 1) // n if items else 1
    refs = []
    for i in builtins.range(0, len(items), chunk):
        refs.append(ray_tpu_torch.put(
            blib.block_from_rows(items[i:i + chunk])))
    if not refs:
        refs = [ray_tpu_torch.put(blib.block_from_rows([]))]
    return Dataset(InputData(refs))


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    per = (n + parallelism - 1) // max(parallelism, 1)
    tasks = []
    for start in itertools.count(0, per):
        if start >= n:
            break
        end = min(start + per, n)
        tasks.append(functools.partial(
            lambda s, e: {"id": np.arange(s, e)}, start, end))
    if not tasks:
        tasks = [lambda: {"id": np.arange(0)}]
    return Dataset(Read(tasks, name=f"ReadRange[{n}]"))


def from_numpy(arr: np.ndarray, *, parallelism: int = 8) -> Dataset:
    chunks = np.array_split(arr, max(1, parallelism))
    refs = [ray_tpu_torch.put(blib.block_from_batch({"data": c}))
            for c in chunks if len(c)]
    return Dataset(InputData(refs))


def from_pandas(df) -> Dataset:
    import pyarrow as pa
    return Dataset(InputData(
        [ray_tpu_torch.put(pa.Table.from_pandas(df, preserve_index=False))]))


def from_arrow(table) -> Dataset:
    return Dataset(InputData([ray_tpu_torch.put(table)]))


def _expand_paths(paths: Union[str, List[str]], suffix: str) -> List[str]:
    import glob
    import os
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, f"*{suffix}"))))
        else:
            out.extend(sorted(glob.glob(p)) or [p])
    return out


def read_parquet(paths: Union[str, List[str]], *,
                 columns: Optional[List[str]] = None) -> Dataset:
    files = _expand_paths(paths, ".parquet")

    def make(f):
        def read():
            import pyarrow.parquet as pq
            return pq.read_table(f, columns=columns)
        return read

    return Dataset(Read([make(f) for f in files], name="ReadParquet"))


def read_csv(paths: Union[str, List[str]]) -> Dataset:
    files = _expand_paths(paths, ".csv")

    def make(f):
        def read():
            import pyarrow.csv as pcsv
            return pcsv.read_csv(f)
        return read

    return Dataset(Read([make(f) for f in files], name="ReadCSV"))


def read_json(paths: Union[str, List[str]]) -> Dataset:
    files = _expand_paths(paths, ".json")

    def make(f):
        def read():
            import pyarrow.json as pjson
            return pjson.read_json(f)
        return read

    return Dataset(Read([make(f) for f in files], name="ReadJSON"))
