"""Streaming executor: pull-based pipelined execution of a physical
plan over the core task/actor API.

Reference: ``python/ray/data/_internal/execution/streaming_executor.py``
+ ``operators/{task_pool_map_operator,actor_pool_map_operator}.py`` +
``backpressure_policy/`` [UNVERIFIED — mount empty, SURVEY.md §0].

Key properties preserved:
- blocks stream between stages with NO barrier between map stages —
  block k can be in stage 3 while block k+1 is in stage 1;
- per-stage in-flight caps (concurrency backpressure) bound memory;
- all-to-all stages (repartition/shuffle/sort/groupby) are the only
  barriers, implemented as two-phase split/reduce task fan-out through
  the object store (num_returns=N split tasks, one reduce per
  partition);
- everything is tasks/actors on the public core API — the
  libraries-on-core invariant (SURVEY.md §1).

The port's copy of ``ray_tpu/data/_internal/executor.py``. A stage that
asks for ``num_gpus`` runs its tasks and its actor pool on threads of
the driver, which owns the cards (the port's runtime places every
GPU-demand task and actor there): a pool's user class is built once, in
the driver's process, with the card; its blocks still stream back as
the method's streamed returns. A block that goes to the store as a
slice of a larger one (a split output, a shuffle partition, a limit's
head) holds only its own rows (``block.slice_block``): a pickled arrow
slice carries its parent's whole buffers, which made a 64 MB
repartition into 16 blocks store and spill ~16 times its bytes. Reads
hand their blocks to the first stage in the order they were launched,
where the reference hands them over as they finish: a stage gives its
outputs downstream in the order of its inputs, so a block that a later
read made first stood at the head and a consumer waiting for the first
read's rows stalled behind it.
"""

from __future__ import annotations

import logging
import math
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorError,
    BackpressureError,
    ObjectLostError,
    WorkerCrashedError,
)
from ray_tpu_torch._private import data_stats
from ray_tpu_torch.data._internal.plan import (
    AllToAllStage,
    LimitStage,
    MapStage,
    MapTransform,
    PhysicalPlan,
)
from ray_tpu_torch.data import block as blib

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Remote kernels (plain functions on the core API)
# --------------------------------------------------------------------------

def _apply_transform(t: MapTransform, blk):
    if t.kind == "batches":
        out_parts = []
        n = blk.num_rows
        bs = t.batch_size or n or 1
        for start in range(0, max(n, 1), bs):
            piece = blib.slice_block(blk, start, min(start + bs, n)) \
                if n else blk
            batch = blib.block_to_batch(piece, t.batch_format)
            res = t.fn(batch, *t.fn_args, **t.fn_kwargs)
            out_parts.append(blib.block_from_batch(res))
            if n == 0:
                break
        return blib.concat_blocks(out_parts)
    rows_out: List[Any] = []
    for row in blib.batch_to_rows(blk):
        if t.kind == "rows":
            rows_out.append(t.fn(row, *t.fn_args, **t.fn_kwargs))
        elif t.kind == "filter":
            if t.fn(row, *t.fn_args, **t.fn_kwargs):
                rows_out.append(row)
        elif t.kind == "flat":
            rows_out.extend(t.fn(row, *t.fn_args, **t.fn_kwargs))
        else:
            raise ValueError(t.kind)
    return blib.block_from_rows(rows_out)


def _split_oversized(blk, target_bytes: int):
    """Dynamic block splitting (reference: target_max_block_size
    handling in the map-task output path): a map output larger than the
    target yields as multiple row-sliced blocks, so no single object
    outgrows the target and downstream stages parallelize over the
    pieces."""
    nb = blib.block_size_bytes(blk)
    rows = blk.num_rows
    if target_bytes <= 0 or nb <= target_bytes or rows <= 1:
        yield blk
        return
    pieces = min(rows, -(-nb // target_bytes))
    per = -(-rows // pieces)
    for start in range(0, rows, per):
        yield blib.slice_block(blk, start, min(start + per, rows))


@ray_tpu_torch.remote
def _map_chain_task(transforms: List[MapTransform], target_bytes: int,
                    stage_name: str, blk):
    """Streaming map task: yields one block normally, several when the
    output exceeds ``target_bytes``."""
    from ray_tpu_torch._private import chaos
    chaos.fire("data", "map", stage_name)
    for t in transforms:
        blk = _apply_transform(t, blk)
    yield from _split_oversized(blk, target_bytes)


@ray_tpu_torch.remote
def _read_task(fn):
    return blib.block_from_batch(fn())


@ray_tpu_torch.remote
class _MapWorker:
    """Actor-pool worker: instantiates the user's callable class once,
    reuses it per block (reference: ActorPoolMapOperator)."""

    def __init__(self, transforms: List[MapTransform],
                 stage_name: str = ""):
        self._stage_name = stage_name
        self._transforms = []
        for t in transforms:
            fn = t.fn
            import inspect
            if inspect.isclass(fn):
                fn = fn(*t.fn_args, **t.fn_kwargs)
                t = MapTransform(t.kind, fn, (), {}, t.batch_size,
                                 t.batch_format)
            self._transforms.append(t)

    def apply(self, target_bytes: int, blk):
        from ray_tpu_torch._private import chaos
        chaos.fire("data", "map", self._stage_name)
        for t in self._transforms:
            blk = _apply_transform(t, blk)
        yield from _split_oversized(blk, target_bytes)


# -- all-to-all kernels ----------------------------------------------------

def _split_fn_factory(kind: str, n: int, kwargs: Dict):
    key = kwargs.get("key")
    boundaries = kwargs.get("boundaries")
    seed = kwargs.get("seed")

    def split(blk):
        import pyarrow as pa
        import pyarrow.compute as pc
        rows = blk.num_rows
        if rows == 0:
            return [blk] * n if n > 1 else blk
        if kind == "repartition":
            idx = np.arange(rows) * n // max(rows, 1)
        elif kind == "shuffle":
            rng = np.random.RandomState(seed)
            idx = rng.randint(0, n, rows)
        elif kind == "sort":
            col = blk.column(key).to_numpy(zero_copy_only=False)
            idx = np.searchsorted(boundaries, col, side="right")
        elif kind == "groupby":
            # Process-stable partitioning: split tasks run in separate
            # worker processes with independent PYTHONHASHSEEDs, so
            # Python's hash() would scatter equal str/bytes keys across
            # partitions. crc32 over a canonical encoding is stable.
            import zlib
            col = blk.column(key).to_numpy(zero_copy_only=False)
            idx = np.asarray([
                zlib.crc32(x if isinstance(x, bytes)
                           else str(x).encode()) % n
                for x in col.tolist()])
        else:
            raise ValueError(kind)
        order = np.argsort(idx, kind="stable")
        sorted_blk = blk.take(pa.array(order))
        counts = np.bincount(idx, minlength=n)
        parts, start = [], 0
        for c in counts:
            parts.append(blib.slice_block(sorted_blk, start, start + int(c)))
            start += int(c)
        return parts if n > 1 else parts[0]

    return split


def _reduce_fn_factory(kind: str, kwargs: Dict):
    key = kwargs.get("key")
    descending = kwargs.get("descending", False)
    aggs = kwargs.get("aggs")
    seed = kwargs.get("seed")

    group_fn = kwargs.get("group_fn")

    def reduce(*parts):
        import pyarrow as pa
        blk = blib.concat_blocks(list(parts))
        if kind == "sort":
            if blk.num_rows:
                blk = blk.sort_by([(key, "descending" if descending
                                    else "ascending")])
        elif kind == "shuffle":
            if blk.num_rows:
                rng = np.random.RandomState(seed)
                blk = blk.take(pa.array(rng.permutation(blk.num_rows)))
        elif kind == "groupby":
            if group_fn is not None:
                blk = _apply_group_fn(blk, key, group_fn)
            else:
                blk = _aggregate_block(blk, key, aggs)
        return blk

    return reduce


def _apply_group_fn(blk, key: str, fn):
    """map_groups reduce: this partition holds every row of each of
    its key values (crc32 partitioning), so grouping is local — sort
    by key, slice runs, apply ``fn`` per group as a numpy batch."""
    if blk.num_rows == 0:
        return blk
    blk = blk.sort_by([(key, "ascending")])
    col = np.asarray(blk.column(key).to_pylist(), dtype=object)
    boundaries = np.flatnonzero(col[1:] != col[:-1]) + 1
    starts = [0, *boundaries.tolist()]
    ends = [*boundaries.tolist(), len(col)]
    out = []
    for s, e in zip(starts, ends):
        batch = blib.block_to_batch(blib.slice_block(blk, s, e))
        out.append(blib.block_from_batch(fn(batch)))
    return blib.concat_blocks(out)


def _aggregate_block(blk, key: str, aggs: List):
    """aggs: [(col, op, out_name)] with op in count/sum/mean/min/max."""
    import pyarrow as pa
    if blk.num_rows == 0:
        return blk
    arrow_aggs = []
    for col, op, _out in aggs:
        arrow_aggs.append((col if col else key,
                           {"count": "count", "sum": "sum", "mean": "mean",
                            "min": "min", "max": "max"}[op]))
    return pa.TableGroupBy(blk, key).aggregate(arrow_aggs)


@ray_tpu_torch.remote
def _sample_task(blk, key: str, k: int):
    rows = blk.num_rows
    if rows == 0:
        return np.asarray([])
    col = blk.column(key).to_numpy(zero_copy_only=False)
    rng = np.random.RandomState(0)
    return col[rng.randint(0, rows, min(k, rows))]


# --------------------------------------------------------------------------
# Streaming loop
# --------------------------------------------------------------------------

def _ref_entry(ref):
    """The owner-directory entry of a resolved driver-owned block ref
    (None when unknown/unresolved) — the locality and size signals the
    budgets and the block router run on. No block fetch involved."""
    from ray_tpu_torch._private.worker import try_global_worker
    w = try_global_worker()
    if w is None or not hasattr(w, "memory_store"):
        return None
    try:
        return w.memory_store.get(ref.id(), timeout=0)
    except TimeoutError:
        return None


def _ref_nbytes(ref) -> int:
    """Stored size of a resolved driver-owned block ref (0 when
    unknown): the byte signal the backpressure budgets run on — block
    sizes are known at ref-resolution time from the owner's directory,
    no block fetch involved."""
    entry = _ref_entry(ref)
    if entry is None:
        return 0
    try:
        if entry.kind in ("shm", "remote"):
            return int(entry.data[1])
        if entry.kind == "blob":
            return len(entry.data)
    except Exception:
        pass    # freed/odd-shaped entry: size is advisory
    return 0


def _ref_node(ref):
    """NodeID holding the block's bytes, or None when the block is
    driver-local (shm/inline — equally cheap from any local raylet) or
    unresolved. The locality router prefers dispatching to an actor on
    this node so the bytes never cross the interconnect."""
    entry = _ref_entry(ref)
    if entry is not None and entry.kind == "remote":
        try:
            return entry.data[0]
        except Exception:
            return None
    return None


def _ref_zero_copy(ref) -> bool:
    """True when the stored block rides the shm mmap path (PR-7): a
    consumer on the holding host maps the bytes instead of copying
    them. Inline blobs (small blocks) re-pickle per consumer."""
    entry = _ref_entry(ref)
    return entry is not None and entry.kind in ("shm", "remote")


# Typed system-fault taxonomy the block re-drive loop treats as
# retryable: the map worker (or the node holding its output) died
# before the stream committed. Deterministic user-code errors
# (TaskError and friends) surface immediately — burning the retry
# budget on them would just repeat the traceback. ConnectionError
# covers a severed transfer surfacing through a raw socket.
_RETRYABLE_BLOCK_ERRORS = (ActorError, WorkerCrashedError,
                           ObjectLostError, ConnectionError)


class _MapRuntime:
    def __init__(self, stage: MapStage, max_in_flight: int,
                 target_block_bytes: int, max_block_retries: int = 3):
        self.stage = stage
        self.target_block_bytes = target_block_bytes
        self.max_block_retries = max_block_retries
        # (ref, seq, nbytes) triples; fed only while the upstream
        # budget check passes — queued_bytes() is fenced under the
        # per-stage byte budget by launch gating, the real bound here
        # unbounded-ok: launch-gated under the per-stage byte budget
        self.inputs: deque = deque()
        self.in_flight: Dict[Any, int] = {}       # done-marker ref -> seq
        self._gen_task: Dict[int, Any] = {}       # seq -> stream TaskID
        # done ref -> (input ref, seq, nbytes): retained until the
        # stream commits so a dead worker's block can be re-driven
        self._inflight_input: Dict[Any, Tuple] = {}
        self._retries: Dict[int, int] = {}        # seq -> re-drives used
        self.ready: Dict[int, List] = {}          # seq -> [refs] in order
        self._ready_nbytes: Dict[int, int] = {}   # seq -> output bytes
        self.next_in_seq = 0
        self.next_out_seq = 0
        self.input_done = False
        self.max_in_flight = max_in_flight
        self.num_reconstructions = 0
        self.last_backpressure: Optional[BackpressureError] = None
        self.actors: List = []
        self.actor_busy: Dict[int, int] = {}      # actor idx -> in-flight
        self._actor_nodes: Dict[int, Any] = {}    # actor idx -> NodeID
        self._ref_actor: Dict[Any, int] = {}

    def add_input(self, ref, seq: int) -> None:
        self.inputs.append((ref, seq, _ref_nbytes(ref)))

    def queued_bytes(self) -> int:
        """Bytes parked at this stage (queued inputs + inputs of
        running tasks): the signal upstream gates on."""
        return (sum(nb for _r, _s, nb in self.inputs)
                + sum(nb for _r, _s, nb in self._inflight_input.values()))

    def ready_bytes(self) -> int:
        """Bytes of completed outputs not yet handed downstream — the
        terminal stage gates its own launches on this (consumer-paced
        byte backpressure). Sizes are cached at completion (immutable
        once stored), so the budget check is O(ready), not O(ready)
        store lookups."""
        return sum(self._ready_nbytes.values())

    def _spread_strategies(self) -> List:
        """One soft NodeAffinity per alive node, round-robin — pool
        actors land where blocks may live instead of piling onto the
        head raylet. Soft: a full node falls back to any placement."""
        from ray_tpu_torch._private.worker import try_global_worker
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        w = try_global_worker()
        if w is None:
            return []
        try:
            alive = [i.node_id for i in w.gcs.get_all_node_info()
                     if i.alive]
        except Exception:
            return []
        if len(alive) <= 1:
            return []
        return [NodeAffinitySchedulingStrategy(nid.hex(), soft=True)
                for nid in alive]

    def ensure_actors(self):
        if self.stage.uses_actors and not self.actors:
            n = self.stage.concurrency or 2
            spread = self._spread_strategies()
            self.actors = [
                self._spawn_actor(spread[i % len(spread)]
                                  if spread else None)
                for i in range(n)]
            self.actor_busy = {i: 0 for i in range(len(self.actors))}

    def _spawn_actor(self, strategy=None):
        opts = dict(self.stage.resources)
        kw = {}
        if "CPU" in opts:
            kw["num_cpus"] = opts["CPU"]
        if "GPU" in opts:
            kw["num_gpus"] = opts["GPU"]
        if strategy is not None:
            kw["scheduling_strategy"] = strategy
        # the pool restarts a chaos-killed worker in place (fresh
        # process, same handle — queued calls flush once it is back);
        # the per-block retry budget bounds the re-drive loop on top
        return _MapWorker.options(max_restarts=4, **kw).remote(
            self.stage.transforms, self.stage.name)

    def _actor_node(self, idx):
        """NodeID hosting pool actor ``idx`` (cached once placed)."""
        node = self._actor_nodes.get(idx)
        if node is None:
            from ray_tpu_torch._private.worker import try_global_worker
            w = try_global_worker()
            if w is not None:
                try:
                    node = w.node_group.actor_node(
                        self.actors[idx]._actor_id)
                except Exception:
                    node = None
                if node is not None:
                    self._actor_nodes[idx] = node
        return node

    def _pick_actor(self, blk_ref) -> int:
        """Locality-aware routing: among the pool, prefer the
        least-busy actor CO-LOCATED with the block's bytes; fall back
        to global least-busy. Only counts as a locality decision when
        the block actually lives on some node (remote entries)."""
        best = min(self.actor_busy, key=self.actor_busy.get)
        node = _ref_node(blk_ref)
        if node is None:
            return best
        local = [i for i in self.actor_busy
                 if self._actor_node(i) == node]
        if local:
            cand = min(local, key=self.actor_busy.get)
            # don't pile onto a local-but-saturated worker when an
            # idle remote one exists: locality saves one block copy,
            # a stalled pool slot costs a whole block's compute
            if self.actor_busy[cand] <= self.actor_busy[best] + 2:
                data_stats.incr("locality_hits")
                return cand
        data_stats.incr("locality_misses")
        return best

    def launch(self, budget_check=None):
        """Start tasks while the count cap AND the downstream byte
        budget allow. ``budget_check`` raises a typed
        :class:`BackpressureError` (PR-3 overload taxonomy) when the
        downstream stage's queued bytes exceed its budget — the signal
        is recorded (observable via ``last_backpressure`` and the
        ``backpressure_events`` counter) and upstream launching stops
        until the downstream drains."""
        self.ensure_actors()
        while self.inputs and len(self.in_flight) < self.max_in_flight:
            if budget_check is not None:
                try:
                    budget_check()
                except BackpressureError as e:
                    self.last_backpressure = e
                    data_stats.incr("backpressure_events")
                    return
            blk_ref, seq, nbytes = self.inputs.popleft()
            if self.stage.uses_actors:
                idx = self._pick_actor(blk_ref)
                try:
                    gen = self.actors[idx].apply.options(
                        num_returns="streaming").remote(
                            self.target_block_bytes, blk_ref)
                except ActorDiedError:
                    # restart budget exhausted: replace the pool slot
                    # with a fresh worker and re-dispatch there
                    self.actors[idx] = self._spawn_actor()
                    self._actor_nodes.pop(idx, None)
                    gen = self.actors[idx].apply.options(
                        num_returns="streaming").remote(
                            self.target_block_bytes, blk_ref)
                self.actor_busy[idx] += 1
                self._ref_actor[gen.completed()] = idx
            else:
                kw = {}
                res = self.stage.resources
                if "CPU" in res:
                    kw["num_cpus"] = res["CPU"]
                if "GPU" in res:
                    kw["num_gpus"] = res["GPU"]
                node = _ref_node(blk_ref)
                if node is not None:
                    from ray_tpu_torch.util.scheduling_strategies import (
                        NodeAffinitySchedulingStrategy)
                    kw["scheduling_strategy"] = \
                        NodeAffinitySchedulingStrategy(node.hex(),
                                                       soft=True)
                gen = _map_chain_task.options(
                    num_returns="streaming", **kw).remote(
                        self.stage.transforms, self.target_block_bytes,
                        self.stage.name, blk_ref)
            done_ref = gen.completed()
            self.in_flight[done_ref] = seq
            self._gen_task[seq] = done_ref.id().task_id()
            self._inflight_input[done_ref] = (blk_ref, seq, nbytes)

    def complete(self, ref):
        """A map task's stream finished: expand its item refs (split
        outputs land as separate driver-owned blocks, indices 2..).

        Fault-tolerant blocks: item refs are expanded ONLY after the
        stream's commit marker resolves cleanly, and the input ref is
        retained until then — so a worker death mid-block re-drives
        the WHOLE block from its input (exactly-once at block
        granularity: the aborted attempt's partial outputs are never
        handed downstream, the re-driven attempt's outputs are handed
        exactly once, in the original seq order)."""
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_ref import ObjectRef
        seq = self.in_flight.pop(ref)
        blk_ref, _seq, nbytes = self._inflight_input.pop(ref)
        idx = self._ref_actor.pop(ref, None)
        if idx is not None:
            self.actor_busy[idx] -= 1
        task_id = self._gen_task.pop(seq)
        try:
            count = ray_tpu_torch.get(ref)  # raises the task's error, if any
        except _RETRYABLE_BLOCK_ERRORS as e:
            self._requeue(blk_ref, seq, nbytes, e)
            return
        refs = [ObjectRef(ObjectID.from_index(task_id, i + 2))
                for i in range(count)]
        self.ready[seq] = refs
        self._ready_nbytes[seq] = sum(_ref_nbytes(r) for r in refs)
        self._retries.pop(seq, None)
        data_stats.incr("blocks_produced", len(refs))
        data_stats.incr("bytes_produced", self._ready_nbytes[seq])
        zc = sum(1 for r in refs if _ref_zero_copy(r))
        if zc:
            data_stats.incr("zero_copy_blocks", zc)

    def _requeue(self, blk_ref, seq: int, nbytes: int,
                 err: BaseException) -> None:
        """Data-plane lineage: put the dead attempt's INPUT back at the
        head of the queue (seq order preserved — downstream ordering
        never observes the fault). The input ref itself may need core
        lineage reconstruction too (its bytes died with the worker);
        that path is the arg-localization retry, not ours."""
        used = self._retries.get(seq, 0)
        if used >= self.max_block_retries:
            raise err
        self._retries[seq] = used + 1
        self.num_reconstructions += 1
        data_stats.incr("blocks_reconstructed")
        logger.warning(
            "data stage %s: block seq=%d re-driven after %r "
            "(attempt %d/%d)", self.stage.name, seq, err, used + 1,
            self.max_block_retries)
        self.inputs.appendleft((blk_ref, seq, nbytes))

    def pop_ready_in_order(self):
        out = []
        while self.next_out_seq in self.ready:
            out.extend(self.ready.pop(self.next_out_seq))
            self._ready_nbytes.pop(self.next_out_seq, None)
            self.next_out_seq += 1
        return out

    @property
    def done(self):
        return (self.input_done and not self.inputs
                and not self.in_flight and not self.ready)

    def shutdown(self):
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass    # actor already dead
        self.actors = []


class StreamingExecutor:
    """Drives a PhysicalPlan; iterate over output block refs.

    Backpressure is BYTE-aware (reference: reservation-based
    backpressure policies + target_max_block_size): each stage's
    launches are gated on the DOWNSTREAM stage's queued bytes staying
    under a per-stage budget (derived from the object-store capacity
    unless pinned via DataContext), reads are gated on the first
    stage's queue, and map outputs above ``target_max_block_size``
    split into multiple blocks inside the producing task.
    """

    def __init__(self, plan: PhysicalPlan, *, max_in_flight=None,
                 name: str = "dataset"):
        from ray_tpu_torch.data.context import DataContext
        ctx = DataContext.get_current()
        self._plan = plan
        self._max_in_flight = max_in_flight or ctx.max_in_flight
        self._target_block_bytes = ctx.target_max_block_size
        self._budget_override = ctx.per_stage_memory_budget
        self._max_block_retries = ctx.max_block_retries
        self._name = name
        # live per-stage runtimes of the currently running segment —
        # what the ray_tpu_data_queued_bytes{stage} gauge reads; empty
        # between segments and after completion, so the series return
        # to baseline when the pipeline finishes
        self._live: List[Tuple[str, _MapRuntime]] = []
        self.num_reconstructions = 0
        data_stats.register_executor(self)

    def queued_bytes_by_stage(self) -> Dict[str, int]:
        """Per-stage parked bytes (queued + in-flight inputs, plus
        completed-unconsumed outputs) of the live segment."""
        return {label: rt.queued_bytes() + rt.ready_bytes()
                for label, rt in list(self._live)}

    def _per_stage_budget(self, n_stages: int) -> int:
        if self._budget_override:
            return self._budget_override
        from ray_tpu_torch._private.config import get_config
        store = get_config().object_store_memory_bytes
        # a quarter of the store shared across stages, floor 8 MiB —
        # the rest is headroom for outputs, consumers, and other users
        return max(8 * 1024 * 1024, int(0.25 * store) // max(1, n_stages))

    def output_refs(self) -> Iterator[Any]:
        plan = self._plan
        # Materialize source refs for this run: launch read tasks
        # incrementally; extra (union) sources are chained after. Both
        # deques hold the plan's fixed source/read lists — sized at
        # plan construction, only drained during streaming.
        source: deque = deque()  # unbounded-ok: plan-sized, drain-only
        pending_reads: deque = deque(
            plan.read_tasks)     # unbounded-ok: plan-sized, drain-only
        source.extend(plan.source_refs)
        for extra in plan.extra_sources:
            if extra.stages:
                for ref in StreamingExecutor(
                        extra, max_in_flight=self._max_in_flight).run():
                    source.append(ref)
            else:
                source.extend(extra.source_refs)
                pending_reads.extend(extra.read_tasks)

        # barrier-free by construction (run() segments at barriers)
        yield from self._run_segment(source, pending_reads, plan.stages)

    # -- segment runner ----------------------------------------------------

    def _run_segment(self, source: deque, pending_reads: deque,
                     stages: List) -> Iterator[Any]:
        assert not any(isinstance(st, AllToAllStage) for st in stages), \
            "barriers are segmented out by run()"
        map_stages = stages

        runtimes: List[_MapRuntime] = []
        limit_remaining: Dict[int, int] = {}
        pipeline: List = []
        for st in map_stages:
            if isinstance(st, MapStage):
                rt = _MapRuntime(st, self._max_in_flight,
                                 self._target_block_bytes,
                                 self._max_block_retries)
                runtimes.append(rt)
                pipeline.append(rt)
            elif isinstance(st, LimitStage):
                limit_remaining[id(st)] = st.n
                pipeline.append(st)
        self._live = [(f"{i}:{rt.stage.name}", rt)
                      for i, rt in enumerate(runtimes)]

        budget = self._per_stage_budget(max(1, len(runtimes)))
        # each stage's launches gate on its DOWNSTREAM stage's queued
        # bytes; reads gate on the FIRST stage's queue
        downstream_of: Dict[int, Optional[_MapRuntime]] = {}
        for i, rt in enumerate(runtimes):
            downstream_of[id(rt)] = (runtimes[i + 1]
                                     if i + 1 < len(runtimes) else None)

        def budget_check_for(rt: _MapRuntime):
            """The typed throttle: raises BackpressureError (PR-3
            overload taxonomy, retryable by construction — nothing was
            launched) when the downstream stage is over budget."""
            ds = downstream_of.get(id(rt))

            def check():
                if ds is None:
                    # terminal stage: gate on its own completed-
                    # unconsumed output bytes (the consumer's pace)
                    parked, where = rt.ready_bytes(), "output"
                else:
                    # downstream queue PLUS this stage's own completed
                    # outputs still parked behind the ordered handoff:
                    # a straggling low-seq task head-of-line blocks
                    # pop_ready_in_order, so ready bytes accumulate
                    # here while the downstream queue reads empty —
                    # they are downstream-destined bytes either way
                    parked = ds.queued_bytes() + rt.ready_bytes()
                    where = "downstream"
                if parked >= budget:
                    raise BackpressureError(
                        f"data stage {rt.stage.name}: {where} holds "
                        f"{parked} queued bytes >= budget {budget}; "
                        "upstream launches throttled",
                        retryable=True, backoff_s=0.05)
            return check

        read_in_flight: Dict[Any, int] = {}
        # finished reads held until every earlier read is out: the first
        # stage takes blocks in read order, so that its ordered handoff
        # never waits behind a block that a later read made first
        read_done: Dict[int, Any] = {}
        read_seq = next_read_out = 0
        emitted: List[Any] = []
        stop = False

        def reads_allowed() -> bool:
            if not runtimes:
                return True
            first = runtimes[0]
            # queued + parked-ready: the first stage's full footprint
            return first.queued_bytes() + first.ready_bytes() < budget

        def feed_first(ref):
            nonlocal stop
            ref = self._through_limits(ref, pipeline, 0, limit_remaining)
            if ref is None:
                stop = True   # a limit is exhausted: stop feeding reads
                return
            tgt = next((it for it in pipeline
                        if isinstance(it, _MapRuntime)), None)
            if tgt is not None:
                tgt.add_input(ref, tgt.next_in_seq)
                tgt.next_in_seq += 1
            else:
                emitted.append(ref)

        def consumed(ref):
            data_stats.incr("blocks_consumed")
            return ref

        # ---- streaming loop ----
        # drained to empty at the bottom of every loop iteration;
        # holds at most one iteration's ordered outputs
        # unbounded-ok: drained to empty every loop iteration
        out_queue: deque = deque()
        try:
            while True:
                # 1. launch reads (count cap + first-stage byte budget)
                while (pending_reads
                       and (len(read_in_flight) + len(read_done)
                            < self._max_in_flight)
                       and reads_allowed()
                       and not stop):
                    fn = pending_reads.popleft()
                    read_in_flight[_read_task.remote(fn)] = read_seq
                    read_seq += 1
                while source:
                    feed_first(source.popleft())
                # 2. launch map work (downstream byte budget)
                for rt in runtimes:
                    rt.launch(budget_check_for(rt))
                # 3. wait for anything
                all_refs = (list(read_in_flight)
                            + [r for rt in runtimes for r in rt.in_flight])
                if not all_refs:
                    while emitted:
                        yield consumed(emitted.pop(0))
                    if (stop or not pending_reads) and all(
                            rt.done for rt in runtimes):
                        break
                    continue
                ready, _ = ray_tpu_torch.wait(
                    all_refs, num_returns=1, timeout=0.5)
                # 4. route completions
                for ref in ready:
                    if ref in read_in_flight:
                        read_done[read_in_flight.pop(ref)] = ref
                        data_stats.incr("blocks_produced")
                        data_stats.incr("bytes_produced",
                                        _ref_nbytes(ref))
                        continue
                    for i, rt in enumerate(runtimes):
                        if ref in rt.in_flight:
                            rt.complete(ref)
                            break
                while next_read_out in read_done:
                    feed_first(read_done.pop(next_read_out))
                    next_read_out += 1
                # 5. move ordered outputs downstream
                for i, item in enumerate(pipeline):
                    if not isinstance(item, _MapRuntime):
                        continue
                    for ref in item.pop_ready_in_order():
                        ref_out = self._through_limits(
                            ref, pipeline, i + 1, limit_remaining)
                        if ref_out is None:
                            continue
                        tgt = None
                        for j in range(i + 1, len(pipeline)):
                            if isinstance(pipeline[j], _MapRuntime):
                                tgt = pipeline[j]
                                break
                        if tgt is not None:
                            tgt.add_input(ref_out, tgt.next_in_seq)
                            tgt.next_in_seq += 1
                        else:
                            emitted.append(ref_out)
                # mark input done for chained stages
                first_done = ((stop or not pending_reads)
                              and not read_in_flight and not read_done
                              and not source)
                prev_done = first_done
                for item in pipeline:
                    if isinstance(item, _MapRuntime):
                        item.input_done = prev_done
                        prev_done = item.done
                # 6. emit
                while emitted:
                    out_queue.append(emitted.pop(0))
                while out_queue:
                    yield consumed(out_queue.popleft())
        finally:
            self.num_reconstructions += sum(
                rt.num_reconstructions for rt in runtimes)
            self._live = []
            for rt in runtimes:
                rt.shutdown()

    def _through_limits(self, ref, pipeline, start_idx, limit_remaining):
        """Apply any LimitStage between start_idx-1 and the next map."""
        for j in range(start_idx, len(pipeline)):
            item = pipeline[j]
            if isinstance(item, _MapRuntime):
                break
            if isinstance(item, LimitStage):
                rem = limit_remaining[id(item)]
                if rem <= 0:
                    return None
                blk = ray_tpu_torch.get(ref)
                if blk.num_rows > rem:
                    blk = blib.slice_block(blk, 0, rem)
                    ref = ray_tpu_torch.put(blk)
                limit_remaining[id(item)] = rem - blk.num_rows
        return ref

    # -- full run with barriers -------------------------------------------

    def run(self) -> Iterator[Any]:
        """Yield final output block refs, handling barrier stages by
        segmenting the plan."""
        plan = self._plan
        stages = list(plan.stages)
        segment_source = deque(
            plan.source_refs)    # unbounded-ok: plan-sized, drain-only
        pending_reads = deque(
            plan.read_tasks)     # unbounded-ok: plan-sized, drain-only
        extra = plan.extra_sources

        while True:
            barrier_idx = None
            for i, st in enumerate(stages):
                if isinstance(st, AllToAllStage):
                    barrier_idx = i
                    break
            seg_stages = stages if barrier_idx is None \
                else stages[:barrier_idx]
            seg_plan = PhysicalPlan(
                source_refs=list(segment_source),
                read_tasks=list(pending_reads),
                stages=seg_stages, extra_sources=extra)
            extra = []
            seg_exec = StreamingExecutor(seg_plan,
                                         max_in_flight=self._max_in_flight)
            if barrier_idx is None:
                try:
                    yield from seg_exec.output_refs()
                finally:
                    self.num_reconstructions += \
                        seg_exec.num_reconstructions
                return
            # barrier: drain segment, run the all-to-all, continue
            upstream_refs = list(seg_exec.output_refs())
            self.num_reconstructions += seg_exec.num_reconstructions
            barrier = stages[barrier_idx]
            # unbounded-ok: the barrier's output partitions — fixed
            # fan-out decided by the all-to-all, drained by the next
            # segment; the empty read deque never grows
            segment_source = deque(
                self._run_all_to_all(barrier, upstream_refs))
            pending_reads = deque()  # unbounded-ok: stays empty
            stages = stages[barrier_idx + 1:]

    def _run_all_to_all(self, stage: AllToAllStage, refs: List) -> List:
        kind = stage.kind
        kwargs = dict(stage.kwargs)
        n_out = kwargs.get("num_partitions") or max(len(refs), 1)
        if not refs:
            return []
        if kind == "sort":
            # sample boundaries
            key = kwargs["key"]
            samples = ray_tpu_torch.get(
                [_sample_task.remote(r, key, 32) for r in refs])
            allv = np.concatenate([s for s in samples if len(s)]) \
                if any(len(s) for s in samples) else np.asarray([0])
            qs = np.linspace(0, 100, n_out + 1)[1:-1]
            kwargs["boundaries"] = np.percentile(allv, qs) if len(allv) \
                else np.asarray([])
            if kwargs.get("descending"):
                pass  # partitions sorted ascending then reversed at concat
        split = _split_fn_factory(kind, n_out, kwargs)
        reduce = _reduce_fn_factory(kind, kwargs)

        # Two-level shuffle (reference: push-based/multi-stage shuffle):
        # one split task per block × n_out partitions is N² intermediate
        # objects — ownership tables and the scheduler drown before the
        # data does (1k blocks -> 1M refs). Grouping ~√N blocks per
        # combiner bounds intermediates to G·n_out = O(N^1.5) and every
        # reduce's fan-in to G = O(√N).
        def combine(*blks):
            partss = [split(b) for b in blks]
            if len(partss) == 1:
                return partss[0]
            if n_out == 1:
                return blib.concat_blocks(list(partss))
            return tuple(
                blib.concat_blocks([p[i] for p in partss])
                for i in range(n_out))

        group_size = max(1, int(math.ceil(math.sqrt(len(refs)))))
        groups = [refs[i:i + group_size]
                  for i in range(0, len(refs), group_size)]
        combine_remote = ray_tpu_torch.remote(combine)
        parts: List[List] = []
        for grp in groups:
            out = combine_remote.options(num_returns=n_out).remote(*grp)
            if n_out == 1:
                out = [out]
            parts.append(out)
        reduce_remote = ray_tpu_torch.remote(reduce)
        out_refs = []
        for i in range(n_out):
            out_refs.append(
                reduce_remote.remote(*[p[i] for p in parts]))
        if kind == "sort" and kwargs.get("descending"):
            out_refs = list(reversed(out_refs))
        return out_refs
