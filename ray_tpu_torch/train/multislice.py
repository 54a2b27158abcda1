"""Multi-slice data-parallel trainer: one checkpointable actor gang
per slice, grad sync through the hierarchical DCN allreduce, and
whole-slice recovery composed from gang restart +
gang-consistent checkpoint restore (docs/multislice.md).

The driver re-drives steps: worker ``train_step`` calls carry
``max_task_retries=0`` because an auto-replayed half-gang collective
could only time out — after a slice dies mid-step, the surviving
slices abort typed out of the fenced DCN tier, :meth:`recover` waits
for the dead slice's gang to re-form (its ranks restore the newest
fully committed generation and come back at step K), re-joins every
leader to the DCN group at the bumped epoch, and the loop re-issues
step K+1. Chaos-free slices never restart; their state was never
mutated by the aborted step (sync happens BEFORE apply).

User contract — three picklable functions over plain numpy state:

- ``init_fn() -> np.ndarray`` — initial state (identical on every
  rank);
- ``grad_fn(state, global_rank, world_size, step_idx) -> np.ndarray``
  — this rank's contribution for the step (depends only on its
  arguments, so a re-driven step reproduces the same update);
- ``apply_fn(state, synced) -> (state, float)`` — fold the reduced
  contribution in, return the new state and a scalar metric.

A ``num_slices=1`` run is the single-mesh baseline: same workers,
same data order, no DCN tier — the two-slice run must match it
numerically (the tier-1 acceptance test).

The port's copy of ``ray_tpu/train/multislice.py``. With
``resources_per_worker={"GPU": ...}`` the ranks run on threads of the
driver and ``grad_fn`` may use the card, as long as it returns numpy.
``run_with_data`` takes its prefetching iterator and its starvation
gauge from ``ray_tpu_torch.data``.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import collective as col
from ray_tpu_torch.collective.collective import ReduceOp
from ray_tpu_torch.train.ingest import to_numpy_batch as _to_numpy_batch


@dataclasses.dataclass
class MultiSliceConfig:
    num_slices: int = 2
    ranks_per_slice: int = 2
    name: Optional[str] = None
    # per-slice gang coordinated-restart budget (None = config default)
    gang_max_restarts: Optional[int] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    reduce_op: str = ReduceOp.MEAN
    # slice-group rendezvous deadline: a backstop only — faults abort
    # typed via the liveness plane in milliseconds
    collective_timeout_s: float = 30.0
    step_timeout_s: float = 60.0
    recover_timeout_s: float = 60.0
    # re-drives per step after a successful recovery
    max_step_retries: int = 2

    @property
    def world_size(self) -> int:
        return self.num_slices * self.ranks_per_slice


@ray_tpu_torch.remote(max_restarts=4, max_task_retries=0,
                checkpoint_interval=1)
class _SliceTrainWorker:
    """One rank of one slice gang. Checkpointable: every call
    autosaves, the slice gang's generations two-phase commit, and a
    restarted rank restores the newest fully committed state before
    replay. Every method is called on EVERY rank of a gang (non-
    leaders get structured no-ops where only leaders act) so call
    counts — and therefore checkpoint generations — stay aligned."""

    def __init__(self):
        from ray_tpu_torch.multislice import dcn
        dcn.begin_incarnation()
        self._blob = None
        self._fns = None
        self._meta: Dict[str, Any] = {}
        self.state = None
        self.steps = 0

    def ping(self):
        return "up"

    def is_configured(self):
        return self._fns is not None

    def reconfigure(self, blob, meta, adopt=None):
        """Re-arm a rank that restarted BARE — its newest fully
        committed checkpoint generation predates :meth:`configure`
        (blob/state None), which happens when a kill lands inside the
        rank's very first save window. Re-ships the training fns and
        adopts a configured peer's replicated ``(steps, state)`` so
        the regular catch-up path can align it. Issued on EVERY rank
        for checkpoint call-count symmetry; configured ranks no-op."""
        if self._fns is not None:
            return False
        import cloudpickle
        self._blob = blob
        self._meta = dict(meta)
        self._fns = cloudpickle.loads(blob)
        if adopt is not None:
            steps, state = adopt
            self.steps = int(steps)
            self.state = np.asarray(state)
        else:
            self.state = np.asarray(self._fns[0]())
            self.steps = 0
        return True

    def arm(self, rule):
        """Install a chaos rule in this rank's process (the fault-
        injection plane's per-process hook; tests aim kills at one
        rank while peers arm never-firing placeholders for call
        symmetry)."""
        from ray_tpu_torch._private import chaos
        chaos.install(rule)
        return True

    def disarm(self):
        """Clear every chaos rule in this rank's process. Like
        :meth:`arm`, callers issue it on EVERY rank of the gang so
        checkpoint call counts stay aligned (the soak plane's trainer
        scope disarms after each faulted epoch)."""
        from ray_tpu_torch._private import chaos
        chaos.clear()
        return True

    def configure(self, blob, meta):
        import cloudpickle
        self._blob = blob
        self._meta = dict(meta)
        self._fns = cloudpickle.loads(blob)
        if self.state is None:      # fresh rank (not a restore)
            self.state = np.asarray(self._fns[0]())
        return True

    def _join_collective_group(self, world, rank, backend, name):
        # gang (re-)join hook: the coordinated restart re-issues
        # exactly this call ahead of any queued user calls
        col.init_collective_group(
            world, rank, backend, name,
            timeout_s=self._meta.get("collective_timeout_s", 30.0))
        return rank

    def _join_dcn_group(self, world, rank, name):
        from ray_tpu_torch.multislice import dcn
        return dcn.join_dcn_group(
            world, rank, name,
            timeout_s=self._meta.get("collective_timeout_s", 30.0))

    def train_step(self, step_idx):
        """Sync-then-apply: the hierarchical allreduce runs BEFORE any
        state mutation, so a step aborted mid-sync (slice death, DCN
        fence) leaves state untouched and the driver's re-drive is
        side-effect clean."""
        from ray_tpu_torch.multislice import hierarchical_allreduce
        _init, grad_fn, apply_fn = self._fns
        m = self._meta
        grad = np.asarray(grad_fn(self.state, m["global_rank"],
                                  m["world_size"], step_idx))
        synced = hierarchical_allreduce(
            grad, m["slice_group"], m.get("dcn_group"),
            op=m.get("reduce_op", ReduceOp.MEAN))
        self.state, metric = apply_fn(self.state, synced)
        self.state = np.asarray(self.state)
        self.steps = int(step_idx)
        return int(step_idx), float(metric)

    def train_step_data(self, step_idx, batch):
        """Data-ingestion variant of :meth:`train_step` (docs/
        data_pipeline.md §Trainer ingestion): the driver ships the
        step's global batch ONCE as an object ref (every rank reads it
        zero-copy from the store) and ``grad_fn`` receives it as a
        fifth argument — ``grad_fn(state, rank, world, step, batch)``.
        Same sync-then-apply contract: an aborted step leaves state
        untouched and the driver re-drives it WITH THE SAME batch
        (exactly-once batch consumption)."""
        from ray_tpu_torch.multislice import hierarchical_allreduce
        _init, grad_fn, apply_fn = self._fns
        m = self._meta
        grad = np.asarray(grad_fn(self.state, m["global_rank"],
                                  m["world_size"], step_idx, batch))
        synced = hierarchical_allreduce(
            grad, m["slice_group"], m.get("dcn_group"),
            op=m.get("reduce_op", ReduceOp.MEAN))
        self.state, metric = apply_fn(self.state, synced)
        self.state = np.asarray(self.state)
        self.steps = int(step_idx)
        return int(step_idx), float(metric)

    def catch_up(self, to_step):
        """Recompute steps this rank missed, locally and without
        collectives (the peers have moved past them — a half-gang
        collective could only time out). Sound because the driver's
        contract makes the synced update a pure function of
        (state, step): ``grad_fn`` depends only on its arguments and
        state is replicated, so this rank can evaluate EVERY rank's
        contribution itself. The reduction mirrors the hierarchical
        op tree (per-slice partials, then cross-slice) so the result
        is bit-identical to what the surviving slices computed.
        No-op for ranks already at ``to_step`` (called on every rank
        for call symmetry)."""
        from ray_tpu_torch.collective.collective import _REDUCERS
        _init, grad_fn, apply_fn = self._fns
        m = self._meta
        op = _REDUCERS[m.get("reduce_op", ReduceOp.MEAN)]
        S, R = m["num_slices"], m["ranks_per_slice"]
        while self.steps < int(to_step):
            idx = self.steps + 1
            partials = []
            for k in range(S):
                grads = [np.asarray(grad_fn(self.state, k * R + i,
                                            m["world_size"], idx))
                         for i in range(R)]
                partials.append(op(np.stack(grads)))
            synced = op(np.stack(partials)) if S > 1 else partials[0]
            self.state, _ = apply_fn(self.state, synced)
            self.state = np.asarray(self.state)
            self.steps = idx
        return self.steps

    def catch_up_data(self, to_step, batches):
        """Data-mode local catch-up: like :meth:`catch_up`, but the
        per-step update needs the step's BATCH, which the driver
        retains in a bounded cache (``keep_batches``) exactly for this
        window. ``batches`` maps step index -> numpy batch (shipped
        once as a ref). A step outside the window is unrecoverable
        locally — surfaced with the remedy rather than computing a
        wrong (batch-less) update."""
        from ray_tpu_torch.collective.collective import _REDUCERS
        _init, grad_fn, apply_fn = self._fns
        m = self._meta
        op = _REDUCERS[m.get("reduce_op", ReduceOp.MEAN)]
        S, R = m["num_slices"], m["ranks_per_slice"]
        while self.steps < int(to_step):
            idx = self.steps + 1
            if idx not in batches:
                raise RuntimeError(
                    f"catch_up_data: the batch for step {idx} left "
                    "the driver's keep_batches window; raise "
                    "keep_batches (MultiSliceTrainer.run_with_data) "
                    "above the checkpoint lag")
            batch = batches[idx]
            partials = []
            for k in range(S):
                grads = [np.asarray(grad_fn(self.state, k * R + i,
                                            m["world_size"], idx,
                                            batch))
                         for i in range(R)]
                partials.append(op(np.stack(grads)))
            synced = op(np.stack(partials)) if S > 1 else partials[0]
            self.state, _ = apply_fn(self.state, synced)
            self.state = np.asarray(self.state)
            self.steps = idx
        return self.steps

    def snapshot(self):
        return self.steps, np.asarray(self.state)

    def dcn_stats(self):
        from ray_tpu_torch.multislice import dcn
        return dcn.stats_snapshot()

    def __ray_save__(self):
        return {"blob": self._blob, "meta": self._meta,
                "state": self.state, "steps": self.steps}

    def __ray_restore__(self, st):
        import cloudpickle
        self._blob = st["blob"]
        self._meta = st["meta"]
        self.state = st["state"]
        self.steps = st["steps"]
        if self._blob is not None:
            self._fns = cloudpickle.loads(self._blob)


class MultiSliceTrainer:
    """Driver for S slice gangs of R ranks each. ``start`` forms the
    SliceSet (gangs + DCN tier + registries), ``run`` drives steps
    with whole-slice recovery, ``shutdown`` tears everything down."""

    def __init__(self, init_fn: Callable, grad_fn: Callable,
                 apply_fn: Callable,
                 config: Optional[MultiSliceConfig] = None):
        self.config = config or MultiSliceConfig()
        self._fns = (init_fn, grad_fn, apply_fn)
        self.name = self.config.name \
            or f"mslice_{uuid.uuid4().hex[:8]}"
        self.slice_set = None
        self.workers: List[List] = []       # handles by slice
        self._metas: List[dict] = []        # per-rank meta, flat order
        self._next_step = 0
        self.history: List[Tuple[int, float]] = []

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "MultiSliceTrainer":
        import cloudpickle
        from ray_tpu_torch.multislice import SliceSet
        from ray_tpu_torch.train.trainer import resources_to_actor_options
        cfg = self.config
        kw = resources_to_actor_options(
            cfg.resources_per_worker or {"CPU": 0.5})
        self.workers = [
            [_SliceTrainWorker.options(**kw).remote()
             for _ in range(cfg.ranks_per_slice)]
            for _ in range(cfg.num_slices)]
        try:
            flat = [h for s in self.workers for h in s]
            ray_tpu_torch.get([h.ping.remote() for h in flat], timeout=60)
            blob = cloudpickle.dumps(self._fns)
            refs = []
            self._metas = []
            for k, members in enumerate(self.workers):
                for i, h in enumerate(members):
                    meta = dict(
                        global_rank=k * cfg.ranks_per_slice + i,
                        world_size=cfg.world_size,
                        num_slices=cfg.num_slices,
                        ranks_per_slice=cfg.ranks_per_slice,
                        slice_index=k, slice_rank=i,
                        slice_group=f"{self.name}.s{k}",
                        # single-slice = the flat single-mesh
                        # baseline: no DCN tier at all
                        dcn_group=(f"{self.name}.dcn"
                                   if cfg.num_slices > 1 else None),
                        reduce_op=cfg.reduce_op,
                        collective_timeout_s=cfg.collective_timeout_s)
                    self._metas.append(meta)
                    refs.append(h.configure.remote(blob, meta))
            ray_tpu_torch.get(refs, timeout=60)
            self.slice_set = SliceSet.create(
                self.workers, name=self.name,
                gang_max_restarts=cfg.gang_max_restarts,
                timeout_s=cfg.collective_timeout_s)
        except BaseException:
            # failed formation must not strand S*R live actors (and a
            # caller retrying start() would double the orphan pool);
            # SliceSet.create already tore down its own gangs/rows
            for h in [h for s in self.workers for h in s]:
                try:
                    ray_tpu_torch.kill(h)
                except Exception:
                    pass    # never spawned / already dead
            self.workers = []
            raise
        return self

    def shutdown(self) -> None:
        if self.slice_set is not None:
            try:
                self.slice_set.refresh_dcn_stats()
            except Exception:
                pass    # final stats pull best-effort
            self.slice_set.destroy()
            self.slice_set = None
        for h in [h for s in self.workers for h in s]:
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                pass    # worker already dead

    # -- the training loop ---------------------------------------------

    def step(self) -> Tuple[int, float]:
        """Drive one step on every rank; returns (step_idx, metric)
        from global rank 0. Raises (typed) on slice failure — callers
        wanting recovery use :meth:`run`."""
        idx = self._next_step + 1
        refs = [h.train_step.remote(idx)
                for s in self.workers for h in s]
        outs = ray_tpu_torch.get(refs, timeout=self.config.step_timeout_s)
        self._next_step = idx
        self.history.append((idx, outs[0][1]))
        return outs[0]

    def run(self, num_steps: int) -> List[Tuple[int, float]]:
        """Advance training by ``num_steps`` global updates, recovering
        from whole-slice failures: abort typed → gang restart +
        checkpoint restore → DCN re-join at the bumped epoch →
        re-drive. Driven by TARGET STEP INDEX, not by collected
        results: a step that half-completed before an abort (some
        slices applied it, others caught up to it during recovery)
        counts toward the target and is NOT driven again — its
        driver-side metric is simply absent from the returned history,
        never duplicated as an extra optimizer update."""
        from ray_tpu_torch.exceptions import (ActorError, CollectiveAbortError,
                                        GetTimeoutError,
                                        WorkerCrashedError)
        done: List[Tuple[int, float]] = []
        target = self._next_step + num_steps
        retries_left = self.config.max_step_retries
        while self._next_step < target:
            try:
                done.append(self.step())
                retries_left = self.config.max_step_retries
            except (CollectiveAbortError, ActorError, GetTimeoutError,
                    WorkerCrashedError):
                # only the typed fault taxonomy is recoverable: a
                # deterministic user-code error must surface with its
                # own traceback immediately, not burn recovery rounds
                if retries_left == 0:
                    raise
                retries_left -= 1
                self.recover()
        return done

    def run_with_data(self, batches, num_steps: Optional[int] = None,
                      *, keep_batches: int = 4,
                      prefetch_batches: Optional[int] = None
                      ) -> List[Tuple[int, float]]:
        """Drive training from a batch iterator (a ``ray_tpu_torch.data``
        pipeline's ``iter_jax_batches``/``iter_batches``, or any
        iterable of dict batches) with prefetch, whole-slice recovery,
        and exactly-once batch consumption (docs/data_pipeline.md
        §Trainer ingestion).

        Each step draws ONE batch from the iterator, converts leaves
        to numpy, ships it once via the object store, and calls
        ``train_step_data`` on every rank (``grad_fn`` receives the
        batch as its fifth argument; shard by ``global_rank`` inside
        it for data parallelism). The last ``keep_batches`` batches
        stay cached on the driver: a re-driven or caught-up step
        reuses its ORIGINAL batch — a fault never drops a batch or
        draws a fresh one for the same step index.

        Starvation accounting: the fraction of wall time spent
        waiting on the iterator lands in ``self.last_ingest`` and the
        ``ray_tpu_data_trainer_starvation`` gauge — ≈ 0 means the
        pipeline (with ``prefetch_batches`` buffered ahead) kept the
        step loop compute-bound.

        ``num_steps=None`` drains the iterator."""
        import time as _time
        from ray_tpu_torch._private import data_stats
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch.data._internal.prefetch import PrefetchIterator
        from ray_tpu_torch.exceptions import (ActorError, CollectiveAbortError,
                                        GetTimeoutError,
                                        WorkerCrashedError)
        if prefetch_batches is None:
            prefetch_batches = get_config().data_prefetch_batches
        own_prefetch = (prefetch_batches and prefetch_batches > 0
                        and not isinstance(batches, PrefetchIterator))
        it = (PrefetchIterator(iter(batches), depth=prefetch_batches,
                               name="rtpt-train-ingest")
              if own_prefetch else iter(batches))
        cache: Dict[int, Any] = {}      # step -> numpy batch (re-drive
        # window; bounded to keep_batches entries below)
        done: List[Tuple[int, float]] = []
        target = (None if num_steps is None
                  else self._next_step + num_steps)
        retries_left = self.config.max_step_retries
        wait_s = 0.0
        t_start = _time.monotonic()
        try:
            while target is None or self._next_step < target:
                idx = self._next_step + 1
                batch = cache.get(idx)
                if batch is None:
                    t0 = _time.monotonic()
                    try:
                        raw = next(it)
                    except StopIteration:
                        break
                    wait_s += _time.monotonic() - t0
                    batch = _to_numpy_batch(raw)
                    cache[idx] = batch
                    for old in [k for k in cache
                                if k <= idx - keep_batches]:
                        cache.pop(old)
                try:
                    done.append(self._step_data(idx, batch))
                    retries_left = self.config.max_step_retries
                except (CollectiveAbortError, ActorError,
                        GetTimeoutError, WorkerCrashedError):
                    if retries_left == 0:
                        raise
                    retries_left -= 1
                    self.recover(
                        _catch_up=lambda resume:
                        self._catch_up_data(resume, cache))
        finally:
            if own_prefetch:
                it.close()
            wall = _time.monotonic() - t_start
            frac = (wait_s / wall) if wall > 0 else 0.0
            self.last_ingest = {
                "steps": len(done), "wait_s": wait_s, "wall_s": wall,
                "starvation_fraction": frac}
            data_stats.set_starvation(frac)
        return done

    def _step_data(self, idx: int, batch) -> Tuple[int, float]:
        """One data-mode step on every rank; the batch ships once."""
        ref = ray_tpu_torch.put(batch)
        refs = [h.train_step_data.remote(idx, ref)
                for s in self.workers for h in s]
        outs = ray_tpu_torch.get(refs, timeout=self.config.step_timeout_s)
        self._next_step = idx
        self.history.append((idx, outs[0][1]))
        return outs[0]

    def _catch_up_data(self, resume: int, cache: Dict[int, Any]) -> None:
        """Catch laggard ranks up using the driver's retained batches
        (shipped once as a ref; every rank gets the call for
        checkpoint-generation symmetry)."""
        window = {k: v for k, v in cache.items() if k <= resume}
        ref = ray_tpu_torch.put(window)
        ray_tpu_torch.get(
            [h.catch_up_data.remote(resume, ref)
             for s in self.workers for h in s],
            timeout=self.config.recover_timeout_s)

    def recover(self, _catch_up=None) -> int:
        """Whole-slice recovery: wait for the dead slice's gang to
        re-form (restart; its ranks restored the newest fully
        committed generation), re-join the DCN tier at the fenced
        epoch, then verify every rank agrees on the resume step.
        Returns the step index training resumes AFTER."""
        cfg = self.config
        self.slice_set.wait_all_alive(cfg.recover_timeout_s)
        # a transport abort INSIDE a slice (local-timeout fan-out with
        # no member death behind it) poisons that gang's epoch for
        # good: the restart plane is death-triggered, so nothing
        # re-forms the group and every re-driven step would fail fast
        # at _check_abort. Surface that now with the remedy instead of
        # burning max_step_retries on it (docs/multislice.md
        # "Limitations").
        poisoned = self.slice_set.poisoned_slice_groups()
        if poisoned:
            raise RuntimeError(
                f"slice group(s) {poisoned} carry a transport-abort "
                "marker at their live epoch with every member healthy; "
                "intra-slice epochs only re-form through a gang "
                "restart — tear the trainer down and start() fresh")
        # A rank can restart BARE: when the kill landed inside its
        # very first save window, the newest fully committed
        # generation is the pre-configure one (blob/state None), and
        # the catch-up below would crash untyped unpacking its fns.
        # Re-ship the fns and adopt a configured peer's replicated
        # state (every rank gets both calls for checkpoint call-count
        # symmetry; configured ranks no-op the reconfigure).
        flat = [h for s in self.workers for h in s]
        flags = ray_tpu_torch.get([h.is_configured.remote() for h in flat],
                            timeout=cfg.recover_timeout_s)
        if not all(flags):
            import cloudpickle
            bare_snaps = ray_tpu_torch.get(
                [h.snapshot.remote() for h in flat],
                timeout=cfg.recover_timeout_s)
            donor = None
            for ok, (st, sv) in zip(flags, bare_snaps):
                if ok and (donor is None or int(st) > donor[0]):
                    donor = (int(st), sv)
            blob = cloudpickle.dumps(self._fns)
            adopt = ray_tpu_torch.put(donor) if donor is not None else None
            ray_tpu_torch.get(
                [h.reconfigure.remote(blob, self._metas[j], adopt)
                 for j, h in enumerate(flat)],
                timeout=cfg.recover_timeout_s)
        # also for num_slices=1 (where steps never touch the DCN
        # group): the fence still marked the set DEGRADED and bumped
        # its epoch, and only the re-join flips the row back ALIVE
        self.slice_set.rejoin_dcn()
        snaps = ray_tpu_torch.get(
            [h.snapshot.remote() for s in self.workers for h in s],
            timeout=cfg.recover_timeout_s)
        steps = sorted({s for s, _ in snaps})
        resume = steps[-1]
        if len(steps) > 1:
            # a slice died inside the commit window (its step-K reply
            # shipped but generation K never two-phase committed): it
            # restored K-1 while the others hold K. Catch the laggards
            # up LOCALLY — every rank gets the call (symmetry); ranks
            # already at `resume` no-op. Data-mode recovery passes its
            # own catch-up (the per-step update needs the batch).
            if _catch_up is not None:
                _catch_up(resume)
            else:
                ray_tpu_torch.get(
                    [h.catch_up.remote(resume)
                     for s in self.workers for h in s],
                    timeout=cfg.recover_timeout_s)
        self._next_step = resume
        self.history = [h for h in self.history if h[0] <= resume]
        return resume

    # -- views ---------------------------------------------------------

    def snapshots(self) -> List[Tuple[int, np.ndarray]]:
        return ray_tpu_torch.get(
            [h.snapshot.remote() for s in self.workers for h in s],
            timeout=self.config.step_timeout_s)

    def dcn_stats(self) -> Dict[str, float]:
        return self.slice_set.refresh_dcn_stats()
