"""DataParallelTrainer: SPMD training on an actor gang in a placement
group, with gang restart from the last checkpoint on failure.

Reference: ``python/ray/train/`` — ``DataParallelTrainer`` /
``BackendExecutor`` / ``WorkerGroup``; ``ScalingConfig``,
``RunConfig(FailureConfig, CheckpointConfig)``; fault tolerance =
restart the whole worker gang from the last checkpoint
[UNVERIFIED — mount empty, SURVEY.md §0].

The port's copy of ``ray_tpu/train/trainer.py``. Gradient sync INSIDE
a worker is the worker's own program (a mesh over NCCL, or none);
BETWEEN workers the host-plane collective group is pre-initialized for
the loop to use (``ctx.collective_group``). Gang restart — not
per-worker restart — is the only correct recovery for an SPMD program.
``ScalingConfig.use_gpu`` asks a ``GPU`` for each worker (upstream
Ray's name; the reference's ``use_tpu``): such a worker runs on a
thread of the driver, which owns the cards, and two workers of
``{"GPU": 0.5}`` share one card and one process. The reference's
``JaxTrainer`` alias is not carried over.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
import shutil
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._session import (
    ElasticResize,
    TrainContext,
    get_context,
    init_session,
    shutdown_session,
)
from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # Elastic training (reference: Train v2 controller-based elastic):
    # when set, a failed attempt that can no longer reserve the full
    # gang SHRINKS to whatever fits (>= min_workers) and continues
    # from the latest checkpoint (the user loop's restore handles the
    # new layout); when capacity returns, the gang stops at the
    # next checkpoint boundary and re-forms at full size. None keeps
    # strict fixed-size gang-restart semantics.
    min_workers: Optional[int] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res


def resources_to_actor_options(
        res: Optional[Dict[str, float]]) -> Dict[str, Any]:
    """Map a ``resources_per_worker`` dict onto ``.options()`` kwargs:
    CPU/TPU/GPU/memory become their dedicated options, anything else
    passes through as custom ``resources``. Shared by every trainer so
    the contract stays uniform (no silently dropped keys)."""
    res = dict(res or {})
    kw: Dict[str, Any] = {}
    if "CPU" in res:
        kw["num_cpus"] = res.pop("CPU")
    if "TPU" in res:
        kw["num_tpus"] = res.pop("TPU")
    if "GPU" in res:
        kw["num_gpus"] = res.pop("GPU")
    if "memory" in res:
        kw["memory"] = res.pop("memory")
    if res:
        kw["resources"] = res
    return kw


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)


@ray_tpu_torch.remote
class _TrainWorker:
    """One gang member. ``run`` executes the user loop to completion."""

    def _join_collective_group(self, world, rank, backend, name):
        from ray_tpu_torch import collective as col
        col.init_collective_group(world, rank, backend, name,
                                  timeout_s=120.0)
        return rank

    def run(self, loop_blob: bytes, ctx_fields: dict, blocks_by_name,
            setup_blob=None):
        import cloudpickle
        ctx = TrainContext(**ctx_fields)
        ctx.datasets = blocks_by_name
        init_session(ctx)
        teardown = None
        try:
            if setup_blob is not None:
                setup = cloudpickle.loads(setup_blob)
                teardown = setup(ctx)
            loop = cloudpickle.loads(loop_blob)
            try:
                loop(ctx.config) if _wants_arg(loop) else loop()
            except ElasticResize:
                # clean stop at a checkpoint boundary: the gang is
                # re-forming at a new world size
                return "__elastic_resize__"
            return True
        finally:
            if teardown is not None:
                try:
                    teardown()
                except Exception:
                    pass    # user teardown must not mask the result
            shutdown_session()


def _wants_arg(fn: Callable) -> bool:
    import inspect
    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return True


class DataParallelTrainer:
    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self._loop = train_loop_per_worker
        self._loop_config = train_loop_config or {}
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._datasets = datasets or {}
        self._resume_ckpt = resume_from_checkpoint
        # subclass backend hook: runs in each worker before the loop
        # (returns an optional teardown callable)
        self._backend_setup: Optional[Callable] = None

    def _attempt_backend_config(self) -> Dict[str, Any]:
        """Per-attempt wiring shipped to every worker (ports etc.)."""
        return {}

    # -- experiment dirs ---------------------------------------------------

    def _trial_dir(self) -> str:
        base = (self._run_config.storage_path
                or os.path.join(tempfile.gettempdir(),
                                "ray_tpu_torch_results"))
        name = self._run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    # -- fit ---------------------------------------------------------------

    def fit(self) -> Result:
        trial_dir = self._trial_dir()
        failures_left = self._run_config.failure_config.max_failures
        latest_ckpt = self._resume_ckpt
        history: List[Dict[str, Any]] = []
        # live view for observers (tests, progress displays)
        self.metrics_history = history
        target = self._scaling.num_workers
        min_workers = self._scaling.min_workers
        world_size = target
        while True:
            try:
                metrics, latest_ckpt, resized = self._run_attempt(
                    trial_dir, latest_ckpt, history,
                    world_size=world_size, target=target)
                if resized:
                    # clean stop at a checkpoint boundary: capacity is
                    # back — re-form the gang at full size
                    world_size = target
                    continue
                return Result(metrics=metrics, checkpoint=latest_ckpt,
                              path=trial_dir, metrics_history=history)
            except Exception as e:
                # keep any checkpoint reported before the crash so the
                # next attempt resumes from it
                attempt_ckpt = getattr(self, "_attempt_ckpt", None)
                if attempt_ckpt is not None:
                    latest_ckpt = attempt_ckpt
                if failures_left == 0:
                    return Result(metrics=history[-1] if history else {},
                                  checkpoint=latest_ckpt, path=trial_dir,
                                  error=e, metrics_history=history)
                if failures_left > 0:
                    failures_left -= 1
                if min_workers is not None:
                    # elastic: continue at whatever gang still fits
                    world_size = self._feasible_world_size(
                        target, min_workers)

    def _feasible_world_size(self, target: int, min_workers: int) -> int:
        """Largest gang (min_workers..target) the cluster can host
        right now, established by PROBING placement (a short reserve/
        release per size). The resource VIEW is not trusted: right
        after a node dies it still advertises the dead capacity until
        the health manager fires, and a view-based answer would retry
        the full gang against a cluster that can no longer host it.
        O(log n) probes: target first (the common not-a-capacity-loss
        failure costs ONE probe), then binary search below it."""
        from ray_tpu_torch.util.placement_group import (
            placement_group, remove_placement_group)
        res = self._scaling.worker_resources()

        def fits(k: int) -> bool:
            pg = placement_group(
                [dict(res) for _ in range(k)],
                strategy=self._scaling.placement_strategy)
            ok = pg.wait(8.0)
            remove_placement_group(pg)
            return ok

        lo = max(min_workers, 1)
        if fits(target):
            return target
        hi = target - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fits(mid):
                lo = mid
            else:
                hi = mid - 1
        return lo

    def _grow_possible(self, current: int, target: int) -> bool:
        res = self._scaling.worker_resources()
        avail = ray_tpu_torch.available_resources()
        extra = target - current
        return all(avail.get(k, 0.0) >= v * extra
                   for k, v in res.items() if v > 0)

    def _run_attempt(self, trial_dir: str,
                     latest_ckpt: Optional[Checkpoint],
                     history: List[Dict[str, Any]],
                     world_size: Optional[int] = None,
                     target: Optional[int] = None):
        from ray_tpu_torch.util.placement_group import (
            placement_group, remove_placement_group)

        scfg = self._scaling
        n = world_size or scfg.num_workers
        target = target or scfg.num_workers
        elastic = scfg.min_workers is not None
        res = scfg.worker_resources()
        report_dir = tempfile.mkdtemp(prefix="rtpt_reports_")
        group_name = f"train_{uuid.uuid4().hex[:8]}"

        pg = placement_group([dict(res) for _ in range(n)],
                             strategy=scfg.placement_strategy)
        if not pg.wait(60):
            remove_placement_group(pg)
            raise RuntimeError(
                f"could not reserve {n} x {res} for the worker gang")
        workers = []
        seen: set = set()
        try:
            kw = resources_to_actor_options(res)
            workers = [
                _TrainWorker.options(
                    placement_group=pg, placement_group_bundle_index=i,
                    **kw).remote()
                for i in range(n)]
            # host-plane collective group for the loop to use
            ray_tpu_torch.get([w._join_collective_group.remote(
                n, i, "shm", group_name)
                for i, w in enumerate(workers)], timeout=120)

            shards = self._shard_datasets(n)
            import cloudpickle
            blob = cloudpickle.dumps(self._loop)
            setup_blob = (cloudpickle.dumps(self._backend_setup)
                          if self._backend_setup is not None else None)
            backend_config = self._attempt_backend_config()
            refs = []
            for i, w in enumerate(workers):
                ctx_fields = dict(
                    world_size=n, rank=i, local_rank=i,
                    experiment_name=self._run_config.name or "",
                    trial_dir=trial_dir, report_dir=report_dir,
                    config=dict(self._loop_config),
                    collective_group=group_name,
                    backend_config=dict(backend_config),
                    latest_checkpoint=latest_ckpt)
                refs.append(w.run.remote(blob, ctx_fields, shards[i],
                                         setup_blob))

            import time as _t
            resized = False
            grow_requested = False
            next_grow_check = _t.monotonic() + 1.0
            while True:
                ready, not_ready = ray_tpu_torch.wait(
                    refs, num_returns=len(refs), timeout=0.2)
                seen, latest_ckpt = self._drain_reports(
                    report_dir, seen, history, latest_ckpt)
                if (elastic and n < target and not grow_requested
                        and _t.monotonic() >= next_grow_check):
                    next_grow_check = _t.monotonic() + 1.0
                    if self._grow_possible(n, target):
                        # ask the shrunken gang to stop at a
                        # RANK-AGREED checkpoint boundary: a seq
                        # ahead of every rank's current progress, so
                        # no rank leaves a step another rank still
                        # expects collectives from
                        max_seq = 0
                        for fname in seen:
                            try:
                                max_seq = max(
                                    max_seq,
                                    int(fname.split("_")[-1]
                                        .split(".")[0]))
                            except (ValueError, IndexError):
                                pass
                        tmp_path = os.path.join(report_dir,
                                                "RESIZE.tmp")
                        with open(tmp_path, "w") as rf:
                            rf.write(str(max_seq + 2))
                        os.replace(tmp_path,
                                   os.path.join(report_dir, "RESIZE"))
                        grow_requested = True
                if ready and len(ready) < len(refs):
                    # GANG semantics: a rank that failed must abort the
                    # attempt NOW — waiting for the survivors to finish
                    # would let them run the rest of the job at the
                    # wrong world size. (Healthy early finishers pass
                    # through this get unharmed.)
                    ray_tpu_torch.get(ready)
                if len(ready) == len(refs):
                    outs = ray_tpu_torch.get(ready)  # surface worker exceptions
                    # resized only if a worker actually STOPPED for the
                    # resize; a loop that finished anyway is just done
                    resized = any(o == "__elastic_resize__"
                                  for o in outs)
                    break
            seen, latest_ckpt = self._drain_reports(
                report_dir, seen, history, latest_ckpt)
            metrics = history[-1] if history else {}
            return metrics, latest_ckpt, resized
        finally:
            try:
                seen, latest_ckpt = self._drain_reports(
                    report_dir, seen, history, latest_ckpt)
            except Exception:
                pass    # drain races the attempt's failure: keep the
                        # error that brought us here
            self._attempt_ckpt = latest_ckpt
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:
                    pass    # worker already dead
            remove_placement_group(pg)
            shutil.rmtree(report_dir, ignore_errors=True)

    def _drain_reports(self, report_dir: str, seen: set,
                       history: List[Dict[str, Any]],
                       latest_ckpt: Optional[Checkpoint]):
        # Track processed FILENAMES, not a count index: the listing is
        # rank-major sorted, so a fresh rank-0 report sorts before
        # already-counted rank>=1 files and a count index would skip it
        # forever (losing rank-0 metrics/checkpoints).
        files = sorted(glob.glob(os.path.join(report_dir, "report_*.pkl")))
        for path in files:
            name = os.path.basename(path)
            if name in seen:
                continue
            try:
                with open(path, "rb") as f:
                    payload = pickle.load(f)
            except (EOFError, pickle.UnpicklingError, FileNotFoundError):
                continue
            seen.add(name)
            if payload["rank"] == 0:
                history.append(payload["metrics"])
            if "checkpoint_path" in payload and payload["rank"] == 0:
                latest_ckpt = Checkpoint(payload["checkpoint_path"])
        return seen, latest_ckpt

    def _shard_datasets(self, n: int) -> List[Dict[str, List]]:
        """Split every dataset into n contiguous block lists (materialized
        — blocks ship to workers zero-copy through the shm store)."""
        shards: List[Dict[str, List]] = [dict() for _ in range(n)]
        for name, ds in self._datasets.items():
            blocks = list(ds.iter_blocks())
            from ray_tpu_torch.data import block as blib
            merged = blib.concat_blocks(blocks)
            rows = merged.num_rows
            per = rows // n
            for i in range(n):
                start = i * per
                end = rows if i == n - 1 else (i + 1) * per
                shards[i][name] = [blib.slice_block(merged, start, end)]
        return shards

