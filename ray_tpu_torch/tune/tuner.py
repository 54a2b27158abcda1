"""Tuner + TuneController: trials as actors, schedulers deciding
promote/stop/exploit, resumable experiment state.

Reference: ``python/ray/tune/tuner.py`` +
``tune/execution/tune_controller.py`` + ``tune/experiment/trial.py``
[UNVERIFIED — mount empty, SURVEY.md §0]. Call stack mirrored from
SURVEY.md §3.5: suggest → acquire resources → trial actor → results
stream back → scheduler decision → checkpoint per trial →
experiment-state snapshot.

The port's copy of ``ray_tpu/tune/tuner.py``. A trial that asks for a
``GPU`` gets its actor with ``num_gpus``, so it runs on a thread of the
driver, which owns the cards; two ``{"GPU": 0.5}`` trials then share one
process, and each still sees only its own reports because Train's
session is keyed by the calling actor (``train/_session.py``). A
trial's report channel is an ``rtpt_trial_`` directory in the runtime's
session directory, removed when the trial ends.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import pickle
import shutil
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._session import TrainContext, init_session, \
    shutdown_session
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.trainer import RunConfig
from ray_tpu_torch.tune.schedulers import (
    CONTINUE,
    EXPLOIT,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher


def _trial_root() -> str:
    """The live runtime's session directory (created if need be), where
    the trials' report directories go."""
    from ray_tpu_torch._private.session_dir import session_dir
    from ray_tpu_torch._private.worker import global_worker
    root = session_dir(global_worker().session)
    os.makedirs(root, exist_ok=True)
    return root


@dataclasses.dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: int = 4
    metric: Optional[str] = None
    mode: str = "max"
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Searcher] = None
    trial_resources: Optional[Dict[str, float]] = None


class Trial:
    def __init__(self, trial_id: str, config: Dict):
        self.trial_id = trial_id
        self.config = config
        self.status = "PENDING"   # PENDING|RUNNING|TERMINATED|ERROR
        self.results: List[Dict] = []
        self.checkpoint: Optional[Checkpoint] = None
        self.error: Optional[str] = None
        self.actor = None
        self.run_ref = None
        self.report_dir: Optional[str] = None
        self.seen_reports: set = set()
        self.restore_from: Optional[Checkpoint] = None

    @property
    def last_result(self) -> Dict:
        return self.results[-1] if self.results else {}


@ray_tpu_torch.remote
class _TrialActor:
    def ping(self):
        return True

    def run(self, fn_blob: bytes, config: Dict, ctx_fields: dict):
        import cloudpickle
        from ray_tpu_torch.train._session import StopTrial
        ctx = TrainContext(**ctx_fields)
        ctx.config = config
        init_session(ctx)
        try:
            fn = cloudpickle.loads(fn_blob)
            out = fn(config)
            if isinstance(out, dict):
                # function returned final metrics without report()
                from ray_tpu_torch.train._session import report
                report(out)
            return True
        except StopTrial:
            return False  # controller-requested early stop; clean exit
        finally:
            shutdown_session()


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str, path: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode
        self.experiment_path = path

    def __len__(self):
        return len(self._trials)

    def __iter__(self):
        from ray_tpu_torch.train.trainer import Result
        for t in self._trials:
            yield Result(metrics=t.last_result, checkpoint=t.checkpoint,
                         path=self.experiment_path,
                         error=RuntimeError(t.error) if t.error else None,
                         metrics_history=t.results)

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None):
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set in TuneConfig or here)")
        best, best_v = None, None
        from ray_tpu_torch.train.trainer import Result
        for t in self._trials:
            vals = [r[metric] for r in t.results if metric in r]
            if not vals:
                continue
            v = max(vals) if mode == "max" else min(vals)
            if best_v is None or (v > best_v if mode == "max"
                                  else v < best_v):
                best, best_v = t, v
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        return Result(metrics=best.last_result, checkpoint=best.checkpoint,
                      path=self.experiment_path,
                      metrics_history=best.results)

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for t in self._trials:
            row = dict(t.last_result)
            row["trial_id"] = t.trial_id
            row.update({f"config/{k}": v for k, v in t.config.items()})
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()

    def _experiment_dir(self) -> str:
        base = (self._run_config.storage_path
                or os.path.join(tempfile.gettempdir(),
                                "ray_tpu_torch_results"))
        name = self._run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        path = os.path.join(base, name)
        os.makedirs(path, exist_ok=True)
        return path

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        search = tc.search_alg or BasicVariantGenerator(
            self._param_space, num_samples=tc.num_samples)
        scheduler = tc.scheduler or FIFOScheduler()
        exp_dir = self._experiment_dir()
        controller = TuneController(
            trainable=self._trainable, search=search, scheduler=scheduler,
            max_concurrent=tc.max_concurrent_trials,
            resources=tc.trial_resources or {"CPU": 1.0},
            exp_dir=exp_dir)
        trials = controller.run()
        self._snapshot(exp_dir, trials)
        return ResultGrid(trials, tc.metric, tc.mode, exp_dir)

    def _snapshot(self, exp_dir: str, trials: List[Trial]) -> None:
        state = [{
            "trial_id": t.trial_id, "config": t.config,
            "status": t.status, "results": t.results,
            "checkpoint": t.checkpoint.path if t.checkpoint else None,
            "error": t.error,
        } for t in trials]
        with open(os.path.join(exp_dir, "experiment_state.json"),
                  "w") as f:
            json.dump(state, f, default=str)

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                metric: Optional[str] = None, mode: str = "max"
                ) -> ResultGrid:
        """Load a finished/interrupted experiment's state."""
        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        trials = []
        for s in state:
            t = Trial(s["trial_id"], s["config"])
            t.status = s["status"]
            t.results = s["results"]
            t.error = s.get("error")
            if s.get("checkpoint"):
                t.checkpoint = Checkpoint(s["checkpoint"])
            trials.append(t)
        return ResultGrid(trials, metric, mode, path)


class TuneController:
    """The event loop: start trials up to the concurrency cap, poll
    their report streams, apply scheduler decisions."""

    def __init__(self, trainable, search: Searcher,
                 scheduler: TrialScheduler, max_concurrent: int,
                 resources: Dict[str, float], exp_dir: str):
        import cloudpickle
        self._fn_blob = cloudpickle.dumps(trainable)
        self._search = search
        self._scheduler = scheduler
        self._max_concurrent = max_concurrent
        self._resources = resources
        self._exp_dir = exp_dir
        self._counter = 0

    def run(self) -> List[Trial]:
        trials: List[Trial] = []
        running: List[Trial] = []
        exhausted = False
        while True:
            # refill — two-phase so a refill batch starts CONCURRENTLY:
            # worker spawn takes seconds per actor, and letting trial 0
            # race ahead while trial 1's worker boots would make rung
            # comparisons (and thus early stopping) arrival-order luck.
            new_batch: List[Trial] = []
            while not exhausted and \
                    len(running) + len(new_batch) < self._max_concurrent:
                trial = self._next_trial()
                if trial is None:
                    exhausted = True
                    break
                trials.append(trial)
                self._start_actor(trial)
                new_batch.append(trial)
            if new_batch:
                # Wait for the batch's workers to spawn, but keep
                # draining/acking the already-running trials meanwhile —
                # a blocking get here would stall their sync reports
                # into the 30s free-run fallback.
                pings = [t.actor.ping.remote() for t in new_batch]
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    ready, pending = ray_tpu_torch.wait(
                        pings, num_returns=len(pings), timeout=0.05)
                    for t in running:
                        self._drain(t)
                    if not pending:
                        break
                for trial in new_batch:
                    self._submit_run(trial)
                    running.append(trial)
            if not running and exhausted:
                break
            # poll (short interval: trials block on report acks, so the
            # controller's cadence gates trial progress)
            refs = [t.run_ref for t in running]
            ray_tpu_torch.wait(refs, num_returns=1, timeout=0.02)
            # Sweep: drain ALL trials' reports first so one sweep's
            # rung arrivals are decided against each other, not in
            # trial order.
            done_flags = {}
            for t in running:
                self._drain(t)
                done_flags[t.trial_id] = self._check_done(t)
            batch = []
            for t in running:
                for metrics in getattr(t, "_new_results", []):
                    batch.append((t, metrics))
                t._new_results = []
            # Scheduler sees every result — including those drained at
            # completion — so rung bookkeeping stays consistent.
            decisions = (self._scheduler.on_batch_result(batch)
                         if batch else {})
            still: List[Trial] = []
            for t in running:
                decision = decisions.get(t.trial_id, CONTINUE)
                if done_flags[t.trial_id]:
                    self._complete(t)
                elif decision == STOP:
                    self._stop_trial(t, "TERMINATED")
                elif decision == EXPLOIT:
                    self._exploit(t)
                    still.append(t)
                else:
                    still.append(t)
            running = still
        return trials

    def _next_trial(self) -> Optional[Trial]:
        trial_id = f"trial_{self._counter:05d}"
        config = self._search.suggest(trial_id)
        if config is None:
            return None
        self._counter += 1
        return Trial(trial_id, config)

    def _start_actor(self, trial: Trial) -> None:
        kw: Dict[str, Any] = {}
        if "CPU" in self._resources:
            kw["num_cpus"] = self._resources["CPU"]
        if "GPU" in self._resources:
            kw["num_gpus"] = self._resources["GPU"]
        trial.report_dir = tempfile.mkdtemp(prefix="rtpt_trial_",
                                            dir=_trial_root())
        trial.seen_reports = set()
        trial.actor = _TrialActor.options(**kw).remote()

    def _submit_run(self, trial: Trial) -> None:
        trial_dir = os.path.join(self._exp_dir, trial.trial_id)
        os.makedirs(trial_dir, exist_ok=True)
        ctx_fields = dict(world_size=1, rank=0,
                          trial_dir=trial_dir,
                          report_dir=trial.report_dir,
                          sync_reports=True,
                          latest_checkpoint=trial.restore_from)
        trial.run_ref = trial.actor.run.remote(
            self._fn_blob, trial.config, ctx_fields)
        trial.status = "RUNNING"

    def _start(self, trial: Trial) -> None:
        self._start_actor(trial)
        self._submit_run(trial)

    def _drain(self, trial: Trial) -> None:
        if not trial.report_dir or not os.path.isdir(trial.report_dir):
            return
        files = sorted(glob.glob(
            os.path.join(trial.report_dir, "report_*.pkl")))
        for path in files:
            name = os.path.basename(path)
            if name in trial.seen_reports:
                continue
            try:
                with open(path, "rb") as f:
                    payload = pickle.load(f)
            except (EOFError, pickle.UnpicklingError, FileNotFoundError):
                continue
            trial.seen_reports.add(name)
            metrics = payload["metrics"]
            metrics.setdefault("training_iteration",
                               len(trial.results) + 1)
            trial.results.append(metrics)
            if "checkpoint_path" in payload:
                trial.checkpoint = Checkpoint(payload["checkpoint_path"])
            trial._new_results = getattr(trial, "_new_results", [])
            trial._new_results.append(metrics)
            # Ack so the (sync_reports) trial may proceed past this
            # report; written after processing so scheduler state is
            # never behind the trial by more than one in-flight report.
            try:
                with open(path + ".ack", "w"):
                    pass
            except OSError:
                pass

    def _check_done(self, trial: Trial) -> bool:
        ready, _ = ray_tpu_torch.wait([trial.run_ref], num_returns=1, timeout=0)
        if not ready:
            return False
        self._drain(trial)
        try:
            ray_tpu_torch.get(trial.run_ref)
            trial.status = "TERMINATED"
        except Exception as e:
            trial.status = "ERROR"
            trial.error = str(e)
        return True

    def _complete(self, trial: Trial) -> None:
        self._search.on_trial_complete(trial.trial_id, trial.last_result,
                                       error=trial.status == "ERROR")
        self._scheduler.on_trial_complete(trial, trial.last_result)
        self._cleanup_actor(trial)

    def _stop_trial(self, trial: Trial, status: str) -> None:
        # Stop token first: a trial blocked in report() raises StopTrial
        # and unwinds cleanly before the actor is killed.
        if trial.report_dir and os.path.isdir(trial.report_dir):
            try:
                with open(os.path.join(trial.report_dir, "STOP"), "w"):
                    pass
            except OSError:
                pass
        ray_tpu_torch.wait([trial.run_ref], num_returns=1, timeout=1.0)
        trial.status = status
        self._cleanup_actor(trial)
        self._search.on_trial_complete(trial.trial_id, trial.last_result,
                                       error=False)
        self._scheduler.on_trial_complete(trial, trial.last_result)

    def _exploit(self, trial: Trial) -> None:
        """PBT: restart this trial from the exploit target's checkpoint
        with the mutated config."""
        info = self._scheduler.exploit_info(trial)
        if info is None:
            return
        src, new_config = info
        self._cleanup_actor(trial)
        trial.config = new_config
        trial.restore_from = src.checkpoint
        self._start(trial)

    def _cleanup_actor(self, trial: Trial) -> None:
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass    # trial actor already dead
            trial.actor = None
        if trial.report_dir:
            shutil.rmtree(trial.report_dir, ignore_errors=True)
