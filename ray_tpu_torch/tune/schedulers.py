"""Trial schedulers: early stopping + population-based training.

Reference: ``python/ray/tune/schedulers/`` — ``ASHAScheduler``
(async successive halving), ``HyperBandScheduler``,
``MedianStoppingRule``, ``PopulationBasedTraining`` [UNVERIFIED —
mount empty, SURVEY.md §0].

The port's copy of ``ray_tpu/tune/schedulers.py``, unchanged: pure
Python and numpy, so the same seed and results give the same stop and
exploit decisions in both packages.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT only: restart this trial from another's checkpoint w/ new config
EXPLOIT = "EXPLOIT"


class TrialScheduler:
    def on_trial_result(self, trial, result: Dict) -> str:
        return CONTINUE

    def on_batch_result(self, items) -> Dict[Any, str]:
        """Decide over one controller sweep's worth of results.

        ``items`` is ``[(trial, result), ...]`` in arrival order. The
        default delegates to :meth:`on_trial_result` per item; rung-based
        schedulers override to record ALL arrivals before deciding, so
        concurrent trials hitting a rung in the same sweep are compared
        against each other deterministically (sync-SHA semantics within
        a sweep, async across sweeps).
        Returns {trial_id: worst decision for that trial}.
        """
        decisions: Dict[Any, str] = {}
        rank = {CONTINUE: 0, EXPLOIT: 1, STOP: 2}
        for trial, result in items:
            d = self.on_trial_result(trial, result)
            cur = decisions.get(trial.trial_id, CONTINUE)
            if rank[d] > rank[cur]:
                decisions[trial.trial_id] = d
            else:
                decisions.setdefault(trial.trial_id, cur)
        return decisions

    def on_trial_complete(self, trial, result: Optional[Dict]) -> None:
        pass

    def exploit_info(self, trial):
        """PBT: (source_trial, new_config) for EXPLOIT decisions."""
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Async successive halving: at each rung, only results in the top
    1/reduction_factor of that rung's recorded scores continue."""

    def __init__(self, *, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4, time_attr: str =
                 "training_iteration"):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self._rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self._rungs.append(t)
            t *= reduction_factor
        # rung level -> recorded scores
        self._recorded: Dict[int, List[float]] = defaultdict(list)

    def _score(self, result: Dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def _record(self, result: Dict) -> None:
        t = int(result.get(self.time_attr, 0))
        for rung in self._rungs:
            if t == rung:
                self._recorded[rung].append(self._score(result))

    def _decide(self, result: Dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return STOP
        score = self._score(result)
        for rung in self._rungs:
            if t == rung:
                recorded = self._recorded[rung]
                k = max(1, len(recorded) // self.rf)
                cutoff = sorted(recorded, reverse=True)[k - 1]
                if score < cutoff:
                    return STOP
        return CONTINUE

    def on_trial_result(self, trial, result: Dict) -> str:
        self._record(result)
        return self._decide(result)

    def on_batch_result(self, items) -> Dict[Any, str]:
        # Record every rung arrival in the sweep first, THEN decide:
        # without this, whichever trial reaches a rung first sets the
        # cutoff with its own score and sails through regardless of how
        # weak it is.
        for _, result in items:
            self._record(result)
        decisions: Dict[Any, str] = {}
        for trial, result in items:
            d = self._decide(result)
            if d == STOP or trial.trial_id not in decisions:
                decisions[trial.trial_id] = d
        return decisions


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running mean falls below the median of other
    trials' means at the same step."""

    def __init__(self, *, metric: str = "score", mode: str = "max",
                 grace_period: int = 1,
                 time_attr: str = "training_iteration",
                 min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.time_attr = time_attr
        self.min_samples = min_samples_required
        self._means: Dict[Any, List[float]] = defaultdict(list)

    def on_trial_result(self, trial, result: Dict) -> str:
        t = int(result.get(self.time_attr, 0))
        v = float(result[self.metric])
        if self.mode == "min":
            v = -v
        self._means[trial.trial_id].append(v)
        if t < self.grace or len(self._means) < self.min_samples:
            return CONTINUE
        my_mean = sum(self._means[trial.trial_id]) / len(
            self._means[trial.trial_id])
        others = [sum(vs) / len(vs) for tid, vs in self._means.items()
                  if tid != trial.trial_id and vs]
        if len(others) + 1 < self.min_samples:
            return CONTINUE
        others_sorted = sorted(others)
        median = others_sorted[len(others_sorted) // 2]
        return STOP if my_mean < median else CONTINUE


class HyperBandScheduler(ASHAScheduler):
    """v1: the asynchronous formulation (ASHA) with HyperBand's default
    knobs — the reference's own docs recommend ASHA over sync
    HyperBand for exactly this reason."""

    def __init__(self, *, metric: str = "score", mode: str = "max",
                 max_t: int = 81, reduction_factor: int = 3, **kw):
        super().__init__(metric=metric, mode=mode, max_t=max_t,
                         grace_period=1,
                         reduction_factor=reduction_factor, **kw)


class PopulationBasedTraining(TrialScheduler):
    """At each perturbation interval, bottom-quantile trials EXPLOIT a
    top-quantile trial: clone its checkpoint and mutate its config."""

    def __init__(self, *, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._latest: Dict[Any, Dict] = {}   # trial_id -> last result
        self._trials: Dict[Any, Any] = {}
        self._exploit: Dict[Any, Any] = {}   # trial_id -> (src, config)

    def _score_of(self, result: Dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial, result: Dict) -> str:
        self._latest[trial.trial_id] = result
        self._trials[trial.trial_id] = trial
        t = int(result.get(self.time_attr, 0))
        if t == 0 or t % self.interval != 0:
            return CONTINUE
        if len(self._latest) < 2:
            return CONTINUE
        ranked = sorted(self._latest.items(),
                        key=lambda kv: self._score_of(kv[1]))
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom = [tid for tid, _ in ranked[:k]]
        top = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id in bottom and top:
            src_id = self._rng.choice(top)
            if src_id != trial.trial_id:
                src = self._trials[src_id]
                new_cfg = self._mutate(dict(src.config))
                self._exploit[trial.trial_id] = (src, new_cfg)
                return EXPLOIT
        return CONTINUE

    def _mutate(self, config: Dict) -> Dict:
        from ray_tpu_torch.tune.search import Domain
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_p:
                if isinstance(spec, Domain):
                    config[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    config[key] = self._rng.choice(spec)
                elif callable(spec):
                    config[key] = spec()
            else:
                cur = config.get(key)
                if isinstance(cur, (int, float)):
                    factor = self._rng.choice([0.8, 1.2])
                    config[key] = type(cur)(cur * factor)
        return config

    def exploit_info(self, trial):
        return self._exploit.pop(trial.trial_id, None)


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference:
    ``python/ray/tune/schedulers/pb2.py``): PBT's exploit step, but the
    exploited trial's new hyperparameters come from a Gaussian-process
    model over (config → score improvement) observations instead of
    random perturbation — model-based, schedule-aware search within
    ``hyperparam_bounds``.

    The GP is a small exact RBF regressor (population-scale data: tens
    of points), maximized by UCB over sampled candidates; categorical/
    non-bounded params fall back to PBT mutation semantics when listed
    in ``hyperparam_mutations``.
    """

    def __init__(self, *, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 1.5,
                 num_candidates: int = 256,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction,
                         time_attr=time_attr, seed=seed)
        self.bounds: Dict[str, tuple] = dict(hyperparam_bounds or {})
        if not self.bounds:
            raise ValueError("PB2 needs hyperparam_bounds="
                             "{name: (low, high), ...}")
        self.kappa = ucb_kappa
        self.num_candidates = num_candidates
        self._keys = sorted(self.bounds)
        # GP data: normalized config vector -> score delta over one
        # perturbation interval
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._prev_score: Dict[Any, float] = {}

    def _normalize(self, config: Dict) -> List[float]:
        out = []
        for k in self._keys:
            lo, hi = self.bounds[k]
            v = float(config.get(k, lo))
            out.append((v - lo) / max(hi - lo, 1e-12))
        return out

    def on_trial_result(self, trial, result: Dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t and t % self.interval == 0:
            # record (config, delta score over the interval) for the GP
            score = self._score_of(result)
            prev = self._prev_score.get(trial.trial_id)
            if prev is not None:
                self._X.append(self._normalize(trial.config))
                self._y.append(score - prev)
                if len(self._X) > 200:       # bound the exact-GP solve
                    self._X = self._X[-200:]
                    self._y = self._y[-200:]
            self._prev_score[trial.trial_id] = score
        decision = super().on_trial_result(trial, result)
        if decision == EXPLOIT:
            # the trial restarts from the SOURCE's checkpoint: its next
            # interval delta would otherwise include the checkpoint
            # score jump and poison the GP's training targets
            self._prev_score.pop(trial.trial_id, None)
        return decision

    def _mutate(self, config: Dict) -> Dict:
        """Called by PBT's exploit path on the SOURCE trial's config:
        replace the bounded params with the GP-UCB argmax."""
        import numpy as np
        new = dict(config)
        rng = self._rng
        cand = np.asarray(
            [[rng.random() for _ in self._keys]
             for _ in range(self.num_candidates)])
        if len(self._y) >= 3:
            X = np.asarray(self._X)
            y = np.asarray(self._y, dtype=float)
            y_mean, y_std = y.mean(), max(y.std(), 1e-9)
            yn = (y - y_mean) / y_std
            ell, noise = 0.2, 1e-3

            def rbf(a, b):
                d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                return np.exp(-d2 / (2 * ell * ell))

            K = rbf(X, X) + noise * np.eye(len(X))
            try:
                L = np.linalg.cholesky(K)
                alpha = np.linalg.solve(
                    L.T, np.linalg.solve(L, yn))
                Ks = rbf(cand, X)
                mu = Ks @ alpha
                v = np.linalg.solve(L, Ks.T)
                var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
                ucb = mu + self.kappa * np.sqrt(var)
                best = cand[int(np.argmax(ucb))]
            except np.linalg.LinAlgError:
                best = cand[rng.randrange(len(cand))]
        else:
            # cold start: explore uniformly within bounds
            best = cand[rng.randrange(len(cand))]
        for k, u in zip(self._keys, best):
            lo, hi = self.bounds[k]
            val = lo + float(u) * (hi - lo)
            if isinstance(config.get(k), int):
                val = int(round(val))
            new[k] = val
        return new
