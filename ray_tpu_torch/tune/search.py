"""Search space + trial generation.

Reference: ``python/ray/tune/search/`` — ``BasicVariantGenerator``
(grid + random sampling), sample domains (``tune.choice/uniform/
loguniform/randint/grid_search``) [UNVERIFIED — mount empty,
SURVEY.md §0]. External searchers (Optuna, HyperOpt, ...) plug in at
the ``Searcher`` seam; none of those libraries are vendored here.

The port's copy of ``ray_tpu/tune/search.py``, unchanged: pure Python
and numpy, so the same seed gives the same suggestions in both packages.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Choice(Domain):
    values: List[Any]

    def sample(self, rng):
        return rng.choice(self.values)


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        import math
        return math.exp(rng.uniform(math.log(self.low),
                                    math.log(self.high)))


@dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class QUniform(Domain):
    low: float
    high: float
    q: float

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return round(v / self.q) * self.q


@dataclass
class GridSearch:
    values: List[Any]


def choice(values): return Choice(list(values))
def uniform(low, high): return Uniform(low, high)
def loguniform(low, high): return LogUniform(low, high)
def randint(low, high): return RandInt(low, high)
def quniform(low, high, q): return QUniform(low, high, q)
def grid_search(values): return GridSearch(list(values))


def sample_from(fn: Callable[[Dict], Any]):
    return _SampleFrom(fn)


@dataclass
class _SampleFrom:
    fn: Callable


class Searcher:
    """Seam for pluggable search algorithms."""

    def suggest(self, trial_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[Dict],
                          error: bool = False) -> None:
        pass


class TPESearch(Searcher):
    """Tree-structured Parzen Estimator search.

    Reference role: the model-based searchers (``OptunaSearch``/
    ``HyperOptSearch`` — both TPE under the hood) behind the same
    Searcher seam [UNVERIFIED — mount empty, SURVEY.md §0]. Homegrown
    numpy TPE: after ``n_initial_points`` random draws, completed
    trials split into good/bad by ``gamma`` quantile; candidates are
    sampled from the good-trial kernel density and scored by the
    density ratio l(x)/g(x); the best of ``n_candidates`` is suggested.
    Continuous domains model in (optionally log) space with per-point
    Gaussian kernels; categorical domains use smoothed category counts.
    """

    def __init__(self, param_space: Dict, metric: str, mode: str = "min",
                 num_samples: int = 64, n_initial_points: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        for key, dom in param_space.items():
            if isinstance(dom, (GridSearch, _SampleFrom)):
                raise ValueError(
                    f"TPESearch supports Domain parameters only; "
                    f"{key!r} is {type(dom).__name__}")
        self._space = param_space
        self._metric = metric
        self._mode = mode
        self._num_samples = num_samples
        self._n_initial = n_initial_points
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._suggested = 0
        self._configs: Dict[str, Dict] = {}
        self._scores: Dict[str, float] = {}

    @property
    def total(self) -> int:
        return self._num_samples

    def on_trial_complete(self, trial_id, result, error=False):
        if error or not result or self._metric not in result:
            self._configs.pop(trial_id, None)
            return
        score = float(result[self._metric])
        self._scores[trial_id] = (score if self._mode == "min"
                                  else -score)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._suggested >= self._num_samples:
            return None
        self._suggested += 1
        done = [tid for tid in self._scores if tid in self._configs]
        if len(done) < self._n_initial:
            cfg = self._random_config()
        else:
            cfg = self._tpe_config(done)
        self._configs[trial_id] = cfg
        return dict(cfg)

    # -- internals -----------------------------------------------------

    def _random_config(self) -> Dict:
        return {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                for k, v in self._space.items()}

    def _tpe_config(self, done: List[str]) -> Dict:
        import numpy as np
        ranked = sorted(done, key=lambda t: self._scores[t])
        n_good = max(1, int(len(ranked) * self._gamma))
        good = [self._configs[t] for t in ranked[:n_good]]
        bad = [self._configs[t] for t in ranked[n_good:]] or good

        best_cfg, best_score = None, -np.inf
        for _ in range(self._n_candidates):
            cand: Dict[str, Any] = {}
            logratio = 0.0
            for key, dom in self._space.items():
                if not isinstance(dom, Domain):
                    cand[key] = dom
                    continue
                value, lr = self._sample_dim(dom, key, good, bad)
                cand[key] = value
                logratio += lr
            if logratio > best_score:
                best_cfg, best_score = cand, logratio
        return best_cfg

    def _sample_dim(self, dom: Domain, key: str, good: List[Dict],
                    bad: List[Dict]):
        import numpy as np
        if isinstance(dom, Choice):
            values = dom.values
            counts_g = np.ones(len(values))
            counts_b = np.ones(len(values))
            for cfg in good:
                counts_g[values.index(cfg[key])] += 1
            for cfg in bad:
                counts_b[values.index(cfg[key])] += 1
            p_g = counts_g / counts_g.sum()
            p_b = counts_b / counts_b.sum()
            idx = int(self._rng.choices(range(len(values)),
                                        weights=p_g)[0])
            return values[idx], float(np.log(p_g[idx] / p_b[idx]))
        # continuous / integer: Parzen mixture over good observations
        log_space = isinstance(dom, LogUniform)
        lo = np.log(dom.low) if log_space else float(dom.low)
        hi = np.log(dom.high) if log_space else float(dom.high)

        def xform(v):
            return np.log(v) if log_space else float(v)

        obs_g = np.array([xform(cfg[key]) for cfg in good])
        obs_b = np.array([xform(cfg[key]) for cfg in bad])
        bw = max((hi - lo) / max(len(obs_g), 1) * 1.5, (hi - lo) * 0.05)

        def density(x, obs):
            if len(obs) == 0:
                return 1.0 / (hi - lo)
            z = (x - obs) / bw
            return float(np.mean(np.exp(-0.5 * z * z))
                         / (bw * np.sqrt(2 * np.pi))) + 1e-12

        center = obs_g[self._rng.randrange(len(obs_g))]
        x = self._rng.gauss(float(center), bw)
        x = min(max(x, lo), hi)
        lr = float(np.log(density(x, obs_g) / density(x, obs_b)))
        value = float(np.exp(x)) if log_space else float(x)
        if isinstance(dom, RandInt):
            value = int(round(value))
            value = min(max(value, dom.low), dom.high - 1)
        elif isinstance(dom, QUniform):
            value = round(value / dom.q) * dom.q
        return value, lr


class BasicVariantGenerator(Searcher):
    """Cross-product of grid axes × num_samples random draws."""

    def __init__(self, param_space: Dict, num_samples: int = 1,
                 seed: Optional[int] = None):
        self._space = param_space
        self._num_samples = num_samples
        self._rng = random.Random(seed)
        self._variants = self._expand()
        self._idx = 0

    def _expand(self) -> List[Dict]:
        grid_keys = [k for k, v in self._space.items()
                     if isinstance(v, GridSearch)]
        grids = [self._space[k].values for k in grid_keys]
        out: List[Dict] = []
        for combo in itertools.product(*grids) if grids else [()]:
            for _ in range(self._num_samples):
                cfg: Dict[str, Any] = {}
                for k, v in self._space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    elif isinstance(v, _SampleFrom):
                        cfg[k] = v.fn(cfg)
                    else:
                        cfg[k] = v
                out.append(cfg)
        return out

    @property
    def total(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._idx >= len(self._variants):
            return None
        cfg = self._variants[self._idx]
        self._idx += 1
        return cfg
