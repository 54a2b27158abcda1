"""The port's Tune (``ray_tpu_torch/tune``) against the JAX package's: the
cases of ``tests/test_tune.py`` that run the Tuner (grid and random
search, samples and the dataframe; ASHA, a trial's error and restore are
in ``test_torch_tune_tuner.py``), each under both packages' runtimes and
held to the reference's assertions and, where a seed fixes them, to its
values; the searchers and
schedulers, which are pure Python and numpy, held exactly: the same seed
and the same results give the same suggestions, stop decisions, exploit
sources and mutated configs, with no runtime. The reference's slow
search-quality cases (TPE through the Tuner, PBT, PB2) run on the port
alone in ``test_torch_tune_search.py``, under the reference's
assertions.

Beyond the reference's cases: two ``{"GPU": 0.5}`` trials at once, which
run on threads of the driver, each see only their own reports."""

import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from tests.test_torch_data import (  # noqa: F401
    LIVE, PACKAGES, _few_threads, _live, mod)


def tune_of(rt):
    return mod(rt, "tune")


def both(scenario):
    LIVE.ensure()
    return [scenario(rt, tune_of(rt)) for rt, _ in PACKAGES]


def _tpe_run(tune, seed):
    space = {"x": tune.uniform(-5, 5), "kind": tune.choice(["a", "b"]),
             "lr": tune.loguniform(1e-4, 1e0)}
    searcher = tune.TPESearch(space, metric="loss", mode="min",
                              num_samples=60, n_initial_points=10, seed=seed)
    suggested = []
    for i in range(60):
        cfg = searcher.suggest(f"t{i}")
        assert cfg is not None
        loss = ((cfg["x"] - 2.0) ** 2
                + (0.0 if cfg["kind"] == "a" else 5.0)
                + abs(np.log10(cfg["lr"]) + 2.0))   # optimum lr=1e-2
        searcher.on_trial_complete(f"t{i}", {"loss": loss})
        suggested.append(cfg)
    return suggested, searcher.suggest("t-done")


def test_tpe_search_concentrates_on_optimum():
    """Model-based search: after warmup, TPE suggestions cluster near
    the best region (continuous + categorical + log dims); the port's
    searcher makes the reference's 60 suggestions exactly."""
    ref, done_ref = _tpe_run(tune_of(ray_tpu), 3)
    suggested, done = _tpe_run(tune_of(ray_tpu_torch), 3)
    assert done is None and done_ref is None       # budget exhausted
    early = suggested[:10]
    late = suggested[-20:]
    err_early = np.mean([abs(c["x"] - 2.0) for c in early])
    err_late = np.mean([abs(c["x"] - 2.0) for c in late])
    assert err_late < err_early, (err_early, err_late)
    assert sum(1 for c in late if c["kind"] == "a") >= 14
    assert suggested == ref


def test_variant_generator_matches_the_reference():
    def variants(tune):
        space = {"a": tune.grid_search([1, 2, 3]),
                 "b": tune.uniform(0, 1), "c": tune.randint(0, 100),
                 "d": tune.quniform(0, 10, 0.5),
                 "e": tune.sample_from(lambda cfg: cfg["a"] * 2),
                 "f": "fixed"}
        gen = tune.BasicVariantGenerator(space, num_samples=4, seed=11)
        out = []
        while True:
            cfg = gen.suggest(f"t{len(out)}")
            if cfg is None:
                return gen.total, out
            out.append(cfg)

    ref, got = variants(tune_of(ray_tpu)), variants(tune_of(ray_tpu_torch))
    assert got[0] == 12 and got == ref


class _Trial:
    def __init__(self, trial_id, config):
        self.trial_id, self.config = trial_id, config


def _drive(tune, make):
    """Feed one scheduler a fixed stream of 6 trials' results, 12
    iterations each, in sweeps of one iteration, as the controller
    does; a stopped trial reports no more, an exploiting trial takes
    its source's mutated config. Returns every decision and exploit."""
    sched = make(tune)
    trials = [_Trial(f"trial_{i:05d}", {"lr": 0.05 + 0.17 * i, "w": i})
              for i in range(6)]
    rng = np.random.RandomState(0)
    alive = {t.trial_id for t in trials}
    log = []
    for it in range(1, 13):
        batch = []
        for t in trials:
            if t.trial_id in alive:
                score = t.config["lr"] * it + 0.1 * rng.standard_normal()
                batch.append((t, {"score": float(score),
                                  "training_iteration": it}))
        decisions = sched.on_batch_result(batch)
        for t, _ in batch:
            d = decisions.get(t.trial_id, "CONTINUE")
            entry = [it, t.trial_id, d]
            if d == "STOP":
                alive.discard(t.trial_id)
                sched.on_trial_complete(t, None)
            elif d == "EXPLOIT":
                info = sched.exploit_info(t)
                if info is not None:
                    src, cfg = info
                    t.config = cfg
                    entry += [src.trial_id, cfg]
            log.append(entry)
    return log


SCHEDULERS = {
    "asha": lambda tune: tune.ASHAScheduler(
        metric="score", mode="max", max_t=12, grace_period=2,
        reduction_factor=2),
    "hyperband": lambda tune: tune.HyperBandScheduler(
        metric="score", mode="max", max_t=12),
    "median": lambda tune: tune.MedianStoppingRule(
        metric="score", mode="max", grace_period=2),
    "pbt": lambda tune: tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0),
                              "w": [1, 2, 3]}, seed=5),
    "pb2": lambda tune: tune.PB2(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_bounds={"lr": (0.0, 1.0)}, seed=5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_match_the_reference(name):
    ref = _drive(tune_of(ray_tpu), SCHEDULERS[name])
    got = _drive(tune_of(ray_tpu_torch), SCHEDULERS[name])
    assert got == ref
    decided = {entry[2] for entry in got}
    if name in ("asha", "hyperband", "median"):
        assert "STOP" in decided, got
    if name in ("pbt", "pb2"):
        assert "EXPLOIT" in decided, got


def test_grid_and_random_search():
    def scenario(rt, tune):
        def trainable(config):
            tune.report({"score": config["a"] * 10 + config["b"]})

        grid = tune.Tuner(
            trainable,
            param_space={"a": tune.grid_search([1, 2, 3]),
                         "b": tune.uniform(0, 1)},
            tune_config=tune.TuneConfig(metric="score", mode="max",
                                        max_concurrent_trials=3)).fit()
        return len(grid), grid.get_best_result().metrics["score"]

    ref, got = both(scenario)
    assert got[0] == 3 == ref[0]
    assert got[1] > 30 and ref[1] > 30


def test_num_samples_and_dataframe():
    def scenario(rt, tune):
        def trainable(config):
            tune.report({"score": config["x"] ** 2})

        grid = tune.Tuner(
            trainable, param_space={"x": tune.uniform(-1, 1)},
            tune_config=tune.TuneConfig(num_samples=5, metric="score",
                                        mode="min")).fit()
        df = grid.get_dataframe()
        return len(grid), len(df), sorted(df.columns)

    ref, got = both(scenario)
    assert got[0] == 5 and got[1] == 5 and "config/x" in got[2]
    assert got == ref


def test_gpu_half_trials_see_only_their_own_reports(tmp_path):
    """Two ``{"GPU": 0.5}`` trials at once run on threads of the driver;
    Train's session is keyed by the calling actor, so each trial's
    reports carry its own config, step by step, and its report channel
    (an ``rtpt_trial_`` directory in the session directory) is gone when
    it ends."""
    import json
    LIVE.stop()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1, max_process_workers=1)
    try:
        tune = tune_of(ray_tpu_torch)
        session = mod(ray_tpu_torch, "_private.worker").global_worker()\
            .session
        root = mod(ray_tpu_torch, "_private.session_dir").session_dir(
            session)
        out_dir = str(tmp_path)

        def trainable(config):
            import threading
            import time

            from ray_tpu_torch import train
            ctx = train.get_context()
            with open(os.path.join(out_dir, f"{config['k']}.json"),
                      "w") as f:
                json.dump([os.getpid(), threading.get_ident(),
                           ctx.report_dir], f)
            for i in range(1, 7):
                time.sleep(0.01)
                tune.report({"k": config["k"], "i": i,
                             "score": config["k"] * 100 + i,
                             "training_iteration": i})

        grid = tune.Tuner(
            trainable, param_space={"k": tune.grid_search([1, 2])},
            tune_config=tune.TuneConfig(
                metric="score", mode="max", max_concurrent_trials=2,
                trial_resources={"GPU": 0.5})).fit()
        leftover = [d for d in os.listdir(root)
                    if d.startswith("rtpt_trial_")]
    finally:
        ray_tpu_torch.shutdown()
    assert not grid.errors, grid.errors
    results = sorted(grid, key=lambda r: r.metrics["k"])
    for k, res in zip((1, 2), results):
        assert [m["k"] for m in res.metrics_history] == [k] * 6
        assert [m["i"] for m in res.metrics_history] == list(range(1, 7))
    seen = {}
    for k in (1, 2):
        with open(tmp_path / f"{k}.json") as f:
            seen[k] = json.load(f)
    # both ran on threads of this process, each with its own channel
    assert {v[0] for v in seen.values()} == {os.getpid()}
    assert seen[1][1] != seen[2][1] and seen[1][2] != seen[2][2]
    assert all(os.path.basename(v[2]).startswith("rtpt_trial_")
               and os.path.dirname(v[2]) == root for v in seen.values())
    assert leftover == []
