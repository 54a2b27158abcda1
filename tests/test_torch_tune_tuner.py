"""The Tuner cases of ``tests/test_tune.py`` continued from
``tests/test_torch_tune.py`` (whose helpers it shares): ASHA stopping
weak trials, a trial's error captured, and an experiment restored from
its state, each under both packages' runtimes and held to the
reference's assertions and values."""

import pytest

from tests.test_torch_data import _few_threads, _live, mod  # noqa: F401
from tests.test_torch_tune import both


def test_asha_stops_bad_trials():
    def scenario(rt, tune):
        def trainable(config):
            for i in range(1, 9):
                tune.report({"score": config["lr"] * i,
                             "training_iteration": i})

        sched = tune.ASHAScheduler(metric="score", mode="max", max_t=8,
                                   grace_period=2, reduction_factor=2)
        grid = tune.Tuner(
            trainable,
            param_space={"lr": tune.grid_search([0.1, 0.5, 1.0, 2.0])},
            tune_config=tune.TuneConfig(metric="score", mode="max",
                                        scheduler=sched,
                                        max_concurrent_trials=4)).fit()
        return (grid.get_best_result().metrics["score"],
                [len(r.metrics_history) for r in grid])

    ref, got = both(scenario)
    assert got[0] == pytest.approx(2.0 * 8) == ref[0]
    # at least one weak trial got fewer than max_t results
    assert min(got[1]) < 8 and min(ref[1]) < 8


def test_trial_error_is_captured():
    def scenario(rt, tune):
        def trainable(config):
            if config["x"] == 1:
                raise ValueError("boom")
            tune.report({"score": 1.0})

        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([0, 1])},
            tune_config=tune.TuneConfig(metric="score", mode="max")).fit()
        return len(grid.errors), grid.get_best_result().metrics["score"]

    ref, got = both(scenario)
    assert got == (1, 1.0) == ref


def test_tuner_restore(tmp_path):
    def scenario(rt, tune):
        def trainable(config):
            tune.report({"score": config["x"]})

        run = mod(rt, "train.trainer").RunConfig(
            name="exp1", storage_path=str(tmp_path / rt.__name__))
        tune.Tuner(
            trainable, param_space={"x": tune.grid_search([1, 2])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=run).fit()
        grid = tune.Tuner.restore(str(tmp_path / rt.__name__ / "exp1"),
                                  trainable, metric="score", mode="max")
        return len(grid), grid.get_best_result().metrics["score"]

    ref, got = both(scenario)
    assert got == (2, 2) == ref
