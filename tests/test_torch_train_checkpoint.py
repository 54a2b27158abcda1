"""The checkpoint cases of ``tests/test_train.py`` under both packages'
Train core, one runtime at a time in this process, held to the same
values: a reported checkpoint resumed by a second ``fit``, and the gang
restarted from its last checkpoint after an injected failure. (Split
from ``test_torch_train.py`` to keep each file's time down.)"""

import os
import tempfile

import numpy as np
import torch

import ray_tpu_torch
from tests.test_torch_train import _few_threads, _run, _train  # noqa: F401


def test_checkpoint_report_and_restore(tmp_path):
    def scenario(rt):
        train = _train(rt)
        torch_side = rt is ray_tpu_torch

        def loop(config):
            ckpt = train.get_checkpoint()
            start = 0
            if ckpt is not None:
                state = train.load_pytree(ckpt.path)
                start = int(state["step"]) + 1
            for step in range(start, start + 2):
                d = tempfile.mkdtemp()
                if torch_side:
                    value = torch.tensor(step)
                else:
                    import jax.numpy as jnp
                    value = jnp.asarray(step)
                train.save_pytree({"step": value}, d)
                train.report({"step": step},
                             checkpoint=train.Checkpoint.from_directory(d))

        base = str(tmp_path / rt.__name__)
        res = train.DataParallelTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="ckpt_test",
                                       storage_path=base)).fit()
        assert res.error is None
        assert res.checkpoint is not None
        res2 = train.DataParallelTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="ckpt_test2", storage_path=base),
            resume_from_checkpoint=res.checkpoint).fit()
        assert res2.error is None
        return (res.metrics["step"], res2.metrics["step"],
                os.path.relpath(res.checkpoint.path, base),
                int(train.load_pytree(res2.checkpoint.path)["step"]))

    ref, got = _run(scenario)
    assert got[:2] == (1, 3)
    assert got == ref


def test_gang_restart_on_failure(tmp_path):
    def scenario(rt):
        train = _train(rt)
        marker = str(tmp_path / f"fail_once_{rt.__name__}")

        def loop(config):
            ckpt = train.get_checkpoint()
            start = 0
            if ckpt is not None:
                state = train.load_pytree(ckpt.path)
                start = int(state["step"]) + 1
            for step in range(start, 4):
                d = tempfile.mkdtemp()
                train.save_pytree({"step": np.asarray(step)}, d)
                train.report({"step": step, "restarted": start > 0},
                             checkpoint=train.Checkpoint.from_directory(d))
                if step == 1 and not os.path.exists(config["marker"]):
                    open(config["marker"], "w").close()
                    raise RuntimeError("injected failure")

        res = train.DataParallelTrainer(
            loop, train_loop_config={"marker": marker},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                storage_path=str(tmp_path / rt.__name__),
                failure_config=train.FailureConfig(max_failures=2))).fit()
        assert res.error is None
        return res.metrics, res.metrics_history

    (ref_m, ref_h), (got_m, got_h) = _run(scenario)
    assert got_m["step"] == 3 and got_m["restarted"] is True
    assert got_m == ref_m and got_h == ref_h
