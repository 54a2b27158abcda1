"""The port's elastic training: the case of ``tests/test_elastic.py`` on
``ray_tpu_torch``. Losing a node mid-run shrinks the gang to the
survivors and training continues from the last checkpoint; returning
capacity grows it back at a checkpoint boundary. Its own tiny cluster
(a 1-CPU head without a card and one 1-CPU remote raylet).
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_elastic_train_shrink_and_regrow():
    """Elastic training (SURVEY §2.4 Train row, 'controller-based
    elastic'): losing a node mid-run shrinks the gang to the survivors
    and CONTINUES from the last checkpoint (no restart from epoch 0);
    when capacity returns the gang stops at the next checkpoint
    boundary and re-forms at full size."""
    import json
    import threading
    import time as _t

    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import (Checkpoint, DataParallelTrainer,
                               FailureConfig, RunConfig, ScalingConfig)

    cluster = Cluster(head_num_cpus=1, num_gpus=0)
    try:
        node_id = cluster.add_node(num_cpus=1, remote=True)

        def loop(config):
            import json
            import os
            import tempfile
            import time

            from ray_tpu_torch import train
            ctx = train.get_context()
            start = 0
            ck = train.get_checkpoint()
            if ck is not None:
                with open(os.path.join(ck.path, "state.json")) as f:
                    start = json.load(f)["epoch"] + 1
            for epoch in range(start, 14):
                time.sleep(0.3)
                d = tempfile.mkdtemp(prefix="el_ck_")
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"epoch": epoch}, f)
                train.report(
                    {"epoch": epoch,
                     "world_size": ctx.get_world_size()},
                    checkpoint=train.Checkpoint.from_directory(d))

        trainer = DataParallelTrainer(
            loop,
            scaling_config=ScalingConfig(num_workers=2, min_workers=1),
            run_config=RunConfig(
                failure_config=FailureConfig(max_failures=6)))

        box = {}

        def run():
            box["result"] = trainer.fit()

        t = threading.Thread(target=run)
        t.start()

        def wait_for(pred, timeout=150):
            deadline = _t.monotonic() + timeout
            while _t.monotonic() < deadline:
                if pred(getattr(trainer, "metrics_history", [])):
                    return True
                _t.sleep(0.1)
            return False

        # progress at full size first, then kill the node
        assert wait_for(lambda h: len(
            [m for m in h if m["world_size"] == 2]) >= 2), "no progress"
        cluster.kill_raylet_process(node_id)  # node loss
        # shrunken epochs prove continuation at N-1
        assert wait_for(lambda h: len(
            [m for m in h if m["world_size"] == 1]) >= 2), (
            f"never shrank: hist="
            f"{[(m['epoch'], m['world_size']) for m in trainer.metrics_history]} "
            f"fit_alive={t.is_alive()} box={box}")
        cluster.add_node(num_cpus=1, remote=True)  # capacity returns
        t.join(timeout=180)
        assert not t.is_alive(), "elastic fit never finished"
        result = box["result"]
        assert result.error is None, result.error
        hist = result.metrics_history
        sizes = [m["world_size"] for m in hist]
        epochs = [m["epoch"] for m in hist]
        assert 1 in sizes, f"gang never shrank: {sizes}"
        assert sizes[0] == 2 and sizes[-1] == 2, (
            f"gang never re-grew: {sizes}")
        # continuation, not restart: after the first few epochs, no
        # later report falls back to epoch 0
        first_kill_idx = sizes.index(1)
        assert first_kill_idx > 0
        assert min(epochs[first_kill_idx:]) >= epochs[first_kill_idx - 1], (
            f"training restarted from scratch: {epochs}")
        assert max(epochs) == 13
    finally:
        cluster.shutdown()
