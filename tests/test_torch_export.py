"""The port's event export: the cases of ``tests/test_export.py`` on
``ray_tpu_torch`` (task, actor and node event streams and the usage
summary of one session, and a remote raylet's node-membership event),
with the export directory in the session directory under ``TMPDIR``.
"""

import json
import os

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private.session_dir import session_dir


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_event_export_and_usage_stats():
    ray_tpu_torch.shutdown()
    from ray_tpu_torch._private.config import get_config

    # export is opt-in since the data-plane fast path (the TASK
    # stream costs two records per task on the hot path)
    w = ray_tpu_torch.init(num_gpus=0, num_cpus=4, max_process_workers=2,
                           _system_config={"event_export_enabled": True})
    export_dir = session_dir(w.session, "export")

    @ray_tpu_torch.remote
    def work(x):
        return x * 2

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    assert ray_tpu_torch.get([work.remote(i) for i in range(3)]) == [0, 2, 4]
    a = A.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    session = w.session
    ray_tpu_torch.shutdown()     # flushes the export buffers
    get_config().reset()   # event_export_enabled must not leak

    task_events = _read_jsonl(os.path.join(export_dir,
                                           "event_TASK.jsonl"))
    finished = [e for e in task_events if e["state"] == "FINISHED"]
    assert any("work" in e["name"] for e in finished)
    assert all("ts" in e for e in task_events)

    actor_events = _read_jsonl(os.path.join(export_dir,
                                            "event_ACTOR.jsonl"))
    states = {e["state"] for e in actor_events}
    assert {"REGISTERED", "ALIVE"} <= states

    node_events = _read_jsonl(os.path.join(export_dir,
                                           "event_NODE.jsonl"))
    assert any(e.get("event") == "ADDED" for e in node_events)

    usage = json.load(open(os.path.join(export_dir,
                                        "usage_stats.json")))
    assert usage["session"] == session
    assert usage["tasks_finished"] >= 4
    assert usage["actors_registered"] >= 1


def test_node_membership_export():
    ray_tpu_torch.shutdown()
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(num_gpus=0, head_num_cpus=4, _system_config={
        "event_export_enabled": True})
    try:
        w = cluster.worker
        export_dir = session_dir(w.session, "export")
        node_id = cluster.add_node(num_cpus=1, remote=True)
        from ray_tpu_torch._private import export
        export._writer.flush()
        events = _read_jsonl(os.path.join(export_dir,
                                          "event_NODE.jsonl"))
        assert any(e.get("event") == "ADDED"
                   and e.get("node_id") == node_id.hex()
                   for e in events)
    finally:
        cluster.shutdown()
        get_config().reset()
