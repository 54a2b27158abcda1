"""The port's per-node agent plane: three cases of
``tests/test_node_agent.py`` on ``ray_tpu_torch`` (a task's stdout
captured and streamed to the driver, a remote raylet's worker output
tailed over its ``read_logs`` RPC, live stacks of the driver and its
workers). Its other four cases import ``dashboard``, ``util.state`` or
``scripts.cli``, which the port does not have yet.
"""

import time

import pytest
import torch

import ray_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    """The reference's fixture on the port: a small single-host runtime
    (2 process workers; 8 GPUs of resource, whose work runs on driver
    threads)."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    """The reference's fixture on the port: a CPU-only head (no card
    here) plus a helper for adding nodes."""
    from ray_tpu_torch.cluster_utils import Cluster
    cluster = Cluster(num_gpus=0, head_num_cpus=4)
    yield cluster
    cluster.shutdown()


def _wait_for(pred, timeout=20.0, period=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = pred()
        if result:
            return result
        time.sleep(period)
    return pred()



def test_worker_stdout_captured_and_streamed(ray_start_regular, capfd):
    """print() inside a task lands in the per-worker log file and the
    driver's log monitor forwards it to the driver's stderr."""
    @ray_tpu_torch.remote
    def speak():
        print("HELLO-FROM-WORKER-TASK")
        return 1

    assert ray_tpu_torch.get(speak.remote()) == 1

    w = ray_start_regular
    from ray_tpu_torch._private.log_monitor import (read_new_log_bytes,
                                              session_log_dir)
    # file capture
    def captured():
        _c, chunks = read_new_log_bytes(session_log_dir(w.session), None)
        return any("HELLO-FROM-WORKER-TASK" in text
                   for _f, text in chunks)
    assert _wait_for(captured)
    # driver streaming (the monitor thread polls every 0.5s)
    def streamed():
        return "HELLO-FROM-WORKER-TASK" in capfd.readouterr().err
    assert _wait_for(streamed, timeout=10)


def test_remote_raylet_read_logs_rpc(ray_start_cluster):
    """The done-criterion path: a remote raylet's worker output is
    tailed live over its read_logs RPC (what ``logs --follow`` and the
    driver's monitor use)."""
    cluster = ray_start_cluster
    node_id = cluster.add_node(num_cpus=2, resources={"R": 2},
                               remote=True)

    @ray_tpu_torch.remote(resources={"R": 1})
    def speak_remote():
        print("HELLO-FROM-REMOTE-NODE")
        return 42

    assert ray_tpu_torch.get(speak_remote.remote(), timeout=60) == 42

    handle = cluster._worker.node_group._remote_nodes[node_id]

    def tail():
        _cursor, chunks = handle.client.call("read_logs", {}, timeout=5)
        return any("HELLO-FROM-REMOTE-NODE" in text
                   for _f, text in chunks)
    assert _wait_for(tail, timeout=20)



def test_dump_stacks_local_and_api(ray_start_regular):
    @ray_tpu_torch.remote
    def stuck_a_bit():
        time.sleep(3.0)
        return 1

    ref = stuck_a_bit.remote()

    def dumped():
        stacks = ray_tpu_torch.dump_stacks()
        head = next(iter(stacks.values()))
        joined = "\n".join(head.values())
        # once the task started on a worker
        if "stuck_a_bit" in joined or "sleep" in joined:
            return stacks, head, joined
    found = _wait_for(dumped, timeout=20)
    assert found, "the task's frame never showed in a worker dump"
    stacks, head, joined = found
    assert "driver" in head
    # the sleeping task's frame should be visible in some worker dump
    assert "stuck_a_bit" in joined or "sleep" in joined, head.keys()
    assert ray_tpu_torch.get(ref, timeout=30) == 1


