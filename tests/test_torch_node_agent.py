"""The port's per-node agent plane: the 7 cases of
``tests/test_node_agent.py`` on ``ray_tpu_torch`` (a task's stdout
captured and streamed to the driver, a remote raylet's worker output
tailed over its ``read_logs`` RPC, live stacks of the driver and its
workers; and, through ``dashboard``, ``util.state`` and ``scripts.cli``,
per-node series on ``/metrics``, heartbeat stats in the nodes table,
worker RSS, and ``stack`` against a remote raylet).
"""

import time
import urllib.request

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


def test_metrics_include_per_node_series(ray_start_cluster):
    """/metrics exposes per-node resource + stats series with a node
    label, covering the head and every heartbeating remote raylet."""
    cluster = ray_start_cluster
    node_id = cluster.add_node(num_cpus=2, resources={"R": 2},
                               remote=True)

    @ray_tpu_torch.remote(resources={"R": 1})
    def touch():
        return 1

    assert ray_tpu_torch.get(touch.remote(), timeout=60) == 1

    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
    host, port = start_dashboard()
    try:
        head_hex = cluster.head_node_id.hex()[:12]
        remote_hex = node_id.hex()[:12]

        def scrape():
            body = urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=5).read().decode()
            return body if (
                "ray_tpu_node_resource_available" in body
                and head_hex in body and remote_hex in body
                and "ray_tpu_node_stat" in body) else None

        body = _wait_for(scrape, timeout=25)
        assert body, "per-node series missing from /metrics"
        # remote stats arrive via heartbeat: look for its stat series
        assert f'node="{remote_hex}"' in body
    finally:
        stop_dashboard()

def test_state_api_nodes_carry_stats(ray_start_cluster):
    cluster = ray_start_cluster
    node_id = cluster.add_node(num_cpus=2, remote=True)
    from ray_tpu_torch.util import state

    def has_stats():
        for row in state.list_nodes():
            if row["node_id"] == node_id.hex() and row["stats"]:
                return row["stats"]
        return None
    stats = _wait_for(has_stats, timeout=25)
    assert stats and "running_tasks" in stats and "workers" in stats

def test_worker_rss_in_metrics_and_nodes_table(ray_start_regular):
    @ray_tpu_torch.remote
    def touch():
        return 1

    assert ray_tpu_torch.get(touch.remote()) == 1   # ensure a worker exists
    from ray_tpu_torch.util import metrics
    text = metrics.prometheus_text()
    assert "ray_tpu_worker_rss_bytes" in text
    assert 'worker="driver"' in text

    from ray_tpu_torch.util.state import list_nodes
    rows = list_nodes()
    head = next(r for r in rows if r["is_head"])
    assert head["stats"].get("workers_rss_bytes", 0) > 0
    assert head["stats"].get("worker_rss")   # per-worker map present

def test_stack_cli_against_remote_raylet(ray_start_cluster):
    """Done-criterion: `ray_tpu_torch stack <node>` returns LIVE stacks from
    a remote raylet process over its dump_stacks RPC."""
    cluster = ray_start_cluster
    node_id = cluster.add_node(num_cpus=2, resources={"S": 2},
                               remote=True)

    @ray_tpu_torch.remote(resources={"S": 1})
    def napper():
        time.sleep(3.0)
        return "ok"

    ref = napper.remote()
    time.sleep(1.5)                 # task running on the remote node

    import io
    from contextlib import redirect_stdout
    from ray_tpu_torch._private import rpc as _rpc
    from ray_tpu_torch.scripts.cli import main as cli_main
    host, port = cluster.gcs_address

    # retry: under full-suite load the raylet's GCS registration /
    # worker spawn can lag the fixed sleep above
    rc, out = 1, ""
    deadline = time.monotonic() + 45
    while time.monotonic() < deadline:
        buf = io.StringIO()
        try:
            with redirect_stdout(buf):
                rc = cli_main(["stack", "--address", f"{host}:{port}",
                               "--node", node_id.hex()[:12],
                               "--token", _rpc.get_session_token() or ""])
        except Exception as e:   # raylet RPC server not accepting yet
            rc, out = 1, repr(e)
            time.sleep(1.0)
            continue
        out = buf.getvalue()
        if rc == 0 and "raylet" in out and "thread" in out:
            break
        time.sleep(1.0)
    assert rc == 0, out
    assert "raylet" in out and "thread" in out, out[:2000]
    assert ray_tpu_torch.get(ref, timeout=60) == "ok"
