"""The port's raylet processes end to end: the ``ray_start_cluster``
cases of ``tests/test_distributed.py`` on ``ray_tpu_torch`` (tasks on a
remote raylet, objects across nodes through the transfer plane, a raylet
killed mid-run, lineage reconstruction of a lost object, nested
submission from a remote worker, a remote actor, heartbeats that carry
real availability, batched leases), plus the port's own cases: a remote
node with GPUs is refused, and a torch tensor in the head's device tier
reaches a remote worker as a host copy.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster

BIG = 200_000   # float64 elements ≈ 1.6MB > inline cap


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _raylet_stats(cluster, node_id):
    return cluster.worker.node_group._remote_nodes[node_id].client.call(
        "stats")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_cluster():
    """The reference's fixture on the port: a CPU-only head (no card
    here) plus a helper for adding nodes."""
    cluster = Cluster(num_gpus=0, head_num_cpus=4)
    yield cluster
    cluster.shutdown()


def test_remote_raylet_runs_tasks(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2, resources={"R": 2}, remote=True)

    @ray_tpu_torch.remote(num_cpus=1, resources={"R": 1})
    def f(a, b):
        import os
        return a + b, os.getpid()

    import os
    results = ray_tpu_torch.get([f.remote(i, i) for i in range(4)])
    assert [r[0] for r in results] == [0, 2, 4, 6]
    # executed in the raylet's worker processes, not the driver's
    assert all(r[1] != os.getpid() for r in results)


def test_cross_node_object_transfer(ray_start_cluster):
    """An object created on node A is consumed on node B via the
    chunked transfer plane (and by the driver via pull)."""
    cluster = ray_start_cluster
    a = cluster.add_node(num_cpus=2, resources={"A": 2}, remote=True)
    b = cluster.add_node(num_cpus=2, resources={"B": 2}, remote=True)

    @ray_tpu_torch.remote(num_cpus=1, resources={"A": 1})
    def make():
        return np.arange(BIG, dtype=np.float64)

    @ray_tpu_torch.remote(num_cpus=1, resources={"B": 1})
    def consume(x):
        return float(x.sum())

    ref = make.remote()
    out = ray_tpu_torch.get(consume.remote(ref))
    assert out == pytest.approx(float(np.arange(BIG,
                                                dtype=np.float64).sum()))
    # node B pulled the object over the wire
    handle_b = cluster.worker.node_group._remote_nodes[b]
    stats = handle_b.client.call("stats")
    assert stats["num_pulled"] >= 1
    # the driver can pull it too
    val = ray_tpu_torch.get(ref)
    assert val.shape == (BIG,)
    assert val[1] == 1.0


def test_kill_raylet_midrun_tasks_retry_on_survivors(ray_start_cluster):
    cluster = ray_start_cluster
    doomed = cluster.add_node(num_cpus=2, resources={"S": 2}, remote=True)

    @ray_tpu_torch.remote(num_cpus=1, resources={"S": 1}, max_retries=3)
    def slow(i):
        import time as t
        t.sleep(1.5)
        return i * 10

    refs = [slow.remote(i) for i in range(2)]
    _wait_for(lambda: _raylet_stats(cluster, doomed)["running"] >= 1,
              what="a task running on the doomed node")
    cluster.kill_raylet_process(doomed)
    # survivors provide the resource after a moment
    cluster.add_node(num_cpus=2, resources={"S": 2}, remote=True)
    cluster.worker.node_group.recheck_infeasible()
    assert sorted(ray_tpu_torch.get(refs, timeout=60)) == [0, 10]


def test_lost_remote_object_reconstructs(ray_start_cluster):
    """Node death loses its objects; get() transparently re-executes
    the creating task on survivors (lineage over the transfer plane)."""
    cluster = ray_start_cluster
    doomed = cluster.add_node(num_cpus=2, resources={"L": 2}, remote=True)

    @ray_tpu_torch.remote(num_cpus=1, resources={"L": 1})
    def make(i):
        return np.full(BIG, i, dtype=np.float64)

    refs = [make.remote(i) for i in range(2)]
    ray_tpu_torch.wait(refs, num_returns=2, timeout=60)
    proc = cluster.worker.node_group._remote_nodes[doomed].proc
    cluster.kill_raylet_process(doomed)
    proc.wait(timeout=10)
    cluster.add_node(num_cpus=2, resources={"L": 2}, remote=True)
    cluster.worker.node_group.recheck_infeasible()
    for i, ref in enumerate(refs):
        val = ray_tpu_torch.get(ref)
        assert val[0] == float(i)
    assert cluster.worker.task_manager.num_reconstructions >= 1


def test_nested_submission_from_remote_raylet(ray_start_cluster):
    """A task on a raylet process submits child tasks back through its
    owner channel; children run wherever the scheduler places them."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2, resources={"N": 2}, remote=True)

    @ray_tpu_torch.remote
    def child(i):
        return i + 1

    @ray_tpu_torch.remote(num_cpus=1, resources={"N": 1})
    def parent():
        import ray_tpu_torch as rt
        return sum(rt.get([child.remote(i) for i in range(3)]))

    assert ray_tpu_torch.get(parent.remote(), timeout=180) == 6


def test_remote_actor_lifecycle(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2, resources={"ACT": 1}, remote=True)

    @ray_tpu_torch.remote(num_cpus=1, resources={"ACT": 1})
    class Counter:
        def __init__(self, start):
            self.v = start

        def add(self, k):
            self.v += k
            return self.v

        def big(self):
            return np.ones(BIG)

    c = Counter.remote(100)
    assert ray_tpu_torch.get(c.add.remote(1)) == 101
    assert ray_tpu_torch.get(c.add.remote(2)) == 103
    # big actor result stays remote until pulled
    assert ray_tpu_torch.get(c.big.remote()).shape == (BIG,)
    ray_tpu_torch.kill(c)


# ---------------------------------------------------------------------------
# resource heartbeat: truthful availability, consumed by the driver


def test_resource_report_reconciles_scheduler_view():
    """A raylet's self-reported availability corrects the driver's
    ledger (min-reconciliation) and recovers on the next report."""
    import ray_tpu_torch as rt
    rt.init(num_gpus=0, num_cpus=2)
    try:
        from ray_tpu_torch._private.ids import NodeID as NID
        from ray_tpu_torch._private.scheduler.resources import NodeResources
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        cr = w.node_group.cluster_resources
        nid = NID.from_random()
        cr.add_or_update_node(nid, NodeResources(
            total={"CPU": 8.0}, available={"CPU": 8.0}))
        # wedged raylet: claims only 2 free though the ledger says 8
        w._on_resource_report((nid, {"CPU": 2.0}))
        assert cr.get_node(nid).available["CPU"] == 2.0
        # recovery: full capacity reported again
        w._on_resource_report((nid, {"CPU": 8.0}))
        assert cr.get_node(nid).available["CPU"] == 8.0
        # ledger allocations compose with corrections
        assert cr.allocate(nid, {"CPU": 4.0})
        w._on_resource_report((nid, {"CPU": 1.0}))
        assert cr.get_node(nid).available["CPU"] == 1.0
        w._on_resource_report((nid, {"CPU": 4.0}))
        assert cr.get_node(nid).available["CPU"] == 4.0
        assert w.node_reports[nid][1] == {"CPU": 4.0}
    finally:
        rt.shutdown()


def test_raylet_heartbeat_reports_real_availability(ray_start_cluster):
    """A remote raylet's heartbeat reflects what its running tasks
    consume — not the static totals — and the driver records it."""
    cluster = ray_start_cluster
    nid = cluster.add_node(num_cpus=2, resources={"HB": 2}, remote=True)
    from ray_tpu_torch._private.worker import global_worker
    w = global_worker()

    @ray_tpu_torch.remote(num_cpus=1, resources={"HB": 1})
    def busy():
        time.sleep(6.0)
        return "done"

    ref = busy.remote()
    deadline = time.monotonic() + 20
    seen_busy = False
    while time.monotonic() < deadline and not seen_busy:
        report = w.node_reports.get(nid)
        if report is not None and report[1].get("HB") == 1.0:
            seen_busy = True
        time.sleep(0.2)
    assert seen_busy, f"never saw a busy heartbeat: {w.node_reports.get(nid)}"
    assert ray_tpu_torch.get(ref, timeout=120) == "done"
    # after completion, the heartbeat recovers to full capacity
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        report = w.node_reports.get(nid)
        if report is not None and report[1].get("HB") == 2.0:
            break
        time.sleep(0.2)
    else:
        pytest.fail(f"heartbeat did not recover: {w.node_reports.get(nid)}")


def test_remote_submit_batching_wave(ray_start_cluster):
    """A wave of tasks bound for one remote raylet coalesces into
    submit_many lease frames (one RPC per raylet per tick) — every
    task still completes and per-task spillback semantics hold."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=4, resources={"W": 100}, remote=True)

    @ray_tpu_torch.remote(num_cpus=0.01, resources={"W": 0.5})
    def bump(i):
        return i * 3

    refs = [bump.remote(i) for i in range(120)]
    out = ray_tpu_torch.get(refs, timeout=300)
    assert out == [i * 3 for i in range(120)]
