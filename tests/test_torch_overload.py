"""The port's overload plane: the cases of ``tests/test_overload.py`` on
``ray_tpu_torch`` (the overload taxonomy over pickle and the wire,
shed outcomes replayed from the dedupe cache, the ``pressure`` chaos
action, a burst four times a remote raylet's queue bound that sheds and
loses nothing, the per-node in-flight window, cancellation of shed
tasks, the memory watchdog's one kill of the largest retryable task and
its ``OutOfMemoryError`` for non-retryable work, nested fan-out against
a bounded owner).
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.chaos import ChaosPlane
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.rpc import (
    RESOURCE_EXHAUSTED,
    RetryingRpcClient,
    RpcClient,
    RpcServer,
)
from ray_tpu_torch.exceptions import (
    BackpressureError,
    OutOfMemoryError,
    SystemOverloadError,
)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean_chaos():
    chaos.clear()
    os.environ.pop(chaos.ENV_VAR, None)
    yield
    chaos.clear()
    os.environ.pop(chaos.ENV_VAR, None)


# ---------------------------------------------------------------------------
# taxonomy + wire mapping (pure units)


def test_overload_taxonomy_flags_survive_pickle():
    import pickle
    e = OutOfMemoryError("killed", retryable=False, backoff_s=1.5)
    e2 = pickle.loads(pickle.dumps(e))
    assert isinstance(e2, OutOfMemoryError)
    assert isinstance(e2, SystemOverloadError)
    assert e2.retryable is False and e2.backoff_s == 1.5
    assert "killed" in str(e2)
    b = BackpressureError()
    assert b.retryable is True       # sheds are always safe to retry


def test_rpc_ships_overload_as_resource_exhausted_frame():
    """A handler raising a SystemOverloadError subclass reaches the
    caller TYPED (flags intact), not wrapped in RpcError — on both the
    plain and the retrying client, and without burning the retrying
    client's deadline on reconnect loops."""
    server = RpcServer(component="ovl_server")

    def shed(ctx):
        raise BackpressureError("intake full", backoff_s=0.125)

    server.register("shed", shed)
    plain = RpcClient(server.address, component="ovl_plain")
    retry = RetryingRpcClient(server.address, component="ovl_retry")
    try:
        with pytest.raises(BackpressureError) as info:
            plain.call("shed", timeout=10)
        assert info.value.backoff_s == 0.125
        t0 = time.monotonic()
        with pytest.raises(BackpressureError):
            retry.call("shed", timeout=30)
        # surfaced immediately: overload is a caller signal, not a
        # transport fault to retry against the 30s deadline
        assert time.monotonic() - t0 < 5.0
    finally:
        plain.close()
        retry.close()
        server.shutdown()


def test_resource_exhausted_outcome_replays_from_dedupe_cache():
    """A shed outcome is an outcome: the dedupe cache replays it for a
    re-sent token instead of re-running the handler."""
    server = RpcServer(component="ovl_dedupe")
    calls = []

    def shed(ctx):
        calls.append(1)
        raise BackpressureError("full")

    server.register("shed", shed)
    client = RetryingRpcClient(server.address,
                               component="ovl_dedupe_client",
                               attempt_timeout=0.5)
    try:
        chaos.install("ovl_dedupe.send.reply:drop@1")
        with pytest.raises(BackpressureError):
            client.call("shed", timeout=15)
        assert calls == [1]
        assert server.dedupe_hits == 1
    finally:
        client.close()
        server.shutdown()


def test_pressure_chaos_action_parses_and_carries_arg():
    plane = ChaosPlane()
    plane.install("raylet.watchdog.sample2:pressure=0.97@2")
    assert plane.fire_arg("raylet", "watchdog", "sample1") == (None, 0.0)
    assert plane.fire_arg("raylet", "watchdog", "sample2") == (None, 0.0)
    assert plane.fire_arg("raylet", "watchdog", "sample2") \
        == ("pressure", 0.97)
    assert plane.fire_arg("raylet", "watchdog", "sample2") == (None, 0.0)


# ---------------------------------------------------------------------------
# acceptance: burst 4x the raylet queue bound -> shed + transparent retry


def test_burst_over_queue_bound_sheds_and_loses_nothing(tmp_path):
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster

    marker = tmp_path / "ran.txt"
    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "raylet_max_queued_tasks": 4,
        "backpressure_retry_base_ms": 20,
        "backpressure_retry_max_ms": 200,
    })
    try:
        nid = cluster.add_node(num_cpus=4, resources={"B": 4},
                               remote=True, max_process_workers=2)

        # zero-CPU so the owner-side scheduler does not throttle the
        # burst first: all 16 hit the raylet's bounded intake at once
        @ray_tpu_torch.remote(num_cpus=0, resources={"B": 0.01})
        def burst(path, i):
            time.sleep(0.1)
            with open(path, "a") as f:
                f.write(f"{i}\n")
            return i

        refs = [burst.remote(str(marker), i) for i in range(16)]
        results = ray_tpu_torch.get(refs, timeout=120)
        # zero lost or duplicated results
        assert results == list(range(16))
        ran = sorted(int(x) for x in marker.read_text().split())
        assert ran == list(range(16))     # each executed exactly once

        w = cluster.worker
        # the shed was real and observable on both sides
        assert w.node_group.num_shed > 0
        handle = w.node_group._remote_nodes[nid]
        stats = handle.client.call("stats", timeout=15)
        assert stats["num_shed"] > 0
        assert stats["num_oom_kills"] == 0
        # recovery: nothing still parked, shed counter persists
        assert w.node_group.stats()["deferred"] == 0
        assert w.task_manager.num_retries == 0   # sheds never ran

        # observability satellite: the gauges moved and the live
        # backpressure gauge returned to zero after recovery
        from tests.test_torch_serve_batching import gauge
        shed = gauge("ray_tpu_tasks", {"state": "shed"})
        assert shed is not None and shed > 0
        deadline = time.monotonic() + 10
        while gauge("ray_tpu_tasks", {"state": "backpressured"}) not in (
                None, 0):
            assert time.monotonic() < deadline, "backpressured gauge stuck"
            time.sleep(0.1)
    finally:
        cluster.shutdown()
        get_config().reset()


def test_inflight_window_caps_per_node_submissions(tmp_path):
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "raylet_inflight_window": 2,
    })
    try:
        nid = cluster.add_node(num_cpus=4, resources={"W": 4},
                               remote=True, max_process_workers=2)

        @ray_tpu_torch.remote(num_cpus=0, resources={"W": 0.01})
        def quick(i):
            time.sleep(0.05)
            return i

        refs = [quick.remote(i) for i in range(8)]
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(8))
        w = cluster.worker
        assert w.node_group.num_window_waits > 0
        assert w.node_group._remote_inflight(nid) == 0
        assert w.node_group.stats()["deferred"] == 0
    finally:
        cluster.shutdown()
        get_config().reset()


def test_cancel_reaches_shed_deferred_tasks(tmp_path):
    """A task shed by the raylet and parked in the owner's deferred
    queue is still cancellable: it never runs its side effects and
    surfaces TaskCancelledError — wherever the cancel catches it
    (deferred, re-queued, or raylet-queued)."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.exceptions import TaskCancelledError

    marker = tmp_path / "cancelled_ran.txt"
    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "raylet_max_queued_tasks": 1,
        "backpressure_retry_base_ms": 300,
        "backpressure_retry_max_ms": 2000,
    })
    try:
        cluster.add_node(num_cpus=2, resources={"C": 2}, remote=True,
                         max_process_workers=1)

        @ray_tpu_torch.remote(num_cpus=0, resources={"C": 0.01})
        def slow(path, i):
            time.sleep(0.4)
            with open(path, "a") as f:
                f.write(f"{i}\n")
            return i

        refs = [slow.remote(str(marker), i) for i in range(6)]
        # the tail of the burst is shed/parked
        deadline = time.monotonic() + 30
        while cluster.worker.node_group.num_shed == 0:
            assert time.monotonic() < deadline, "nothing was shed"
            time.sleep(0.02)
        victim = refs[-1]
        ray_tpu_torch.cancel(victim)
        with pytest.raises(TaskCancelledError):
            ray_tpu_torch.get(victim, timeout=120)
        # the survivors all completed exactly once
        assert ray_tpu_torch.get(refs[:-1], timeout=120) == list(range(5))
        ran = sorted(int(x) for x in marker.read_text().split())
        assert 5 not in ran   # the cancelled task never ran
    finally:
        cluster.shutdown()
        get_config().reset()


# ---------------------------------------------------------------------------
# acceptance: memory watchdog under injected pressure


def test_watchdog_kills_largest_retryable_exactly_once(tmp_path):
    """Two retryable tasks run on the node; injected pressure at the
    first stable sample kills the LARGEST (the 48MB hog), exactly
    once; the owner retries it to success with num_retries == 1 and a
    single side effect; the small task is untouched."""
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster

    marker = tmp_path / "sides.txt"
    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "health_check_period_ms": 200,
        "backpressure_retry_base_ms": 50,
    })
    try:
        # armed only in the spawned raylet: pressure=0.99 on the
        # SECOND sample at which exactly two victims are running (the
        # first gives the hog time to finish allocating)
        os.environ[chaos.ENV_VAR] = \
            "raylet.watchdog.sample2:pressure=0.99@2"
        cluster.add_node(num_cpus=2, resources={"M": 2}, remote=True,
                         max_process_workers=2)
        os.environ.pop(chaos.ENV_VAR)

        @ray_tpu_torch.remote(num_cpus=1, resources={"M": 1}, max_retries=3)
        def big_hog(path):
            data = np.ones(6_000_000)          # ~48MB of RSS
            time.sleep(2.5)
            with open(path, "a") as f:
                f.write("big\n")               # side effect AFTER the
            return int(data.shape[0])          # kill window

        @ray_tpu_torch.remote(num_cpus=1, resources={"M": 1}, max_retries=3)
        def small_task(path):
            time.sleep(2.5)
            with open(path, "a") as f:
                f.write("small\n")
            return "small-done"

        big_ref = big_hog.options(name="big_hog").remote(str(marker))
        small_ref = small_task.options(name="small_task").remote(
            str(marker))

        assert ray_tpu_torch.get(big_ref, timeout=120) == 6_000_000
        assert ray_tpu_torch.get(small_ref, timeout=120) == "small-done"

        lines = marker.read_text().splitlines()
        assert sorted(lines) == ["big", "small"]   # no double effects

        w = cluster.worker
        assert w.task_manager.num_oom_kills == 1
        assert w.task_manager.num_oom_retries == 1
        assert w.task_manager.num_retries == 1
        # the victim was the big task (its record retried; small's not)
        by_name = {r.spec.repr_name(): r
                   for r in w.task_manager.list_records()}
        big_rec = next(v for k, v in by_name.items() if "big_hog" in k)
        small_rec = next(v for k, v in by_name.items()
                         if "small_task" in k)
        assert big_rec.attempt == 1 and small_rec.attempt == 0

        # observability: oom gauge moved
        from ray_tpu_torch.util import metrics
        text = metrics.prometheus_text()
        oom_line = [ln for ln in text.splitlines()
                    if ln.startswith("ray_tpu_oom_kills")]
        assert oom_line and float(oom_line[0].split()[-1]) == 1
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        cluster.shutdown()
        get_config().reset()


def test_watchdog_surfaces_oom_to_nonretryable_get(tmp_path):
    ray_tpu_torch.shutdown()
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(num_gpus=0, head_num_cpus=2, _system_config={
        "health_check_period_ms": 200,
    })
    try:
        os.environ[chaos.ENV_VAR] = \
            "raylet.watchdog.sample1:pressure=0.99@2"
        cluster.add_node(num_cpus=2, resources={"N": 2}, remote=True,
                         max_process_workers=2)
        os.environ.pop(chaos.ENV_VAR)

        @ray_tpu_torch.remote(num_cpus=1, resources={"N": 1}, max_retries=0)
        def doomed():
            time.sleep(2.5)
            return "never"

        ref = doomed.remote()
        with pytest.raises(OutOfMemoryError):
            ray_tpu_torch.get(ref, timeout=90)
        w = cluster.worker
        assert w.task_manager.num_oom_kills == 1
        assert w.task_manager.num_oom_retries == 0
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        cluster.shutdown()
        get_config().reset()


# ---------------------------------------------------------------------------
# owner-side bounded intake for nested submissions


def test_nested_fanout_sheds_and_retries_against_bounded_owner():
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_gpus=0, num_cpus=2, max_process_workers=2, _system_config={
        "owner_max_pending_tasks": 2,
        "backpressure_retry_base_ms": 20,
        "backpressure_retry_max_ms": 200,
    })
    try:
        @ray_tpu_torch.remote
        def leaf(i):
            return i

        @ray_tpu_torch.remote
        def fanout(n):
            refs = [leaf.remote(i) for i in range(n)]
            return sum(ray_tpu_torch.get(refs))

        assert ray_tpu_torch.get(fanout.remote(8), timeout=120) == 28
        assert w.num_nested_shed > 0   # the bound actually engaged
    finally:
        ray_tpu_torch.shutdown()
        get_config().reset()
