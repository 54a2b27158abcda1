"""The port's ``ray_tpu_torch.cancel()``: the single-node cases of
``tests/test_cancel.py`` on ``ray_tpu_torch`` (queued tasks never run,
running tasks get KeyboardInterrupt, force kills the worker, cancelled
tasks never retry, finished tasks keep their results, actor calls
refuse, async-actor calls and pipelined tasks cancel) and its
remote-raylet case on the port's ``Cluster``.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.exceptions import TaskCancelledError


@pytest.fixture
def rt():
    w = ray_tpu_torch.init(num_cpus=2, max_process_workers=2, num_gpus=0)
    yield w
    ray_tpu_torch.shutdown()


def test_cancel_queued_task_never_runs(rt, tmp_path):
    mark = tmp_path / "ran"

    @ray_tpu_torch.remote(num_cpus=1)
    def blocker():
        time.sleep(5)
        return "blocked"

    @ray_tpu_torch.remote(num_cpus=1)
    def victim():
        mark.touch()
        return "ran"

    # saturate both CPUs, then queue the victim behind them
    b1, b2 = blocker.remote(), blocker.remote()
    time.sleep(0.5)
    v = victim.remote()
    ray_tpu_torch.cancel(v)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(v, timeout=30)
    assert ray_tpu_torch.get([b1, b2], timeout=60) == ["blocked", "blocked"]
    time.sleep(0.3)
    assert not mark.exists()        # the victim never executed


def test_cancel_running_task_interrupts_worker_survives(rt):
    @ray_tpu_torch.remote
    def napper():
        time.sleep(30)
        return "done"

    ref = napper.remote()
    time.sleep(1.0)                 # let it start
    ray_tpu_torch.cancel(ref)
    t0 = time.perf_counter()
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=30)
    assert time.perf_counter() - t0 < 20   # did not sleep out the 30s

    # the interrupted worker keeps serving
    @ray_tpu_torch.remote
    def quick():
        return 7

    assert ray_tpu_torch.get(quick.remote(), timeout=30) == 7


def test_cancel_force_kills_and_never_retries(rt):
    @ray_tpu_torch.remote(max_retries=3)
    def stubborn():
        # ignores KeyboardInterrupt: only force can stop it
        while True:
            try:
                time.sleep(30)
            except KeyboardInterrupt:
                continue

    ref = stubborn.remote()
    time.sleep(1.0)
    ray_tpu_torch.cancel(ref, force=True)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=30)   # no retry despite max_retries=3


def test_cancel_after_finish_keeps_result(rt):
    @ray_tpu_torch.remote
    def f():
        return 42

    ref = f.remote()
    assert ray_tpu_torch.get(ref, timeout=30) == 42
    ray_tpu_torch.cancel(ref)             # no-op: already finished
    assert ray_tpu_torch.get(ref, timeout=30) == 42


def test_cancel_actor_call_refuses(rt):
    @ray_tpu_torch.remote
    class A:
        def m(self):
            return 1

    a = A.remote()
    ref = a.m.remote()
    with pytest.raises(TypeError):
        ray_tpu_torch.cancel(ref)
    assert ray_tpu_torch.get(ref, timeout=30) == 1


def test_cancel_async_actor_call(rt):
    """ray.cancel on ASYNC-actor calls: a running coroutine is
    cancelled at its next await; queued calls are cancelled before
    they start; the actor itself stays healthy (reference: asyncio
    cancellation for async-actor tasks)."""
    @ray_tpu_torch.remote(max_concurrency=1)
    class Async:
        def __init__(self):
            self.progress = 0

        async def slow(self):
            import asyncio
            for _ in range(200):
                await asyncio.sleep(0.1)
                self.progress += 1
            return "finished"

        async def quick(self):
            return self.progress

    a = Async.remote()
    assert ray_tpu_torch.get(a.quick.remote(), timeout=60) == 0

    running = a.slow.remote()
    queued = a.slow.remote()     # waits on the concurrency semaphore
    time.sleep(1.0)              # first slow() is mid-coroutine
    ray_tpu_torch.cancel(queued)
    ray_tpu_torch.cancel(running)
    t0 = time.perf_counter()
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(running, timeout=30)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(queued, timeout=30)
    assert time.perf_counter() - t0 < 20   # not the 20s run time
    # the actor survives and serves new calls
    assert ray_tpu_torch.get(a.quick.remote(), timeout=30) >= 0


def test_cancel_pipelined_task_never_runs(rt):
    """A task queued on a busy worker's pipe (lease pipelining) is
    cancellable: the owner steals it back and completes it cancelled —
    it must not run after the head task finishes (the pre-pipelining
    guarantee for queued tasks)."""
    import tempfile
    marker = tempfile.mktemp(prefix="rtpt_cancel_pipe_")

    @ray_tpu_torch.remote
    def blocker():
        time.sleep(4)
        return "done"

    @ray_tpu_torch.remote
    def touch(path):
        with open(path, "w") as f:
            f.write("ran")
        return "ran"

    # saturate the pool so `touch` pipelines behind a blocker
    blockers = [blocker.remote() for _ in range(8)]
    time.sleep(1.0)
    ref = touch.remote(marker)
    time.sleep(0.3)            # let it dispatch onto a busy pipe
    ray_tpu_torch.cancel(ref)
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=30)
    assert ray_tpu_torch.get(blockers, timeout=60) == ["done"] * 8
    time.sleep(0.5)
    import os
    assert not os.path.exists(marker), "cancelled pipelined task ran"


@pytest.fixture
def ray_start_cluster():
    """The reference's fixture on the port: a CPU-only head (no card
    here) plus a helper for adding nodes."""
    cluster = Cluster(num_gpus=0, head_num_cpus=4)
    yield cluster
    cluster.shutdown()


def test_cancel_on_remote_raylet(ray_start_cluster, tmp_path):
    """Cancellation crosses to a remote raylet's worker."""
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2, resources={"RC": 2}, remote=True)
    started = tmp_path / "started"

    @ray_tpu_torch.remote(resources={"RC": 1})
    def napper(path):
        open(path, "w").close()
        time.sleep(30)
        return "done"

    ref = napper.remote(str(started))
    deadline = time.monotonic() + 30
    while not started.exists():     # running on the remote node
        assert time.monotonic() < deadline, "the task never started"
        time.sleep(0.02)
    ray_tpu_torch.cancel(ref)
    t0 = time.perf_counter()
    with pytest.raises(TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=30)
    assert time.perf_counter() - t0 < 25
