"""The port's lineage reconstruction: the cases of
``tests/test_reconstruction.py`` on ``ray_tpu_torch``. When a task
result's backing storage is lost, the owner re-executes the creating
task from recorded lineage, recursively and bounded by ``max_retries``;
a ``put`` has no lineage; a checkpoint-restored actor changes nothing
about object ownership; a lost spill file is recovered too.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import ObjectLostError


@pytest.fixture
def ray_start_regular():
    """The reference fixture's runtime on the port: 4 CPUs, 8 GPUs of
    resource (no card is needed for work that demands none), 2 process
    workers."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


BIG = 300_000  # elements; ~2.4MB — well above the inline cap


def _lose(w, ref):
    """Destroy an object's backing shm segment while keeping its
    directory entry — simulates losing the primary copy."""
    oid = ref.id()
    w.shm_store.free(oid)
    entry = w.memory_store.get(oid, timeout=0)
    # Drop the process-local materialized value too: the loss scenario
    # is a consumer that has NOT already deserialized the object.
    entry._has_value = False
    entry._value = None


def test_reconstruct_lost_object(ray_start_regular):
    w = ray_start_regular

    @ray_tpu_torch.remote
    def make():
        return np.arange(BIG, dtype=np.int64)

    ref = make.remote()
    first = ray_tpu_torch.get(ref)
    _lose(w, ref)
    again = ray_tpu_torch.get(ref)
    np.testing.assert_array_equal(first, again)
    assert w.task_manager.num_reconstructions == 1


def test_reconstruct_dependency_chain(ray_start_regular):
    """Recovering an object whose creating task's own argument was also
    lost recovers the whole chain."""
    w = ray_start_regular

    @ray_tpu_torch.remote
    def make():
        return np.ones(BIG)

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    a = make.remote()
    b = double.remote(a)
    out = ray_tpu_torch.get(b)
    assert out[0] == 2.0
    _lose(w, a)
    _lose(w, b)
    out = ray_tpu_torch.get(b)
    assert out[0] == 2.0 and out.shape == (BIG,)
    assert w.task_manager.num_reconstructions >= 2


def test_put_objects_not_recoverable(ray_start_regular):
    """ray_tpu_torch.put has no lineage; losing it is permanent (reference:
    only task outputs reconstruct)."""
    w = ray_start_regular
    ref = ray_tpu_torch.put(np.zeros(BIG))
    ray_tpu_torch.get(ref)
    _lose(w, ref)
    with pytest.raises(ObjectLostError):
        ray_tpu_torch.get(ref)


def test_reconstruction_budget_exhausted(ray_start_regular):
    w = ray_start_regular

    @ray_tpu_torch.remote
    def make():
        return np.zeros(BIG)

    ref = make.options(max_retries=0).remote()
    ray_tpu_torch.get(ref)
    _lose(w, ref)
    with pytest.raises(ObjectLostError):
        ray_tpu_torch.get(ref)


def test_reconstruction_after_actor_checkpoint_restore(tmp_path):
    """Checkpoint x reconstruction interplay: a normal-task object
    consumed by a checkpointable actor is lost AFTER the actor was
    chaos-killed and restored from its checkpoint — the actor's next
    call on that ref still triggers lineage reconstruction (the
    restored actor changes nothing about object ownership), and the
    max_retries budget is honored when exhausted."""
    import ray_tpu_torch._private.chaos as chaos
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=2, max_process_workers=2, num_gpus=0)
    try:
        @ray_tpu_torch.remote
        def make():
            return np.arange(BIG, dtype=np.int64)

        @ray_tpu_torch.remote(max_restarts=1, max_task_retries=2,
                        checkpoint_interval=1)
        class Summer:
            def __init__(self):
                self.calls = 0

            def ping(self):
                return "up"

            def use(self, arr):
                self.calls += 1
                return int(arr[:3].sum()), self.calls

            def __ray_save__(self):
                return {"calls": self.calls}

            def __ray_restore__(self, st):
                self.calls = st["calls"]

        # Arm BEFORE any worker spawns (a pre-spawned unarmed worker
        # would be reused for the actor): die at the 2nd `use` exec.
        # The armed window is confined to EXACTLY ONE worker spawn by
        # capping the pool: dispatch retries during actor creation
        # spawn ahead, and a second worker spawned while the env rule
        # is set would stay armed — the RESTARTED actor landing on it
        # replays one `use` and the next call is that process's @2
        # trigger again, burning the restart budget (flaky kill #2).
        pool = w.node_group._raylets[
            w.node_group.head_node_id].worker_pool
        with pool._lock:
            pool._max_process = 1
        os.environ[chaos.ENV_VAR] = "worker.exec.Summer.use:kill@2"
        try:
            a = Summer.remote()
            assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "up"
        finally:
            os.environ.pop(chaos.ENV_VAR, None)
            with pool._lock:
                pool._max_process = 2
        data = make.remote()
        ray_tpu_torch.get(data)
        assert ray_tpu_torch.get(a.use.remote(data), timeout=60) == (3, 1)
        # kill + checkpoint-restore cycle (the 2nd use dies at exec
        # entry and replays after the restore)
        assert ray_tpu_torch.get(a.use.remote(data), timeout=120) == (3, 2)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if w.gcs.get_actor_info(a._actor_id).num_restarts == 1:
                break
            time.sleep(0.05)
        assert w.gcs.get_actor_info(a._actor_id).num_restarts == 1
        assert w.num_ckpt_restored == 1
        # NOW lose the argument object: the restored actor's next call
        # reconstructs it from lineage on the flush path
        _lose(w, data)
        assert ray_tpu_torch.get(a.use.remote(data), timeout=60) == (3, 3)
        assert w.task_manager.num_reconstructions == 1
        # budget honored: a retry-less object lost after the restore
        # surfaces ObjectLostError instead of reconstructing
        dead_end = make.options(max_retries=0).remote()
        ray_tpu_torch.get(dead_end)
        _lose(w, dead_end)
        ref = a.use.remote(dead_end)
        with pytest.raises(ObjectLostError):
            ray_tpu_torch.get(ref, timeout=60)
        assert w.task_manager.num_reconstructions == 1
    finally:
        ray_tpu_torch.shutdown()


def test_reconstruct_lost_spill_file():
    """A spilled object whose spill file vanished reconstructs
    transparently on get()."""
    ray_tpu_torch.shutdown()   # a leaked runtime would make init() a no-op
    w = ray_tpu_torch.init(num_cpus=4, object_store_memory=6 * 1024 * 1024,
                     max_process_workers=2, num_gpus=0)
    try:
        @ray_tpu_torch.remote
        def make(i):
            return np.full(BIG, i, dtype=np.float64)

        refs = [make.remote(i) for i in range(3)]
        ray_tpu_torch.get(refs[-1])
        # Spilling under capacity pressure is asynchronous — poll for
        # it instead of snapshotting immediately (loaded machines lag).
        deadline = time.monotonic() + 15
        spilled = {}
        while not spilled and time.monotonic() < deadline:
            spilled = dict(w.shm_store._spilled)
            if not spilled:
                time.sleep(0.05)
        assert spilled, "expected at least one spilled object"
        for path, _size in spilled.values():
            os.unlink(path)
        for i, ref in enumerate(refs):
            val = ray_tpu_torch.get(ref)
            assert val[0] == float(i)
        assert w.task_manager.num_reconstructions >= 1
    finally:
        ray_tpu_torch.shutdown()
