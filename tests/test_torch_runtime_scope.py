"""What one runtime leaves to the next in the same process: nothing.

Two faults of both packages, repaired in the port: an
``init(_system_config=...)`` changed the process-wide config for good, so
every later ``init()`` in a test worker ran, say, an out-of-process GCS;
and with an out-of-process GCS an actor's restart was counted on the copy
of its info that the GCS client handed out, so ``num_restarts`` stayed 0
(``test_torch_checkpoint_recovery.py``'s restart cases failed whenever
they ran after a test that used ``gcs_mode="process"``). The runtime's
threads are joined at ``shutdown()`` with either GCS."""

import os
import threading
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.config import get_config


def _poll(predicate, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@rt.remote(max_restarts=1, max_task_retries=2)
class Bumper:
    def __init__(self):
        self.n = 0

    def ping(self):
        return "up"

    def bump(self):
        self.n += 1
        return self.n


def test_system_config_ends_with_its_runtime():
    rt.shutdown()
    assert get_config().gcs_mode == "inproc"
    w = rt.init(num_cpus=1, num_gpus=0, max_process_workers=1,
                _system_config={"gcs_mode": "process"})
    try:
        assert type(w.gcs).__name__ == "GcsClient"
        assert get_config().gcs_mode == "process"
    finally:
        rt.shutdown()
    assert get_config().gcs_mode == "inproc"
    w = rt.init(num_cpus=1, num_gpus=0, max_process_workers=1)
    try:
        assert type(w.gcs).__name__ == "GcsLite"
    finally:
        rt.shutdown()


@pytest.mark.parametrize("gcs_mode", ["inproc", "process"])
def test_restart_is_counted_by_the_gcs(gcs_mode):
    """A chaos-killed actor restarts once; the GCS, in this process or
    its own, counts the restart before the restarted actor answers."""
    rt.shutdown()
    w = rt.init(num_cpus=2, num_gpus=0, max_process_workers=1,
                _system_config={"gcs_mode": gcs_mode})
    try:
        os.environ[chaos.ENV_VAR] = "worker.exec.Bumper.bump:kill@2"
        try:
            a = Bumper.remote()
            assert rt.get(a.ping.remote(), timeout=60) == "up"
        finally:
            os.environ.pop(chaos.ENV_VAR, None)
        assert rt.get(a.bump.remote(), timeout=60) == 1
        # the second bump kills the worker at its entry; the retried
        # call runs on the restarted actor (fresh state: no checkpoint)
        assert rt.get(a.bump.remote(), timeout=120) == 1
        assert w.gcs.get_actor_info(a._actor_id).num_restarts == 1
        _poll(lambda: w.gcs.get_actor_info(a._actor_id).state == "ALIVE",
              30, "actor ALIVE")
    finally:
        rt.shutdown()


def test_process_gcs_shutdown_leaves_no_thread():
    before = set(threading.enumerate())
    for _ in range(2):
        rt.init(num_cpus=1, num_gpus=0, max_process_workers=1,
                _system_config={"gcs_mode": "process"})
        rt.shutdown()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive()]
    assert not left, left
