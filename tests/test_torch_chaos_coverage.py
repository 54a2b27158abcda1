"""The port's chaos points that the chaos-coverage pass
(``ray_tpu_torch.devtools.analysis``) finds no port test for:
``worker_pool.spawn`` / ``worker_pool.teardown`` / ``worker.boot`` /
``rpc *.recv.*`` / ``actor.checkpoint.restore`` — the cases of
``tests/test_chaos_coverage.py`` on ``ray_tpu_torch``, so the matrix row
(``ray_tpu_torch/docs/static_analysis.md``) and the test literal both
exist and the pass stays quiet.

The injected actions are deliberately benign (``delay``) where a
harsher action would wedge the plane being tested: a kill at
``worker.boot`` would kill every respawned worker in a loop, and a
sever at ``worker_pool.spawn`` has no connection to sever yet.  The
point of these tests is that the HOOK fires and the plane survives it,
observable via ``chaos.events()`` (same-process points) or via the
behavior the delay cannot have broken (child-process points).
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import actor_checkpoint as ackpt
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private.rpc import RetryingRpcClient, RpcServer


@pytest.fixture(autouse=True)
def _clean_chaos():
    os.environ.pop(chaos.ENV_VAR, None)
    chaos.clear()
    yield
    os.environ.pop(chaos.ENV_VAR, None)
    chaos.clear()


def _poll(predicate, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_rpc_recv_chaos_point_delays_and_records():
    """`*.recv.*` (rpc.py frame receive): a delay rule on the server's
    inbound dispatch fires, is visible in the event log, and the call
    still completes."""
    server = RpcServer(component="recvcov_server")
    server.register("echo", lambda ctx, x: x + 1)
    client = RetryingRpcClient(server.address,
                               component="recvcov_client")
    try:
        chaos.install("recvcov_server.recv.echo:delay=0.15@1")
        t0 = time.monotonic()
        assert client.call("echo", 41, timeout=15) == 42
        assert time.monotonic() - t0 >= 0.15
        assert ("recvcov_server", "recv", "echo",
                "delay") in chaos.events()
    finally:
        client.close()
        server.shutdown()


def test_worker_pool_spawn_and_teardown_chaos_points():
    """`worker_pool.spawn` / `worker_pool.teardown` fire in the
    spawning (driver/raylet) process — delay rules on both are
    observable driver-side. Teardown only fires on a HARD kill (a
    graceful shutdown drains workers via the pipe), so the test kills
    an actor's worker through the user-level `ray_tpu_torch.kill` path."""
    ray_tpu_torch.shutdown()
    chaos.install("worker_pool.spawn.*:delay=0.01@1;"
                  "worker_pool.teardown.*:delay=0.01@1")
    w = ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1)
    try:
        @ray_tpu_torch.remote
        class Holder:
            def ping(self):
                return "up"

        a = Holder.remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == "up"
        assert ("worker_pool", "spawn", "", "delay") in chaos.events()
        # kill the actor WITH its worker: release_actor(kill_worker=
        # True) is the hard path that reaches ProcessWorker.kill()
        ray_tpu_torch.kill(a)
        _poll(lambda: ("worker_pool", "teardown", "", "delay")
              in chaos.events(), 30, "teardown hook to fire")
    finally:
        ray_tpu_torch.shutdown()


def test_worker_boot_chaos_delay_still_boots():
    """`worker.boot` fires inside the CHILD process right after it
    arms from the env — a delay there must only slow registration,
    never break it. (Never use kill at this point: the respawned
    replacement would inherit nothing but the pool would churn through
    its restart budget booting corpses.)"""
    ray_tpu_torch.shutdown()
    os.environ[chaos.ENV_VAR] = "worker.boot.*:delay=0.1@1"
    try:
        w = ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_process_workers=1)
        head = w.node_group._raylets[w.node_group.head_node_id]
        head.worker_pool.prestart(1)
        _poll(lambda: head.worker_pool.stats()["idle_process"] >= 1,
              60, "armed worker to boot through the delay")
        os.environ.pop(chaos.ENV_VAR)

        @ray_tpu_torch.remote
        def probe():
            return "alive"

        assert ray_tpu_torch.get(probe.remote(), timeout=60) == "alive"
    finally:
        os.environ.pop(chaos.ENV_VAR, None)
        ray_tpu_torch.shutdown()


class _Restorable:
    def __init__(self):
        self.state = None

    def __ray_save__(self):
        return self.state

    def __ray_restore__(self, state):
        self.state = state


def test_checkpoint_restore_drop_falls_back_one_generation(tmp_path):
    """`actor.checkpoint.restore`: a chaos drop fails the newest
    committed generation's restore attempt; restore_instance falls
    back one generation instead of giving up (the documented
    `actor.checkpoint.restore:drop` semantics)."""
    root = str(tmp_path / "ckpt")
    os.makedirs(root)
    for gen, payload in ((1, {"n": 1}), (2, {"n": 2})):
        assert ackpt.save_generation(root, gen, cursor=gen,
                                     state=payload) > 0
        # commit marker: what the driver's two-phase commit writes
        with open(ackpt.commit_marker_path(root, gen), "w") as f:
            f.write("COMMIT")
    chaos.install("actor.checkpoint.restore:drop@1")
    inst = _Restorable()
    info = ackpt.restore_instance(root, inst)
    # gen 2's attempt was chaos-dropped; gen 1 restored
    assert info["restored_gen"] == 1
    assert inst.state == {"n": 1}
    assert info["discarded"] == 1
    assert ("actor", "checkpoint", "restore", "drop") in chaos.events()
    # and with the plane quiet the newest generation restores
    chaos.clear()
    inst2 = _Restorable()
    assert ackpt.restore_instance(root, inst2)["restored_gen"] == 2
    assert inst2.state == {"n": 2}
