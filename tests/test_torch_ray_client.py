"""The port's proxied remote driver (``rtpu://``, the Ray Client
analog): the cases of ``tests/test_ray_client.py`` on ``ray_tpu_torch``,
with the client server started with ``--num-gpus 0`` (no card here), and
the port's own case: a ``num_gpus=1`` task of a thin client runs on a
thread of a ``--num-gpus 1`` client server's driver.
"""

import contextlib
import os
import subprocess
import sys
import time

import pytest
import torch

import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@contextlib.contextmanager
def _client_cluster(tmp_path, num_gpus):
    """GCS + client-server processes; yields (rtpu_addr, token,
    add_raylet, cs_proc) — the helper spawns extra cluster raylets (all
    reaped at teardown)."""
    from ray_tpu_torch._private import rpc as _rpc
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch._private.gcs_server import spawn_gcs_process

    session = os.urandom(4).hex()
    token = _rpc.ensure_session_token(session)
    gcs_proc, gcs_addr = spawn_gcs_process(session,
                                           get_config().serialize(),
                                           persist=True)
    port_file = str(tmp_path / "cs.addr")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
    env["RTPU_SESSION_TOKEN"] = token
    cs_proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.client_server",
         "--address", f"{gcs_addr[0]}:{gcs_addr[1]}",
         "--port-file", port_file,
         "--config", get_config().serialize(),
         "--num-gpus", str(num_gpus)],
        env=env, start_new_session=True)
    raylet_procs = []
    try:
        deadline = time.monotonic() + 60
        addr = None
        while time.monotonic() < deadline:
            if os.path.exists(port_file):
                addr = open(port_file).read().strip()
                break
            assert cs_proc.poll() is None, "client server died"
            time.sleep(0.05)
        assert addr, "client server never reported its address"

        def add_raylet(resources):
            from ray_tpu_torch._private.ids import NodeID
            from ray_tpu_torch._private.raylet_server import (
                spawn_raylet_process)
            proc, _ = spawn_raylet_process(
                f"{session}r{len(raylet_procs) + 1}", NodeID.from_random(),
                resources, gcs_addr=gcs_addr, max_process_workers=2)
            raylet_procs.append(proc)
            return proc

        yield f"rtpu://{addr}", token, add_raylet, cs_proc
    finally:
        ray_tpu_torch.shutdown()
        for proc in [*raylet_procs, cs_proc, gcs_proc]:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


@pytest.fixture
def client_cluster(tmp_path):
    with _client_cluster(tmp_path, num_gpus=0) as (addr, token, add, _p):
        yield addr, token, add


def test_client_tasks_objects_wait(client_cluster):
    addr, _token, _add_raylet = client_cluster
    w = ray_tpu_torch.init(address=addr)
    assert type(w).__name__ == "ClientWorker"

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    # tasks + chained refs through the proxy
    r1 = add.remote(1, 2)
    r2 = add.remote(r1, 10)
    assert ray_tpu_torch.get(r2, timeout=60) == 13

    # put/get round trip (driver-owned object)
    ref = ray_tpu_torch.put({"k": [1, 2, 3]})
    assert ray_tpu_torch.get(ref, timeout=30) == {"k": [1, 2, 3]}

    # wait
    ready, not_ready = ray_tpu_torch.wait([add.remote(5, 5)], num_returns=1,
                                    timeout=30)
    assert len(ready) == 1 and not not_ready
    assert ray_tpu_torch.get(ready[0]) == 10

    # error propagation
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("client boom")

    with pytest.raises(Exception, match="client boom"):
        ray_tpu_torch.get(boom.remote(), timeout=30)


def test_client_actors(client_cluster):
    addr, _token, _add_raylet = client_cluster
    ray_tpu_torch.init(address=addr)

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote()
    assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
    assert ray_tpu_torch.get(c.incr.remote(5), timeout=30) == 6
    ray_tpu_torch.kill(c)


def test_client_detached_actor_across_connections(client_cluster):
    """Detached actors through the rtpu:// thin driver: connection A
    creates a named detached actor hosted on a cluster raylet and
    disconnects; connection B finds it by name with state intact
    (reference: Ray Client + detached actor composition)."""
    addr, _token, add_raylet = client_cluster
    ray_tpu_torch.init(address=addr)
    # Baseline BEFORE the raylet exists: the proxied driver's own head
    # node already contributes CPUs, so "total >= 2" alone would pass
    # before the new node attaches (flake). Poll for the DELTA.
    baseline = ray_tpu_torch.cluster_resources().get("CPU", 0)
    add_raylet({"CPU": 2.0})
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if ray_tpu_torch.cluster_resources().get("CPU", 0) >= baseline + 2:
            break
        time.sleep(0.1)
    else:
        raise AssertionError("added raylet never became visible")

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    Counter.options(name="cli_det", lifetime="detached",
                    num_cpus=1).remote()
    h = ray_tpu_torch.get_actor("cli_det")
    assert ray_tpu_torch.get(h.incr.remote(), timeout=120) == 1
    assert ray_tpu_torch.get(h.incr.remote(), timeout=60) == 2
    ray_tpu_torch.shutdown()       # connection A gone

    ray_tpu_torch.init(address=addr)   # connection B
    h2 = ray_tpu_torch.get_actor("cli_det")
    assert ray_tpu_torch.get(h2.incr.remote(), timeout=120) == 3
    ray_tpu_torch.kill(h2)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get_actor("cli_det")
        except ValueError:
            break
        time.sleep(0.2)
    else:
        raise AssertionError("name not freed after kill")
    ray_tpu_torch.shutdown()


def test_client_gpu_task_runs_on_the_servers_driver_thread(tmp_path):
    """A thin client's ``num_gpus=1`` task runs in the client server's
    own process (a driver thread, where the head's cards are), not in a
    process worker."""
    with _client_cluster(tmp_path, num_gpus=1) as (addr, _t, _a, cs_proc):
        ray_tpu_torch.init(address=addr)
        assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0

        @ray_tpu_torch.remote(num_gpus=1)
        def where():
            import os
            import threading
            return os.getpid(), threading.current_thread().name

        @ray_tpu_torch.remote
        def cpu_where():
            import os
            return os.getpid()

        pid, thread = ray_tpu_torch.get(where.remote(), timeout=60)
        assert pid == cs_proc.pid and thread != "MainThread"
        assert ray_tpu_torch.get(cpu_where.remote(), timeout=60) \
            != cs_proc.pid
