"""The port's detached actors: the 4 cases of ``tests/test_detached.py``
on ``ray_tpu_torch``. ``lifetime="detached"`` registers the actor
cluster-wide; it survives its creating driver, a later driver reaches it
by ``get_actor(name)``, and ``kill`` reaps it. The multi-driver cases
start their cluster through the CLI, each process with this module's
own ``TMPDIR`` (``test_torch_cli.py``'s helpers).
"""

import os
import re

import pytest

import ray_tpu_torch
from tests.test_torch_cli import (  # noqa: F401  (fixtures)
    _cli, _few_threads, _own_tmpdir, _run_driver, _tmpdir)


@pytest.fixture
def ray_start_regular():
    """The reference's fixture on the port: 4 CPUs, 2 process workers and
    8 GPUs of resource, whose work runs on driver threads."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


def test_lifetime_option_validation():
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    with pytest.raises(ValueError, match="lifetime must be"):
        A.options(lifetime="immortal").remote()
    with pytest.raises(ValueError, match="must be named"):
        A.options(lifetime="detached").remote()


def test_detached_actor_in_process(ray_start_regular):
    """Single-driver (in-process cluster) detached actor: named
    registration + get_actor + kill reaping the name."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    h = Counter.options(name="det_local", lifetime="detached").remote()
    assert ray_tpu_torch.get(h.inc.remote()) == 1
    h2 = ray_tpu_torch.get_actor("det_local")
    assert ray_tpu_torch.get(h2.inc.remote()) == 2
    ray_tpu_torch.kill(h2)
    with pytest.raises(ValueError, match="no live actor"):
        ray_tpu_torch.get_actor("det_local")


def test_detached_actor_survives_driver(tmp_path):
    """Driver A creates a named detached actor on a cluster raylet and
    exits cleanly; driver B connects, finds it via get_actor, observes
    A's state (same instance), kills it; the name is freed."""
    session = f"det{os.getpid()}"
    head = _cli("start", "--head", "--session", session)
    assert head.returncode == 0, head.stderr
    m = re.search(r"at (\d+\.\d+\.\d+\.\d+:\d+)", head.stdout)
    assert m, head.stdout
    addr = m.group(1)
    try:
        node = _cli("start", "--address", addr, "--session", session,
                    "--num-cpus", "2")
        assert node.returncode == 0, node.stderr
        assert "raylet started" in node.stdout

        driver_a = tmp_path / "driver_a.py"
        driver_a.write_text(f"""
import ray_tpu_torch
ray_tpu_torch.init(address="{addr}", num_cpus=1, num_gpus=0,
                   max_process_workers=1)

@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0
    def inc(self):
        self.n += 1
        return self.n

h = Counter.options(name="svc", lifetime="detached",
                    num_cpus=1).remote()
assert ray_tpu_torch.get(h.inc.remote(), timeout=120) == 1
assert ray_tpu_torch.get(h.inc.remote(), timeout=60) == 2
print("A-OK")
ray_tpu_torch.shutdown()
""")
        run_a = _run_driver(driver_a)
        assert run_a.returncode == 0, run_a.stderr[-3000:]
        assert "A-OK" in run_a.stdout

        driver_b = tmp_path / "driver_b.py"
        driver_b.write_text(f"""
import ray_tpu_torch
ray_tpu_torch.init(address="{addr}", num_cpus=1, num_gpus=0,
                   max_process_workers=1)
h = ray_tpu_torch.get_actor("svc")
# Same instance driver A incremented twice: state proves the worker
# survived A's exit.
assert ray_tpu_torch.get(h.inc.remote(), timeout=120) == 3
ray_tpu_torch.kill(h)
import time
for _ in range(50):
    try:
        ray_tpu_torch.get_actor("svc")
    except ValueError:
        break
    time.sleep(0.2)
else:
    raise AssertionError("name not freed after kill")
print("B-OK")
ray_tpu_torch.shutdown()
""")
        run_b = _run_driver(driver_b)
        assert run_b.returncode == 0, run_b.stderr[-3000:]
        assert "B-OK" in run_b.stdout
    finally:
        stop = _cli("stop", "--session", session)
        assert "terminated" in stop.stdout


def test_non_detached_actor_reaped_on_driver_exit(tmp_path):
    """The inverse guarantee: a NON-detached named actor does not
    outlive its driver — a later driver finds it dead/absent."""
    session = f"ndet{os.getpid()}"
    head = _cli("start", "--head", "--session", session)
    assert head.returncode == 0, head.stderr
    m = re.search(r"at (\d+\.\d+\.\d+\.\d+:\d+)", head.stdout)
    assert m, head.stdout
    addr = m.group(1)
    try:
        node = _cli("start", "--address", addr, "--session", session,
                    "--num-cpus", "2")
        assert node.returncode == 0, node.stderr

        driver_a = tmp_path / "driver_a2.py"
        driver_a.write_text(f"""
import ray_tpu_torch
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
ray_tpu_torch.init(address="{addr}", num_cpus=1, num_gpus=0,
                   max_process_workers=1)

@ray_tpu_torch.remote
class P:
    def ping(self):
        return "pong"

# Force it onto the cluster raylet so survival would even be possible.
from ray_tpu_torch._private.worker import global_worker
remotes = list(global_worker().node_group._remote_nodes)
h = P.options(name="mortal", num_cpus=1,
              scheduling_strategy=NodeAffinitySchedulingStrategy(
                  node_id=remotes[0].hex())).remote()
assert ray_tpu_torch.get(h.ping.remote(), timeout=120) == "pong"
print("A2-OK")
ray_tpu_torch.shutdown()
""")
        run_a = _run_driver(driver_a)
        assert run_a.returncode == 0, run_a.stderr[-3000:]
        assert "A2-OK" in run_a.stdout

        driver_b = tmp_path / "driver_b2.py"
        driver_b.write_text(f"""
import ray_tpu_torch
ray_tpu_torch.init(address="{addr}", num_cpus=1, num_gpus=0,
                   max_process_workers=1)
try:
    ray_tpu_torch.get_actor("mortal")
    raise AssertionError("non-detached actor survived its driver")
except ValueError:
    pass
print("B2-OK")
ray_tpu_torch.shutdown()
""")
        run_b = _run_driver(driver_b)
        assert run_b.returncode == 0, run_b.stderr[-3000:]
        assert "B2-OK" in run_b.stdout
    finally:
        stop = _cli("stop", "--session", session)
        assert "terminated" in stop.stdout
