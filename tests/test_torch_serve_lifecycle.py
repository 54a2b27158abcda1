"""The port's Serve replica lifecycle: the cases of the JAX package's
``tests/test_serve.py`` that kill, autoscale, roll or drain replicas,
run against ``ray_tpu_torch.serve`` on ``init(num_cpus=4, num_gpus=8,
max_process_workers=2)``.
"""

import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve


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
    """A small single-host runtime (2 process workers, 8 GPUs of
    resource; no card is needed for work that demands none)."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


@pytest.fixture
def serve_instance(ray_start_regular):
    yield serve
    serve.shutdown()


def test_replica_death_recovery(serve_instance):
    @serve.deployment(num_replicas=2)
    class Svc:
        def __call__(self, x):
            return x + 1

    handle = serve.run(Svc.bind())
    controller = serve._controller
    info_replicas = controller._deployments["Svc"].replicas
    victim = info_replicas[0]
    ray_tpu_torch.kill(victim)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = serve.status()["Svc"]
        live = controller._deployments["Svc"].replicas
        if st["live_replicas"] == 2 and victim not in live:
            break
        time.sleep(0.1)
    st = serve.status()["Svc"]
    assert st["live_replicas"] == 2
    # service keeps working through the replacement
    assert ray_tpu_torch.get(handle.remote(1), timeout=60) == 2

def test_autoscale_up_and_down_on_ongoing_requests(serve_instance):
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 1.0,
        "upscale_delay_s": 0.2, "downscale_delay_s": 0.6})
    class Slow:
        def __call__(self, x):
            time.sleep(1.0)
            return x

    handle = serve.run(Slow.bind())
    assert serve.status()["Slow"]["live_replicas"] == 1
    # flood: sustained ongoing > target -> scale up
    refs = [handle.remote(i) for i in range(12)]
    deadline = time.monotonic() + 45
    scaled_up = False
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["live_replicas"] >= 2:
            scaled_up = True
            break
        time.sleep(0.1)
    assert scaled_up, f"never scaled up: {serve.status()}"
    ray_tpu_torch.get(refs, timeout=90)
    # idle -> scale back down to min
    deadline = time.monotonic() + 45
    scaled_down = False
    while time.monotonic() < deadline:
        if serve.status()["Slow"]["live_replicas"] == 1:
            scaled_down = True
            break
        time.sleep(0.2)
    assert scaled_down, f"never scaled down: {serve.status()}"

def test_rolling_redeploy_zero_dropped_requests(serve_instance):
    """Redeploy under load: no request fails, both versions are
    observed serving during the roll, and the roll converges to only
    the new version (reference: DeploymentVersion rolling update)."""
    import threading

    @serve.deployment(num_replicas=2)
    class V:
        def __init__(self, tag):
            self.tag = tag

        def __call__(self, i):
            time.sleep(0.02)
            return (self.tag, i)

    handle = serve.run(V.bind("v1"), name="roll")
    results, errors = [], []
    stop = threading.Event()

    def spam():
        i = 0
        while not stop.is_set():
            try:
                results.append(ray_tpu_torch.get(handle.remote(i), timeout=60))
            except Exception as e:   # noqa: BLE001
                errors.append(e)
            i += 1

    threads = [threading.Thread(target=spam) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        serve.run(V.options(num_replicas=2).bind("v2"), name="roll")
        # roll completes: no old-generation replicas remain
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = serve.status()["roll"]
            if (not st["updating"] and st["live_replicas"] == 2
                    and st["draining_replicas"] == 0):
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"roll never converged: {st}")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, f"dropped requests during roll: {errors[:3]}"
    tags = {tag for tag, _ in results}
    assert tags == {"v1", "v2"}, (
        f"both versions should serve during the roll, saw {tags}")
    # fresh post-roll traffic (threads stopped) must be all-v2
    post = {ray_tpu_torch.get(handle.remote(i), timeout=60)[0]
            for i in range(6)}
    assert post == {"v2"}, f"old version served after the roll: {post}"
    serve.delete("roll")

def test_downscale_drains_in_flight(serve_instance):
    """Scaling 3 -> 1 under load: victims finish their in-flight
    requests before dying — zero failures (reference: graceful
    shutdown on replica removal)."""
    import threading

    @serve.deployment(num_replicas=3)
    class Slow:
        def __call__(self, i):
            time.sleep(0.05)
            return i

    handle = serve.run(Slow.bind(), name="down")
    results, errors = [], []
    stop = threading.Event()

    def spam():
        i = 0
        while not stop.is_set():
            try:
                results.append(ray_tpu_torch.get(handle.remote(i), timeout=60))
            except Exception as e:   # noqa: BLE001
                errors.append(e)
            i += 1

    threads = [threading.Thread(target=spam) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.4)
        serve.run(Slow.options(num_replicas=1).bind(), name="down")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = serve.status()["down"]
            if st["live_replicas"] == 1 and st["draining_replicas"] == 0:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"downscale never converged: {st}")
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, f"dropped requests during downscale: {errors[:3]}"
    assert len(results) > 20
    serve.delete("down")
