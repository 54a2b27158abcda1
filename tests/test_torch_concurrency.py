"""The port's threaded actors (``max_concurrency``): the cases of the JAX
package's ``tests/test_concurrency.py`` run against ``ray_tpu_torch`` on
``init(num_cpus=4, num_gpus=8, max_process_workers=2)``. The reference's
in-process (TPU) actor case is the port's in-process (GPU) actor, which
runs on a thread of the driver. Serve's ``max_ongoing_requests`` stands
on these caps.
"""

import time

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
    """A small single-host runtime (2 process workers, 8 GPUs of
    resource; no card is needed for work that demands none)."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


def test_threaded_actor_overlaps_calls(ray_start_regular):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Sleeper:
        def nap(self, i):
            time.sleep(1.0)
            return i

    s = Sleeper.remote()
    ray_tpu_torch.get(s.nap.remote(-1), timeout=120)   # warm the worker
    t0 = time.monotonic()
    refs = [s.nap.remote(i) for i in range(4)]
    assert sorted(ray_tpu_torch.get(refs, timeout=120)) == [0, 1, 2, 3]
    wall = time.monotonic() - t0
    assert wall < 3.0, f"calls did not overlap: {wall:.1f}s"


def test_max_concurrency_is_a_cap(ray_start_regular):
    """N is a CAP, not a boolean: an actor with max_concurrency=2
    never runs more than 2 calls at once."""

    @ray_tpu_torch.remote(max_concurrency=2)
    class Capped:
        def __init__(self):
            import threading
            self.lock = threading.Lock()
            self.inside = 0
            self.max_inside = 0

        def probe(self):
            with self.lock:
                self.inside += 1
                self.max_inside = max(self.max_inside, self.inside)
            time.sleep(0.4)
            with self.lock:
                self.inside -= 1
                return self.max_inside

    c = Capped.remote()
    out = ray_tpu_torch.get([c.probe.remote() for _ in range(6)], timeout=120)
    assert max(out) == 2, out


def test_gpu_actor_concurrency(ray_start_regular):
    """In-process (GPU) actors honor max_concurrency too."""

    @ray_tpu_torch.remote(num_gpus=1, max_concurrency=3)
    class DeviceActor:
        def nap(self, i):
            time.sleep(0.8)
            return i

    a = DeviceActor.remote()
    ray_tpu_torch.get(a.nap.remote(-1), timeout=120)
    t0 = time.monotonic()
    out = ray_tpu_torch.get([a.nap.remote(i) for i in range(3)], timeout=120)
    wall = time.monotonic() - t0
    assert sorted(out) == [0, 1, 2]
    assert wall < 2.0, f"in-process calls did not overlap: {wall:.1f}s"


def test_nested_call_from_user_thread(ray_start_regular):
    """User code spawning its own thread inside a task can still use
    the API (process-level owner-channel fallback)."""

    @ray_tpu_torch.remote
    def child():
        return 21

    @ray_tpu_torch.remote
    def parent():
        import threading
        import ray_tpu_torch as rt
        out = {}

        def helper():
            out["v"] = rt.get(child.remote()) * 2

        t = threading.Thread(target=helper)
        t.start()
        t.join(timeout=120)
        return out.get("v")

    assert ray_tpu_torch.get(parent.remote(), timeout=180) == 42


def test_default_actor_stays_serial(ray_start_regular):
    @ray_tpu_torch.remote
    class Serial:
        def __init__(self):
            self.inside = 0
            self.max_inside = 0

        def probe(self):
            self.inside += 1
            self.max_inside = max(self.max_inside, self.inside)
            time.sleep(0.3)
            self.inside -= 1
            return self.max_inside

    s = Serial.remote()
    out = ray_tpu_torch.get([s.probe.remote() for _ in range(4)], timeout=120)
    assert max(out) == 1          # never two calls inside at once
