"""The port's async (asyncio) actors: the cases of the JAX package's
``tests/test_async_actors.py`` (event-loop execution, ordering,
concurrency caps, streaming generators, cancellation on kill, the
batched actor wire path) run against ``ray_tpu_torch`` on
``init(num_cpus=4, num_gpus=0, max_process_workers=3)``: the reference's
``init`` detects no accelerator on the CPU, and the port's asks for the
count. Serve's replicas are such actors.
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


@pytest.fixture()
def rt():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, max_process_workers=3)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_async_method_basic(rt):
    @ray_tpu_torch.remote
    class A:
        def __init__(self):
            self.n = 0

        async def add(self, k):
            self.n += k
            return self.n

    a = A.remote()
    assert ray_tpu_torch.get(a.add.remote(5)) == 5
    assert ray_tpu_torch.get(a.add.remote(2)) == 7


def test_async_calls_start_in_submission_order(rt):
    @ray_tpu_torch.remote
    class Tagger:
        def __init__(self):
            self.order = []

        async def tag(self, i):
            # no awaits: start order IS completion order
            self.order.append(i)
            return i

        async def order_seen(self):
            return list(self.order)

    t = Tagger.remote()
    refs = [t.tag.remote(i) for i in range(100)]
    ray_tpu_torch.get(refs)
    assert ray_tpu_torch.get(t.order_seen.remote()) == list(range(100))


def test_async_concurrency_overlaps(rt):
    @ray_tpu_torch.remote
    class Sleeper:
        async def nap(self, t):
            import asyncio
            await asyncio.sleep(t)
            return t

    s = Sleeper.remote()
    ray_tpu_torch.get(s.nap.remote(0.0))      # actor up
    t0 = time.perf_counter()
    ray_tpu_torch.get([s.nap.remote(0.3) for _ in range(8)])
    dt = time.perf_counter() - t0
    # 8 concurrent 0.3s naps must overlap (serial would be 2.4s)
    assert dt < 1.5, dt


def test_async_max_concurrency_cap(rt):
    @ray_tpu_torch.remote
    class Gauge:
        def __init__(self):
            self.inflight = 0
            self.peak = 0

        async def work(self):
            import asyncio
            self.inflight += 1
            self.peak = max(self.peak, self.inflight)
            await asyncio.sleep(0.02)
            self.inflight -= 1

        async def peak_seen(self):
            return self.peak

    g = Gauge.options(max_concurrency=3).remote()
    ray_tpu_torch.get([g.work.remote() for _ in range(12)])
    peak = ray_tpu_torch.get(g.peak_seen.remote())
    assert 1 <= peak <= 3, peak


def test_async_coroutines_interleave_at_awaits(rt):
    @ray_tpu_torch.remote
    class Rendezvous:
        def __init__(self):
            import asyncio
            self.evt = asyncio.Event()

        async def waiter(self):
            await self.evt.wait()
            return "woke"

        async def setter(self):
            self.evt.set()
            return "set"

    r = Rendezvous.remote()
    w = r.waiter.remote()       # blocks until the LATER call runs
    s = r.setter.remote()
    assert ray_tpu_torch.get(s) == "set"
    assert ray_tpu_torch.get(w, timeout=10) == "woke"


def test_async_error_propagates(rt):
    @ray_tpu_torch.remote
    class Boom:
        async def go(self):
            raise ValueError("async boom")

    b = Boom.remote()
    with pytest.raises(ValueError, match="async boom"):
        ray_tpu_torch.get(b.go.remote())


def test_async_generator_streaming(rt):
    @ray_tpu_torch.remote
    class Streamer:
        async def produce(self, n):
            import asyncio
            for i in range(n):
                await asyncio.sleep(0.001)
                yield i * 2

    s = Streamer.remote()
    gen = s.produce.options(num_returns="streaming").remote(6)
    items = [ray_tpu_torch.get(r) for r in gen]
    assert items == [0, 2, 4, 6, 8, 10]


def test_sync_generator_streaming_on_actor(rt):
    @ray_tpu_torch.remote
    class Gen:
        def produce(self, n):
            for i in range(n):
                yield i + 1

    g = Gen.remote()
    gen = g.produce.options(num_returns="streaming").remote(4)
    assert [ray_tpu_torch.get(r) for r in gen] == [1, 2, 3, 4]


def test_streaming_consumes_before_producer_finishes(rt):
    @ray_tpu_torch.remote
    class Slow:
        async def produce(self):
            import asyncio
            yield "first"
            await asyncio.sleep(5.0)
            yield "last"

    s = Slow.remote()
    gen = s.produce.options(num_returns="streaming").remote()
    t0 = time.perf_counter()
    first = ray_tpu_torch.get(next(gen))
    dt = time.perf_counter() - t0
    assert first == "first"
    # the first item must arrive long before the producer finishes
    assert dt < 4.0, dt


def test_kill_cancels_pending_async_calls(rt):
    @ray_tpu_torch.remote
    class Stuck:
        async def hang(self):
            import asyncio
            await asyncio.sleep(60)
            return "never"

        async def quick(self):
            return "ok"

    a = Stuck.remote()
    assert ray_tpu_torch.get(a.quick.remote()) == "ok"
    inflight = [a.hang.remote() for _ in range(3)]
    time.sleep(0.3)             # let them reach the worker
    ray_tpu_torch.kill(a)
    from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError
    for ref in inflight:
        with pytest.raises((ActorDiedError, WorkerCrashedError)):
            ray_tpu_torch.get(ref, timeout=10)
    # queued-after-kill calls fail fast too
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(a.quick.remote(), timeout=10)


def test_sync_actor_batch_ordering(rt):
    # the batched wire path must preserve per-actor call order
    @ray_tpu_torch.remote
    class Seq:
        def __init__(self):
            self.vals = []

        def push(self, i):
            self.vals.append(i)
            return i

        def all(self):
            return list(self.vals)

    s = Seq.remote()
    refs = [s.push.remote(i) for i in range(300)]
    ray_tpu_torch.get(refs)
    assert ray_tpu_torch.get(s.all.remote()) == list(range(300))


def test_batch_with_dependencies(rt):
    # calls whose args are not-yet-ready refs must still dispatch in
    # order once the deps land
    @ray_tpu_torch.remote
    def slow_value():
        time.sleep(0.3)
        return 10

    @ray_tpu_torch.remote
    class Acc:
        def __init__(self):
            self.total = 0

        def add(self, v):
            self.total += v
            return self.total

    a = Acc.remote()
    dep = slow_value.remote()
    r1 = a.add.remote(1)        # ready immediately
    r2 = a.add.remote(dep)      # blocked on dep
    r3 = a.add.remote(2)        # behind r2 in order
    assert ray_tpu_torch.get(r1) == 1
    assert ray_tpu_torch.get(r2) == 11
    assert ray_tpu_torch.get(r3) == 13


def test_async_actor_restart_replays(rt):
    # an async actor with max_restarts recovers and NEW calls land on
    # the restarted instance (max_task_retries stays 0: retrying die()
    # would correctly kill the replacement too)
    @ray_tpu_torch.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        async def bump(self):
            self.n += 1
            return self.n

        async def die(self):
            import os
            os._exit(1)

    f = Flaky.remote()
    assert ray_tpu_torch.get(f.bump.remote()) == 1
    f.die.remote()
    # restarted instance starts fresh; new calls land on it
    for _ in range(100):
        try:
            if ray_tpu_torch.get(f.bump.remote(), timeout=15) >= 1:
                break
        except Exception:
            time.sleep(0.2)
    else:
        pytest.fail("actor did not come back after restart")


def test_async_actor_throughput_smoke(rt):
    # not a perf gate (bench.py carries that); just assert the batched
    # async path sustains a few thousand calls quickly
    @ray_tpu_torch.remote
    class C:
        def __init__(self):
            self.n = 0

        async def ping(self):
            self.n += 1
            return self.n

    c = C.remote()
    ray_tpu_torch.get(c.ping.remote())
    m = 2000
    t0 = time.perf_counter()
    refs = [c.ping.remote() for _ in range(m)]
    assert ray_tpu_torch.get(refs)[-1] == m + 1
    dt = time.perf_counter() - t0
    assert m / dt > 500, f"async path too slow: {m/dt:.0f}/s"
