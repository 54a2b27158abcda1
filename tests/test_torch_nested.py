"""Nested API calls from process workers, on the port: the cases of the
JAX package's ``tests/test_nested.py`` run against ``ray_tpu_torch`` on
``init(num_cpus=4, num_gpus=8, max_process_workers=2)`` (the reference
takes ``num_tpus=8``), plus the smallest nested call (a task returning
``get(put(3))``) in both packages, and a nested ``get`` of a CPU tensor
that the driver put."""

import numpy as np
import pytest
import torch

import ray_tpu
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
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


# -- the cases of tests/test_nested.py ------------------------------------

def test_nested_fan_out(ray_start_regular):
    @ray_tpu_torch.remote
    def child(i):
        return i * 10

    @ray_tpu_torch.remote
    def parent(n):
        import ray_tpu_torch as rt
        refs = [child.remote(i) for i in range(n)]
        return sum(rt.get(refs))

    assert ray_tpu_torch.get(parent.remote(4), timeout=180) == 60


def test_nested_recursion_with_blocking_parents(ray_start_regular):
    """Multiple levels of parents blocked in get() at once — the pool
    must lend slots or this deadlocks at max_process_workers=2."""

    @ray_tpu_torch.remote
    def fib(n):
        if n < 2:
            return n
        import ray_tpu_torch as rt
        return sum(rt.get([fib.remote(n - 1), fib.remote(n - 2)]))

    assert ray_tpu_torch.get(fib.remote(5), timeout=300) == 5


def test_nested_put_and_ref_passing(ray_start_regular):
    @ray_tpu_torch.remote
    def total(x):
        return float(np.asarray(x).sum())

    @ray_tpu_torch.remote
    def parent():
        import ray_tpu_torch as rt
        big = np.ones(200_000)
        ref = rt.put(big)
        return rt.get(total.remote(ref))

    assert ray_tpu_torch.get(parent.remote(), timeout=180) == 200_000.0


def test_nested_wait(ray_start_regular):
    @ray_tpu_torch.remote
    def quick(i):
        return i

    @ray_tpu_torch.remote
    def parent():
        import ray_tpu_torch as rt
        refs = [quick.remote(i) for i in range(3)]
        ready, not_ready = rt.wait(refs, num_returns=3, timeout=120)
        return len(ready), len(not_ready)

    assert ray_tpu_torch.get(parent.remote(), timeout=180) == (3, 0)


def test_actor_created_and_called_from_task(ray_start_regular):
    """Tasks can create actors and call their methods — the full core
    API from anywhere."""

    @ray_tpu_torch.remote
    def orchestrate():
        import ray_tpu_torch as rt

        @rt.remote
        class Acc:
            def __init__(self, start):
                self.v = start

            def add(self, k):
                self.v += k
                return self.v

        acc = Acc.remote(100)
        out = [rt.get(acc.add.remote(i)) for i in (1, 2, 3)]
        rt.kill(acc)
        return out

    assert ray_tpu_torch.get(orchestrate.remote(), timeout=180) == [
        101, 103, 106]


def test_placement_group_from_task(ray_start_regular):
    """Gang scheduling works from inside a task (the full PG surface
    over the nested channel)."""

    @ray_tpu_torch.remote
    def gang():
        import ray_tpu_torch as rt
        from ray_tpu_torch.util.placement_group import (
            placement_group, remove_placement_group)
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy)

        pg = placement_group([{"CPU": 1}] * 2, strategy="PACK")
        rt.get(pg.ready(), timeout=60)

        @rt.remote(num_cpus=1)
        def member(i):
            return i * 7

        refs = [member.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                pg, placement_group_bundle_index=i)).remote(i)
            for i in range(2)]
        out = rt.get(refs)
        remove_placement_group(pg)
        return out

    assert ray_tpu_torch.get(gang.remote(), timeout=240) == [0, 7]


def test_actor_handle_passed_into_task(ray_start_regular):
    """A driver-created handle works inside a worker (method calls
    route through the owner)."""

    @ray_tpu_torch.remote
    class Store:
        def __init__(self):
            self.items = []

        def push(self, x):
            self.items.append(x)
            return len(self.items)

    @ray_tpu_torch.remote
    def producer(store, n):
        import ray_tpu_torch as rt
        return [rt.get(store.push.remote(i)) for i in range(n)]

    store = Store.remote()
    assert ray_tpu_torch.get(producer.remote(store, 3), timeout=180) == [
        1, 2, 3]


# -- the port's own cases --------------------------------------------------

@pytest.mark.parametrize("rt,accel", [(ray_tpu, "num_tpus"),
                                      (ray_tpu_torch, "num_gpus")],
                         ids=["ray_tpu", "ray_tpu_torch"])
def test_get_of_own_put_in_a_process_worker(rt, accel):
    """The smallest nested call: a process-worker task returns
    ``get(put(3))``. Both packages give 3."""
    rt.init(num_cpus=2, **{accel: 1}, max_process_workers=1)
    try:
        @rt.remote
        def nested():
            return rt.get(rt.put(3))

        assert rt.get(nested.remote(), timeout=120) == 3
    finally:
        rt.shutdown()


def test_nested_get_of_a_driver_put_tensor(ray_start_regular):
    """A process worker gets a CPU tensor that the driver put (its ref
    travels inside a list, so the task resolves it itself) and puts its
    sum; the driver's get of that ref is the tensor's sum."""
    t = torch.arange(4096, dtype=torch.float32).reshape(64, 64) / 7
    ref = ray_tpu_torch.put(t)

    @ray_tpu_torch.remote(num_cpus=1)
    def summed(refs):
        import ray_tpu_torch as rt
        x = rt.get(refs[0])
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        return rt.put(x.sum())

    out_ref = ray_tpu_torch.get(summed.remote([ref]), timeout=120)
    got = ray_tpu_torch.get(out_ref, timeout=60)
    assert isinstance(got, torch.Tensor)
    torch.testing.assert_close(got, t.sum(), rtol=0, atol=0)
