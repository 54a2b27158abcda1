"""The port's util layer (``ray_tpu_torch.util``): the cases of
``tests/test_util.py`` that the port's other files do not mirror yet:
``ActorPool``, ``Queue`` and the state API's lists, on ``ray_tpu_torch``
with the reference's assertions.
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import state
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it. Imported
    here, not at the top: a process worker that unpickles this module's
    functions then loads no torch."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def ray_start_regular():
    """The reference's fixture on the port: 4 CPUs, 2 process workers and
    8 GPUs of resource, whose work runs on driver threads."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Sq:
    def compute(self, x):
        return x * x


def test_actor_pool_ordered_and_unordered(ray_start_regular):
    actors = [_Sq.remote() for _ in range(2)]
    pool = ActorPool(actors)
    out = list(pool.map(lambda a, v: a.compute.remote(v), range(8)))
    assert out == [i * i for i in range(8)]
    out2 = sorted(pool.map_unordered(
        lambda a, v: a.compute.remote(v), range(8)))
    assert out2 == sorted(i * i for i in range(8))


def test_actor_pool_submit_get_next(ray_start_regular):
    pool = ActorPool([_Sq.remote()])
    pool.submit(lambda a, v: a.compute.remote(v), 3)
    assert pool.has_next()
    assert not pool.has_free()
    assert pool.get_next(timeout=60) == 9
    assert pool.has_free()


def test_queue_roundtrip_and_bounds(ray_start_regular):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    with pytest.raises(Full):
        q.put(3, block=False)
    assert q.qsize() == 2
    assert q.get() == 1
    assert q.get() == 2
    with pytest.raises(Empty):
        q.get_nowait()
    q.put_batch([10, 11])
    assert q.get() == 10
    q.shutdown()


def test_queue_blocking_get(ray_start_regular):
    """get() blocks until a producer (another driver thread) puts."""
    q = Queue()

    def producer():
        time.sleep(0.3)
        q.put("late")

    threading.Thread(target=producer, daemon=True).start()
    assert q.get(timeout=30) == "late"
    q.shutdown()


def test_state_api_lists(ray_start_regular):
    @ray_tpu_torch.remote
    def work(x):
        return x + 1

    @ray_tpu_torch.remote
    class A:
        def hi(self):
            return "hi"

    ray_tpu_torch.get([work.remote(i) for i in range(3)])
    a = A.remote()
    ray_tpu_torch.get(a.hi.remote())

    nodes = state.list_nodes()
    assert len(nodes) >= 1 and any(n["is_head"] for n in nodes)
    actors = state.list_actors()
    assert any(x["class_name"] == "A" and x["state"] == "ALIVE"
               for x in actors)
    tasks = state.list_tasks()
    assert sum(1 for t in tasks if t["status"] == "finished") >= 3
    objs = state.list_objects()
    assert isinstance(objs, list)
    s = state.summary()
    assert s["tasks"]["finished"] >= 3
    assert s["actors"]["ALIVE"] >= 1
    workers = state.list_workers()
    assert any(w["kind"] == "logical" for w in workers)
