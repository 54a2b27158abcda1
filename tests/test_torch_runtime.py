"""The port's runtime core on the CPU: the cases of the JAX package's
``test_basic.py``, ``test_actor.py``, ``test_ids.py``,
``test_object_store.py`` and ``test_serialization.py``, run against
``ray_tpu_torch`` on ``init(num_cpus=4, num_gpus=8, max_process_workers=2)``
(the reference's tests take ``num_tpus=8``; the port's node counts GPUs),
plus the tensor cases of the port's serialization context."""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
)
from ray_tpu_torch._private.object_store import (
    MemoryStore,
    ObjectStoreFullError,
    ShmClient,
    ShmStore,
)
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, TaskError


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


# -- the cases of tests/test_basic.py -------------------------------------

def test_simple_task(ray_start_regular):
    @ray_tpu_torch.remote
    def f(a, b):
        return a + b

    assert ray_tpu_torch.get(f.remote(1, 2)) == 3


def test_kwargs_and_options(ray_start_regular):
    @ray_tpu_torch.remote
    def f(a, b=10, *, c=0):
        return a + b + c

    assert ray_tpu_torch.get(f.remote(1)) == 11
    assert ray_tpu_torch.get(f.remote(1, b=2, c=3)) == 6
    assert ray_tpu_torch.get(f.options(num_cpus=2).remote(1)) == 11


def test_task_dependencies(ray_start_regular):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    r = f.remote(0)
    for _ in range(5):
        r = f.remote(r)
    assert ray_tpu_torch.get(r) == 6


def test_tree_reduce_dag(ray_start_regular):
    """BASELINE.json config 2 (miniature): recursive tree reduce."""

    @ray_tpu_torch.remote
    def leaf(i):
        return i

    @ray_tpu_torch.remote
    def combine(a, b):
        return a + b

    refs = [leaf.remote(i) for i in range(16)]
    while len(refs) > 1:
        refs = [combine.remote(refs[i], refs[i + 1])
                for i in range(0, len(refs), 2)]
    assert ray_tpu_torch.get(refs[0]) == sum(range(16))


def test_large_objects_shm(ray_start_regular):
    @ray_tpu_torch.remote
    def make():
        return np.arange(500_000, dtype=np.float64)

    @ray_tpu_torch.remote
    def consume(arr):
        return float(arr.sum())

    ref = make.remote()
    total = ray_tpu_torch.get(consume.remote(ref))
    assert total == float(np.arange(500_000).sum())


def test_put_get_roundtrip(ray_start_regular):
    obj = {"k": np.ones(10), "s": "hello"}
    ref = ray_tpu_torch.put(obj)
    out = ray_tpu_torch.get(ref)
    assert out["s"] == "hello"
    np.testing.assert_array_equal(out["k"], np.ones(10))


def test_multiple_returns(ray_start_regular):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray_tpu_torch.get([a, b, c]) == [1, 2, 3]


def test_error_propagation(ray_start_regular):
    @ray_tpu_torch.remote(max_retries=0)
    def bad():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        ray_tpu_torch.get(bad.remote())
    with pytest.raises(TaskError):
        ray_tpu_torch.get(bad.remote())


def test_dependent_task_error(ray_start_regular):
    @ray_tpu_torch.remote(max_retries=0)
    def bad():
        raise RuntimeError("upstream")

    @ray_tpu_torch.remote
    def dependent(x):
        return x

    with pytest.raises(RuntimeError):
        ray_tpu_torch.get(dependent.remote(bad.remote()))


def test_retry_on_app_error(ray_start_regular):
    @ray_tpu_torch.remote
    class FlakyState:
        def __init__(self):
            self.calls = 0

        def incr(self):
            self.calls += 1
            return self.calls

    state = FlakyState.remote()

    @ray_tpu_torch.remote(max_retries=2, retry_exceptions=True)
    def flaky(s):
        import ray_tpu_torch as rt
        n = rt.get(s.incr.remote()) if False else None  # noqa: F841
        raise ValueError("always fails")

    with pytest.raises(ValueError):
        ray_tpu_torch.get(flaky.remote(1))


def test_get_timeout(ray_start_regular):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(slow.remote(), timeout=0.5)


def test_wait(ray_start_regular):
    @ray_tpu_torch.remote
    def quick(i):
        return i

    @ray_tpu_torch.remote
    def slow():
        time.sleep(30)

    refs = [quick.remote(i) for i in range(4)] + [slow.remote()]
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=4, timeout=20)
    assert len(ready) == 4
    assert len(not_ready) == 1


def test_nested_object_refs(ray_start_regular):
    @ray_tpu_torch.remote
    def make():
        return 7

    inner = make.remote()
    ref = ray_tpu_torch.put({"inner": inner})
    out = ray_tpu_torch.get(ref)
    assert ray_tpu_torch.get(out["inner"]) == 7


def test_cluster_resources(ray_start_regular):
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 4.0
    assert res["GPU"] == 8.0
    assert "TPU" not in res


def test_many_small_tasks(ray_start_regular):
    @ray_tpu_torch.remote
    def sq(i):
        return i * i

    refs = [sq.remote(i) for i in range(200)]
    assert sum(ray_tpu_torch.get(refs)) == sum(i * i for i in range(200))


# -- the cases of tests/test_actor.py -------------------------------------

def test_actor_basic(ray_start_regular):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def inc(self, k=1):
            self.v += k
            return self.v

        def get(self):
            return self.v

    c = Counter.remote(10)
    assert ray_tpu_torch.get(c.inc.remote()) == 11
    assert ray_tpu_torch.get(c.inc.remote(5)) == 16
    assert ray_tpu_torch.get(c.get.remote()) == 16


def test_actor_ordering(ray_start_regular):
    @ray_tpu_torch.remote
    class Appender:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)
            return len(self.items)

        def get(self):
            return self.items

    a = Appender.remote()
    for i in range(20):
        a.add.remote(i)
    assert ray_tpu_torch.get(a.get.remote()) == list(range(20))


def test_two_actors_independent(ray_start_regular):
    @ray_tpu_torch.remote
    class Holder:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v

    a, b = Holder.remote("a"), Holder.remote("b")
    assert ray_tpu_torch.get([a.get.remote(), b.get.remote()]) == ["a", "b"]


def test_actor_creation_error(ray_start_regular):
    @ray_tpu_torch.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("cannot construct")

        def m(self):
            return 1

    broken = Broken.remote()
    with pytest.raises((RuntimeError, ActorDiedError)):
        ray_tpu_torch.get(broken.m.remote())


def test_actor_method_error(ray_start_regular):
    @ray_tpu_torch.remote
    class Faulty:
        def ok(self):
            return "fine"

        def bad(self):
            raise KeyError("nope")

    f = Faulty.remote()
    assert ray_tpu_torch.get(f.ok.remote()) == "fine"
    with pytest.raises(KeyError):
        ray_tpu_torch.get(f.bad.remote())
    # actor still alive after method error
    assert ray_tpu_torch.get(f.ok.remote()) == "fine"


def test_named_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class Registry:
        def ping(self):
            return "pong"

    Registry.options(name="reg").remote()
    h = ray_tpu_torch.get_actor("reg")
    assert ray_tpu_torch.get(h.ping.remote()) == "pong"


def test_kill_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    assert ray_tpu_torch.get(v.ping.remote()) == "pong"
    ray_tpu_torch.kill(v)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(v.ping.remote())


def test_actor_restart(ray_start_regular):
    @ray_tpu_torch.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.lives = 1

        def ping(self):
            return "pong"

        def die(self):
            import os
            os._exit(1)

    p = Phoenix.remote()
    assert ray_tpu_torch.get(p.ping.remote()) == "pong"
    p.die.remote()
    # after restart the actor serves again (state reset)
    import time
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            assert ray_tpu_torch.get(p.ping.remote(), timeout=30) == "pong"
            break
        except Exception:
            time.sleep(0.5)
    else:
        raise AssertionError("actor did not restart")


# -- the cases of tests/test_ids.py ---------------------------------------

def test_sizes_and_roundtrip():
    job = JobID.from_int(7)
    assert len(job.binary()) == 4
    actor = ActorID.of(job)
    assert actor.job_id() == job
    task = TaskID.of(actor)
    assert task.actor_id() == actor
    assert task.job_id() == job
    oid = ObjectID.from_index(task, 3)
    assert oid.task_id() == task
    assert oid.index() == 3
    assert not oid.is_put()


def test_put_index_space_disjoint():
    task = TaskID.for_normal_task(JobID.from_int(1))
    ret = ObjectID.from_index(task, 1)
    put = ObjectID.for_put(task, 1)
    assert ret != put
    assert put.is_put()


def test_hex_roundtrip_equality_hash():
    n = NodeID.from_random()
    assert NodeID.from_hex(n.hex()) == n
    assert hash(NodeID.from_hex(n.hex())) == hash(n)
    assert n != NodeID.from_random()
    assert NodeID.nil().is_nil()


def test_ids_pickle():
    import pickle
    t = TaskID.for_normal_task(JobID.from_int(2))
    assert pickle.loads(pickle.dumps(t)) == t


# -- the cases of tests/test_object_store.py ------------------------------

def _oid(i: int) -> ObjectID:
    return ObjectID.from_index(TaskID.for_normal_task(JobID.from_int(1)), i)


@pytest.fixture
def store(tmp_path):
    s = ShmStore("testsess", capacity_bytes=1 << 20,
                 spill_dir=str(tmp_path), spill_threshold=0.8)
    yield s
    s.shutdown()


def test_create_seal_get(store):
    oid = _oid(1)
    buf = store.create(oid, 100)
    buf[:5] = b"hello"
    store.seal(oid)
    assert store.contains(oid)
    view = store.get_local(oid)
    assert bytes(view[:5]) == b"hello"
    del buf, view


def test_reader_attach(store):
    oid = _oid(2)
    store.put_blob(oid, b"shared-data")
    name, size = store.segment_for(oid)
    client = ShmClient("testsess")
    data = client.read(name, size)
    assert bytes(data) == b"shared-data"
    del data
    client.close()


def test_spill_and_restore(store):
    blobs = {}
    for i in range(20):
        oid = _oid(10 + i)
        payload = bytes([i]) * 100_000
        blobs[oid] = payload
        store.put_blob(oid, payload)
    assert store.num_spilled > 0
    # every object still readable (restored on demand)
    for oid, payload in blobs.items():
        view = store.get_local(oid)
        assert bytes(view[:10]) == payload[:10]
        del view
    assert store.num_restored > 0


def test_store_full(store):
    with pytest.raises(ObjectStoreFullError):
        store.create(_oid(99), 2 << 20)


def test_free(store):
    oid = _oid(3)
    store.put_blob(oid, b"x" * 100)
    store.free(oid)
    assert not store.contains(oid)
    assert store.get_local(oid) is None


def test_memory_store_wait():
    import threading
    ms = MemoryStore()
    oids = [_oid(i) for i in range(5)]
    ready, not_ready = ms.wait(oids, num_returns=1, timeout=0.05)
    assert len(ready) == 0 and len(not_ready) == 5

    def putter():
        for o in oids[:3]:
            ms.put(o, "v")

    t = threading.Thread(target=putter)
    t.start()
    ready, not_ready = ms.wait(oids, num_returns=3, timeout=5)
    t.join()
    assert len(ready) == 3 and len(not_ready) == 2


# -- the cases of tests/test_serialization.py -----------------------------

def test_roundtrip_scalars_and_containers():
    ctx = serialization.get_context()
    for value in [1, "x", None, {"a": [1, 2]}, (1, 2), {1, 2}, b"bytes"]:
        ser = ctx.serialize(value)
        out, refs = ctx.deserialize_from_blob(memoryview(ser.to_bytes()))
        assert out == value
        assert refs == []


def test_numpy_zero_copy():
    ctx = serialization.get_context()
    arr = np.arange(1000, dtype=np.float32)
    ser = ctx.serialize({"a": arr, "b": 5})
    assert ser.buffers, "large numpy should go out-of-band"
    blob = ser.to_bytes()
    out, _ = ctx.deserialize_from_blob(memoryview(blob))
    np.testing.assert_array_equal(out["a"], arr)
    # The deserialized array aliases the blob (zero-copy).
    assert not out["a"].flags.writeable or out["a"].base is not None


def test_write_into_matches_to_bytes():
    ctx = serialization.get_context()
    value = {"x": np.ones(512), "y": list(range(100))}
    ser = ctx.serialize(value)
    size = ser.size_with_header()
    buf = bytearray(size)
    written = ser.write_into(memoryview(buf))
    assert written == size
    assert bytes(buf) == ser.to_bytes()


def test_closure_serialization():
    ctx = serialization.get_context()
    k = 42

    def fn(x):
        return x + k

    ser = ctx.serialize(fn)
    out, _ = ctx.deserialize_from_blob(memoryview(ser.to_bytes()))
    assert out(1) == 43



# -- the port's own: tensors in the serialization context -----------------


@pytest.mark.parametrize("make", [
    lambda: torch.arange(12.0).reshape(3, 4),
    lambda: torch.ones(5, dtype=torch.bfloat16),
    lambda: torch.tensor(7, dtype=torch.int64),
    lambda: torch.zeros(0, 3),
    lambda: torch.arange(20.0)[::3],
], ids=["fp32", "bf16", "scalar", "empty", "strided"])
def test_tensor_roundtrip_out_of_band(make):
    ctx = serialization.get_context()
    t = make()
    ser = ctx.serialize({"t": t, "n": 1})
    if t.numel():
        assert ser.buffers, "a tensor's bytes go out-of-band"
    out, _ = ctx.deserialize_from_blob(memoryview(ser.to_bytes()))
    assert out["t"].dtype == t.dtype and out["t"].shape == t.shape
    assert out["t"].device.type == "cpu"
    assert torch.equal(out["t"], t)
    out["t"].add_(1)                    # a private, writable copy
    assert torch.equal(out["t"] - 1, t)


def test_parameter_and_requires_grad_survive():
    ctx = serialization.get_context()
    p = torch.nn.Parameter(torch.ones(3))
    g = torch.ones(2, requires_grad=True)
    out, _ = ctx.deserialize_from_blob(
        memoryview(ctx.serialize([p, g]).to_bytes()))
    assert isinstance(out[0], torch.nn.Parameter) and out[0].requires_grad
    assert out[1].requires_grad and not isinstance(out[1],
                                                   torch.nn.Parameter)


def test_cuda_tag_rebuilds_on_cpu_without_a_card(monkeypatch):
    """A tensor tagged ``cuda`` (as one from the card is) loads on the
    CPU in a process that has no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, args = serialization._reduce_tensor(torch.arange(4.0))
    out = fn(args[0], args[1], args[2], "cuda:0", *args[4:])
    assert out.device.type == "cpu" and torch.equal(out, torch.arange(4.0))
