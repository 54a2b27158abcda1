"""A ref ``put`` inside a task or an actor method and returned in a
container, on the port: the caller's ``get`` of the element returns the
value, whether the method ran on a thread of the driver (``num_gpus``
demand) or in a process worker, and the element is freed with its
container. Every wait is bounded."""

import time

import pytest
import torch

import ray_tpu_torch as rt

WAIT_S = 10


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def runtime():
    w = rt.init(num_cpus=4, num_gpus=2, max_process_workers=1)
    yield w
    rt.shutdown()


class _Maker:
    def make(self):
        return [rt.put(5)]


class _AsyncMaker:
    async def make(self):
        return [rt.put(5)]


def _make():
    return [rt.put(5)]


def _wait_until(cond, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("kind,options", [
    ("actor", {"num_gpus": 1}),
    ("async_actor", {"num_gpus": 1}),
    ("task", {"num_gpus": 1}),
    ("actor", {"num_cpus": 1}),
])
def test_ref_put_in_callee_outlives_its_frame(runtime, kind, options):
    if kind == "task":
        outer = rt.remote(_make).options(**options).remote()
        actor = None
    else:
        cls = _Maker if kind == "actor" else _AsyncMaker
        actor = rt.remote(cls).options(**options).remote()
        outer = actor.make.remote()
    try:
        inner = rt.get(outer, timeout=WAIT_S)
        assert len(inner) == 1
        assert rt.get(inner[0], timeout=WAIT_S) == 5
        if options.get("num_gpus"):
            # the driver owns the element: freed with the container
            oid = inner[0].id()
            del inner, outer
            assert _wait_until(
                lambda: not runtime.memory_store.contains(oid)), \
                "the element outlived its container"
    finally:
        if actor is not None:
            rt.kill(actor)
