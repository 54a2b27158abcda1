"""The port's streaming generator tasks (``num_returns="streaming"``):
the single-node cases of the JAX package's ``tests/test_streaming.py``
run against ``ray_tpu_torch`` on ``init(num_cpus=4, num_gpus=8,
max_process_workers=2)``, and its remote-raylet case on the port's
``Cluster``. Serve's streaming handles stand on these generators.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster


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


def test_streaming_basic(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    out = [ray_tpu_torch.get(ref) for ref in gen.remote(5)]
    assert out == [0, 10, 20, 30, 40]


def test_streaming_items_arrive_incrementally(ray_start_regular):
    """The first item is consumable while the generator still runs."""

    @ray_tpu_torch.remote(num_returns="streaming")
    def slow_gen():
        import time as t
        yield "first"
        t.sleep(1.5)
        yield "second"

    g = slow_gen.remote()
    assert ray_tpu_torch.get(next(g)) == "first"
    # the generator is still inside its sleep when "first" is consumed
    t_mid = time.monotonic()
    assert ray_tpu_torch.get(next(g)) == "second"
    assert time.monotonic() - t_mid > 0.7
    with pytest.raises(StopIteration):
        next(g)


def test_streaming_big_items_via_shm(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def big_gen(n):
        for i in range(n):
            yield np.full(100_000, i, dtype=np.float64)

    vals = [ray_tpu_torch.get(r) for r in big_gen.remote(3)]
    assert [v[0] for v in vals] == [0.0, 1.0, 2.0]


def test_streaming_error_mid_stream(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def bad_gen():
        yield 1
        raise ValueError("boom mid-stream")

    g = bad_gen.remote()
    assert ray_tpu_torch.get(next(g)) == 1
    with pytest.raises(ValueError, match="boom mid-stream"):
        next(g)


def test_streaming_requires_generator(ray_start_regular):
    @ray_tpu_torch.remote(num_returns="streaming")
    def not_gen():
        return [1, 2, 3]

    g = not_gen.remote()
    with pytest.raises(TypeError, match="generator"):
        next(g)


def test_streaming_retry_after_worker_death(ray_start_regular, tmp_path):
    """A streaming task killed mid-stream retries with item-index dedup:
    already-delivered items are kept (not re-stored, not duplicated) and
    the retry resumes past them."""
    marker = str(tmp_path / "attempt")

    @ray_tpu_torch.remote(num_returns="streaming", max_retries=1)
    def gen(n):
        import os
        first_attempt = not os.path.exists(marker)
        if first_attempt:
            with open(marker, "w") as f:
                f.write("1")
        for i in range(n):
            yield i * 10
            if first_attempt and i == 2:
                # items 0..2 are out; die hard mid-stream
                os._exit(1)

    g = gen.remote(6)
    out = [ray_tpu_torch.get(ref, timeout=60) for ref in g]
    assert out == [0, 10, 20, 30, 40, 50]


def test_streaming_launched_from_inside_task(ray_start_regular):
    """Tasks can launch and consume streaming generators (nested-client
    path: the generator handle polls the owner via the worker surface)."""

    @ray_tpu_torch.remote(num_returns="streaming")
    def inner(n):
        for i in range(n):
            yield i + 100

    @ray_tpu_torch.remote
    def outer(n):
        g = inner.remote(n)
        return [ray_tpu_torch.get(ref) for ref in g]

    assert ray_tpu_torch.get(outer.remote(4), timeout=60) == [100, 101, 102, 103]


@pytest.fixture
def ray_start_cluster():
    """The reference's fixture on the port: a CPU-only head (no card
    here) plus a helper for adding nodes."""
    cluster = Cluster(num_gpus=0, head_num_cpus=4)
    yield cluster
    cluster.shutdown()


def test_streaming_on_remote_raylet(ray_start_cluster):
    cluster = ray_start_cluster
    cluster.add_node(num_cpus=2, resources={"SG": 1}, remote=True)

    @ray_tpu_torch.remote(num_cpus=1, resources={"SG": 1},
                          num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield np.full(60_000, i, dtype=np.float64)

    vals = [float(ray_tpu_torch.get(r)[0]) for r in gen.remote(3)]
    assert vals == [0.0, 1.0, 2.0]
