"""The port's ``multiprocessing.Pool`` shim and joblib backend
(``ray_tpu_torch.util.multiprocessing``, ``util.joblib_backend``): the 7
cases of ``tests/test_pool_joblib.py`` on ``ray_tpu_torch``, and both
packages' joblib backends registered in one process (the JAX package's
as ``"ray_tpu"``, the port's as ``"ray_tpu_torch"``) giving equal
results, each on its own runtime.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.multiprocessing import Pool


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


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_pool_map_and_starmap(ray_start_regular):
    with Pool(processes=2) as pool:
        assert pool.map(_sq, range(20)) == [i * i for i in range(20)]
        assert pool.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]


def test_pool_imap_orders_and_unordered(ray_start_regular):
    with Pool(processes=2) as pool:
        assert list(pool.imap(_sq, range(10), chunksize=3)) == [
            i * i for i in range(10)]
        assert sorted(pool.imap_unordered(_sq, range(10),
                                          chunksize=2)) == [
            i * i for i in range(10)]


def test_pool_apply_async_and_errors(ray_start_regular):
    pool = Pool(processes=2)
    res = pool.apply_async(_add, (5, 6))
    assert res.get(timeout=30) == 11
    assert res.ready() and res.successful()

    def boom(_x):
        raise RuntimeError("pool boom")

    bad = pool.apply_async(boom, (1,))
    with pytest.raises(Exception, match="pool boom"):
        bad.get(timeout=30)
    assert not bad.successful()
    assert pool.apply(_sq, (7,)) == 49
    pool.close()
    with pytest.raises(ValueError):
        pool.map(_sq, [1])
    pool.join()


def test_pool_map_async_callback(ray_start_regular):
    import threading
    got = {}
    evt = threading.Event()
    with Pool(processes=2) as pool:
        res = pool.map_async(_sq, range(5),
                             callback=lambda v: (got.update(v=v),
                                                 evt.set()))
        assert res.get(timeout=30) == [0, 1, 4, 9, 16]
        assert evt.wait(10)
        assert got["v"] == [0, 1, 4, 9, 16]


def test_joblib_backend(ray_start_regular):
    joblib = pytest.importorskip("joblib")
    from joblib import Parallel, delayed

    from ray_tpu_torch.util.joblib_backend import register_ray_tpu_torch
    register_ray_tpu_torch()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = Parallel()(delayed(_sq)(i) for i in range(12))
    assert out == [i * i for i in range(12)]


def test_pool_processes_bounds_inflight(ray_start_regular):
    """processes=1 really serializes chunks (windowed submission): four
    0.3s tasks cannot finish faster than ~1.2s."""
    import time

    def slow(x):
        import time as t
        t.sleep(0.3)
        return x

    with Pool(processes=1) as pool:
        t0 = time.monotonic()
        assert pool.map(slow, range(4), chunksize=1) == [0, 1, 2, 3]
        assert time.monotonic() - t0 >= 1.0


def test_async_result_timeout_does_not_poison(ray_start_regular):
    def slow_add(a, b):
        import time as t
        t.sleep(1.5)
        return a + b

    pool = Pool(processes=2)
    res = pool.apply_async(slow_add, (2, 3))
    with pytest.raises(TimeoutError):
        res.get(timeout=0.1)
    # a later untimed get returns the value (stdlib semantics)
    assert res.get(timeout=30) == 5
    assert res.successful()


def test_both_joblib_backends_in_one_process():
    joblib = pytest.importorskip("joblib")
    from joblib import Parallel, delayed
    from joblib.parallel import BACKENDS

    import ray_tpu
    from ray_tpu.util.joblib_backend import register_ray_tpu
    from ray_tpu_torch.util import joblib_backend as port_backend

    register_ray_tpu()
    port_backend.register_ray_tpu_torch()
    assert BACKENDS["ray_tpu_torch"] is port_backend.RayTpuTorchBackend
    assert BACKENDS["ray_tpu"] is not BACKENDS["ray_tpu_torch"]
    outs = []
    for rt, accel in ((ray_tpu, "num_tpus"), (ray_tpu_torch, "num_gpus")):
        rt.init(num_cpus=4, max_process_workers=2, **{accel: 0})
        try:
            with joblib.parallel_backend(rt.__name__, n_jobs=2):
                outs.append(Parallel()(delayed(_add)(i, 3 * i)
                                       for i in range(10)))
        finally:
            rt.shutdown()
    assert outs[0] == outs[1] == [4 * i for i in range(10)]
