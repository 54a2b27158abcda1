"""The port's runtime leaves no thread behind at ``shutdown()``: each
``init`` used to leave its worker hub's accept thread blocked in
``accept()`` (closing a listening socket does not wake it on Linux), so
a long-lived process such as a test worker gathered one thread per
runtime, and a stack dump of a stalled test (faulthandler's, which stops
at 100 threads) no longer reached the main thread."""

import threading

import pytest
import torch

import ray_tpu_torch as rt


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Cap torch's intra-op threads so that this file does not starve the
    timing-sensitive multi-process tests running beside it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("work", ["idle", "process_task"])
def test_init_shutdown_leaves_no_thread(work):
    before = set(threading.enumerate())
    for _ in range(3):
        rt.init(num_cpus=1, num_gpus=0, max_process_workers=1)
        try:
            if work == "process_task":
                f = rt.remote(lambda x: x + 1)
                assert rt.get(f.remote(1), timeout=60) == 2
        finally:
            rt.shutdown()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive()]
    assert not left, left
