"""The port's tracing (``ray_tpu_torch.util.tracing``): the two tracing
cases of ``tests/test_util.py`` on ``ray_tpu_torch``, then the
``torch.profiler`` capture that takes the place of ``jax.profiler``:

- a CPU capture (``device="cpu"``) around a driver-thread task writes a
  Chrome trace ``*.pt.trace.json`` into the logdir that holds the task's
  ``record_function`` span by name;
- ``start_trace()`` (``device="cuda"``) raises without a card;
- a second ``start_trace`` while one is active raises;
- on the card (``cuda``), the trace holds the flash kernel inside a
  ``num_gpus=1`` task's span.
"""

import glob
import importlib
import json
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.util import tracing


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
    """The reference's fixture on the port: 4 CPUs, 2 process workers and
    8 GPUs of resource, whose work runs on driver threads."""
    w = ray_tpu_torch.init(num_cpus=4, num_gpus=8, max_process_workers=2)
    yield w
    ray_tpu_torch.shutdown()


def test_task_timeline_carries_exec_ms(ray_start_regular):
    """Per-task device-time attribution: the worker-measured exec_ms
    rides the done path into the task timeline (process AND in-process
    workers)."""
    from ray_tpu_torch._private import events as _events

    @ray_tpu_torch.remote
    def cpu_task():
        return int(np.arange(10).sum())

    @ray_tpu_torch.remote(num_gpus=1)
    def gpu_task():
        return float(torch.arange(8.0).sum())

    assert ray_tpu_torch.get(cpu_task.remote()) == 45
    assert ray_tpu_torch.get(gpu_task.remote()) == 28.0
    finished = [e for e in _events.raw_events()
                if e["state"] == "FINISHED" and "exec_ms" in e]
    names = {e["name"] for e in finished}
    assert any("cpu_task" in n for n in names)
    assert any("gpu_task" in n for n in names)
    assert all(e["exec_ms"] >= 0 for e in finished)
    # Chrome-trace export carries it through
    spans = [t for t in ray_tpu_torch.timeline() if "exec_ms" in t["args"]]
    assert spans


def test_tracing_module_surface(ray_start_regular, tmp_path):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2
    out = tracing.timeline(str(tmp_path / "tl.json"))
    assert isinstance(out, list)
    assert (tmp_path / "tl.json").exists()
    assert tracing.task_events()


def _trace_events(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_cpu_capture_holds_the_task_span(ray_start_regular, tmp_path):
    @ray_tpu_torch.remote(num_gpus=1)
    def traced_matmul(n):
        x = torch.ones(n, n)
        return float((x @ x).sum())

    logdir = str(tmp_path / "prof")
    with tracing.trace(logdir, device="cpu"):
        assert ray_tpu_torch.get(traced_matmul.remote(32)) == 32.0 ** 3
    names = [e.get("name", "") for e in _trace_events(logdir)]
    assert any("traced_matmul" in n for n in names), sorted(set(names))[:40]
    assert any(n == "aten::mm" for n in names)


def test_start_trace_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tracing.start_trace(str(tmp_path / "prof"))
    # nothing was left active: a CPU capture starts and stops
    tracing.start_trace(str(tmp_path / "prof"), device="cpu")
    assert tracing.stop_trace() == str(tmp_path / "prof")


def test_second_start_trace_raises(tmp_path):
    tracing.start_trace(str(tmp_path / "a"), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already active"):
            tracing.start_trace(str(tmp_path / "b"), device="cpu")
    finally:
        assert tracing.stop_trace() == str(tmp_path / "a")
    with pytest.raises(RuntimeError, match="no trace is active"):
        tracing.stop_trace()


@pytest.mark.cuda
def test_cuda_capture_puts_flash_under_the_task_span(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    ray_tpu_torch.init(num_cpus=2, max_process_workers=1)
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        def attend():
            g = torch.Generator("cuda").manual_seed(0)
            q, k, v = (torch.randn(1, 256, 4, 64, device="cuda",
                                   dtype=torch.bfloat16, generator=g)
                       for _ in range(3))
            out = fa.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            return float(out.float().abs().sum())

        logdir = str(tmp_path / "prof")
        with tracing.trace(logdir):
            assert ray_tpu_torch.get(attend.remote()) > 0
    finally:
        ray_tpu_torch.shutdown()
    events = _trace_events(logdir)
    span = next(e for e in events
                if "attend" in e.get("name", "") and e.get("ph") == "X"
                and e.get("cat") == "user_annotation")
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "flash_fwd" in e.get("name", "")]
    assert kernels
    start, end = span["ts"], span["ts"] + span["dur"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and start <= e["ts"] <= end
                and any(k["args"].get("correlation")
                        == e["args"].get("correlation") for k in kernels)]
    assert len(launches) == 1
