"""The port's tracing (``ray_tpu_torch.util.tracing``): the two tracing
cases of ``tests/test_util.py`` on ``ray_tpu_torch``, then the
``torch.profiler`` capture that takes the place of ``jax.profiler``:

- a CPU capture (``device="cpu"``) around a driver-thread task writes a
  Chrome trace ``*.pt.trace.json`` into the logdir that holds the task's
  ``record_function`` span by name;
- ``start_trace()`` (``device="cuda"``) raises without a card;
- a second ``start_trace`` while one is active raises;
- on the card (``cuda``), the trace holds the flash kernel inside a
  ``num_gpus=1`` task's span;
- the program's spans (``tracing.span``): nothing recorded without a
  capture; under a CPU capture (one thread's, or every thread's as
  ``start_trace`` runs it) a train step records ``rt.train.step`` over the
  forward, the backward and ``rt.optim.update``, on its thread; Train's
  report on the gang worker's thread; the spans' clock is ``time.time_ns()``;
  the buffer outlives ``shutdown()``.
"""

import glob
import importlib
import json
import os
import sys
import threading
import time

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


def _tiny_step():
    """A CPU step of the flagship's code at a tiny size (the flash op's
    plain path), and its first batch."""
    from ray_tpu_torch.models.training import (
        init_state, make_optimizer, make_train_step)
    from ray_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=64,
                            max_seq_len=16, dtype=torch.float32,
                            remat=False, use_flash=True)
    tx = make_optimizer(warmup_steps=1, total_steps=4)
    state = init_state(cfg, tx, seed=0, device="cpu")
    tokens = torch.randint(0, 64, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    return make_train_step(cfg, tx), state, {"tokens": tokens}


def _by_name(spans):
    out = {}
    for sp in spans:
        out.setdefault(sp.name, []).append(sp)
    return out


def test_no_capture_records_no_span():
    step, state, batch = _tiny_step()
    tracing.clear_spans()
    with tracing.span("rt.test.off") as inside:
        assert inside is None
    step(state, batch)
    assert tracing.recorded_spans() == []


def _within(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_cpu_capture_records_the_step_split():
    step, state, batch = _tiny_step()
    step(state, batch)              # the first call's one-time work
    tracing.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    spans = _by_name(tracing.recorded_spans())
    (top,) = spans["rt.train.step"]
    (fwd,), (bwd,), (opt,) = (spans["rt.train.forward"],
                              spans["rt.train.backward"],
                              spans["rt.optim.update"])
    me = threading.get_ident()
    assert top.thread == me
    for child in (fwd, bwd, opt):
        assert child.thread == me and _within(child, top)
    assert fwd.end_ns <= bwd.start_ns and bwd.end_ns <= opt.start_ns
    # each span is a record_function in the capture, over the ops it ran
    names = {e.name for e in prof.events()}
    assert {"rt.train.step", "rt.train.forward", "rt.train.backward",
            "rt.optim.update"} <= names


def test_every_thread_capture_records_spans(tmp_path):
    """``start_trace`` records every thread's ops; the spans follow it,
    from this thread and another one."""
    tracing.clear_spans()
    tracing.start_trace(str(tmp_path / "prof"), device="cpu")
    try:
        with tracing.span("rt.test.here"):
            worker = threading.Thread(target=_span_on_this_thread)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    finally:
        tracing.stop_trace()
    spans = _by_name(tracing.recorded_spans())
    (here,), (there,) = spans["rt.test.here"], spans["rt.test.there"]
    assert here.thread == threading.get_ident()
    assert there.thread != here.thread
    names = [e.get("name") for e in _trace_events(str(tmp_path / "prof"))]
    assert "rt.test.here" in names and "rt.test.there" in names


def _span_on_this_thread():
    with tracing.span("rt.test.there"):
        pass


def test_span_clock_is_time_ns():
    tracing.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        before = time.time_ns()
        with tracing.span("rt.test.clock"):
            time.sleep(0.01)
        after = time.time_ns()
    (sp,) = tracing.recorded_spans()
    assert sp.name == "rt.test.clock"
    assert before <= sp.start_ns < sp.end_ns <= after
    assert sp.end_ns - sp.start_ns >= 10_000_000


def test_a_torch_without_the_flag_fails_saying_why(monkeypatch):
    """The flag ``span`` reads is private to torch: a torch without it
    makes the first look at it raise, naming the flag, and not an
    ``AttributeError`` inside a training step."""
    import types
    monkeypatch.setitem(sys.modules, "torch.autograd.profiler",
                        types.ModuleType("torch.autograd.profiler"))
    monkeypatch.setattr(tracing, "_profiler", None)
    with pytest.raises(ImportError, match="_is_profiler_enabled"):
        tracing.span("rt.test.flag")


def test_train_report_and_drain_spans_outlive_shutdown(tmp_path):
    """Train's reports are recorded on the gang worker's thread, not on
    the driver's, which drains their files under no span of its own; the
    buffer still holds them after ``shutdown()``."""
    from ray_tpu_torch import train

    def loop(config):
        for i in range(3):
            train.report({"loss": 1.0 / (i + 1), "step": i})

    tracing.clear_spans()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1, max_process_workers=1)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            res = train.DataParallelTrainer(
                loop, scaling_config=train.ScalingConfig(
                    num_workers=1, use_gpu=True),
                run_config=train.RunConfig(
                    name="spans", storage_path=str(tmp_path))).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert res.error is None and res.metrics["step"] == 2
    spans = _by_name(tracing.recorded_spans())
    reports = spans["rt.train.report"]
    assert len(reports) == 3
    assert all(sp.end_ns > sp.start_ns for sp in reports)
    (worker,) = {sp.thread for sp in reports}
    assert worker != threading.get_ident()
    assert not any(sp.thread == threading.get_ident()
                   and sp.name.startswith("rt.train.")
                   for sp in tracing.recorded_spans())
