"""Tracing: torch.profiler capture + the task-event timeline.

Reference: ``python/ray/util/tracing/tracing_helper.py`` (opt-in spans
around submit/execute) and ``ray timeline`` [UNVERIFIED — mount empty,
SURVEY.md §0]. The deep trace is the CUDA trace — ``start_trace`` /
``stop_trace`` wrap ``torch.profiler`` in the process that owns the
cards, and every task executes inside a ``record_function`` span
carrying its name, so the kernels in the profile attribute to the task
that launched them (GPU work runs on threads of this process).

Three layers, cheap to expensive:

- **Task timeline** (always on): per-task RUNNING→FINISHED spans with
  worker-measured ``exec_ms`` (result serialization copies device
  tensors to the host where a result leaves the card, so such tasks'
  exec_ms includes device compute). ``timeline()`` exports Chrome-trace
  JSON.
- **Device profile** (opt-in, heavyweight): ``start_trace(logdir)`` →
  run the workload → ``stop_trace()``, which writes a Chrome trace
  ``*.pt.trace.json`` into the logdir (Perfetto or chrome://tracing).
  Task names appear as ``record_function`` spans above the kernels.
- **Program spans** (recorded only while a ``torch.profiler`` capture
  runs in this process): ``with span(name)`` at a layer boundary records
  ``Span`` (name, start and end in ``time.time_ns()``, thread) into a
  bounded buffer that ``recorded_spans()`` reads and ``clear_spans()``
  empties; it outlives ``shutdown()``. The span also opens
  ``record_function(name)``, so a capture that records CPU ops links each
  kernel launched inside it to the span. The profiler's clock is
  ``time.time_ns()`` too. With no capture running a span costs one flag
  check.

Spans of the training path: ``rt.train.step`` (``make_train_step``'s
step), ``rt.train.forward`` (``loss_fn``, ``vit_loss_fn``),
``rt.train.backward`` (``torch.autograd.grad`` of the step),
``rt.optim.update`` (``AdamW.update_`` with the global norm and the
clip), ``rt.train.report`` (``train.report`` from the stop check to the file on
disk), and each task under its own name.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import List, NamedTuple, Optional

__all__ = ["start_trace", "stop_trace", "trace", "timeline",
           "task_events", "span", "Span", "recorded_spans", "clear_spans"]

_active = {"logdir": None, "profiler": None}


def start_trace(logdir: str, device: str = "cuda") -> None:
    """Begin a torch.profiler capture in THIS process (the card's owner
    — in-process tasks and actors are captured; process workers see no
    card and annotate only their own CPU work). ``device="cuda"``
    records CPU and CUDA activity and raises ``RuntimeError`` without a
    card; ``device="cpu"`` records CPU activity alone."""
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    if _active["profiler"] is not None:
        raise RuntimeError(
            f"a trace is already active (logdir {_active['logdir']!r}); "
            "stop_trace() it first")
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "start_trace(device='cuda') needs a CUDA card; pass "
                "device='cpu' to capture CPU activity alone")
        activities.append(ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    os.makedirs(logdir, exist_ok=True)
    # GPU tasks and actors run on driver threads other than the caller's:
    # record every thread's ops, not only this one's
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    prof.__enter__()
    _active["logdir"], _active["profiler"] = logdir, prof


def stop_trace() -> Optional[str]:
    """End the capture, write its Chrome trace into the logdir, and
    return the logdir."""
    prof = _active["profiler"]
    if prof is None:
        raise RuntimeError("no trace is active")
    logdir = _active["logdir"]
    _active["logdir"], _active["profiler"] = None, None
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(
        logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))
    return logdir


class trace:
    """Context manager: ``with tracing.trace(logdir): ...``"""

    def __init__(self, logdir: str, device: str = "cuda"):
        self._logdir = logdir
        self._device = device

    def __enter__(self):
        start_trace(self._logdir, device=self._device)
        return self

    def __exit__(self, *exc):
        stop_trace()
        return False


def task_events() -> List[dict]:
    """Raw task state-transition events (includes per-task exec_ms)."""
    from ray_tpu_torch._private import events
    return events.raw_events()


def timeline(path: Optional[str] = None) -> List[dict]:
    """Chrome-trace events for completed tasks; written to ``path``
    (JSON) when given — load in chrome://tracing or Perfetto."""
    from ray_tpu_torch._private import events
    trace_events = events.get_task_events()
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace_events, f)
    return trace_events


class Span(NamedTuple):
    """One closed span."""
    name: str
    start_ns: int
    end_ns: int
    thread: int


# A traced benchmark window records a few thousand spans; the oldest give
# way first.
SPAN_CAPACITY = 1 << 16
_spans: "collections.deque[Span]" = collections.deque(maxlen=SPAN_CAPACITY)
_OFF = contextlib.nullcontext()
_profiler = None        # torch.autograd.profiler, once torch is loaded


def _find_profiler():
    """``torch.autograd.profiler`` if torch is loaded in this process,
    else None. The first time it is found, check that it has the flag
    ``span`` reads, so a torch without it fails here, saying why."""
    global _profiler
    module = sys.modules.get("torch.autograd.profiler")
    if module is not None:
        if not hasattr(module, "_is_profiler_enabled"):
            raise ImportError(
                "ray_tpu_torch.util.tracing reads the process-wide flag "
                "torch.autograd.profiler._is_profiler_enabled, which this "
                "torch does not have")
        _profiler = module
    return module


class _Recording:
    __slots__ = ("name", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        from torch.autograd.profiler import record_function
        self.annotation = record_function(self.name)
        self.annotation.__enter__()
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        self.annotation.__exit__(*exc)
        _spans.append(Span(self.name, self.start, end,
                           threading.get_ident()))
        return False


def span(name: str):
    """``with span(name):`` records a ``Span`` while a ``torch.profiler``
    capture runs in this process (any thread, any activities), and opens
    ``record_function(name)`` around it; with no capture running it
    records nothing. The check is
    ``torch.autograd.profiler._is_profiler_enabled``, which every capture
    sets process-wide (``torch.autograd._profiler_enabled()`` reads a
    thread's state, and is false on every thread under a
    ``profile_all_threads`` capture)."""
    profiler = _profiler or _find_profiler()
    if profiler is None or not profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name)


def recorded_spans() -> List[Span]:
    """The closed spans in the buffer, in the order they closed."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


# Imported after torch, the module checks the flag now.
_find_profiler()
