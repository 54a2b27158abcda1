"""Tracing: torch.profiler capture + the task-event timeline.

Reference: ``python/ray/util/tracing/tracing_helper.py`` (opt-in spans
around submit/execute) and ``ray timeline`` [UNVERIFIED — mount empty,
SURVEY.md §0]. The deep trace is the CUDA trace — ``start_trace`` /
``stop_trace`` wrap ``torch.profiler`` in the process that owns the
cards, and every task executes inside a ``record_function`` span
carrying its name, so the kernels in the profile attribute to the task
that launched them (GPU work runs on threads of this process).

Two layers, cheap to expensive:

- **Task timeline** (always on): per-task RUNNING→FINISHED spans with
  worker-measured ``exec_ms`` (result serialization copies device
  tensors to the host where a result leaves the card, so such tasks'
  exec_ms includes device compute). ``timeline()`` exports Chrome-trace
  JSON.
- **Device profile** (opt-in, heavyweight): ``start_trace(logdir)`` →
  run the workload → ``stop_trace()``, which writes a Chrome trace
  ``*.pt.trace.json`` into the logdir (Perfetto or chrome://tracing).
  Task names appear as ``record_function`` spans above the kernels.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

__all__ = ["start_trace", "stop_trace", "trace", "timeline",
           "task_events"]

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
