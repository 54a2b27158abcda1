"""Task-event stream (tracing backbone).

Reference: ``src/ray/core_worker/task_event_buffer.cc`` + GcsTaskManager
timeline export [UNVERIFIED — mount empty, SURVEY.md §0]. Workers append
(task, state, timestamp) transitions to a bounded ring buffer; the
timeline API renders Chrome-trace events.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional

from ray_tpu_torch._private.config import get_config

_events: Optional[Deque] = None
_lock = threading.Lock()


def _buffer() -> Deque:
    global _events
    if _events is None:
        with _lock:
            if _events is None:
                _events = deque(maxlen=get_config().task_events_max_buffer)
    return _events


def active() -> bool:
    """True when any event sink is on. Hot-path callers guard with
    this BEFORE building record arguments (task_id.hex() and
    repr_name() per transition are pure waste when both sinks are
    off)."""
    from ray_tpu_torch._private import export
    return get_config().event_log_enabled or export._writer is not None


def record(task_id_hex: str, name: str, state: str,
           worker: str = "", extra: Optional[dict] = None) -> None:
    """Ring buffer (event_log_enabled) and JSONL export
    (event_export_enabled) gate INDEPENDENTLY. Short-circuits before
    building the record when both sinks are off — this runs per task
    transition on the hot path."""
    from ray_tpu_torch._private import export
    log_on = get_config().event_log_enabled
    if not log_on and export._writer is None:
        return
    rec = {
        "task_id": task_id_hex,
        "name": name,
        "state": state,
        "worker": worker,
        "ts": time.time(),
        **(extra or {}),
    }
    if log_on:
        _buffer().append(rec)
    export.emit("TASK", rec)


def raw_events() -> List[dict]:
    """The raw (task, state, ts) transition stream, oldest first."""
    return list(_buffer())


def get_task_events() -> List[dict]:
    """Chrome-trace ("catapult") event dicts: pair RUNNING->FINISHED."""
    events = list(_buffer())
    starts = {}
    trace = []
    for e in events:
        key = e["task_id"]
        if e["state"] == "RUNNING":
            starts[key] = e
        elif e["state"] in ("FINISHED", "FAILED") and key in starts:
            s = starts.pop(key)
            trace.append({
                "name": e["name"],
                "cat": "task",
                "ph": "X",
                "ts": s["ts"] * 1e6,
                "dur": (e["ts"] - s["ts"]) * 1e6,
                "pid": 0,
                "tid": hash(e.get("worker", "")) % 1000,
                "args": {"state": e["state"],
                         # worker-measured execution time (includes
                         # result serialization, which syncs pending
                         # device work — the device-time attribution)
                         **({"exec_ms": e["exec_ms"]}
                            if "exec_ms" in e else {})},
            })
    return trace


def clear() -> None:
    _buffer().clear()
