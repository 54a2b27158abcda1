"""Structured event export + usage summary.

Reference: ``src/ray/util/event.cc`` (structured event log files, the
export-API JSONL streams under ``src/ray/protobuf/export_api/``) and
``python/ray/_private/usage/usage_lib.py`` [UNVERIFIED — mount empty,
SURVEY.md §0]. Zero-egress adaptation: everything lands as local
JSONL/JSON under the session dir — an external collector can tail the
files; nothing is ever sent anywhere by this runtime.

Layout (``<tmp>/rtpt_<session>/export/``):
  event_TASK.jsonl    one record per task state transition
  event_ACTOR.jsonl   actor lifecycle (REGISTERED/ALIVE/RESTARTING/DEAD)
  event_NODE.jsonl    node membership (ADDED/REMOVED)
  usage_stats.json    end-of-session counters (written at shutdown)
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from ray_tpu_torch._private.session_dir import session_dir

_FLUSH_PERIOD_S = 2.0


class ExportWriter:
    """Buffered JSONL writers, one file per event kind."""

    def __init__(self, session: str):
        self.dir = session_dir(session, "export")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._buffers: Dict[str, list] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-export")
        self._thread.start()

    def emit(self, kind: str, record: dict) -> None:
        rec = {"ts": time.time(), **record}
        with self._lock:
            self._buffers.setdefault(kind, []).append(rec)

    def flush(self) -> None:
        with self._lock:
            buffers, self._buffers = self._buffers, {}
        for kind, records in buffers.items():
            path = os.path.join(self.dir, f"event_{kind}.jsonl")
            try:
                with open(path, "a") as f:
                    for rec in records:
                        f.write(json.dumps(rec, default=str) + "\n")
            except OSError:
                pass

    def _loop(self) -> None:
        while not self._stop.wait(_FLUSH_PERIOD_S):
            self.flush()

    def write_usage_stats(self, stats: dict) -> None:
        path = os.path.join(self.dir, "usage_stats.json")
        try:
            with open(path, "w") as f:
                json.dump(stats, f, indent=2, default=str)
        except OSError:
            pass

    def stop(self) -> None:
        self._stop.set()
        # Join before the final flush: a concurrent loop-thread flush
        # would interleave partial lines in the same append-mode file.
        self._thread.join(timeout=5.0)
        self.flush()


_writer: Optional[ExportWriter] = None
_writer_lock = threading.Lock()


def start(session: str) -> ExportWriter:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = ExportWriter(session)
        return _writer


def emit(kind: str, record: dict) -> None:
    w = _writer
    if w is not None:
        w.emit(kind, record)


def stop() -> None:
    global _writer
    with _writer_lock:
        if _writer is not None:
            _writer.stop()
            _writer = None
