"""Per-node log plane: worker stdout/stderr capture + driver streaming.

Reference: ``python/ray/_private/log_monitor.py`` + the dashboard
agent's log streaming (``python/ray/dashboard/agent.py``) [UNVERIFIED —
mount empty, SURVEY.md §0]. Every process worker's stdout/stderr is
redirected to a per-worker file under the node's session log dir
(``<tmp>/rtpt_<session>/logs/worker-<id>.out``); this module is the
tail plane over those files:

- ``read_new_log_bytes``: cursor-based incremental read over a log
  dir — the unit both the raylet's ``read_logs`` RPC and the local
  monitor use. Reads stop on complete UTF-8 boundaries, so a chunk
  never splits a multi-byte character.
- ``LogMonitor``: the one tail loop. The driver runs it as a thread
  over its session dir + every remote raylet's ``read_logs`` RPC,
  forwarding lines to stderr (``log_to_driver``); the ``logs
  --follow`` CLI runs the same object with ``start=False`` and its
  own sink/dirs.
"""

from __future__ import annotations

import glob
import logging
import os
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.session_dir import session_dir

logger = logging.getLogger(__name__)

_MAX_READ_PER_FILE = 256 * 1024


def session_log_dir(session: str) -> str:
    return session_dir(session, "logs")


def worker_log_path(session: str, worker_id_hex: str) -> str:
    d = session_log_dir(session)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"worker-{worker_id_hex[:12]}.out")


def _complete_utf8_len(data: bytes) -> int:
    """Length of the longest prefix that ends on a complete UTF-8
    sequence (a read can stop mid-write or at the byte cap)."""
    i = len(data)
    for back in range(1, min(4, i) + 1):
        b = data[i - back]
        if b < 0x80:
            return i                       # ASCII tail: complete
        if b >= 0xC0:                      # start byte at i-back
            need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            return i if back >= need else i - back
    return i


def read_new_log_bytes(log_dir: str, cursor: Optional[Dict[str, int]],
                       max_bytes: int = _MAX_READ_PER_FILE
                       ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Incremental tail over ``log_dir``: returns (new_cursor, chunks)
    where chunks is [(filename, new_text), ...]. The cursor maps
    filename -> byte offset already consumed; pass the returned cursor
    back on the next poll. A truncated/rotated file restarts from 0."""
    cursor = dict(cursor or {})
    chunks: List[Tuple[str, str]] = []
    for path in sorted(glob.glob(os.path.join(log_dir, "*.out"))
                       + glob.glob(os.path.join(log_dir, "*.log"))):
        name = os.path.basename(path)
        try:
            size = os.path.getsize(path)
        except OSError:
            continue
        offset = cursor.get(name, 0)
        if size < offset:
            offset = 0          # truncated/rotated
        if size == offset:
            continue
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(min(size - offset, max_bytes))
        except OSError:
            continue
        data = data[:_complete_utf8_len(data)]
        cursor[name] = offset + len(data)
        if data:
            chunks.append((name, data.decode("utf-8", "replace")))
    return cursor, chunks


class LogMonitor:
    """The tail loop: local log dirs + remote raylet ``read_logs``."""

    def __init__(self,
                 local_dirs: Callable[[], List[str]],
                 remote_sources: Callable[[], List[Tuple[str, object]]],
                 sink=None, period: float = 0.5, start: bool = True):
        """``local_dirs()`` returns the log directories to tail;
        ``remote_sources()`` returns [(node_hex, rpc_client), ...] for
        live remote raylets (each client must serve ``read_logs``).
        ``sink(line)`` defaults to stderr."""
        self._local_dirs = local_dirs
        self._remote_sources = remote_sources
        self._sink = sink or (lambda line: print(
            line, file=sys.stderr, flush=True))
        self._period = period
        self._local_cursors: Dict[str, Dict[str, int]] = {}
        self._remote_cursors: Dict[str, Dict[str, int]] = {}
        self._stop = threading.Event()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="rtpu-log-monitor")
            self._thread.start()

    @classmethod
    def for_session(cls, session: str, remote_sources, **kwargs
                    ) -> "LogMonitor":
        return cls(lambda: [session_log_dir(session)], remote_sources,
                   **kwargs)

    def _emit(self, prefix: str, text: str) -> None:
        for line in text.splitlines():
            self._sink(f"({prefix}) {line}")

    def poll_once(self) -> None:
        """One tail pass (the CLI and tests call this directly)."""
        for d in self._local_dirs():
            self._local_cursors[d], chunks = read_new_log_bytes(
                d, self._local_cursors.get(d))
            for fname, text in chunks:
                self._emit(fname[:-len(".out")]
                           if fname.endswith(".out") else fname, text)
        for node_hex, client in self._remote_sources():
            cursor = self._remote_cursors.get(node_hex, {})
            try:
                cursor, chunks = client.call("read_logs", cursor,
                                             timeout=5)
            except Exception:
                continue
            self._remote_cursors[node_hex] = dict(cursor)
            for fname, text in chunks:
                self._emit(f"node={node_hex[:8]} {fname}", text)

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                self.poll_once()
            except Exception:
                # keep the monitor thread alive across one bad poll
                # (rotated file, racing unlink) but leave a trace
                logger.debug("log poll failed", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        # join, so that the runtime's shutdown() leaves no thread behind
        # (a poll in progress ends within its remote call's timeout)
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
