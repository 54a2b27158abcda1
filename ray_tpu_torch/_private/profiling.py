"""Host-side profiling: on-demand stack dumps + per-process RSS.

Reference analog: ``python/ray/dashboard/modules/reporter/`` — the
py-spy stack-dump and memory endpoints served per node [UNVERIFIED —
mount empty, SURVEY.md §0]. Here the raylet serves the role directly:
a ``dump_stacks`` RPC returns live Python stacks for the raylet
process and every one of its process workers, and worker RSS rides the
heartbeat stats into the per-node Prometheus series and the dashboard
nodes table.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, List, Optional


def dump_all_stacks() -> str:
    """Live stacks of every thread in THIS process (pure-Python; no
    file descriptors, unlike faulthandler — safe to ship over RPC)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts: List[str] = []
    for tid, frame in sorted(sys._current_frames().items()):
        parts.append(f"--- thread {names.get(tid, '?')} (id={tid}) ---")
        parts.append("".join(traceback.format_stack(frame)))
    return "\n".join(parts)


def process_rss_bytes(pid: Optional[int] = None) -> int:
    """Resident set size of ``pid`` (default: this process) from
    /proc; 0 when unreadable (non-linux, dead pid)."""
    try:
        with open(f"/proc/{pid or 'self'}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


# Serializes concurrent stack requests: the per-worker reply slots
# (_stack_evt/_stack_text) are shared state, and two overlapping
# requesters would orphan each other's events.
_REQUEST_LOCK = threading.Lock()
# Makes slot RESET (requester) and slot DELIVERY (worker IO thread)
# atomic against each other: a late reply from a previous timed-out
# request must not interleave with the next request's reset (which
# could report a responsive worker as unresponsive).
_SLOT_LOCK = threading.Lock()


def gather_pool_stacks(worker_pool, timeout: float = 3.0
                       ) -> Dict[str, str]:
    """Live stacks from a pool's registered, live process workers
    (shared by the driver API and the raylet's dump_stacks RPC)."""
    with worker_pool._lock:
        workers = [w for w in worker_pool._all.values()
                   if getattr(w, "conn", None) is not None and w.alive]
    return request_worker_stacks(workers, timeout=timeout)


def request_worker_stacks(workers, timeout: float = 3.0
                          ) -> Dict[str, str]:
    """Request live stacks from process workers and gather their
    ("stacks", text) replies (routed back by the worker IO thread into
    ``deliver_stack_reply``). The request is SIGUSR1 when a pid is
    known — a worker busy executing a task never reads its pipe, and
    mid-task is exactly when stacks matter — falling back to the pipe
    message otherwise. Workers that do not answer within the deadline
    are reported as such rather than omitted."""
    import os
    import signal
    with _REQUEST_LOCK:
        asked = []
        for w in workers:
            with _SLOT_LOCK:
                w._stack_evt = threading.Event()
                w._stack_text = None
            pid = getattr(getattr(w, "proc", None), "pid", None)
            try:
                if pid is not None:
                    os.kill(pid, signal.SIGUSR1)
                else:
                    w.send(("dump_stacks",))
                asked.append(w)
            except Exception:
                pass    # worker died mid-request: report the rest
        out: Dict[str, str] = {}
        deadline = time.monotonic() + timeout
        for w in asked:
            w._stack_evt.wait(max(0.0, deadline - time.monotonic()))
            key = f"worker:{w.worker_id.hex()[:12]}"
            out[key] = (w._stack_text if w._stack_text is not None
                        else "<no reply within deadline>")
        return out


def deliver_stack_reply(worker, text: str) -> None:
    """Reply half of ``request_worker_stacks`` (called from the reply
    routers). Atomic against slot reset — a straggler reply either
    lands fully before the next request's reset (and is discarded by
    it) or fully after (a fresh-enough dump the fresh reply then
    overwrites)."""
    with _SLOT_LOCK:
        worker._stack_text = text
        evt = getattr(worker, "_stack_evt", None)
        if evt is not None:
            evt.set()


def worker_rss_map(worker_pool) -> Dict[str, int]:
    """worker-hex -> RSS bytes for a pool's live process workers."""
    out: Dict[str, int] = {}
    with worker_pool._lock:
        workers = list(worker_pool._all.values())
    for w in workers:
        proc = getattr(w, "proc", None)
        if proc is not None and w.alive:
            rss = process_rss_bytes(proc.pid)
            if rss:
                out[w.worker_id.hex()[:12]] = rss
    return out
