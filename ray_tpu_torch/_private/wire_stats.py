"""Process-local wire-plane counters (data-plane fast path).

One tiny accumulator per logical channel (worker pipes, the
owner->raylet lease channel, raylet completion pushes, the rpc layer's
binary fast path) counting frames vs payloads vs bytes. The ratio
payloads/frames is the realized coalescing factor — the number the
batching knobs (``submit_coalesce_*``, ``task_done_coalesce_*``,
``worker_reply_flush_*``) exist to move — and bytes/payload is the
wire cost per task. bench.py reports both (``rpc_frame_avg_batch``,
``rpc_bytes_per_task``) and stats.py exports them as
``ray_tpu_rpc_batch_size{channel}``.

Counters are plain ints bumped under the GIL without a lock: they sit
on per-frame hot paths, and a (never observed in practice) lost
increment costs one count in a monitoring gauge, not correctness.
"""

from __future__ import annotations

import threading
from typing import Dict


class ChannelStats:
    __slots__ = ("frames", "payloads", "bytes", "fastframe_hits")

    def __init__(self):
        self.frames = 0
        self.payloads = 0
        self.bytes = 0
        self.fastframe_hits = 0

    def record(self, payloads: int, nbytes: int = 0,
               fastframe: bool = False) -> None:
        self.frames += 1
        self.payloads += payloads
        self.bytes += nbytes
        if fastframe:
            self.fastframe_hits += 1

    def snapshot(self) -> dict:
        frames = self.frames
        return {
            "frames": frames,
            "payloads": self.payloads,
            "bytes": self.bytes,
            "fastframe_hits": self.fastframe_hits,
            "avg_batch": (self.payloads / frames) if frames else 0.0,
        }


_lock = threading.Lock()
_channels: Dict[str, ChannelStats] = {}  # guarded-by: _lock


def channel(name: str) -> ChannelStats:
    """The named channel's accumulator (create on first use). Callers
    on hot paths should hold the returned object instead of re-looking
    it up per frame."""
    stats = _channels.get(name)
    if stats is None:
        with _lock:
            stats = _channels.setdefault(name, ChannelStats())
    return stats


def snapshot() -> Dict[str, dict]:
    with _lock:
        items = list(_channels.items())
    return {name: ch.snapshot() for name, ch in items}


def reset() -> None:
    """Zero every channel IN PLACE: hot-path callers hold ChannelStats
    references (per the ``channel`` docstring), so dropping the dict
    entries would silently detach them from future snapshots."""
    with _lock:
        for ch in _channels.values():
            ch.frames = ch.payloads = ch.bytes = ch.fastframe_hits = 0
