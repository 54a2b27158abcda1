"""Prefetching iterator: overlap pipeline execution with consumption.

A background thread drives the source iterator (the streaming
executor, or a batch re-chunker on top of it) and parks results in a
bounded queue ``depth`` deep — the same shape as
``streaming_split``'s driver thread, but single-consumer and with
starvation accounting: the consumer's cumulative wait on the queue
over its total wall time is the *starvation fraction* the trainer
ingestion scenario asserts on (≈ 0 means the pipeline kept up;
≈ 1 means the trainer is input-bound).

The queue being bounded is the backpressure hand-off: a slow consumer
parks the producer thread on ``put``, which stops pulling the
executor, whose byte budgets then throttle the actual task launches.

The port's copy of ``ray_tpu/data/_internal/prefetch.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterator, Optional


class PrefetchIterator:
    """Iterate ``source`` with ``depth`` items produced ahead."""

    def __init__(self, source: Iterator[Any], depth: int = 2,
                 name: str = "rtpu-data-prefetch"):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._closed = threading.Event()
        self._wait_s = 0.0
        self._items = 0
        self._started_at: Optional[float] = None
        self._thread = threading.Thread(
            target=self._pump, args=(source,), daemon=True, name=name)
        self._thread.start()

    def _pump(self, source) -> None:
        try:
            for item in source:
                if not self._offer(("item", item)):
                    return          # consumer closed early
        except BaseException as e:  # propagate to the consumer
            self._offer(("err", e))
            return
        self._offer(("end", None))

    def _offer(self, msg) -> bool:
        """put() that gives up when the consumer is gone — a closed
        iterator must not strand this thread (and the executor's
        actors) on a full queue forever."""
        while not self._closed.is_set():
            try:
                self._q.put(msg, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._started_at is None:
            self._started_at = time.monotonic()
        t0 = time.monotonic()
        msg, val = self._q.get()
        self._wait_s += time.monotonic() - t0
        if msg == "err":
            self.close()
            raise val
        if msg == "end":
            self.close()
            raise StopIteration
        self._items += 1
        return val

    def close(self) -> None:
        self._closed.set()

    # -- starvation accounting -------------------------------------------

    def stats(self) -> dict:
        wall = ((time.monotonic() - self._started_at)
                if self._started_at is not None else 0.0)
        return {
            "items": self._items,
            "wait_s": self._wait_s,
            "wall_s": wall,
            "starvation_fraction": (self._wait_s / wall) if wall > 0
            else 0.0,
        }
