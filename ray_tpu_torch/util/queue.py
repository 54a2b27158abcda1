"""Actor-backed distributed queue.

Reference: ``python/ray/util/queue.py`` [UNVERIFIED — mount empty,
SURVEY.md §0]: a Queue whose state lives in an actor, shareable across
tasks/actors by passing the handle.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: deque = deque()

    def qsize(self) -> int:
        return len(self.items)

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def get(self) -> tuple:
        if not self.items:
            return False, None
        return True, self.items.popleft()

    def put_batch(self, items: List) -> int:
        n = 0
        for item in items:
            if self.maxsize > 0 and len(self.items) >= self.maxsize:
                break
            self.items.append(item)
            n += 1
        return n


class Queue:
    """Blocking semantics via bounded polling on the actor."""

    POLL_S = 0.02

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        ray_tpu_torch.init()
        cls = ray_tpu_torch.remote(_QueueActor)
        self._actor = cls.options(**(actor_options or {"num_cpus": 0.1})
                                  ).remote(maxsize)
        self.maxsize = maxsize

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self._actor.put.remote(item)):
                return
            if not block:
                raise Full("queue is full")
            if deadline is not None and time.monotonic() >= deadline:
                raise Full("put timed out")
            time.sleep(self.POLL_S)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self._actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty("queue is empty")
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty("get timed out")
            time.sleep(self.POLL_S)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_batch(self, items: List) -> None:
        items = list(items)
        while items:
            n = ray_tpu_torch.get(self._actor.put_batch.remote(items))
            items = items[n:]
            if items:
                time.sleep(self.POLL_S)

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self._actor)
